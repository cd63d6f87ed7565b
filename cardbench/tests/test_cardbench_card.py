"""On the card: a short run of the cell through ``run.py`` is correct, and
the lower-precision control at the cell's own size is not.

    python -m pytest -m cuda cardbench/tests/test_cardbench_card.py
"""
import json
import subprocess
import sys

import pytest

from cardbench import harness
from conftest import CELL


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card, workload=CELL):
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload", workload, "--seed", "2147483999",
                          "--seconds", "5", "--trace", "0"], cwd=harness.REPO_DIR, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == {"setup_s", "leapfrog_ms_p95"}


@pytest.mark.cuda
def test_the_control_at_the_cells_size_is_not_correct(card, workload=CELL):
    import torch

    from bumpcosmology_torch.utils import enable_compilation_cache

    from cardbench import limits

    enable_compilation_cache(str(harness.BENCH_DIR / ".cache" / "kernels"))
    manifest = harness.load_manifest()
    cell_entry, config_entry = harness.cell_of(manifest, workload)
    cell = harness.Cell(harness.load_config(config_entry), harness.load_traffic(cell_entry["traffic"]), "cuda")
    lim = harness.limits_of(workload)
    (row,) = limits.readings(cell, [2147483998], 4.0, "cuda", torch.cuda.synchronize, lim)
    assert all(row["program"][k] <= lim[k] for k in harness.NUMBERS)
    assert any(row["control"][k] > lim[k] for k in harness.NUMBERS)
