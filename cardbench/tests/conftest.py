"""Fixtures of the benchmark's tests: the repository root on the path, a
copy of the benchmark's files cut to a size the CPU runs in seconds, and
the card's look, made inside a fixture."""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELL = "flagship_bump.nuts"


@pytest.fixture
def card():
    """Skips unless a CUDA device is there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port on the card")
    return torch.device("cuda")


@pytest.fixture
def tiny_bench(tmp_path):
    """(manifest, bench_dir) of the cell at a tiny size, with the
    benchmark's own traffic mix, readers, reference and limits and its 4
    chains; the data files are the committed ones."""
    import torch

    torch.set_num_threads(1)
    bench = tmp_path / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for f in (BENCH / "limits").glob("*.json"):
        shutil.copy(f, bench / "limits" / f.name)
    data = {k: str(BENCH / "data" / f) for k, f in (("catalog", "flagship_catalog.npz"),
                                                    ("warmup_state", "flagship_warmup16.npz"))}
    fb = json.loads((BENCH / "configs" / "flagship_bump.json").read_text())
    fb.update(events=4, pe_samples=32, injections=512, n_grid=32, n_z=64, **data)
    (bench / "configs" / "flagship_bump.json").write_text(json.dumps(fb))
    t = json.loads((BENCH / "traffic" / "nuts.json").read_text())
    t.update(max_depth=7, leapfrog_sample=32, trace_stretch={"after_share": 0.3, "value_and_grads": 5})
    (bench / "traffic" / "nuts.json").write_text(json.dumps(t))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        c["file"] = f"configs/{c['name']}.json"
    return manifest, bench
