"""The port's profiling and build-cache utilities (``utils/profiling.py``,
``utils/compile_cache.py``): the phase report, the profiler's trace file,
and the order in which the build directory is resolved."""
import json

import torch

from bumpcosmology_torch.ops import _build
from bumpcosmology_torch.utils import enable_compilation_cache
from bumpcosmology_torch.utils.profiling import PhaseTimer, trace


def test_phase_timer_reports_the_phases_and_the_total():
    t = PhaseTimer()
    with t.phase("warmup"):
        _ = sum(range(1000))
    with t.phase("sampling", block_on={"x": torch.ones(3), "y": [torch.zeros(2)]}):
        _ = sum(range(1000))
    with t.phase("warmup"):
        _ = sum(range(1000))
    assert list(t.phases) == ["warmup", "sampling"] and all(v > 0 for v in t.phases.values())
    lines = t.report().splitlines()
    assert [ln.split()[0] for ln in lines] == ["warmup", "sampling", "total"]
    assert float(lines[-1].split()[1].rstrip("s")) >= sum(round(v, 2) for v in t.phases.values()) - 0.02


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "prof"):
        (x @ x).sum()
    with trace(tmp_path / "prof"):
        torch.exp(x)
    files = sorted((tmp_path / "prof").glob("trace-*.json"))
    assert len(files) == 2
    for f in files:
        events = json.loads(f.read_text())["traceEvents"]
        assert f.stat().st_size > 0 and any("mm" in e.get("name", "") or "exp" in e.get("name", "")
                                            for e in events)


def test_enable_compilation_cache_resolves_argument_then_environment_then_default(tmp_path, monkeypatch):
    monkeypatch.setenv("BUMPCOSMOLOGY_CACHE_DIR", str(tmp_path / "env"))
    try:
        got = enable_compilation_cache(str(tmp_path / "arg"), min_compile_time_secs=5.0)
        assert got == tmp_path / "arg" and got.is_dir() and _build.BUILD_DIR == got
        assert _build._target("bump").parent == got
        got = enable_compilation_cache()
        assert got == tmp_path / "env" and _build.BUILD_DIR == got
    finally:
        monkeypatch.delenv("BUMPCOSMOLOGY_CACHE_DIR")
        restored = enable_compilation_cache()
    assert restored == _build.DEFAULT_BUILD_DIR == _build.BUILD_DIR
    assert restored.name == "_build" and restored.parent.name == "bumpcosmology_torch"
