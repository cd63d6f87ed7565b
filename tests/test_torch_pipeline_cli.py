"""The port's DAG (``pipeline/dag.py``), ``build_pipeline`` and CLI
(``python -m bumpcosmology_torch.pipeline``) against the JAX package's.

The offline run goes through fetch (rehearsal fixtures, no download), both
draws and a tiny population-only fit on the CPU.  Its fit inputs are held to
the JAX stages' tables drawn from the same rehearsal files: the rows are the
same (``m1 q z evt`` and ``m1 q z ndraw`` equal), and the weight columns
(``wt``, ``pdraw``: each package's float32 ``default_pop_wt``) agree at
rtol 5e-5, the two packages' population-weight tolerance
(``tests/test_torch_mock.py``).
"""
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bumpcosmology_torch.pipeline import __main__ as cli
from bumpcosmology_torch.pipeline import stages as tstages
from bumpcosmology_torch.pipeline.config import PipelineConfig
from bumpcosmology_torch.pipeline.dag import Pipeline, Stage
from bumpcosmology_torch.utils.io import read_table
from bumpcosmology_torch.utils.trace import load_trace

TINY = ["ingest.rehearsal_events=3", "ingest.rehearsal_campaign_ndraw=60000", "ingest.nsamp_pe=32",
        "ingest.nsamp_sel=128", "fit.num_chains=2", "fit.num_warmup=20", "fit.num_samples=8", "fit.max_depth=3",
        "fit.n_grid=48", "fit.n_z=64"]
F32_POP = 5e-5
INJECTION = "endo3_bbhpop-LIGO-T2100113-v12.hdf5"


def raw_paths(root):
    """``key=value`` arguments that put the raw inputs under ``root``
    (``--data-dir`` moves the artifacts only, as in the JAX package)."""
    return [f"paths.pe_raw_dir={root / 'pe-samples-raw'}", f"paths.injection_file={root / INJECTION}"]


@pytest.fixture(autouse=True)
def no_network(monkeypatch):
    """A download would fail the test (the rehearsal attempts none)."""
    from bumpcosmology_torch.data import fetch

    def refuse(url, dest, timeout):
        raise AssertionError("the pipeline attempted a download")

    monkeypatch.setattr(fetch, "_download", refuse)


# --------------------------------------------------------------------- the DAG


def _touch(path, t):
    Path(path).write_text("x")
    os.utime(path, (t, t))


def test_dag_runs_stale_stages_in_order_and_skips_fresh_ones(tmp_path, capsys):
    ran = []
    a_out, b_out = tmp_path / "a.out", tmp_path / "b.out"
    pipe = Pipeline([
        Stage("b", lambda: (ran.append("b"), _touch(b_out, time.time())), inputs=[a_out], outputs=[b_out],
              after=["a"]),
        Stage("a", lambda: (ran.append("a"), _touch(a_out, time.time() - 10)), outputs=[a_out]),
    ])
    pipe.run(["b"])
    assert ran == ["a", "b"]
    pipe.run(["b"])
    assert ran == ["a", "b"]
    assert capsys.readouterr().out.count("up to date") == 2
    _touch(a_out, time.time() + 10)  # an input newer than the output: b is stale again, a is not
    pipe.run(["b"])
    assert ran == ["a", "b", "b"]
    pipe.run(["b"], force=True)
    assert ran == ["a", "b", "b", "a", "b"]


def test_dag_errors(tmp_path):
    noop = lambda: None  # noqa: E731
    with pytest.raises(ValueError, match="stage cycle: a -> b -> a"):
        Pipeline([Stage("a", noop, after=["b"]), Stage("b", noop, after=["a"])]).run(["a"])
    with pytest.raises(KeyError, match="unknown stage 'c'"):
        Pipeline([Stage("a", noop)]).run(["c"])
    with pytest.raises(RuntimeError, match="did not produce outputs"):
        Pipeline([Stage("a", noop, outputs=[tmp_path / "never"])]).run(["a"])


def test_build_pipeline_mirrors_jax(tmp_path):
    """Every JAX stage, ``figures`` and ``report`` included, with the same
    dependencies and the JAX artifacts' names as ``.npz``."""
    from bumpcosmology_tpu.pipeline.config import PipelineConfig as JaxConfig
    from bumpcosmology_tpu.pipeline.stages import build_pipeline as jax_build

    jcfg, tcfg = JaxConfig(), PipelineConfig()
    jcfg.paths.data_dir = tcfg.paths.data_dir = str(tmp_path)
    jax_pipe, pipe = jax_build(jcfg), tstages.build_pipeline(tcfg, device="cpu")
    assert set(pipe.stages) == set(jax_pipe.stages)
    as_npz = lambda paths: [str(p)[:-3] + ".npz" if str(p).endswith(".h5") else str(p) for p in paths]  # noqa: E731
    for name, stage in pipe.stages.items():
        ref = jax_pipe.stages[name]
        assert list(stage.after) == list(ref.after), name
        assert [str(p) for p in stage.outputs] == as_npz(ref.outputs), name
        assert [str(p) for p in stage.inputs] == as_npz(ref.inputs), name


# ----------------------------------------------------------------------- the CLI


def test_list(tmp_path, capsys):
    assert cli.main(["list", "--device", "cpu", "--data-dir", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    cfg = PipelineConfig()
    cfg.paths.data_dir = str(tmp_path)
    assert [line.split()[0] for line in lines] == list(tstages.build_pipeline(cfg, "cpu").stages)
    assert all("[stale]" in line for line in lines)
    assert "sample_cosmo             [stale] -> " + str(tmp_path / "trace_cosmo.npz") in lines


def test_data_dir_moves_the_artifacts_and_not_the_raw_inputs(tmp_path, monkeypatch, capsys):
    """As the JAX package's ``--data-dir``: the raw inputs stay at their
    configured paths (``data/...`` by default) unless ``key=value`` moves them."""
    seen = []
    real_build = cli.build_pipeline
    monkeypatch.setattr(cli, "build_pipeline", lambda c, device=None: (seen.append(c.paths), real_build(c, device))[1])
    for extra, injection in (([], PipelineConfig().paths.injection_file), (raw_paths(tmp_path), tmp_path / INJECTION)):
        assert cli.main(["list", "--device", "cpu", "--data-dir", str(tmp_path)] + extra) == 0
        paths = seen.pop()
        assert paths.data_dir == str(tmp_path)
        assert paths.injection_file == str(injection)
        assert Path(paths.pe_raw_dir).parent == Path(injection).parent
    capsys.readouterr()


def test_the_device_is_cuda_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["sample", "--data-dir", str(tmp_path)], ["list"], ["all", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(argv)
    assert not (tmp_path / "input_manifest.json").exists()


def test_the_dropped_flags_are_refused_and_named_in_help(capsys):
    with pytest.raises(SystemExit):
        cli.main(["sample", "--platform", "cpu"])
    assert "--platform is --device here" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    for flag in ("--device", "--platform", "--host-devices", "--no-compile-cache", "--rehearsal"):
        assert flag in out
    assert cli.GROUPS["all"] == ["sample", "sample_cosmo", "figures", "report"]  # the JAX package's group


@pytest.mark.parametrize("stage", ["fetch", "draw_pe_samples", "draw_selection_samples"])
def test_ingestion_without_h5py_names_it(tmp_path, monkeypatch, stage):
    """On a host without h5py (the GPU host) ingestion raises an ImportError
    that names h5py and says where ingestion runs; nothing is skipped."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="needs h5py.*runs on a host that has h5py"):
        cli.main([stage, "--device", "cpu", "--rehearsal", "--data-dir", str(tmp_path)] + raw_paths(tmp_path) + TINY)


@pytest.fixture(scope="module")
def offline_run(tmp_path_factory):
    """``sample --rehearsal --device cpu`` from an empty directory, then again."""
    import contextlib
    import io

    root = tmp_path_factory.mktemp("cli")
    argv = ["sample", "--rehearsal", "--device", "cpu", "--data-dir", str(root)] + raw_paths(root) + TINY
    from bumpcosmology_torch.data import fetch

    refuse = lambda url, dest, timeout: pytest.fail("the pipeline attempted a download")  # noqa: E731
    saved, fetch._download = fetch._download, refuse
    try:
        runs = []
        for _ in range(2):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert cli.main(argv) == 0
            runs.append(out.getvalue())
    finally:
        fetch._download = saved
    return root, runs


def test_offline_run_reaches_a_trace_and_then_is_up_to_date(offline_run):
    root, (first, second) = offline_run
    for name in ("input_manifest.json", "pe-samples.npz", "selection-samples.npz", "trace.npz"):
        assert (root / name).exists()
    assert "[fetch] rehearsal fallback wrote 3 PE files + injection file" in first
    assert "(offline: no download attempted)" in first
    trace = load_trace(root / "trace.npz")
    assert trace.posterior["mpisn"].shape == (2, 8)
    assert all(np.isfinite(v).all() for v in trace.posterior.values())
    stages = ("fetch", "draw_pe_samples", "draw_selection_samples", "sample")
    assert all(f"[pipeline] {s}: up to date" in second for s in stages)
    assert "running" not in second


def test_offline_run_tables_equal_the_jax_stages(offline_run, tmp_path):
    from bumpcosmology_tpu.pipeline import stages as jstages
    from bumpcosmology_tpu.pipeline.config import PipelineConfig as JaxConfig
    from bumpcosmology_tpu.utils.io import read_table as jax_read

    root, _ = offline_run
    jcfg = JaxConfig.load(None, [o for o in TINY if o.startswith("ingest.")])
    jcfg.paths.data_dir = str(tmp_path)
    jcfg.paths.pe_raw_dir = str(root / "pe-samples-raw")
    jcfg.paths.injection_file = str(root / INJECTION)
    jstages._stage_draw_pe_samples(jcfg)
    jstages._stage_draw_selection_samples(jcfg)
    for name, exact, weight in (("pe-samples", ("m1", "q", "z", "evt"), "wt"),
                                ("selection-samples", ("m1", "q", "z", "ndraw"), "pdraw")):
        ref = jax_read(tmp_path / f"{name}.h5")
        got = read_table(root / f"{name}.npz")
        assert list(got) == list(ref.columns)
        for col in exact:
            np.testing.assert_array_equal(got[col], ref[col].to_numpy(), err_msg=f"{name}:{col}")
        np.testing.assert_allclose(got[weight], ref[weight].to_numpy(), rtol=F32_POP, atol=0.0)
    assert len(np.unique(got["m1"])) > 1 and len(np.unique(read_table(root / "pe-samples.npz")["evt"])) == 3
