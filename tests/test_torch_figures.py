"""The figures and the report (``bumpcosmology_torch/figures``) and their
stages, on the CPU, against the JAX package's figure code.

The artifacts are port-format (``.npz`` keyed by the JAX package's HDF5
paths), built as ``tests/test_utils_and_figures.py:115-218`` builds its
inputs, with the diagnostics stages' artifacts written in the port stages'
layouts.  One run of the pipeline's ``report`` target (the ``figures``
stage, then the ``report`` stage) draws every entry of ``FIGURES`` and
``EXTRA_FIGURES``; each file must exceed 1,000 bytes.  The arrays behind
three figures are held against the JAX package's own figure functions,
whose plotting calls are recorded: the ``dNdm_PISN_effects`` curves at rtol
1e-4, ``omh2_zoomin``'s posterior and prior draws and ``dndm_fitted``'s
median and quantile bands exactly (the same float64 numpy on the same
trace).  The report passes ``test_utils_and_figures.py:293-325``'s asserts,
and ``python -m bumpcosmology_torch.figures all --device cpu`` exits 0.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bumpcosmology_torch.figures import plots
from bumpcosmology_torch.models.population import COORDS
from bumpcosmology_torch.pipeline.config import PipelineConfig
from bumpcosmology_torch.utils.io import write_table
from bumpcosmology_torch.utils.trace import Trace, save_trace

ROOT = Path(__file__).resolve().parent.parent
SITES = {"h": (0.7, 0.05), "Om": (0.3, 0.05), "w": (-1.0, 0.1), "mpisn": (31, 2), "mbhmax": (36, 2),
         "sigma": (2.3, 0.4)}


def _posterior(seed: int, nc: int = 2, nd: int = 50) -> dict:
    rng = np.random.default_rng(seed)
    post = {k: rng.normal(loc, scale, size=(nc, nd)) for k, (loc, scale) in SITES.items()}
    post["mdNdmdVdt_fixed_qz"] = np.abs(rng.normal(1.0, 0.2, size=(nc, nd, 128)))
    return post


def _write_artifacts(cfg: PipelineConfig) -> None:
    from bumpcosmology_torch.pipeline.stages import write_influence_artifact, write_sbc_artifact

    p = cfg.paths.path
    save_trace(p("trace.npz"), Trace(_posterior(1), coords=COORDS))
    save_trace(p("trace_cosmo.npz"), Trace(_posterior(1), coords=COORDS))
    save_trace(p("trace_plpeak.npz"), Trace(_posterior(5), coords=COORDS, attrs={"family": "plpeak"}))
    rng = np.random.default_rng(1)
    pe = {"m1": rng.uniform(10, 60, 256), "q": rng.uniform(0.3, 1.0, 256), "z": rng.uniform(0.05, 1.0, 256),
          "wt": rng.uniform(0.5, 2.0, 256), "evt": np.repeat([f"GW_{e}" for e in range(4)], 64)}
    write_table(p("pe-samples.npz"), pe)
    obs = {"m1": rng.uniform(10, 60, 30), "q": rng.uniform(0.3, 1.0, 30), "z": rng.uniform(0.05, 1.0, 30),
           "log_mc_obs": rng.normal(3.3, 0.2, 30), "sigma_log_mc": np.full(30, 0.05),
           "q_obs": rng.uniform(0.4, 0.95, 30), "sigma_q": np.full(30, 0.07),
           "log_dl_obs": rng.normal(0.0, 0.3, 30), "sigma_log_dl": np.full(30, 0.2)}
    write_table(p("mock_observations.npz"), obs, key="observations")

    sites = ("h", "Om", "w", "mpisn", "sigma")
    ranks = {s: rng.integers(0, 17, size=40) for s in sites}
    ranks["__n_bins__"] = np.asarray(17)
    write_sbc_artifact(p("sbc_ranks.npz"), "pop_cosmo", 40, ranks, {s: 0.5 for s in sites})
    events = [f"GW_{i}" for i in range(14)]
    write_influence_artifact(p("influence.npz"), "pop_cosmo", events,
                             {s: {"mean_loo": rng.normal(size=14), "delta_mean": rng.normal(size=14),
                                  "z": rng.normal(size=14)} for s in sites})
    compare = {"attrs/best_model": np.asarray("pop_cosmo"), "attrs/table": np.asarray("model elpd ..."),
               "event": np.array(events, dtype=str)}
    for m in ("pop", "pop_cosmo"):
        compare.update({f"{m}/elpd_i": rng.normal(-3.0, 0.5, 14), f"{m}/khat": rng.uniform(0.0, 0.9, 14),
                        f"{m}/attrs/elpd": np.asarray(-40.0), f"{m}/attrs/log_z": np.asarray(-50.0 - len(m))})
    np.savez(p("model_compare.npz"), **compare)
    grid = np.linspace(0.0, 1.0, 32)
    ppc = {"attrs/n_draws": np.asarray(64)}
    for m in ("pop", "pop_cosmo"):
        ppc[f"{m}/attrs/n_draws"] = np.asarray(64)
        for col, label in (("m1", "m1 [Msun]"), ("q", "q")):
            g = f"{m}/{col}/"
            band = np.sort(rng.uniform(0, 1, (3, 32)), axis=0).cumsum(axis=1) / 32
            ppc.update({g + "grid": grid, g + "pred_cdf_q": band, g + "obs_cdf_q": band[::-1],
                        g + "attrs/p_value": np.asarray(0.4), g + "attrs/label": np.asarray(label),
                        g + "ks_obs": rng.uniform(size=8), g + "ks_rep": rng.uniform(size=8)})
    np.savez(p("ppc.npz"), **ppc)
    sens = {}
    for m in ("pop", "pop_cosmo"):
        perts = [f"{s} x{f}" for s in sites for f in ("0.5", "2")]
        sens.update({f"{m}/perturbation": np.array(perts, dtype=str), f"{m}/site": np.array(sites, dtype=str),
                     f"{m}/shift_sd": rng.normal(0, 0.3, (len(perts), len(sites))),
                     f"{m}/sd_ratio": rng.uniform(0.8, 1.2, (len(perts), len(sites))),
                     f"{m}/ess_frac": rng.uniform(0.01, 1.0, len(perts))})
    np.savez(p("prior_sensitivity.npz"), **sens)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The artifacts, then ``report`` through the pipeline (``figures`` first), on the CPU."""
    from bumpcosmology_torch.pipeline.stages import build_pipeline

    cfg = PipelineConfig()
    cfg.paths.data_dir = str(tmp_path_factory.mktemp("figures_data"))
    _write_artifacts(cfg)
    build_pipeline(cfg, device="cpu").run(["report"])
    return cfg


@pytest.mark.parametrize("name", [*plots.FIGURES, *plots.EXTRA_FIGURES])
def test_every_figure_renders(run, name):
    out = Path(run.paths.data_dir) / "figures" / f"{name}.pdf"
    assert out.exists() and out.stat().st_size > 1000, name


def test_the_report(run):
    """``test_utils_and_figures.py:293-325``'s asserts on the report stage's output."""
    out_dir = Path(run.paths.data_dir) / "report"
    for name in ("ms.tex", "ms.md", "report.pdf"):
        assert (out_dir / name).exists() and (out_dir / name).stat().st_size > 0
    tex = (out_dir / "ms.tex").read_text()
    assert "\\includegraphics" in tex and "Posterior summary" in tex
    assert "\\documentclass" in tex
    md = (out_dir / "ms.md").read_text()
    assert "| site |" in md and "cosmo_params_corner" in md
    assert len(list((out_dir / "figures").glob("*.png"))) == len(plots.FIGURES) + len(plots.EXTRA_FIGURES)


def test_the_figures_stage_names_a_missing_library(tmp_path, monkeypatch):
    from bumpcosmology_torch.pipeline.stages import _stage_figures, _stage_report

    cfg = PipelineConfig()
    cfg.paths.data_dir = str(tmp_path)
    monkeypatch.setitem(sys.modules, "seaborn", None)
    for stage in (_stage_figures, _stage_report):
        with pytest.raises(ImportError, match="lacks seaborn"):
            stage(cfg, device="cpu")
    assert not (tmp_path / "figures").exists()


def _recorded(monkeypatch, module, names):
    """Wrap ``module.<name>`` for each name so that its positional arguments are recorded."""
    calls = {n: [] for n in names}

    def wrap(n, fn):
        def recorder(*args, **kwargs):
            calls[n].append(args)
            return fn(*args, **kwargs)
        return recorder

    for n in names:
        monkeypatch.setattr(module, n, wrap(n, getattr(module, n)))
    return calls


def test_the_pisn_curves_match_jax(tmp_path, monkeypatch):
    from bumpcosmology_tpu.figures import plots as jplots

    calls = _recorded(monkeypatch, jplots.plt, ["plot"])
    jplots.dndm_pisn_effects(out=tmp_path / "jax.png")
    m, curves = plots._pisn_curves("cpu")
    assert len(calls["plot"]) == len(curves) == 5
    for (jm, jvals), (label, vals) in zip(calls["plot"], curves.items()):
        np.testing.assert_array_equal(m, jm)
        assert np.isfinite(vals).all() and vals.max() > 0
        np.testing.assert_allclose(vals, jvals, rtol=1e-4, atol=0.0, err_msg=label)


def test_omh2_and_dndm_arrays_match_jax(tmp_path, monkeypatch):
    from bumpcosmology_tpu.figures import plots as jplots
    from bumpcosmology_tpu.utils.trace import Trace as JTrace
    from bumpcosmology_tpu.utils.trace import save_trace as jsave

    post = _posterior(3)
    port_path = tmp_path / "port" / "trace.npz"
    port_path.parent.mkdir()
    save_trace(port_path, Trace(post, coords=COORDS))
    jax_path = tmp_path / "jax" / "trace.h5"
    jax_path.parent.mkdir()
    jsave(jax_path, JTrace(post, coords=COORDS))

    calls = _recorded(monkeypatch, jplots.sns, ["kdeplot"])
    jplots.omh2_zoomin(jax_path, out=tmp_path / "omh2.png")
    got_post, got_prior = plots._omh2_draws(port_path)
    (jpost,), (jprior,) = calls["kdeplot"]
    np.testing.assert_array_equal(got_post, jpost)
    np.testing.assert_array_equal(got_prior, jprior)

    calls = _recorded(monkeypatch, jplots.plt, ["plot", "fill_between"])
    jplots.dndm_fitted(jax_path, out=tmp_path / "dndm.png")
    x, family, (med, q16, q84, q025, q975), siblings = plots._dndm_bands(port_path)
    assert family == "bump" and siblings == []
    (jx, jmed), = calls["plot"]
    np.testing.assert_array_equal(x[1:], jx)
    np.testing.assert_array_equal(med[1:], jmed)
    for (_, hi, lo), (want_hi, want_lo) in zip(calls["fill_between"], ((q84, q16), (q975, q025))):
        np.testing.assert_array_equal(hi, want_hi[1:])
        np.testing.assert_array_equal(lo, want_lo[1:])


def test_the_figures_cli(run, tmp_path):
    out_dir = tmp_path / "cli"
    proc = subprocess.run([sys.executable, "-m", "bumpcosmology_torch.figures", "all", "--device", "cpu",
                           "--data-dir", run.paths.data_dir, "--out-dir", str(out_dir), "--fmt", "png"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert sorted(p.stem for p in out_dir.glob("*.png")) == sorted(plots.FIGURES)
