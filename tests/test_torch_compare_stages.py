"""The model-comparison stages of the port against the JAX package's stages,
on the CPU at a tiny size.

One data directory holds source-frame fit inputs (5 events x 16 samples, 64
injections) and three traces fitted by the port's own stages (pop, pop_cosmo
and POWER-LAW+PEAK pop_cosmo; one chain of 80 draws after 20 warmup steps,
``max_depth`` 2, ``n_grid`` 48, ``n_z`` 64).  A second directory holds the
same tables and traces in the JAX package's HDF5 files, and the JAX stages
run there.  An artifact's keys are compared with the JAX stage's HDF5 paths
(datasets, and attributes as ``attrs/<name>`` and ``<group>/attrs/<name>``).

* ``_stage_compare``: the JAX stage's keys; the pointwise matrices against
  the JAX stage's at rtol 2e-5, atol 2e-5 (both packages take the fused
  route on the stage's bounds); the table's layout; a bridge-sampling
  ``log_z`` for every model.
* ``_stage_ppc``: the JAX stage's keys; every p-value in [0, 1].  The
  weights are not compared here (the bump's route differs on purpose;
  ``tests/test_torch_ppc.py`` holds both routes).
* ``_stage_prior_sens``: the JAX stage's keys and, under ``jax.enable_x64``,
  its values at rtol 1e-10; it visits the bump's and PLPeak's traces only.
* ``_stage_loo`` (the joint model, 5 leave-one-out chains, 20 warmup steps
  and 8 draws): ``influence.npz`` with the keys the JAX package's
  ``write_influence_artifact`` writes for the same summary, every z finite.
* ``PipelineConfig``: ``load`` of a JSON with ``loo``, ``compare`` and
  ``ppc`` sections and their overrides, and the defaults of every section
  equal to the JAX package's.
* The model-comparison entry points raise without CUDA when given
  ``device=None``, before they touch the data directory.
"""
import json

import h5py
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from bumpcosmology_torch.pipeline import config, stages
from bumpcosmology_torch.testing import synthetic_source_tables
from bumpcosmology_torch.utils.io import write_table
from bumpcosmology_torch.utils.trace import load_trace

N_GRID, N_Z = 48, 64
TRACES = (("bump", "pop"), ("bump", "cosmo"), ("plpeak", "cosmo"))
ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _configs(port_dir, jax_dir):
    from bumpcosmology_tpu.pipeline import config as jconfig

    def make(module, d):
        return module.PipelineConfig(
            paths=module.PathsConfig(data_dir=str(d)),
            fit=module.FitConfig(num_warmup=20, num_samples=80, num_chains=1, max_depth=2, n_grid=N_GRID, n_z=N_Z),
            loo=module.LooConfig(num_warmup=20, num_samples=8, max_depth=3),
            compare=module.CompareConfig(batch=16), ppc=module.PpcConfig(batch=16, n_draws=40))

    return make(config, port_dir), make(jconfig, jax_dir)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The port's traces in one directory, the same tables and traces as the JAX package's files in another."""
    from bumpcosmology_tpu.utils import io as jio
    from bumpcosmology_tpu.utils import trace as jtrace
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES

    tmp = tmp_path_factory.mktemp("compare")
    cfg, jcfg = _configs(tmp / "port", tmp / "jax")
    pe, sel = synthetic_source_tables(nobs=5, nsamp=16, nsel=64, seed=1)
    write_table(cfg.paths.path("pe-samples.npz"), pe)
    write_table(cfg.paths.path("selection-samples.npz"), sel)
    jio.write_table(str(jcfg.paths.path("pe-samples.h5")), pd.DataFrame(pe))
    jio.write_table(str(jcfg.paths.path("selection-samples.h5")), pd.DataFrame(sel))
    for family, model in TRACES:
        cfg.fit.mass_family = family
        (stages.run_pop_fit if model == "pop" else stages.run_pop_cosmo_fit)(cfg, device="cpu")
        fam = MASS_FAMILIES[family]
        name = fam.trace_name if model == "pop" else fam.cosmo_trace_name
        t = load_trace(cfg.paths.path(name))
        jtrace.save_trace(str(jcfg.paths.path(name.replace(".npz", ".h5"))),
                          jtrace.Trace(t.posterior, t.sample_stats, t.coords, t.attrs))
    cfg.fit.mass_family = "bump"
    return cfg, jcfg


def _h5_keys(path):
    """The HDF5 file's datasets and attributes as the port's ``.npz`` keys."""
    keys = []
    with h5py.File(path, "r") as f:
        keys += [f"attrs/{a}" for a in f.attrs]

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                keys.append(name)
            keys.extend(f"{name}/attrs/{a}" for a in obj.attrs)

        f.visititems(visit)
    return sorted(keys)


def _npz(path):
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def test_stage_compare_matches_the_jax_stage(dirs, capsys):
    from bumpcosmology_tpu.pipeline import stages as jstages

    cfg, jcfg = dirs
    table = stages._stage_compare(cfg, device="cpu")
    jstages._stage_compare(jcfg)
    out = capsys.readouterr().out
    got = _npz(cfg.paths.path("model_compare.npz"))
    assert sorted(got) == _h5_keys(jcfg.paths.path("model_compare.h5"))
    assert str(got["attrs/table"]) == table and "[compare]" in out
    assert table.splitlines()[0].split() == ["model", "elpd", "se", "d_elpd", "d_se", "max_k"]
    assert sorted(line.split()[0] for line in table.splitlines()[1:]) == ["pop", "pop_cosmo", "pop_cosmo_plpeak"]
    assert [str(e) for e in got["event"]] == [f"GW{i:02d}" for i in range(5)]
    with h5py.File(jcfg.paths.path("model_compare.h5"), "r") as f:
        for name in ("pop", "pop_cosmo", "pop_cosmo_plpeak"):
            ref = np.asarray(f[name]["pointwise"])
            assert got[f"{name}/pointwise"].shape == ref.shape == (80, 5)
            np.testing.assert_allclose(got[f"{name}/pointwise"], ref, rtol=2e-5, atol=2e-5, err_msg=name)
            assert int(got[f"{name}/attrs/n_draws"]) == 80
            assert np.isfinite(got[f"{name}/attrs/log_z"]) and got[f"{name}/log_z_blocks"].ndim == 1


def test_stage_ppc_writes_the_jax_stages_keys(dirs, capsys):
    from bumpcosmology_tpu.pipeline import stages as jstages

    cfg, jcfg = dirs
    path = stages._stage_ppc(cfg, device="cpu")
    assert capsys.readouterr().out.count("[ppc] pop") == 3
    jstages._stage_ppc(jcfg)
    got = _npz(path)
    assert sorted(got) == _h5_keys(jcfg.paths.path("ppc.h5"))
    p = [float(v) for k, v in got.items() if k.endswith("/attrs/p_value")]
    assert len(p) == 9 and all(0.0 <= x <= 1.0 for x in p)


def test_stage_prior_sens_matches_the_jax_stage(dirs):
    from bumpcosmology_tpu.pipeline import stages as jstages

    cfg, jcfg = dirs
    got = _npz(stages._stage_prior_sens(cfg, device="cpu"))
    with jax.enable_x64(True):
        jstages._stage_prior_sens(jcfg)
    assert sorted(got) == _h5_keys(jcfg.paths.path("prior_sensitivity.h5"))
    assert sorted({k.split("/")[0] for k in got}) == ["pop", "pop_cosmo", "pop_cosmo_plpeak"]
    with h5py.File(jcfg.paths.path("prior_sensitivity.h5"), "r") as f:
        for key, v in got.items():
            ref = np.asarray(f[key])
            if ref.dtype.kind == "S":
                assert [str(x) for x in v] == [x.decode() for x in ref]
            else:
                np.testing.assert_allclose(v, ref, rtol=1e-10, atol=1e-12, err_msg=key)


def test_stage_loo_writes_the_influence_artifact(dirs, tmp_path, capsys):
    from bumpcosmology_tpu.pipeline.stages import write_influence_artifact as j_write

    cfg = dirs[0]
    stages._stage_loo(cfg, device="cpu")
    assert "[loo] most influential: event GW" in capsys.readouterr().out
    got = _npz(cfg.paths.path("influence.npz"))
    sites = sorted({k.split("/")[0] for k in got} - {"attrs", "event"})
    infl = {s: {k: got[f"{s}/{k}"] for k in ("mean_loo", "delta_mean", "z")} for s in sites}
    j_write(str(tmp_path / "influence.h5"), "pop_cosmo", [f"GW{i:02d}" for i in range(5)], infl)
    assert sorted(got) == _h5_keys(tmp_path / "influence.h5")
    assert str(got["attrs/model"]) == "pop_cosmo" and len(sites) == 15  # every sampled site of the joint model
    assert all(got[f"{s}/z"].shape == (5,) and np.isfinite(got[f"{s}/z"]).all() for s in sites)


def test_pipeline_config_loads_the_comparison_sections(tmp_path):
    from bumpcosmology_tpu.pipeline import config as jconfig

    assert config.PipelineConfig().to_dict() == jconfig.PipelineConfig().to_dict()
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"loo": {"model": "pop", "num_warmup": 40}, "compare": {"batch": 8},
                                "ppc": {"n_draws": 64, "seed": 3}}))
    cfg = config.PipelineConfig.load(str(path), overrides=["loo.max_depth=5", "compare.max_draws=128", "ppc.batch=4"])
    ref = jconfig.PipelineConfig.load(str(path), overrides=["loo.max_depth=5", "compare.max_draws=128",
                                                            "ppc.batch=4"])
    assert cfg.to_dict() == ref.to_dict()
    assert (cfg.loo.model, cfg.loo.num_warmup, cfg.loo.max_depth, cfg.loo.seed) == ("pop", 40, 5, 515151)
    assert (cfg.compare.max_draws, cfg.compare.batch, cfg.ppc.n_draws, cfg.ppc.batch, cfg.ppc.seed) == (
        128, 8, 64, 4, 3)
    with pytest.raises(KeyError):
        config.PipelineConfig.load(overrides=["loo.no_such_key=1"])


@pytest.mark.parametrize("entry", ["loo", "compare", "ppc", "prior_sens", "pointwise_matrix",
                                   "posterior_predictive_check", "loo_fit"])
def test_comparison_entry_points_raise_without_cuda(monkeypatch, entry):
    from bumpcosmology_torch.inference.distributions import Normal
    from bumpcosmology_torch.inference.influence import loo_fit
    from bumpcosmology_torch.inference.model import ModelSpec
    from bumpcosmology_torch.inference.model_compare import pointwise_matrix
    from bumpcosmology_torch.inference.ppc import posterior_predictive_check
    from bumpcosmology_torch.testing import synthetic_pop_data

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = ROOT / "no-such-directory"
    cfg = config.PipelineConfig(paths=config.PathsConfig(data_dir=str(missing)))
    data = synthetic_pop_data(2, 3, 4, device="cpu")
    spec = ModelSpec(priors={"x": Normal(0.0, 1.0)}, loglike=lambda s: 0.0 * s["x"])
    calls = {
        **{name: (lambda name=name: getattr(stages, f"_stage_{name}")(cfg))
           for name in ("loo", "compare", "ppc", "prior_sens")},
        "pointwise_matrix": lambda: pointwise_matrix(lambda s: s["x"][:, None], {"x": np.zeros((1, 4))}, ["x"]),
        "posterior_predictive_check": lambda: posterior_predictive_check({"x": np.zeros((1, 4))}, ["x"], data),
        "loo_fit": lambda: loo_fit(spec, lambda s, d: 0.0 * s["x"], data),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    assert not missing.exists()
