"""The port's ``fit`` and joint-fit stage against the JAX package's.

* ``compute_deterministics`` with ``pop_cosmo_deterministics`` equals JAX's
  site by site on the same unconstrained draws, rtol 1e-4 / atol 1e-5.  Both
  run at the flagship's ``n_z`` = 1024: JAX's deterministics invert the
  cosmology table at each dL, the port (like both potentials) reads the
  detector-frame table built at ``n_z`` points; the two interpolations part by
  1.1e-5 in a weight at 1024, but by 2.4e-3 at ``n_z`` = 64.
* ``_finite_prior_init`` redraws exactly the chains whose potential is not
  finite (``tests/test_nuts.py:190-205``).
* ``fit`` resumes from a warmup checkpoint without adapting.
* ``run_pop_cosmo_fit`` on ``device="cpu"`` (2 chains, 20 warmup steps, 8
  draws, ``max_depth`` 4) writes a trace whose every posterior array JAX's
  ``constrain`` + ``compute_deterministics`` reproduce from its draws; its
  coords and attrs are those the JAX stage writes, its sample-stat keys those
  JAX's ``fit`` returns.
* ``group_events`` and the config sections' defaults (paths, ingest, fit,
  mock) equal JAX's.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bumpcosmology_tpu.inference import sampler as jsampler
from bumpcosmology_tpu.inference.model import ModelSpec as JModelSpec
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import prior_sample as jprior
from bumpcosmology_tpu.inference.nuts import NutsConfig as JNutsConfig
from bumpcosmology_torch.inference.distributions import Normal
from bumpcosmology_torch.inference.likelihoods import POP_COSMO_PRIORS
from bumpcosmology_torch.inference.model import ModelSpec, make_potential, unconstrain
from bumpcosmology_torch.inference.nuts import NutsConfig
from bumpcosmology_torch.inference.sampler import _finite_prior_init, compute_deterministics, fit
from bumpcosmology_torch.pipeline import config, stages
from bumpcosmology_torch.testing import synthetic_source_tables
from bumpcosmology_torch.utils.io import read_table, write_table
from bumpcosmology_torch.utils.trace import load_trace

N_GRID, N_Z = 48, 1024


def _assert_sites(got, ref, what=""):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, (what, k)
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-5, err_msg=f"{what} {k}")


def _fit_config(module, data_dir):
    return module.PipelineConfig(paths=module.PathsConfig(data_dir=str(data_dir)),
                                 fit=module.FitConfig(num_warmup=20, num_samples=8, num_chains=2, max_depth=4,
                                                      n_grid=N_GRID, n_z=N_Z))


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """Both packages' ``run_pop_cosmo_fit`` on the same source-frame tables.

    The port's stage runs for real, its ``fit`` wrapped to keep the spec and
    the deterministics it is given.  The JAX stage's ``fit`` is replaced by
    one that keeps the JAX spec and deterministics and hands back the port's
    result, so the JAX stage writes the port's draws with its own writer."""
    from bumpcosmology_tpu.pipeline import config as jconfig
    from bumpcosmology_tpu.pipeline import stages as jstages
    from bumpcosmology_tpu.utils.trace import load_trace as jload_trace
    from bumpcosmology_torch.inference import sampler

    tmp = tmp_path_factory.mktemp("stage")
    pe, sel = synthetic_source_tables()
    # the port's stage reads its tables from the data directory when none are given
    cfg = _fit_config(config, tmp / "port")
    write_table(cfg.paths.path("pe-samples.npz"), pe)
    write_table(cfg.paths.path("selection-samples.npz"), sel)
    port, jax_seen = {}, {}
    real_fit = sampler.fit

    def kept_fit(spec, seed, deterministics_fn=None, **kw):
        port.update(spec=spec, det_fn=deterministics_fn)
        return real_fit(spec, seed, deterministics_fn=deterministics_fn, **kw)

    def stub_fit(spec, key, deterministics_fn=None, **kw):
        jax_seen.update(spec=spec, det_fn=deterministics_fn, kw=kw)
        return jsampler.FitResult(port["res"].posterior, port["res"].sample_stats, None, None, {})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sampler, "fit", kept_fit)
        mp.setattr(jsampler, "fit", stub_fit)
        port["res"] = stages.run_pop_cosmo_fit(cfg, device="cpu")
        jstages.run_pop_cosmo_fit(_fit_config(jconfig, tmp / "jax"), pd.DataFrame(pe), pd.DataFrame(sel),
                                  trace_out=str(tmp / "ref.h5"))
    return dict(port=port, jax=jax_seen, trace=load_trace(tmp / "port" / "trace_cosmo.npz"),
                ref=jload_trace(str(tmp / "ref.h5")))


def test_compute_deterministics_matches_jax(stage):
    """On prior draws (a wider range than the posterior's), in chunks of 5 draws (the last one short)."""
    js, port = stage["jax"]["spec"], stage["port"]
    theta = np.asarray(jprior(js, jax.random.PRNGKey(3), (16,))).reshape(2, 8, 15)
    got = compute_deterministics(port["spec"], torch.as_tensor(theta.copy()), port["det_fn"], batch_size=5)
    ref = jsampler.compute_deterministics(js, jnp.asarray(theta), stage["jax"]["det_fn"])
    _assert_sites(got, ref)
    assert got["neff"].shape == (2, 8, 8) and got["hz"].shape == (2, 8, 128)


def test_finite_prior_init_redraws_only_the_non_finite_chains():
    spec = ModelSpec(priors={"x": Normal(0.0, 1.0)},
                     loglike=lambda s: torch.where(s["x"] > 0.0, -torch.inf, 0.0))
    pot = make_potential(spec)
    first = torch.Generator().manual_seed(0)
    draw0 = torch.stack([Normal(0.0, 1.0).sample(first, (16,), "cpu")], dim=-1)
    theta = _finite_prior_init(spec, pot, torch.Generator().manual_seed(0), num_chains=16)
    assert torch.isfinite(pot(theta)).all() and (theta[:, 0] <= 0.0).all()
    kept = draw0[:, 0] <= 0.0
    assert 0 < int(kept.sum()) < 16
    assert torch.equal(theta[kept], draw0[kept])  # finite chains keep their first draw
    assert not torch.equal(theta[~kept], draw0[~kept])
    never = ModelSpec(priors={"x": Normal(0.0, 1.0)}, loglike=lambda s: torch.full_like(s["x"], -torch.inf))
    with pytest.raises(RuntimeError, match="after 3 prior redraws"):
        _finite_prior_init(never, make_potential(never), torch.Generator().manual_seed(0), 4, max_tries=3)


def _gauss_spec():
    priors = {"x": Normal(0.0, 1.0), "y": Normal(1.0, 2.0)}
    return ModelSpec(priors=priors, loglike=lambda s: -0.5 * ((s["x"] - 0.5) / 0.3) ** 2)


def test_fit_resumes_from_a_warmup_checkpoint_without_adapting(tmp_path, capsys):
    spec = _gauss_spec()
    ckpt = tmp_path / "warm"
    first = fit(spec, 1, num_warmup=30, num_samples=4, num_chains=3, cfg=NutsConfig(max_depth=4),
                checkpoint_path=str(ckpt), device="cpu")
    assert "warmup_s" in first.timings and (tmp_path / "warm.npz").exists()
    capsys.readouterr()
    again = fit(spec, 2, num_warmup=30, num_samples=4, num_chains=3, cfg=NutsConfig(max_depth=4),
                checkpoint_path=str(ckpt), device="cpu")
    out = capsys.readouterr().out
    assert "resuming from warmup checkpoint" in out and "[fit] warmup:" not in out
    assert "warmup_s" not in again.timings
    for a, b in zip((*first.warmup_state.state, *first.warmup_state[1:]),
                    (*again.warmup_state.state, *again.warmup_state[1:])):
        assert torch.equal(a, b)
    assert again.posterior["x"].shape == (3, 4) and set(again.sample_stats) == set(first.sample_stats)


def test_fit_rejects_what_is_not_ported():
    """An unknown mass family raises ValueError with the JAX package's message
    in both stages, before any table is read; so does an unknown sampler."""
    cfg = config.PipelineConfig(fit=config.FitConfig(mass_family="gaussian"))
    # the JAX package's message, naming the port's families: its three and POWER LAW + SPLINE
    msg = "unknown mass_family 'gaussian' \\(expected one of \\['brokenpl', 'bump', 'plpeak', 'pspline'\\]\\)"
    for stage in (stages.run_pop_fit, stages.run_pop_cosmo_fit):
        with pytest.raises(ValueError, match=msg):
            stage(cfg, {}, {}, device="cpu")
    with pytest.raises(ValueError, match="unknown sampler 'hmc'; use 'nuts', 'chees', or 'nuts\\+chees'"):
        fit(_gauss_spec(), 0, sampler="hmc", device="cpu")


def test_sample_stat_keys_equal_those_of_jax_fit():
    """The keys of JAX's own ``fit`` on a one-site model (2 warmup steps, 2 draws)."""
    from bumpcosmology_tpu.inference.distributions import Normal as JNormal

    js = JModelSpec(priors={"x": JNormal(0.0, 1.0)}, loglike=lambda s: 0.0 * s["x"])
    ref = jsampler.fit(js, jax.random.PRNGKey(0), num_warmup=2, num_samples=2, num_chains=2,
                       cfg=JNutsConfig(max_depth=2), verbose=False)
    spec = ModelSpec(priors={"x": Normal(0.0, 1.0)}, loglike=lambda s: 0.0 * s["x"])
    got = fit(spec, 0, num_warmup=2, num_samples=2, num_chains=2, cfg=NutsConfig(max_depth=2), verbose=False,
              device="cpu")
    assert list(got.sample_stats) == list(ref.sample_stats)
    for k, v in ref.sample_stats.items():
        assert got.sample_stats[k].shape == np.shape(v), k


# ---------------------------------------------------------------- the stage


def test_run_pop_cosmo_fit_writes_what_the_jax_stage_writes(stage):
    res, trace, ref = stage["port"]["res"], stage["trace"], stage["ref"]
    for k, v in res.posterior.items():
        np.testing.assert_array_equal(trace.posterior[k], v)
    assert trace.posterior["h"].shape == (2, 8) and trace.posterior["neff"].shape == (2, 8, 8)
    assert all(np.isfinite(v).all() for v in trace.posterior.values())
    assert trace.attrs == ref.attrs == {"model": "pop_cosmo", "family": "bump"}
    assert sorted(trace.coords) == sorted(ref.coords)  # the HDF5 store lists its keys sorted
    for k in ref.coords:
        np.testing.assert_array_equal(trace.coords[k], ref.coords[k])
    assert sorted(trace.sample_stats) == sorted(ref.sample_stats)
    assert {k: stage["jax"]["kw"][k] for k in ("num_warmup", "num_samples", "num_chains")} == {
        "num_warmup": 20, "num_samples": 8, "num_chains": 2}

    # every posterior array again, from the draws, through JAX's constrain + compute_deterministics
    js = stage["jax"]["spec"]
    theta = unconstrain(stage["port"]["spec"], {k: torch.as_tensor(trace.posterior[k]) for k in POP_COSMO_PRIORS})
    theta = jnp.asarray(theta.numpy())
    again = {k: np.asarray(v) for k, v in jconstrain(js, theta).items()}
    again.update(jsampler.compute_deterministics(js, theta, stage["jax"]["det_fn"]))
    _assert_sites(trace.posterior, again, "trace")


def test_group_events_matches_jax():
    from bumpcosmology_tpu.pipeline.stages import group_events as jgroup

    pe, _ = synthetic_source_tables(nobs=5, nsamp=6, seed=3)
    order = np.random.default_rng(4).permutation(30)  # rows of the events interleaved
    pe = {k: v[order] for k, v in pe.items()}
    events, arrays = stages.group_events(pe, cols=("m1", "q", "wt"))
    jevents, jarrays = jgroup(pd.DataFrame(pe), cols=("m1", "q", "wt"))
    assert list(events) == list(jevents)
    for a, b in zip(arrays, jarrays):
        np.testing.assert_array_equal(a, b)


def test_table_round_trip(tmp_path):
    pe, _ = synthetic_source_tables(nobs=2, nsamp=3)
    write_table(tmp_path / "t.npz", pe, key="pe")
    back = read_table(tmp_path / "t.npz", key="pe")
    assert list(back) == list(pe)
    for k in pe:
        np.testing.assert_array_equal(back[k], pe[k])


@pytest.mark.parametrize("name", ["PathsConfig", "IngestConfig", "FitConfig", "MockConfig"])
def test_config_defaults_equal_jax(name):
    from bumpcosmology_tpu.pipeline import config as jconfig

    got, ref = getattr(config, name)(), getattr(jconfig, name)()
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert isinstance(config.PipelineConfig().fit, config.FitConfig)
    assert pathlib.Path(config.PathsConfig(data_dir="x").data_dir) == pathlib.Path("x")
