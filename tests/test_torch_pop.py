"""The port's population-only fit against the JAX package's, and the public
``ops`` helpers that came with it.

* ``planck18_log_dvdz_grid`` equals JAX's at rtol 1e-12 (both float64 numpy),
  with the same ``-inf`` at z = 0; ``make_pop_data``'s tensors equal JAX's
  ``PopData`` field by field (the clamped z = 0 knot included).
* ``pop_loglike`` at prior draws: rtol 2e-5 (``tests/test_model_compare.py:93``).
  The potential's value and gradient: |ΔU|/(1+|U|) < 2e-4 and
  |Δgrad|/(1+|grad|) < 5e-3, the joint potential's limits
  (``tests/test_torch_potential.py``).
* ``compute_deterministics`` with ``pop_deterministics``: site by site at
  rtol 1e-4 / atol 1e-5, as ``tests/test_torch_fit.py`` holds the joint one.
* ``run_pop_fit`` on ``device="cpu"`` (2 chains, 20 warmup steps, 8 draws,
  ``max_depth`` 4) writes a trace whose every posterior array JAX's
  ``constrain`` + ``compute_deterministics`` reproduce from its draws, with
  the attrs, coords and sample-stat keys of the JAX stage's trace.
* ``logmeanexp``, ``log_neff``, ``neff``, ``log_cumtrapz`` (columns with
  ``-inf`` and one all ``-inf``) and ``inverse_interp``: rtol 1e-6 / atol 1e-6.

Data: 8 events x 32 samples and 128 injections, ``n_grid`` 48.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from bumpcosmology_tpu.inference import sampler as jsampler
from bumpcosmology_tpu.inference.likelihoods import pop_loglike as jpop_loglike
from bumpcosmology_tpu.inference.likelihoods import pop_model_spec as jpop_spec
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import make_potential as jpotential
from bumpcosmology_tpu.inference.model import prior_sample as jprior
from bumpcosmology_tpu.testing import synthetic_pop_data as jsynthetic
from bumpcosmology_torch import ops
from bumpcosmology_torch.inference.likelihoods import POP_PRIORS, pop_deterministics, pop_loglike, pop_model_spec
from bumpcosmology_torch.inference.model import constrain, make_potential, unconstrain, value_and_grad
from bumpcosmology_torch.inference.sampler import compute_deterministics
from bumpcosmology_torch.models.cosmology import planck18_log_dvdz_grid
from bumpcosmology_torch.ops.interp import interp
from bumpcosmology_torch.pipeline import config, stages
from bumpcosmology_torch.testing import synthetic_pop_data, synthetic_source_tables
from bumpcosmology_torch.utils.io import write_table
from bumpcosmology_torch.utils.trace import load_trace

N_GRID = 48
SHAPE = dict(nobs=8, nsamp=32, nsel=128, seed=0)


@pytest.fixture(scope="module")
def pair():
    jd, td = jsynthetic(**SHAPE), synthetic_pop_data(**SHAPE, device="cpu")
    return jd, td, jpop_spec(jd, n_grid=N_GRID), pop_model_spec(td, n_grid=N_GRID, device="cpu")


def _assert_sites(got, ref, what=""):
    assert set(got) == set(ref), (what, set(got) ^ set(ref))
    for k in ref:
        r = np.asarray(ref[k])
        assert got[k].shape == r.shape, (what, k)
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-5, err_msg=f"{what} {k}")


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("zmax, n", [(100.0, 1024), (10.0, 257)])
def test_planck18_log_dvdz_grid_matches_jax(zmax, n):
    from bumpcosmology_tpu.models.cosmology import planck18_log_dvdz_grid as jgrid

    z, log_dv = planck18_log_dvdz_grid(zmax, n)
    jz, jlog_dv = jgrid(zmax, n)
    assert z.dtype == log_dv.dtype == np.float64 and z.shape == log_dv.shape == (n,)
    np.testing.assert_allclose(z, jz, rtol=1e-12, atol=0)
    assert np.array_equal(np.isneginf(log_dv), np.isneginf(jlog_dv)) and np.isneginf(log_dv).sum() == 1
    fin = np.isfinite(jlog_dv)
    np.testing.assert_allclose(log_dv[fin], jlog_dv[fin], rtol=1e-12, atol=0)


def test_make_pop_data_matches_jax(pair):
    jd, td, _, _ = pair
    for group in ("events", "selection"):
        for name, got in getattr(td, group)._asdict().items():
            ref = np.asarray(getattr(getattr(jd, group), name))
            assert got.dtype == torch.float32 and got.shape == ref.shape, (group, name)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-7, atol=0, err_msg=f"{group} {name}")
    np.testing.assert_array_equal(td.planck.log_dv.numpy(), np.asarray(jd.planck.log_dv))
    assert np.isfinite(td.planck.log_dv.numpy()).all()  # the z = 0 knot clamped, as JAX's
    assert td.planck.u0 == float(jd.planck.u0) and td.planck.du == float(jd.planck.du)
    moved = td.to("cpu")
    assert torch.equal(moved.planck.log_dv, td.planck.log_dv) and torch.equal(moved.events.a, td.events.a)


# ---------------------------------------------------------------- likelihood and potential


@pytest.fixture(scope="module")
def jax_at_prior_draws(pair):
    """JAX's log-likelihood, potential and gradient at 6 prior draws, from one compiled program."""
    jd, _, js, _ = pair
    theta = jprior(js, jax.random.PRNGKey(4), (6,))
    pot = jpotential(js)
    one = lambda th: (jpop_loglike(jconstrain(js, th), jd, N_GRID), *jax.value_and_grad(pot)(th))  # noqa: E731
    return np.array(theta), *(np.asarray(x) for x in jax.jit(jax.vmap(one))(theta))


def test_pop_loglike_matches_jax(pair, jax_at_prior_draws):
    _, td, _, spec = pair
    theta, ref = jax_at_prior_draws[:2]
    got = pop_loglike(constrain(spec, torch.as_tensor(theta)), td, N_GRID)
    assert got.shape == (6,) and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5)


def test_pop_potential_value_and_grad_match_jax(pair, jax_at_prior_draws):
    theta, _, ju, jg = jax_at_prior_draws
    u, g = value_and_grad(make_potential(pair[3]), torch.as_tensor(theta))
    assert np.isfinite(ju).all() and np.isfinite(jg).all() and g.shape == (6, 12)
    assert np.all(np.abs(u.numpy() - ju) / (1.0 + np.abs(ju)) < 2e-4)
    assert np.all(np.abs(g.numpy() - jg) / (1.0 + np.abs(jg)) < 5e-3)


def test_pop_model_spec_sites_equal_jax(pair):
    _, _, js, spec = pair
    assert list(spec.priors) == list(js.priors) == list(POP_PRIORS) and spec.dim == 12


# ---------------------------------------------------------------- the stage


def _fit_config(module, data_dir):
    return module.PipelineConfig(paths=module.PathsConfig(data_dir=str(data_dir)),
                                 fit=module.FitConfig(num_warmup=20, num_samples=8, num_chains=2, max_depth=4,
                                                      n_grid=N_GRID))


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """Both packages' ``run_pop_fit`` on the same source-frame tables: the
    port's for real (its ``fit`` wrapped to keep the spec and deterministics),
    the JAX stage with a ``fit`` that keeps its spec and deterministics and
    hands back the port's result, so the JAX stage writes the port's draws."""
    from bumpcosmology_tpu.pipeline import config as jconfig
    from bumpcosmology_tpu.pipeline import stages as jstages
    from bumpcosmology_tpu.utils.trace import load_trace as jload_trace
    from bumpcosmology_torch.inference import sampler

    tmp = tmp_path_factory.mktemp("pop_stage")
    pe, sel = synthetic_source_tables()
    cfg = _fit_config(config, tmp / "port")
    write_table(cfg.paths.path("pe-samples.npz"), pe)
    write_table(cfg.paths.path("selection-samples.npz"), sel)
    port, jax_seen = {}, {}
    real_fit = sampler.fit

    def kept_fit(spec, seed, deterministics_fn=None, **kw):
        port.update(spec=spec, det_fn=deterministics_fn, seed=seed, kw=kw)
        return real_fit(spec, seed, deterministics_fn=deterministics_fn, **kw)

    def stub_fit(spec, key, deterministics_fn=None, **kw):
        jax_seen.update(spec=spec, det_fn=deterministics_fn, kw=kw)
        return jsampler.FitResult(port["res"].posterior, port["res"].sample_stats, None, None, {})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sampler, "fit", kept_fit)
        mp.setattr(jsampler, "fit", stub_fit)
        port["res"] = stages.run_pop_fit(cfg, device="cpu")
        jstages.run_pop_fit(_fit_config(jconfig, tmp / "jax"), pd.DataFrame(pe), pd.DataFrame(sel),
                            trace_out=str(tmp / "ref.h5"))
    return dict(port=port, jax=jax_seen, trace=load_trace(tmp / "port" / "trace.npz"),
                ref=jload_trace(str(tmp / "ref.h5")))


@pytest.fixture(scope="module")
def jax_deterministics(stage):
    """JAX's ``constrain`` + ``compute_deterministics`` (the JAX stage's spec
    and deterministics) on the stage's 2 x 8 draws, then on 2 x 8 prior draws:
    one compiled program for the two tests that use it."""
    js = stage["jax"]["spec"]
    trace = stage["trace"]
    drawn = unconstrain(stage["port"]["spec"], {k: torch.as_tensor(trace.posterior[k]) for k in POP_PRIORS}).numpy()
    prior = np.array(jprior(js, jax.random.PRNGKey(3), (16,))).reshape(2, 8, 12)
    theta = jnp.asarray(np.concatenate([drawn, prior]))
    out = {k: np.asarray(v) for k, v in jconstrain(js, theta).items()}
    out.update(jsampler.compute_deterministics(js, theta, stage["jax"]["det_fn"]))
    return prior, {k: v[:2] for k, v in out.items()}, {k: v[2:] for k, v in out.items()}


def test_pop_deterministics_match_jax(stage, jax_deterministics):
    """On prior draws (a wider range than the posterior's), in chunks of 5 draws (the last one short)."""
    prior, _, ref = jax_deterministics
    got = compute_deterministics(stage["port"]["spec"], torch.as_tensor(prior), stage["port"]["det_fn"],
                                 batch_size=5)
    _assert_sites(got, {k: ref[k] for k in got})
    assert set(ref) == set(got) | set(POP_PRIORS)
    assert got["neff"].shape == (2, 8, 8) and got["mdNdmdVdt_fixed_qz"].shape == (2, 8, 128)


def test_run_pop_fit_writes_what_the_jax_stage_writes(stage, jax_deterministics):
    res, trace, ref = stage["port"]["res"], stage["trace"], stage["ref"]
    for k, v in res.posterior.items():
        np.testing.assert_array_equal(trace.posterior[k], v)
    assert trace.posterior["a"].shape == (2, 8) and trace.posterior["neff"].shape == (2, 8, 8)
    assert all(np.isfinite(v).all() for v in trace.posterior.values())
    assert trace.attrs == ref.attrs == {"model": "pop", "family": "bump"}
    assert sorted(trace.coords) == sorted(ref.coords)  # the HDF5 store lists its keys sorted
    for k in ref.coords:
        np.testing.assert_array_equal(trace.coords[k], ref.coords[k])
    assert sorted(trace.sample_stats) == sorted(ref.sample_stats) == sorted(
        ["accept_prob", "diverging", "tree_depth", "n_leapfrog", "potential_energy", "step_size"])
    seen = {k: stage["jax"]["kw"][k] for k in ("num_warmup", "num_samples", "num_chains", "sampler")}
    assert seen == {k: stage["port"]["kw"][k] for k in seen} == {
        "num_warmup": 20, "num_samples": 8, "num_chains": 2, "sampler": "nuts"}
    assert stage["port"]["seed"] == config.FitConfig().seed

    # every posterior array again, from the draws, through JAX's constrain + compute_deterministics
    _assert_sites(trace.posterior, jax_deterministics[1], "trace")


# ---------------------------------------------------------------- ops helpers

jlse = importlib.import_module("bumpcosmology_tpu.ops.logsumexp")
jint = importlib.import_module("bumpcosmology_tpu.ops.integrate")
jinterp = importlib.import_module("bumpcosmology_tpu.ops.interp")


def _weights():
    rng = np.random.default_rng(7)
    x = rng.normal(scale=3.0, size=(5, 40)).astype(np.float32)
    x[1, ::3] = -np.inf
    x[3] = -np.inf  # a row that is all -inf
    return x


@pytest.mark.parametrize("name", ["logmeanexp", "log_neff", "neff"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_log_domain_reductions_match_jax(name, axis):
    """Through the package's exports (``ops.logsumexp`` stays the module)."""
    x = _weights()
    if axis is None:
        x = x[[0, 1, 2, 4]]  # over every element: leave the all -inf row out
    ref = np.asarray(getattr(jlse, name)(jnp.asarray(x), axis=axis))
    got = getattr(ops, name)(torch.as_tensor(x), axis=axis).numpy()
    if name == "logmeanexp":  # the module's logsumexp, with JAX's axis=None convention
        ref_lse = np.asarray(jlse.logsumexp(jnp.asarray(x), axis=axis))
        got_lse = ops.logsumexp.logsumexp(torch.as_tensor(x), axis=axis).numpy()
        assert np.array_equal(np.isneginf(got_lse), np.isneginf(ref_lse))
        np.testing.assert_allclose(got_lse[np.isfinite(ref_lse)], ref_lse[np.isfinite(ref_lse)], rtol=1e-6, atol=1e-6)
    assert got.shape == ref.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(ref)) and np.array_equal(np.isnan(got), np.isnan(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("axis", [0, 1])
def test_log_cumtrapz_matches_jax(axis):
    rng = np.random.default_rng(8)
    log_ys = _weights() if axis == 1 else _weights().T.copy()
    xs = np.sort(rng.uniform(0.0, 4.0, size=log_ys.shape), axis=axis).astype(np.float32)
    ref = np.asarray(jint.log_cumtrapz(jnp.asarray(log_ys), jnp.asarray(xs), axis=axis))
    got = ops.log_cumtrapz(torch.as_tensor(log_ys), torch.as_tensor(xs), axis=axis).numpy()
    first = np.take(got, 0, axis=axis)
    assert np.isneginf(first).all() and np.isneginf(np.take(got, 3, axis=1 - axis)).all()
    assert np.array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-6, atol=1e-6)
    if axis == 1:  # a grid shared by the batch (broadcast along the leading axis, as JAX does)
        ref1 = np.asarray(jint.log_cumtrapz(jnp.asarray(log_ys), jnp.asarray(xs[0]), axis=1))
        got1 = ops.log_cumtrapz(torch.as_tensor(log_ys), torch.as_tensor(xs[0]), axis=1).numpy()
        assert np.array_equal(np.isneginf(got1), np.isneginf(ref1))
        fin = np.isfinite(ref1)
        np.testing.assert_allclose(got1[fin], ref1[fin], rtol=1e-6, atol=1e-6)


def test_inverse_interp_matches_jax():
    rng = np.random.default_rng(9)
    xp = np.sort(rng.uniform(0.0, 3.0, 64)).astype(np.float32)
    fp = np.cumsum(rng.uniform(0.1, 1.0, 64)).astype(np.float32)  # strictly increasing
    y = rng.uniform(fp[0] - 1.0, fp[-1] + 1.0, 200).astype(np.float32)  # both ends clamped
    ref = np.asarray(jinterp.inverse_interp(jnp.asarray(y), jnp.asarray(xp), jnp.asarray(fp)))
    got = ops.inverse_interp(torch.as_tensor(y), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # and back through the forward lookup, to float32 round-trip accuracy
    back = interp(torch.as_tensor(got), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    inside = (y > fp[0]) & (y < fp[-1])
    np.testing.assert_allclose(back[inside], y[inside], rtol=1e-4)
