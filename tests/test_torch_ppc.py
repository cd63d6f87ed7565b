"""Posterior predictive checks (``inference/ppc.py``).

* The device part, ``_logwts_matrix``, on 6 prior draws in batches of 4 (a
  tail of 2):
  - the population-only bump against the JAX package's ``_logwts_matrix``
    at kernel B's value limits (rtol 2e-5, atol 2e-5; the same -inf rows);
  - the joint bump against the JAX package's fused route on the same dL
    bounds (the data's own, margin 0.05) at the same limits;
  - **the route difference:** the JAX package's PPC passes no ``dl_bounds``
    and takes the non-fused route (the cosmology table inverted at each dL),
    the port's bump takes kernel B's fused route on the data's bounds.  At
    ``n_z`` 1024 the two differ by the tables' interpolation alone: held at
    atol 2e-4 + rtol 2e-5 (the largest gap on these draws is 4.1e-5 nats at
    ``n_z`` 1024, and 1.1e-2 at 64, where the route is not held).
* The host part fed the JAX package's own weights (recorded from its run)
  gives a ``PpcResult`` equal to the JAX package's array for array: the same
  ``default_rng(seed)`` draws in the same order.
"""
import jax
import numpy as np
import pytest

from bumpcosmology_tpu.inference import likelihoods as jlk
from bumpcosmology_tpu.inference import ppc as jppc
from bumpcosmology_tpu.inference.model import ModelSpec as JModelSpec
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import prior_sample as jprior_sample
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as j_synthetic_pop_cosmo_data
from bumpcosmology_tpu.testing import synthetic_pop_data as j_synthetic_pop_data
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import ppc

N_GRID = 48
NOBS, NSAMP, NSEL = 5, 16, 64
S, BATCH = 6, 4


def _flat_sites(priors, seed):
    spec = JModelSpec(priors=priors, loglike=None)
    theta = jax.vmap(lambda k: jprior_sample(spec, k))(jax.random.split(jax.random.PRNGKey(seed), S))
    return {k: np.asarray(v) for k, v in jax.vmap(lambda t: jconstrain(spec, t))(theta).items()}


def _hold(got, ref, rtol, atol):
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(r))
        fin = np.isfinite(r)
        assert np.isfinite(g[fin]).all()
        np.testing.assert_allclose(g[fin], r[fin], rtol=rtol, atol=atol)


def test_pop_logwts_matrix_matches_jax():
    jd = j_synthetic_pop_data(NOBS, NSAMP, NSEL, seed=5)
    flat = _flat_sites(jlk.POP_PRIORS, seed=1)
    ref = jppc._logwts_matrix(flat, jd, N_GRID, 64, None, BATCH)
    got = ppc._logwts_matrix(flat, convert.pop_data(jd, "cpu"), N_GRID, 64, None, BATCH, device="cpu")
    assert got[0].shape == (S, NOBS, NSAMP) and got[1].shape == (S, NSEL)
    _hold(got, ref, 2e-5, 2e-5)


@pytest.mark.parametrize("n_z", [64, 1024])
def test_joint_logwts_matrix_matches_jax_fused_route_on_the_same_bounds(n_z):
    jd = j_synthetic_pop_cosmo_data(NOBS, NSAMP, NSEL, seed=6)
    flat = _flat_sites(jlk.POP_COSMO_PRIORS, seed=2)
    bounds = jlk.dl_bounds_of(jd)

    def one(s):
        _, _, lw, lsw = jlk._pop_cosmo_event_sel_logwts(s, jd, N_GRID, n_z, bounds)
        return lw, lsw

    ref = [np.asarray(x) for x in jax.jit(jax.vmap(one))(flat)]
    got = ppc._logwts_matrix(flat, convert.pop_cosmo_data(jd, "cpu"), N_GRID, n_z, None, BATCH, device="cpu")
    _hold(got, ref, 2e-5, 2e-5)


def test_joint_logwts_matrix_against_jax_non_fused_route_at_n_z_1024():
    """The route difference: the JAX package's PPC weights (non-fused) against the port's (kernel B, fused)."""
    jd = j_synthetic_pop_cosmo_data(NOBS, NSAMP, NSEL, seed=6)
    flat = _flat_sites(jlk.POP_COSMO_PRIORS, seed=2)
    ref = jppc._logwts_matrix(flat, jd, N_GRID, 1024, None, BATCH)
    got = ppc._logwts_matrix(flat, convert.pop_cosmo_data(jd, "cpu"), N_GRID, 1024, None, BATCH, device="cpu")
    _hold(got, ref, 2e-5, 2e-4)


@pytest.mark.parametrize("model", ["pop", "pop_cosmo"])
def test_host_part_on_jax_weights_equals_jax(monkeypatch, model):
    joint = model == "pop_cosmo"
    jd = (j_synthetic_pop_cosmo_data if joint else j_synthetic_pop_data)(NOBS, NSAMP, NSEL, seed=7)
    priors = jlk.POP_COSMO_PRIORS if joint else jlk.POP_PRIORS
    flat = _flat_sites(priors, seed=3)
    posterior = {k: v.reshape(2, 3) for k, v in flat.items()}
    seen, real = {}, jppc._logwts_matrix

    def recorded(*args):
        seen["w"] = real(*args)
        return seen["w"]

    monkeypatch.setattr(jppc, "_logwts_matrix", recorded)
    ref = jppc.posterior_predictive_check(posterior, list(priors), jd, n_grid=N_GRID, n_z=64, n_draws=5, seed=4,
                                          batch=BATCH, model=model, cdf_grid_size=32)
    cols = lambda part: {c: np.asarray(getattr(part, c)) for c in ("a", "q", "c")}  # noqa: E731
    got = ppc._check_from_logwts(*seen["w"], cols(jd.events), cols(jd.selection), 5, 4, model, 32)
    assert got.n_draws == ref.n_draws == 5
    assert got.labels == ref.labels == ppc.OBSERVABLE_LABELS[model]
    assert got.p_values == ref.p_values
    for field in ("ks_obs", "ks_rep", "grid", "pred_cdf_q", "obs_cdf_q"):
        for col in ("a", "q", "c"):
            np.testing.assert_array_equal(getattr(got, field)[col], getattr(ref, field)[col])
    assert all(0.0 <= p <= 1.0 for p in got.p_values.values())


def test_posterior_predictive_check_runs_end_to_end_on_the_cpu():
    jd = j_synthetic_pop_data(NOBS, NSAMP, NSEL, seed=8)
    flat = _flat_sites(jlk.POP_PRIORS, seed=4)
    res = ppc.posterior_predictive_check({k: v.reshape(2, 3) for k, v in flat.items()}, list(jlk.POP_PRIORS),
                                         convert.pop_data(jd, "cpu"), n_grid=N_GRID, batch=BATCH, device="cpu")
    assert res.n_draws == S and sorted(res.p_values) == ["a", "c", "q"]
    assert all(res.ks_obs[c].shape == (S,) and res.pred_cdf_q[c].shape == (3, 128) for c in "aqc")
