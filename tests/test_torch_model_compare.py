"""Predictive model comparison (``inference/model_compare.py``).

* The pointwise log-likelihoods of the bump and of POWER-LAW+PEAK, in the
  population-only and the joint model, against the JAX package's (``vmap``
  of its one-draw functions) on the same catalogs and draws, at the JAX
  test's own rtol 2e-5 (``tests/test_model_compare.py:93``) with atol 2e-5
  for entries near zero.  The joint model takes the fused route in both
  packages (the stage's ``dl_bounds``); the port's bump runs kernel B's
  ``lse`` epilogue through its plain twin on the CPU.
* Each pointwise row sums to the port's own log-likelihood (rtol 2e-5).
* ``pointwise_matrix`` thins and batches as the JAX package's (a tail batch
  evaluated at its own size here, padded there): equal matrices at the same
  rtol, and a cheap synthetic function to the JAX test's rtol 1e-6.
* ``fit_gpd``, ``psis_smooth_logratios``, ``psis_loo``, ``waic`` and
  ``compare`` on the same float64 matrices equal to the JAX package's at
  rtol 1e-12 (the same numpy code).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import likelihoods as jlk
from bumpcosmology_tpu.inference import model_compare as jmc
from bumpcosmology_tpu.inference.model import ModelSpec as JModelSpec
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import prior_sample as jprior_sample
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as j_synthetic_pop_cosmo_data
from bumpcosmology_tpu.testing import synthetic_pop_data as j_synthetic_pop_data
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import likelihoods as lk
from bumpcosmology_torch.inference import model_compare as mc

N_GRID, N_Z = 48, 64
NOBS, NSAMP, NSEL = 5, 16, 64
C = 4
RTOL, ATOL = 2e-5, 2e-5


def _sites(priors, seed):
    """C prior draws, constrained, as the JAX package's and the port's site dicts."""
    spec = JModelSpec(priors=priors, loglike=None)
    theta = jax.vmap(lambda k: jprior_sample(spec, k))(jax.random.split(jax.random.PRNGKey(seed), C))
    jsites = jax.vmap(lambda t: jconstrain(spec, t))(theta)
    return jsites, {k: convert.tensor(v, "cpu") for k, v in jsites.items()}


@pytest.fixture(scope="module")
def pop_case():
    jd = j_synthetic_pop_data(NOBS, NSAMP, NSEL, seed=3)
    return jd, convert.pop_data(jd, "cpu")


@pytest.fixture(scope="module")
def cosmo_case():
    jd = j_synthetic_pop_cosmo_data(NOBS, NSAMP, NSEL, seed=4)
    td = convert.pop_cosmo_data(jd, "cpu")
    return jd, td, jlk.dl_bounds_of(jd, margin=0.1)


@pytest.mark.parametrize("family", ["bump", "plpeak"])
def test_pop_pointwise_matches_jax_and_sums_to_the_loglike(pop_case, family):
    jd, td = pop_case
    jbuild, build = jlk.MASS_FAMILIES[family].build, lk.MASS_FAMILIES[family].build
    jsites, sites = _sites(jlk.MASS_FAMILIES[family].pop_priors, seed=11)
    ref = np.asarray(jax.jit(jax.vmap(lambda s: jmc.pop_pointwise_loglike(s, jd, N_GRID, build=jbuild)))(jsites))
    got = mc.pop_pointwise_loglike(sites, td, N_GRID, build=build)
    assert got.shape == (C, NOBS) and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    total = lk.pop_loglike(sites, td, N_GRID, build=build)
    np.testing.assert_allclose(got.sum(-1).numpy(), total.numpy(), rtol=RTOL)


@pytest.mark.parametrize("family", ["bump", "plpeak"])
def test_pop_cosmo_pointwise_matches_jax_and_sums_to_the_loglike(cosmo_case, family):
    jd, td, bounds = cosmo_case
    jbuild, build = jlk.MASS_FAMILIES[family].build, lk.MASS_FAMILIES[family].build
    jsites, sites = _sites(jlk.MASS_FAMILIES[family].cosmo_priors, seed=12)
    ref = np.asarray(jax.jit(jax.vmap(lambda s: jmc.pop_cosmo_pointwise_loglike(
        s, jd, N_GRID, N_Z, bounds, build=jbuild)))(jsites))
    got = mc.pop_cosmo_pointwise_loglike(sites, td, N_GRID, N_Z, bounds, build=build)
    assert got.shape == (C, NOBS) and np.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    total = lk.pop_cosmo_loglike(sites, td, N_GRID, N_Z, bounds, build=build)
    np.testing.assert_allclose(got.sum(-1).numpy(), total.numpy(), rtol=RTOL)


def test_pointwise_matrix_with_a_tail_batch_matches_jax(pop_case):
    """14 draws thinned to 11, in batches of 4: two full batches and a tail of 3."""
    jd, td = pop_case
    jsites, _ = _sites(jlk.POP_PRIORS, seed=13)
    rng = np.random.default_rng(0)
    # a (2, 7) trace: the four prior draws, jittered
    post = {k: (np.resize(np.asarray(v, np.float64), 14) * (1 + 1e-3 * rng.standard_normal(14))).reshape(2, 7)
            for k, v in jsites.items()}
    names = list(jlk.POP_PRIORS)
    ref = jmc.pointwise_matrix(lambda s: jmc.pop_pointwise_loglike(s, jd, N_GRID), post, names, max_draws=11,
                               batch=4)
    got = mc.pointwise_matrix(lambda s: mc.pop_pointwise_loglike(s, td, N_GRID), post, names, max_draws=11,
                              batch=4, device="cpu")
    assert got.shape == ref.shape == (11, NOBS)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_pointwise_matrix_thinning_on_a_synthetic_function():
    rng = np.random.default_rng(2)
    posterior = {"x": rng.normal(size=(2, 5)), "y": rng.normal(size=(2, 5))}
    names = ["x", "y"]
    ref = jmc.pointwise_matrix(lambda s: jnp.stack([s["x"], 2.0 * s["x"], s["y"], s["x"] - s["y"]]), posterior,
                               names, max_draws=7, batch=3)
    got = mc.pointwise_matrix(lambda s: torch.stack([s["x"], 2.0 * s["x"], s["y"], s["x"] - s["y"]], dim=-1),
                              posterior, names, max_draws=7, batch=3, device="cpu")
    assert got.shape == ref.shape == (7, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    flat = {k: v.reshape(-1) for k, v in posterior.items()}
    np.testing.assert_allclose(got[-1], [flat["x"][-1], 2 * flat["x"][-1], flat["y"][-1],
                                         flat["x"][-1] - flat["y"][-1]], rtol=1e-6)


def _gpd_sample(rng, k, sigma, n):
    u = rng.uniform(size=n)
    return -sigma * np.log1p(-u) if abs(k) < 1e-12 else sigma / k * (np.power(1.0 - u, -k) - 1.0)


@pytest.mark.parametrize("k_true", [0.0, 0.4, 0.8])
def test_fit_gpd_and_smoothing_equal_jax(k_true):
    rng = np.random.default_rng(1)
    x = _gpd_sample(rng, k_true, 1.3, 3000)
    np.testing.assert_allclose(mc.fit_gpd(x), jmc.fit_gpd(x), rtol=1e-12)
    lr = np.log(x + 0.1)
    got, ref = mc.psis_smooth_logratios(lr), jmc.psis_smooth_logratios(lr)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-12)
    assert got[1] == pytest.approx(ref[1], rel=1e-12)
    assert mc.fit_gpd(x[:4]) == jmc.fit_gpd(x[:4])  # too few exceedances


def test_psis_loo_waic_and_compare_equal_jax():
    """Two matrices, one with a heavy-tailed event (k̂ > 0.7) and a short one (m < 5: no smoothing)."""
    rng = np.random.default_rng(6)
    ll_good = rng.normal(-1.0, 0.1, size=(500, 12))
    ll_bad = ll_good - 0.5
    ll_bad[:, 0] = -np.log(_gpd_sample(rng, 1.0 / 1.2, 1.0, 500) + 0.1)
    results, ref_results = {}, {}
    for name, ll in (("pop", ll_bad), ("pop_cosmo", ll_good), ("short", ll_good[:20])):
        got, ref = mc.psis_loo(ll), jmc.psis_loo(ll)
        for field in got._fields:
            np.testing.assert_allclose(getattr(got, field), getattr(ref, field), rtol=1e-12)
        w_got, w_ref = mc.waic(ll), jmc.waic(ll)
        for field in w_got._fields:
            np.testing.assert_allclose(getattr(w_got, field), getattr(w_ref, field), rtol=1e-12)
        if name != "short":
            results[name], ref_results[name] = got, ref
    assert results["pop"].khat[0] > 0.7
    assert mc.compare(results) == jmc.compare(ref_results)
    assert mc.compare(results).splitlines()[1].startswith("pop_cosmo")
