"""Bridge-sampling evidence (``inference/evidence.py``) and the multimodality
tools (``inference/modes.py``).

* ``log_evidence_bridge`` on a conjugate Gaussian toy (exact posterior
  draws) and on a synthetic joint-model trace of 80 draws (n_grid 48, n_z
  64, the fused route with the data's bounds in both packages).  Both
  packages draw the same proposals (``numpy.random.default_rng(seed)``), so
  their ``log_z`` can differ only through the potentials: the estimator is a
  weighted mean of exp(−U) ratios, and |Δ log_z| must stay within the
  largest |ΔU| over the evaluated points plus 1e-6.  The points themselves
  (the unconstrained trace and the proposals) agree to rtol 1e-6.
* ``_bridge_iterate``, ``_gaussian_logpdf`` and ``bayes_factor_table`` on
  the same inputs: equal to rtol 1e-12 (the same float64 numpy).
* ``assign_modes``, ``split_rhat_per_mode`` and ``mode_weighted_resample``
  equal to the JAX package's on a two-basin mixture; ``mode_weights_by_bridge``
  within the same |ΔU| bound (rtol 1e-5 on the weights).
* **A difference on purpose:** when no mode has a bridge estimate (every
  mode under 64 draws) the JAX package returns NaN weights; the port raises
  ``ValueError``.
"""
import math

import jax
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import evidence as jev
from bumpcosmology_tpu.inference import likelihoods as jlk
from bumpcosmology_tpu.inference import modes as jmodes
from bumpcosmology_tpu.inference.distributions import Normal as JNormal
from bumpcosmology_tpu.inference.model import ModelSpec as JModelSpec
from bumpcosmology_tpu.inference.model import constrain as jconstrain
from bumpcosmology_tpu.inference.model import make_potential as jmake_potential
from bumpcosmology_tpu.inference.model import prior_sample as jprior_sample
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as j_synthetic_pop_cosmo_data
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import evidence as ev
from bumpcosmology_torch.inference import likelihoods as lk
from bumpcosmology_torch.inference import modes
from bumpcosmology_torch.inference.distributions import Normal
from bumpcosmology_torch.inference.model import ModelSpec

N_GRID, N_Z = 48, 64
CPU = torch.device("cpu")


def _gauss_loglike(y, sigma):
    """Σ_i log N(y_i | x_i, sigma): the same arithmetic on JAX scalars and torch (C,) tensors."""
    def loglike(sites):
        total = 0.0
        for i, yi in enumerate(y):
            total = total - 0.5 * ((yi - sites[f"x{i}"]) / sigma) ** 2 - 0.5 * math.log(2.0 * math.pi * sigma**2)
        return total
    return loglike


def _gauss_specs(y, sigma, mu0, tau):
    priors = lambda dist: {f"x{i}": dist(mu0, tau) for i in range(len(y))}  # noqa: E731
    return (JModelSpec(priors=priors(JNormal), loglike=_gauss_loglike(y, sigma)),
            ModelSpec(priors=priors(Normal), loglike=_gauss_loglike(y, sigma), device=CPU))


def _recorded(monkeypatch, module):
    """Wrap ``module._batched_logq`` to keep every (points, −U) pair it returns."""
    calls, real = [], module._batched_logq

    def rec(spec, theta, batch=512):
        out = real(spec, theta, batch=batch)
        calls.append((np.asarray(theta, np.float64), out))
        return out

    monkeypatch.setattr(module, "_batched_logq", rec)
    return calls


def _hold_bridge(monkeypatch, jspec, spec, posterior, **kwargs):
    """Both packages' bridge on one trace: the points agree, |Δ log_z| <= max|ΔU| + 1e-6."""
    jcalls, calls = _recorded(monkeypatch, jev), _recorded(monkeypatch, ev)
    ref = jev.log_evidence_bridge(jspec, posterior, **kwargs)
    got = ev.log_evidence_bridge(spec, posterior, **kwargs)
    assert len(calls) == len(jcalls) == 2
    du = 0.0
    for (th, lq), (jth, jlq) in zip(calls, jcalls):
        np.testing.assert_allclose(th, jth, rtol=1e-6, atol=1e-6)
        assert np.isfinite(lq).all() == np.isfinite(jlq).all()
        fin = np.isfinite(jlq)
        du = max(du, float(np.max(np.abs(lq[fin] - jlq[fin]))))
    assert abs(got.log_z - ref.log_z) <= du + 1e-6, (got.log_z, ref.log_z, du)
    assert (got.n_posterior, got.n_proposal, got.converged) == (ref.n_posterior, ref.n_proposal, ref.converged)
    assert got.log_z_blocks.shape == ref.log_z_blocks.shape
    np.testing.assert_allclose(got.log_z_blocks, ref.log_z_blocks, rtol=0, atol=du + 1e-6)
    return got, ref, du


def test_bridge_matches_jax_on_a_gaussian_toy(monkeypatch):
    rng = np.random.default_rng(7)
    d, sigma, mu0, tau = 4, 0.7, 0.5, 2.0
    y = rng.normal(0.0, 1.5, size=d)
    jspec, spec = _gauss_specs(y, sigma, mu0, tau)
    post_var = 1.0 / (1.0 / tau**2 + 1.0 / sigma**2)
    post_mean = post_var * (mu0 / tau**2 + y / sigma**2)
    draws = post_mean + math.sqrt(post_var) * rng.standard_normal((512, d))
    posterior = {f"x{i}": draws[:, i].reshape(2, 256) for i in range(d)}
    got, ref, du = _hold_bridge(monkeypatch, jspec, spec, posterior, seed=11, batch=100)
    log_z_true = float(np.sum(-0.5 * (y - mu0) ** 2 / (tau**2 + sigma**2)
                              - 0.5 * np.log(2 * math.pi * (tau**2 + sigma**2))))
    assert got.converged and abs(got.log_z - log_z_true) < 0.1
    assert du < 1e-4


def test_bridge_matches_jax_on_a_joint_model_trace(monkeypatch):
    jd = j_synthetic_pop_cosmo_data(5, 16, 64, seed=8)
    td = convert.pop_cosmo_data(jd, CPU)
    bounds = jlk.dl_bounds_of(jd)  # the port's spec keys its detector table on the same bounds
    jspec = JModelSpec(priors=dict(jlk.POP_COSMO_PRIORS),
                       loglike=lambda s: jlk.pop_cosmo_loglike(s, jd, N_GRID, N_Z, bounds))
    spec = lk.pop_cosmo_model_spec(td, N_GRID, N_Z, device=CPU)
    pot = jax.jit(jmake_potential(jspec))
    for seed in range(20):  # a prior draw of finite potential, then 80 draws scattered about it
        theta0 = jprior_sample(jspec, jax.random.PRNGKey(seed))
        if np.isfinite(float(pot(theta0))):
            break
    rng = np.random.default_rng(1)
    theta = np.asarray(theta0) + 0.02 * rng.standard_normal((80, theta0.shape[0]))
    sites = jax.vmap(lambda t: jconstrain(jspec, t))(jax.numpy.asarray(theta, dtype=jax.numpy.float32))
    posterior = {k: np.asarray(v).reshape(2, 40) for k, v in sites.items()}
    got, ref, du = _hold_bridge(monkeypatch, jspec, spec, posterior, seed=3, batch=32)
    assert np.isfinite(got.log_z) and du < 0.05


def test_bridge_iterate_gaussian_logpdf_and_table_equal_jax():
    rng = np.random.default_rng(2)
    l1 = rng.normal(-1.0, 1.0, 300)
    l1[:7] = -np.inf
    l2 = rng.normal(-0.5, 0.8, 200)
    for max_iter in (3, 500):
        assert ev._bridge_iterate(l1, l2, max_iter, 1e-10) == pytest.approx(
            jev._bridge_iterate(l1, l2, max_iter, 1e-10), rel=1e-12)
    with pytest.raises(FloatingPointError):
        ev._bridge_iterate(np.full(4, -np.inf), l2, 10, 1e-10)
    mean, a = rng.normal(size=3), rng.normal(size=(3, 3))
    chol = np.linalg.cholesky(a @ a.T + 3 * np.eye(3))
    x = rng.normal(size=(50, 3))
    np.testing.assert_allclose(ev._gaussian_logpdf(x, mean, chol), jev._gaussian_logpdf(x, mean, chol), rtol=1e-12)
    mk = lambda m, lz: m(log_z=lz, se=0.01, n_posterior=100, n_proposal=100, n_iter=5,  # noqa: E731
                         converged=True, log_z_blocks=np.zeros(2))
    got = ev.bayes_factor_table({"worse": mk(ev.EvidenceResult, -10.0), "better": mk(ev.EvidenceResult, -5.0)})
    assert got == jev.bayes_factor_table({"worse": mk(jev.EvidenceResult, -10.0),
                                          "better": mk(jev.EvidenceResult, -5.0)})
    assert got.splitlines()[1].startswith("better") and "-2.17" in got.splitlines()[2]


def test_bridge_rejects_short_and_nonfinite_traces():
    _, spec = _gauss_specs([0.0], 1.0, 0.0, 1.0)
    with pytest.raises(ValueError):
        ev.log_evidence_bridge(spec, {"x0": np.zeros((1, 63))})
    with pytest.raises(FloatingPointError):
        ev.log_evidence_bridge(spec, {"x0": np.full((1, 128), np.nan)})


# --------------------------------------------------------------------- modes

DIM, SD, SEP, LOG_W2 = 3, 0.4, 8.0, -2.0


def _mixture_loglike(lib):
    mu2 = SEP / math.sqrt(DIM)

    def loglike(sites):
        l1 = sum(-0.5 * (sites[f"x{i}"] / SD) ** 2 for i in range(DIM))
        l2 = LOG_W2 + sum(-0.5 * ((sites[f"x{i}"] - mu2) / SD) ** 2 for i in range(DIM))
        return lib.logaddexp(l1, l2)
    return loglike


@pytest.fixture(scope="module")
def mixture():
    """Exact draws: chains 0-2 in the main basin, chain 3 in the second, 96 draws each."""
    rng = np.random.default_rng(4)
    centre = np.array([0.0, 0.0, 0.0, SEP / math.sqrt(DIM)])[:, None, None]
    draws = centre + SD * rng.standard_normal((4, 96, DIM))
    posterior = {f"x{i}": draws[:, :, i] for i in range(DIM)}
    priors = lambda dist: {f"x{i}": dist(0.0, 10.0) for i in range(DIM)}  # noqa: E731
    jspec = JModelSpec(priors=priors(JNormal), loglike=_mixture_loglike(jax.numpy))
    spec = ModelSpec(priors=priors(Normal), loglike=_mixture_loglike(torch), device=CPU)
    return posterior, jspec, spec


def test_assign_modes_and_per_mode_rhat_equal_jax(mixture):
    posterior = mixture[0]
    labels = modes.assign_modes(posterior)
    np.testing.assert_array_equal(labels, jmodes.assign_modes(posterior))
    np.testing.assert_array_equal(labels, [0, 0, 0, 1])
    got, ref = modes.split_rhat_per_mode(posterior, labels), jmodes.split_rhat_per_mode(posterior, labels)
    assert sorted(got) == sorted(ref) == [0, 1]
    for m in got:
        assert got[m]["n_chains"] == ref[m]["n_chains"]
        for k in ("max_rhat", "min_ess"):
            assert got[m][k] == pytest.approx(ref[m][k], rel=1e-10)


def test_mode_weights_by_bridge_match_jax(mixture):
    posterior, jspec, spec = mixture
    labels = np.array([0, 0, 0, 1])
    w, res = modes.mode_weights_by_bridge(spec, posterior, labels, seed=2, batch=64)
    jw, jres = jmodes.mode_weights_by_bridge(jspec, posterior, labels, seed=2, batch=64)
    assert [r is None for r in res] == [r is None for r in jres] == [False, False]
    np.testing.assert_allclose(w, jw, rtol=1e-5)
    assert w[1] == pytest.approx(1.0 / (1.0 + math.exp(-LOG_W2)), abs=0.05)


def test_mode_weights_raise_where_jax_gives_nan(mixture):
    """Every mode under 64 draws: no bridge estimate anywhere.  The JAX
    package returns NaN weights; the port raises (a difference on purpose)."""
    posterior, jspec, spec = mixture
    short = {k: v[:, :15] for k, v in posterior.items()}
    labels = np.array([0, 0, 0, 1])
    jw, jres = jmodes.mode_weights_by_bridge(jspec, short, labels)
    assert np.isnan(jw).all() and jres == [None, None]
    with pytest.raises(ValueError, match="no evidence"):
        modes.mode_weights_by_bridge(spec, short, labels)


def test_mode_weighted_resample_equals_jax(mixture):
    posterior = mixture[0]
    labels = np.array([0, 0, 0, 1])
    got = modes.mode_weighted_resample(posterior, labels, np.array([0.7, 0.3]), 200, np.random.default_rng(9))
    ref = jmodes.mode_weighted_resample(posterior, labels, np.array([0.7, 0.3]), 200, np.random.default_rng(9))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].shape == (1, 200)
        np.testing.assert_array_equal(got[k], ref[k])
