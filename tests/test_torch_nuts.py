"""Batched NUTS sampling of the port.

Exact trajectories from another RNG cannot be compared, so:
* ``_leapfrog`` and ``_sample_momentum`` match the JAX package given the same
  momentum / the same standard-normal ξ (rtol 1e-5: float32, same formulas);
* batched NUTS recovers the mean and covariance of a correlated 3-d Gaussian
  under a dense mass matrix (tolerances from the Monte-Carlo error below);
* a 3-draw ``run_sampling`` smoke on the small joint model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from bumpcosmology_tpu.inference import nuts as jnuts
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as jsynthetic
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import nuts
from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
from bumpcosmology_torch.inference.model import make_potential, prior_sample, value_and_grad

MU = np.array([1.0, -2.0, 0.5], np.float32)
COV = np.array([[1.0, 0.8, 0.2], [0.8, 2.0, -0.5], [0.2, -0.5, 0.5]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def _tgauss(theta):
    d = theta - torch.as_tensor(MU)
    return 0.5 * (d * (d @ torch.as_tensor(PREC))).sum(-1)


def _jgauss(theta):
    d = theta - MU
    return 0.5 * d @ PREC @ d


def test_leapfrog_matches_jax():
    rng = np.random.default_rng(0)
    theta, p = rng.normal(size=(2, 4, 3)).astype(np.float32)
    eps = np.array([0.1, -0.2, 0.3, 0.05], np.float32)
    cov = np.stack([COV, np.eye(3, dtype=np.float32), COV * 0.5, COV]).astype(np.float32)
    grad = np.stack([np.asarray(jax.grad(_jgauss)(t)) for t in theta])
    got = nuts._leapfrog(lambda th: value_and_grad(_tgauss, th), *(torch.as_tensor(x) for x in
                         (theta, p, grad, eps, cov)))
    for c in range(4):
        ref = jnuts._leapfrog(jax.value_and_grad(_jgauss), theta[c], p[c], grad[c], eps[c], cov[c])
        for r, g in zip(ref, got):
            np.testing.assert_allclose(g[c].numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_sample_momentum_matches_jax():
    chol = np.linalg.cholesky(COV).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    ref = np.stack([np.asarray(jnuts._sample_momentum(k, jnp.asarray(chol), 3, jnp.float32)) for k in keys])
    xi = np.stack([np.asarray(jax.random.normal(k, (3,), dtype=jnp.float32)) for k in keys])
    got = nuts._sample_momentum(torch.as_tensor(np.broadcast_to(chol, (5, 3, 3)).copy()), torch.as_tensor(xi))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_nuts_recovers_correlated_gaussian():
    c, n_draws = 16, 150
    gen = torch.Generator().manual_seed(1)
    theta0 = torch.as_tensor(MU) + torch.randn((c, 3), generator=gen)
    u, g = value_and_grad(_tgauss, theta0)
    cov = torch.as_tensor(COV).expand(c, 3, 3).contiguous()
    warm = nuts.WarmupResult(nuts.ChainState(theta0, u, g), torch.full((c,), 0.7), cov,
                             torch.linalg.cholesky(cov))
    res = nuts.run_sampling(_tgauss, warm, n_draws, nuts.NutsConfig(max_depth=6), generator=gen,
                            device="cpu")
    draws = res.thetas[:, 20:].reshape(-1, 3).numpy()
    assert res.thetas.shape == (c, n_draws, 3)
    assert not res.stats.diverging.any()
    assert 0.6 < float(res.stats.accept_prob.mean()) < 1.0
    # ~2000 near-independent draws: standard error of a mean ≤ sqrt(2/2000) ≈ 0.03
    np.testing.assert_allclose(draws.mean(0), MU, atol=0.15)
    np.testing.assert_allclose(np.cov(draws.T), COV, atol=0.2)


def test_run_sampling_smoke_on_joint_model():
    jd = jsynthetic(nobs=8, nsamp=32, nsel=128, seed=0)
    spec = pop_cosmo_model_spec(convert.pop_cosmo_data(jd, "cpu"), n_grid=48, n_z=64, device="cpu")
    pot = make_potential(spec)
    gen = torch.Generator().manual_seed(4)
    theta0 = prior_sample(spec, gen, (4,))
    u, g = value_and_grad(pot, theta0)
    eye = torch.eye(15).expand(4, 15, 15).contiguous()
    warm = nuts.WarmupResult(nuts.ChainState(theta0, u + 1.0, g), torch.full((4,), 0.02), eye, eye)
    res = nuts.run_sampling(pot, warm, 3, nuts.NutsConfig(max_depth=4), generator=gen, device="cpu")
    assert res.thetas.shape == (4, 3, 15) and torch.isfinite(res.thetas).all()
    assert abs(res.max_abs_du - 1.0) < 1e-4  # the stored u is recomputed, not trusted
    assert (res.stats.n_leapfrog >= 1).all() and (res.stats.tree_depth <= 4).all()
    u_end, _ = value_and_grad(pot, res.warm.state.theta)
    np.testing.assert_allclose(res.warm.state.u.numpy(), u_end.numpy(), rtol=1e-5, atol=1e-4)
