"""The port's ChEES-HMC (``inference/chees.py``) and the ``chees`` and
``nuts+chees`` samplers of ``fit`` against the JAX package's.

* ``_halton(i)`` equals JAX's for i < 2000, and the leapfrog counts (the
  adaptation's, the sampling phase's jittered ones and the mean) equal the
  JAX package's host arithmetic on a grid of (T, eps, jitter_floor,
  max_leapfrogs).
* ``_hmc_step`` against JAX's, given the same momentum noise and uniforms
  (drawn from JAX's own keys, split as JAX splits them), for every
  ``n_steps`` from 1 to 32: on a correlated Gaussian (steps up to 1.5, some
  trajectories diverging, a potential that is NaN past a wall so that a
  proposal's energy is NaN) and on the population-only model at steps like
  the adapted ones.  θ', p', the new state and the accept probability at
  rtol 1e-5 (Gaussian) or 1e-4 (pop model) relative to |ref| plus the
  chain's largest entry, the accept and divergence decisions exactly.
* One ``_t_adapt_iteration`` and one ``_chees_iteration`` against JAX's, on
  the same states and draws: the new states and Welford statistics by chain
  as above, the ChEES gradient through Adam and dual averaging at rtol 1e-5.
* Gaussian recovery by ``run_chees`` and ``run_chees_from_warmup``, with the
  JAX package's own limits (``tests/test_nuts.py:209-255``); the latter keeps
  the warm state's step size.
* ``fit(sampler="nuts+chees")`` on the prior-only model and
  ``fit(sampler="chees")`` on a small pop spec (``tests/test_nuts.py:258-299``);
  the sample-stat keys, shapes and dtypes and the timing keys of each sampler
  equal those of JAX's ``fit``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import chees as jchees
from bumpcosmology_tpu.inference import nuts as jnuts
from bumpcosmology_tpu.inference import sampler as jsampler
from bumpcosmology_tpu.inference.likelihoods import pop_model_spec as jpop_spec
from bumpcosmology_tpu.inference.model import make_potential as jpotential
from bumpcosmology_tpu.inference.model import prior_sample as jprior
from bumpcosmology_tpu.testing import synthetic_pop_data as jsynthetic
from bumpcosmology_torch.inference import chees, nuts
from bumpcosmology_torch.inference.distributions import Normal, TruncatedNormal
from bumpcosmology_torch.inference.likelihoods import pop_model_spec
from bumpcosmology_torch.inference.model import ModelSpec, make_potential, value_and_grad
from bumpcosmology_torch.inference.sampler import fit
from bumpcosmology_torch.testing import synthetic_pop_data

MU = np.array([1.0, -2.0, 0.5], np.float32)
COV = np.array([[1.0, 0.8, 0.2], [0.8, 2.0, -0.5], [0.2, -0.5, 0.5]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)
WALL = 4.0  # the Gaussian's potential is NaN where x0 > WALL


def _tgauss(theta):
    d = theta - torch.as_tensor(MU)
    u = 0.5 * (d * (d @ torch.as_tensor(PREC))).sum(-1)
    return torch.where(theta[:, 0] > WALL, torch.nan, u)


def _jgauss(theta):
    d = theta - MU
    return jnp.where(theta[0] > WALL, jnp.nan, 0.5 * d @ PREC @ d)


def _jax_draws(key, c, dim):
    """The momentum noise and accept uniform each chain's key gives in JAX's ``_hmc_step``."""
    def one(k):
        k_mom, k_acc = jax.random.split(k)
        return jax.random.normal(k_mom, (dim,), jnp.float32), jax.random.uniform(k_acc, dtype=jnp.float32)

    xi, uniform = jax.vmap(one)(jax.random.split(key, c))
    return torch.as_tensor(np.array(xi)), torch.as_tensor(np.array(uniform))


def _assert_close_by_chain(got, ref, rtol, what):
    """|got - ref| <= rtol (|ref| + max(1, the chain's largest |ref|)), the same non-finite entries."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.array_equal(np.isfinite(got), np.isfinite(ref)), what
    fin = np.isfinite(ref)
    rows = np.where(fin, np.abs(ref), 0.0).reshape(ref.shape[0], -1).max(1)
    scale = np.maximum(rows, 1.0).reshape((-1,) + (1,) * (ref.ndim - 1))
    err = np.where(fin, np.abs(got - ref), 0.0)
    assert (err <= rtol * (np.abs(np.where(fin, ref, 0.0)) + scale)).all(), (what, err.max())


# ---------------------------------------------------------------- host arithmetic


def test_halton_matches_jax():
    assert [chees._halton(i) for i in range(2000)] == [jchees._halton(i) for i in range(2000)]
    assert all(0.0 < chees._halton(i) < 1.0 for i in range(2000))


def _jax_counts(i, t, eps, floor, max_lf):
    """The leapfrog counts as the JAX package computes them on the host
    (``run_chees``/``run_chees_from_warmup``: adaptation, jittered sampling, mean)."""
    adapt = int(np.clip(math.ceil(jchees._halton(i) * t / max(float(eps), 1e-6)), 1, max_lf))
    u = floor + (1.0 - floor) * jchees._halton(i)
    jitter = int(np.clip(math.ceil(u * t / max(float(eps), 1e-6)), 1, max_lf))
    mean = int(np.clip(math.ceil(0.5 * (1.0 + floor) * t / max(float(eps), 1e-6)), 1, max_lf))
    return adapt, jitter, mean


@pytest.mark.parametrize("jitter_floor", [0.0, 0.25, 0.6])
def test_leapfrog_counts_match_jax(jitter_floor):
    rng = np.random.default_rng(int(jitter_floor * 100))
    for t in (0.01, 0.37, 1.0, 2.9, 40.0):
        for eps in (np.float32(x) for x in (1e-8, 0.003, 0.0517, 0.25, 1.3)):
            for max_lf in (1, 16, 96, 1000):
                cfg = chees.CheesConfig(max_leapfrogs=max_lf, jitter_floor=jitter_floor)
                for i in rng.integers(0, 5000, 12):
                    got = (chees._n_steps(chees._halton(i), t, float(eps), max_lf),
                           chees._jitter_steps(i, t, float(eps), cfg), chees._mean_steps(t, float(eps), cfg))
                    assert got == _jax_counts(i, t, eps, jitter_floor, max_lf), (i, t, eps, max_lf)


# ---------------------------------------------------------------- one trajectory


def _jax_hmc_step(j_potential):
    vg = jax.value_and_grad(j_potential)

    def one(state, eps, n_steps, cov, chol, key):
        return jchees._hmc_step(vg, state, eps, n_steps, cov, chol, key)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, None, 0, 0, 0)))


def _compare_hmc_steps(potential, j_potential, theta, eps, cov, key, rtol, n_max=32):
    """Hold ``_hmc_step`` to JAX's for n_steps = 1 .. n_max; return the
    accept probabilities, divergence flags and proposals of every length,
    (C, n_max[, dim])."""
    c, dim = theta.shape
    u, grad = value_and_grad(potential, theta)
    state = nuts.ChainState(theta, u, grad)
    chol = torch.linalg.cholesky(cov)
    keys = jax.random.split(key, c)
    xi, uniform = _jax_draws(key, c, dim)
    step = _jax_hmc_step(j_potential)
    jstate = jnuts.ChainState(*(x.numpy() for x in state))
    vg = lambda th: value_and_grad(potential, th)  # noqa: E731
    accepts, divs, props = [], [], []
    for n in range(1, n_max + 1):
        new, accept, div, theta_p, p_p = chees._hmc_step(vg, state, eps, n, cov, chol, xi, uniform)
        jnew, jaccept, jdiv, jtheta_p, jp_p = step(jstate, eps.numpy(), jnp.asarray(n, jnp.int32), cov.numpy(),
                                                   chol.numpy(), keys)
        what = f"n_steps={n}"
        np.testing.assert_array_equal(div.numpy(), np.asarray(jdiv), err_msg=what)
        took = (new.theta != state.theta).any(1).numpy()  # the accept decisions
        np.testing.assert_array_equal(took, (np.asarray(jnew.theta) != state.theta.numpy()).any(1), err_msg=what)
        for name, got, ref in (("theta'", theta_p, jtheta_p), ("p'", p_p, jp_p), ("theta", new.theta, jnew.theta),
                               ("u", new.u[:, None], np.asarray(jnew.u)[:, None]), ("grad", new.grad, jnew.grad),
                               ("accept", accept[:, None], np.asarray(jaccept)[:, None])):
            _assert_close_by_chain(got.numpy(), np.asarray(ref), rtol, f"{name} {what}")
        accepts.append(accept.numpy())
        divs.append(div.numpy())
        props.append(theta_p.numpy())
    return np.stack(accepts, 1), np.stack(divs, 1), np.stack(props, 1)


def test_hmc_step_matches_jax_on_the_gaussian():
    c = 24
    rng = np.random.default_rng(2)
    theta = torch.as_tensor(MU + rng.normal(size=(c, 3)).astype(np.float32))
    eps = torch.as_tensor(np.exp(rng.uniform(np.log(0.02), np.log(0.6), c)).astype(np.float32))
    eps[4:8] = torch.tensor([1.3, 1.4, 1.5, 1.5])  # unstable for the dense kernel: these diverge
    cov = torch.as_tensor(np.stack([COV if i % 2 else np.eye(3, dtype=np.float32) for i in range(c)]))
    accept, div, prop = _compare_hmc_steps(_tgauss, _jgauss, theta, eps, cov, jax.random.PRNGKey(7), rtol=1e-5)
    assert div.any() and (~div).any()
    # a proposal past the wall has a NaN energy: accept probability exactly 0
    past = prop[..., 0] > WALL
    assert past.any() and (accept[past] == 0.0).all()
    assert ((accept > 0.0) & (accept < 1.0)).any() and (accept == 1.0).any()


def test_hmc_step_nan_energy_gives_accept_zero_and_keeps_the_state():
    theta = torch.tensor([[WALL - 0.01, -2.0, 0.5], [1.0, -2.0, 0.5]])
    u, grad = value_and_grad(_tgauss, theta)
    state = nuts.ChainState(theta, u, grad)
    cov = torch.eye(3).expand(2, 3, 3)
    xi = torch.tensor([[5.0, 0.0, 0.0], [0.0, 0.0, 0.0]])  # chain 0 is pushed through the wall
    vg = lambda th: value_and_grad(_tgauss, th)  # noqa: E731
    new, accept, div, theta_p, _ = chees._hmc_step(vg, state, torch.full((2,), 0.1), 3, cov, cov, xi,
                                                   torch.zeros(2))
    assert theta_p[0, 0] > WALL and accept[0] == 0.0 and bool(div[0])
    assert torch.equal(new.theta[0], theta[0]) and torch.equal(new.u[0], u[0])
    assert accept[1] > 0.0 and torch.equal(new.theta[1], theta_p[1])  # uniform 0 takes any proposal with accept > 0


@pytest.fixture(scope="module")
def pop_pair():
    shape = dict(nobs=8, nsamp=32, nsel=128, seed=0)
    jd, td = jsynthetic(**shape), synthetic_pop_data(**shape, device="cpu")
    return jpop_spec(jd, n_grid=48), pop_model_spec(td, n_grid=48, device="cpu")


def test_hmc_step_matches_jax_on_the_pop_model(pop_pair):
    """Steps like the adapted ones (0.005-0.05): from a prior draw, larger
    steps make the two packages' float32 trajectories part chaotically
    within 32 steps (``tests/test_torch_warmup.py``)."""
    js, spec = pop_pair
    c = 8
    theta = torch.as_tensor(np.array(jprior(js, jax.random.PRNGKey(5), (c,))))
    rng = np.random.default_rng(3)
    eps = torch.as_tensor(np.exp(rng.uniform(np.log(0.005), np.log(0.05), c)).astype(np.float32))
    cov = torch.eye(12).expand(c, 12, 12).contiguous()
    accept, _, _ = _compare_hmc_steps(make_potential(spec), jpotential(js), theta, eps, cov, jax.random.PRNGKey(8),
                                      rtol=1e-4)
    assert np.isfinite(accept).all() and (accept > 0.0).any()


# ---------------------------------------------------------------- one adaptation iteration


def _iteration_inputs(c=16, seed=4):
    rng = np.random.default_rng(seed)
    theta = torch.as_tensor(MU + rng.normal(size=(c, 3)).astype(np.float32))
    u, grad = value_and_grad(_tgauss, theta)
    state = nuts.ChainState(theta, u, grad)
    cov = torch.as_tensor(COV).expand(c, 3, 3).contiguous()
    chol = torch.linalg.cholesky(cov)
    f = lambda x: torch.tensor([x], dtype=torch.float32)  # noqa: E731
    adam = chees._AdamState(f(math.log(1.7)), f(0.4), f(0.09), f(3.0))
    da = nuts._DualAveragingState(f(math.log(0.3)), f(math.log(0.25)), f(0.02), f(math.log(3.0)), f(5.0))
    wf = nuts._WelfordState(torch.full((c,), 4.0), torch.as_tensor(rng.normal(size=(c, 3)).astype(np.float32)),
                            torch.as_tensor(np.stack([np.eye(3, dtype=np.float32) * 3.0] * c)))
    return state, cov, chol, adam, da, wf


def _j(x):
    return jnp.asarray(np.asarray(x))


def test_t_adapt_iteration_matches_jax():
    state, cov, chol, adam, _, _ = _iteration_inputs()
    cfg = chees.CheesConfig()
    key, eps, n = jax.random.PRNGKey(9), 0.3, 7
    xi, uniform = _jax_draws(key, 16, 3)
    new, adam_n, acc = chees._t_adapt_iteration(_tgauss, state, torch.full((16,), eps), n, cov, chol, adam, xi,
                                                uniform, cfg)
    jstate = jnuts.ChainState(*(_j(x) for x in state))
    jadam = jchees._AdamState(*(_j(x[0]) for x in adam))
    jnew, jadam_n, jacc = jchees._t_adapt_iteration(_jgauss, jstate, jnp.float32(eps), jnp.int32(n), _j(cov),
                                                    _j(chol), jadam, key, (cfg.adam_lr, cfg.adam_b1, cfg.adam_b2))
    for name, got, ref in zip(nuts.ChainState._fields, new, jnew):
        _assert_close_by_chain(got.numpy().reshape(16, -1), np.asarray(ref).reshape(16, -1), 1e-5, name)
    for name, got, ref in zip(chees._AdamState._fields, adam_n, jadam_n):
        np.testing.assert_allclose(got.numpy(), [float(ref)], rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-5)
    assert float(adam_n.log_t) != float(adam.log_t)


def test_chees_iteration_matches_jax():
    state, cov, chol, adam, da, wf = _iteration_inputs(seed=5)
    cfg = chees.CheesConfig(target_accept=0.7)
    key, n = jax.random.PRNGKey(10), 5
    eps = torch.exp(da.log_eps)
    xi, uniform = _jax_draws(key, 16, 3)
    new, adam_n, da_n, wf_n, acc = chees._chees_iteration(_tgauss, state, eps.expand(16), n, cov, chol, adam, da, wf,
                                                          xi, uniform, cfg)
    jstate = jnuts.ChainState(*(_j(x) for x in state))
    cfg_tuple = (cfg.target_accept, cfg.adam_lr, cfg.adam_b1, cfg.adam_b2, cfg.da_gamma, cfg.da_t0, cfg.da_kappa)
    jnew, jadam_n, jda_n, jwf_n, jacc = jchees._chees_iteration(
        _jgauss, jstate, _j(eps[0]), jnp.int32(n), _j(cov), _j(chol), jchees._AdamState(*(_j(x[0]) for x in adam)),
        jnuts._DualAveragingState(*(_j(x[0]) for x in da)), jnuts._WelfordState(*(_j(x) for x in wf)), key,
        cfg_tuple)
    for name, got, ref in zip(nuts.ChainState._fields, new, jnew):
        _assert_close_by_chain(got.numpy().reshape(16, -1), np.asarray(ref).reshape(16, -1), 1e-5, name)
    for fields, got_s, ref_s in ((chees._AdamState._fields, adam_n, jadam_n),
                                 (nuts._DualAveragingState._fields, da_n, jda_n)):
        for name, got, ref in zip(fields, got_s, ref_s):
            np.testing.assert_allclose(got.numpy(), [float(ref)], rtol=1e-5, atol=1e-7, err_msg=name)
    for name, got, ref in zip(nuts._WelfordState._fields, wf_n, jwf_n):
        _assert_close_by_chain(got.numpy().reshape(16, -1), np.asarray(ref).reshape(16, -1), 1e-5, name)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-5)


def test_chees_grad_leaves_out_non_finite_proposals():
    """A chain whose proposal is NaN is left out of the means and the weights
    (the JAX package's estimate would be NaN); the rest give the estimate of
    the finite chains alone."""
    rng = np.random.default_rng(6)
    theta, theta_p, p_p = (torch.as_tensor(rng.normal(size=(6, 3)).astype(np.float32)) for _ in range(3))
    accept = torch.as_tensor(rng.uniform(0.2, 1.0, 6).astype(np.float32))
    theta_bad = theta_p.clone()
    theta_bad[2, 1] = torch.nan
    got = chees._chees_grad(theta, theta_bad, p_p, torch.where(torch.arange(6) == 2, 0.0, accept))
    keep = torch.arange(6) != 2
    d_old = theta - theta.mean(0)
    d_prop = theta_p[keep] - theta_p[keep].mean(0)
    delta = (d_prop * d_prop).sum(1) - (d_old[keep] * d_old[keep]).sum(1)
    ref = (accept[keep] / accept[keep].sum() * delta * (d_prop * p_p[keep]).sum(1)).sum()
    assert got.shape == (1,) and torch.isfinite(got).all()
    torch.testing.assert_close(got[0], ref, rtol=1e-5, atol=1e-6)
    # with every proposal finite it is JAX's arithmetic
    jt, jp, jpp, ja = (jnp.asarray(x.numpy()) for x in (theta, theta_p, p_p, accept))
    d_o, d_p = jt - jt.mean(0), jp - jp.mean(0)
    jref = jnp.sum(ja / jnp.maximum(ja.sum(), 1e-6) * (jnp.sum(d_p * d_p, 1) - jnp.sum(d_o * d_o, 1))
                   * jnp.sum(d_p * jpp, 1))
    np.testing.assert_allclose(float(chees._chees_grad(theta, theta_p, p_p, accept)[0]), float(jref), rtol=1e-5)


# ---------------------------------------------------------------- recovery


RHO = 0.7
PREC2 = torch.as_tensor(np.linalg.inv(np.array([[1.0, RHO], [RHO, 1.0]])).astype(np.float32))


def _pot2(theta):
    return 0.5 * ((theta @ PREC2) * theta).sum(-1)


def _check_recovery(res):
    x = res.thetas.reshape(-1, 2).numpy()
    emp = np.cov(x.T)
    np.testing.assert_allclose(emp[0, 0], 1.0, atol=0.2)
    np.testing.assert_allclose(emp[0, 1], RHO, atol=0.2)
    assert 0.4 < float(res.accept.mean()) <= 1.0
    assert res.n_leapfrog >= 1 and math.isfinite(res.trajectory_length) and res.eps > 0.0
    assert res.diverging.shape == res.accept.shape


def test_run_chees_recovers_the_gaussian():
    theta0 = torch.randn((16, 2), generator=torch.Generator().manual_seed(0))
    res = chees.run_chees(_pot2, theta0, num_warmup=400, num_samples=400, seed=1, device="cpu")
    assert res.thetas.shape == (16, 400, 2) and res.accept.shape == res.diverging.shape == (16, 400)
    _check_recovery(res)
    # one shared kernel, broadcast over the chains
    assert torch.equal(res.warm.eps, torch.full((16,), res.warm.eps[0].item()))
    assert all(torch.equal(res.warm.cov[0], m) for m in res.warm.cov)
    torch.testing.assert_close(res.warm.chol_cov[0] @ res.warm.chol_cov[0].T, res.warm.cov[0])


def test_run_chees_from_warmup_recovers_the_gaussian_and_keeps_eps():
    theta0 = torch.randn((16, 2), generator=torch.Generator().manual_seed(0))
    warm, _ = nuts.run_warmup(_pot2, theta0, 300, nuts.NutsConfig(), seed=1, device="cpu")
    res = chees.run_chees_from_warmup(_pot2, warm, num_adapt=100, num_samples=300, seed=2, device="cpu")
    assert res.thetas.shape == (16, 300, 2)
    _check_recovery(res)
    assert res.eps == float(warm.eps[0]) and torch.equal(res.warm.eps, warm.eps[:1].expand(16))
    assert torch.equal(res.warm.cov, warm.cov[:1].expand(16, 2, 2))
    assert res.max_abs_du == 0.0  # the port's own state: the recompute changes nothing
    # a state from elsewhere: u off by 0.5 is recomputed before the first trajectory
    off = warm._replace(state=warm.state._replace(u=warm.state.u + 0.5))
    again = chees.run_chees_from_warmup(_pot2, off, num_adapt=3, num_samples=2, seed=2, device="cpu")
    assert again.max_abs_du == pytest.approx(0.5, abs=1e-5)
    first = chees.run_chees_from_warmup(_pot2, warm, num_adapt=3, num_samples=2, seed=2, device="cpu")
    assert torch.equal(again.thetas, first.thetas)


# ---------------------------------------------------------------- fit


def _prior_only_spec():
    priors = {"x": Normal(0.0, 1.0), "y": TruncatedNormal(1.0, 2.0, low=0.0)}
    return ModelSpec(priors=priors, loglike=lambda s: torch.zeros_like(s["x"]))


def test_fit_with_hybrid_nuts_chees_sampler():
    res = fit(_prior_only_spec(), 11, num_warmup=300, num_samples=300, num_chains=4, sampler="nuts+chees",
              chees_num_adapt=50, verbose=False, device="cpu")
    x = res.posterior["x"]
    assert x.shape == (4, 300) and np.isfinite(x).all()
    assert abs(x.mean()) < 0.2 and abs(x.std() - 1.0) < 0.2
    assert 0.4 < res.sample_stats["accept_prob"].mean() <= 1.0
    assert res.sample_stats["diverging"].shape == (4, 300) and res.sample_stats["diverging"].sum() == 0
    # the hybrid's final state has the NUTS warmup's kernel, chain 0's shared
    assert res.final_state.cov.shape == res.warmup_state.cov.shape
    assert torch.equal(res.final_state.cov, res.warmup_state.cov[:1].expand_as(res.warmup_state.cov))
    assert set(res.timings) == {"warmup_s", "sampling_s"}


def test_fit_with_chees_sampler_on_the_pop_model():
    spec = pop_model_spec(synthetic_pop_data(nobs=4, nsamp=16, nsel=32, seed=0, device="cpu"), n_grid=64,
                          device="cpu")
    res = fit(spec, 0, num_warmup=50, num_samples=30, num_chains=4, sampler="chees", verbose=False, device="cpu")
    assert res.posterior["a"].shape == (4, 30) and np.isfinite(res.posterior["a"]).all()
    assert 0.0 < res.sample_stats["accept_prob"].mean() <= 1.0
    assert set(res.timings) == {"sampling_s"}


@pytest.mark.parametrize("sampler", ["chees", "nuts+chees"])
def test_sample_stats_and_timings_equal_those_of_jax_fit(sampler):
    """JAX's own ``fit`` on a one-site model (2 warmup steps, 2 adaptation steps, 3 draws)."""
    from bumpcosmology_tpu.inference.distributions import Normal as JNormal
    from bumpcosmology_tpu.inference.model import ModelSpec as JModelSpec

    js = JModelSpec(priors={"x": JNormal(0.0, 1.0)}, loglike=lambda s: 0.0 * s["x"])
    kw = dict(num_warmup=2, num_samples=3, num_chains=2, sampler=sampler, chees_num_adapt=2, verbose=False)
    ref = jsampler.fit(js, jax.random.PRNGKey(0), cfg=jnuts.NutsConfig(max_depth=2), **kw)
    spec = ModelSpec(priors={"x": Normal(0.0, 1.0)}, loglike=lambda s: 0.0 * s["x"])
    got = fit(spec, 0, cfg=nuts.NutsConfig(max_depth=2), device="cpu", **kw)
    assert list(got.sample_stats) == list(ref.sample_stats)
    for k, v in ref.sample_stats.items():
        assert got.sample_stats[k].shape == np.shape(v) and got.sample_stats[k].dtype == np.asarray(v).dtype, k
    assert set(got.timings) == set(ref.timings)
    assert got.posterior["x"].shape == np.shape(ref.posterior["x"]) == (2, 3)
