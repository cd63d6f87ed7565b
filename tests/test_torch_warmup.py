"""NUTS warmup of the port against the JAX package's, and the tree it adapts on.

* **The tree (step 0).** With the start, the signed step, ``h0`` and the mass
  matrix fixed, a subtree's ``leaf``, ``turning``, ``diverging``, ``p_sum``,
  ``log_w``, ``accept_sum`` and end point do not depend on the uniform draws:
  the port's batched ``_build_subtree`` is held to the JAX one run per chain
  for ``n_leaf`` = 1, 2, 4, … 2^max_depth.  Integer and boolean fields
  exactly; float fields at rtol 1e-5 (the correlated 3-d Gaussian) or 1e-4
  (the small joint model), relative to |ref| plus the chain's largest entry
  (at least 1; entries of ``p_sum`` pass through zero).  A U-turn decision is the
  sign of a float32 dot product, so starts where one of them lies within 1e-3
  (relative to |v| |rho|) of zero, or where an energy error lies within 1 of
  the divergence threshold, are set aside: a float32 reordering could flip
  them.  The starts cover subtrees that run to the end, that turn at each
  checkpoint level and that diverge (a large step).
* **The step-size search** equals JAX's given the same momentum (JAX's own
  ``_sample_momentum`` on the split key), including chains whose first step
  has a NaN energy and a flat potential that hits the 60-step cap.  The steps
  are powers of two, so equality is exact.
* **The update functions** (dual averaging, Welford, the covariance with and
  without shrinkage, pooling, the window's end with a chain whose covariance
  is not positive definite) equal JAX's on the same inputs at rtol 1e-6, and
  ``warmup_schedule`` equals JAX's exactly.
* **Covariance recovery** by a short ``run_warmup`` on the Gaussian, with
  ``shared_mass`` off and on; the tolerance is four Monte-Carlo standard
  errors (below).
* **Checkpoints**: ``save_warmup``/``load_warmup`` across the two packages,
  and a sampling checkpoint that resumes to the draws of an uninterrupted run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bumpcosmology_tpu.inference import nuts as jnuts
from bumpcosmology_tpu.inference.likelihoods import pop_cosmo_model_spec as jspec
from bumpcosmology_tpu.inference.model import make_potential as jpotential
from bumpcosmology_tpu.inference.model import prior_sample as jprior
from bumpcosmology_tpu.testing import synthetic_pop_cosmo_data as jsynthetic
from bumpcosmology_torch import convert
from bumpcosmology_torch.inference import nuts
from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
from bumpcosmology_torch.inference.model import make_potential, value_and_grad

MU = np.array([1.0, -2.0, 0.5], np.float32)
COV = np.array([[1.0, 0.8, 0.2], [0.8, 2.0, -0.5], [0.2, -0.5, 0.5]], np.float32)
PREC = np.linalg.inv(COV).astype(np.float32)


def _tgauss(theta):
    d = theta - torch.as_tensor(MU)
    return 0.5 * (d * (d @ torch.as_tensor(PREC))).sum(-1)


def _jgauss(theta):
    d = theta - MU
    return 0.5 * d @ PREC @ d


# ---------------------------------------------------------------- the tree


def _jax_subtree(j_potential, max_depth):
    """JAX's ``_build_subtree`` run per chain (vmapped; one compilation for every ``n_leaf``)."""
    vg = jax.value_and_grad(j_potential)

    def one(theta, p, grad, n_leaf, eps_signed, cov, h0):
        dim = theta.shape[0]
        zero = jnp.zeros((max_depth + 1, dim), theta.dtype)
        f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
        carry = jnuts._SubtreeCarry(
            key=jax.random.PRNGKey(0), theta=theta, p=p, u=f32(0.0), grad=grad, theta_prop=theta,
            u_prop=f32(jnp.inf), grad_prop=grad, log_w=f32(-jnp.inf), p_sum=jnp.zeros_like(theta),
            accept_sum=f32(0.0), leaf=jnp.asarray(0, jnp.int32), turning=jnp.asarray(False),
            diverging=jnp.asarray(False), ptr=jnp.asarray(0, jnp.int32), p_ckpt=zero, s_ckpt=zero)
        return jnuts._build_subtree(vg, carry, n_leaf, eps_signed, cov, h0, max_depth)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None, 0, 0, 0)))


def _trailing_zeros(n):
    return (n & -n).bit_length() - 1


def _trajectory_margins(potential, theta, p, grad, eps, cov, h0, n_max):
    """Walk every start ``n_max`` leaves with the port's leapfrog and return,
    per chain, (the smallest U-turn margin |v·rho| / (|v| |rho|) and the
    smallest |dh - 1000| met up to the subtree's first stop, the checkpoint
    level that stopped it: 0 none, -1 a divergence, l a block of 2^l leaves)."""
    c = theta.shape[0]
    ps, dhs = [], []
    th, pp, g = theta, p, grad
    for _ in range(n_max):
        th, pp, u, g = nuts._leapfrog(lambda x: value_and_grad(potential, x), th, pp, g, eps, cov)
        h = u + nuts._kinetic(pp, cov)
        ps.append(pp.double().numpy())
        dhs.append(torch.where(torch.isnan(h), torch.inf, h).double().numpy() - h0.double().numpy())
    ps, dhs, cov64 = np.stack(ps, 1), np.stack(dhs, 1), cov.double().numpy()
    margin, level = np.full(c, np.inf), np.zeros(c, int)
    for i in range(c):
        for k in range(n_max):
            dh = dhs[i, k]
            margin[i] = min(margin[i], abs(dh - 1000.0) / 1000.0 if np.isfinite(dh) else np.inf)
            if not np.isfinite(dh) or dh > 1000.0:
                level[i] = -1
                break
            for lev in range(1, _trailing_zeros(k + 1) + 1):
                a = k + 1 - 2 ** lev
                rho = ps[i, a:k + 1].sum(0)
                for v in (cov64[i] @ ps[i, a], cov64[i] @ ps[i, k]):
                    margin[i] = min(margin[i], abs(v @ rho) / (np.linalg.norm(v) * np.linalg.norm(rho)))
                if (cov64[i] @ ps[i, a]) @ rho <= 0 or (cov64[i] @ ps[i, k]) @ rho <= 0:
                    level[i] = lev
                    break
            if level[i]:
                break
    return margin, level


def _assert_close_by_chain(got, ref, rtol, what):
    """|got - ref| <= rtol (|ref| + max(1, the chain's largest |ref|)), the same non-finite entries."""
    assert np.array_equal(np.isfinite(got), np.isfinite(ref)), what
    fin = np.isfinite(ref)
    rows = np.where(fin, np.abs(ref), 0.0).reshape(ref.shape[0], -1).max(1)
    scale = np.maximum(rows, 1.0).reshape((-1,) + (1,) * (ref.ndim - 1))
    err = np.where(fin, np.abs(got - ref), 0.0)
    assert (err <= rtol * (np.abs(np.where(fin, ref, 0.0)) + scale)).all(), (what, err.max())


def _compare_subtrees(potential, j_potential, theta, p, eps_signed, cov, max_depth, rtol):
    """Hold the port's subtree to JAX's for every n_leaf; return the stop level of each kept start."""
    u, grad = value_and_grad(potential, theta)
    h0 = u + nuts._kinetic(p, cov)
    margin, level = _trajectory_margins(potential, theta, p, grad, eps_signed, cov, h0, 2 ** max_depth)
    keep = torch.as_tensor(margin > 1e-3)
    theta, p, grad, eps_signed, cov, h0, level = (x[keep] for x in (theta, p, grad, eps_signed, cov, h0,
                                                                    torch.as_tensor(level)))
    build = _jax_subtree(j_potential, max_depth)
    active = torch.ones(theta.shape[0], dtype=torch.bool)
    for d in range(max_depth + 1):
        n_leaf = 1 << d
        got = nuts._build_subtree(potential, torch.Generator().manual_seed(d), active, n_leaf, theta, p, grad,
                                  eps_signed, cov, h0, max_depth)
        ref = build(*(x.numpy() for x in (theta, p, grad)), jnp.asarray(n_leaf, jnp.int32),
                    *(x.numpy() for x in (eps_signed, cov, h0)))
        for name in ("leaf", "turning", "diverging"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(getattr(ref, name)), err_msg=f"{name} n_leaf={n_leaf}")
        for name in ("p_sum", "log_w", "accept_sum", "theta", "p", "grad"):
            _assert_close_by_chain(got[name].numpy(), np.asarray(getattr(ref, name)), rtol, f"{name} n_leaf={n_leaf}")
    return level.numpy()


def test_subtree_matches_jax_on_the_gaussian():
    max_depth, c = 6, 96
    rng = np.random.default_rng(0)
    theta = torch.as_tensor(MU + rng.normal(size=(c, 3)).astype(np.float32) * 1.5)
    p = torch.as_tensor(rng.normal(size=(c, 3)).astype(np.float32))
    # log-uniform steps from 0.03 to 1.2 turn at every level; a few of 2.5-4 diverge
    eps = np.exp(rng.uniform(np.log(0.03), np.log(1.2), c)).astype(np.float32)
    eps[:8] = rng.uniform(2.5, 4.0, 8)
    eps_signed = torch.as_tensor(eps * np.where(rng.uniform(size=c) < 0.5, -1, 1).astype(np.float32))
    cov = torch.as_tensor(np.stack([COV if i % 2 else np.eye(3, dtype=np.float32) for i in range(c)]))
    level = _compare_subtrees(_tgauss, _jgauss, theta, p, eps_signed, cov, max_depth, rtol=1e-5)
    assert len(level) >= 64
    # subtrees that run to the end, diverge, and stop at checkpoint levels 1 to 5
    assert {0, -1, 1, 2, 3, 4, 5} <= set(level.tolist())


def test_subtree_matches_jax_on_the_joint_model():
    max_depth, c = 5, 16
    jd = jsynthetic(nobs=8, nsamp=32, nsel=128, seed=0)
    js = jspec(jd, n_grid=48, n_z=64)
    spec = pop_cosmo_model_spec(convert.pop_cosmo_data(jd, "cpu"), n_grid=48, n_z=64, device="cpu")
    theta = convert.theta_batch(jprior(js, jax.random.PRNGKey(5), (c,)), "cpu")
    rng = np.random.default_rng(1)
    # steps like the adapted ones (0.005-0.08): from a prior draw, steps of 0.3 make the float32
    # trajectories of the two packages part by 1e-5 to 1 within 16 leaves (chaos, not a fault)
    eps = np.exp(rng.uniform(np.log(0.005), np.log(0.08), c)).astype(np.float32)
    eps[:2] = 8.0  # diverges
    eps_signed = torch.as_tensor(eps * np.where(np.arange(c) % 2, -1, 1).astype(np.float32))
    cov = torch.eye(15).expand(c, 15, 15).contiguous()
    potential = make_potential(spec)
    # three starts in four climb the gradient with a momentum spent within 2^0.5-2^5.5 leaves: they turn
    _, grad = value_and_grad(potential, theta)
    gn = grad.norm(dim=1, keepdim=True)
    leaves = torch.as_tensor(2.0 ** rng.uniform(0.5, 5.5, (c, 1)).astype(np.float32))
    uphill = torch.sign(eps_signed)[:, None] * grad / gn * (eps_signed.abs()[:, None] * gn * leaves)
    p = torch.as_tensor(rng.normal(size=(c, 15)).astype(np.float32))
    p = torch.where(torch.arange(c)[:, None] % 4 == 3, p, uphill + 0.1 * p)
    level = _compare_subtrees(potential, jpotential(js), theta, p, eps_signed, cov, max_depth, rtol=1e-4)
    assert len(level) >= 12 and {-1, 0} <= set(level.tolist()) and len(set(level[level > 0].tolist())) >= 2


# ---------------------------------------------------------------- the step-size search


def _nan_beyond(x0):
    def t(theta):
        return torch.where(theta[:, 0] > x0, torch.nan, _tgauss(theta))

    def j(theta):
        return jnp.where(theta[0] > x0, jnp.nan, _jgauss(theta))

    return t, j


@pytest.mark.parametrize("case", ["gaussian", "nan_region", "flat"])
def test_find_reasonable_eps_matches_jax(case):
    c = 24
    rng = np.random.default_rng(2)
    theta = MU + rng.normal(size=(c, 3)).astype(np.float32) * np.linspace(0.1, 6.0, c)[:, None].astype(np.float32)
    pot, jpot = {"gaussian": (_tgauss, _jgauss), "nan_region": _nan_beyond(MU[0] + 0.3),
                 "flat": (lambda th: 0.0 * th.sum(-1), lambda th: 0.0 * th.sum())}[case]
    if case == "nan_region":
        theta[:, 0] = np.minimum(theta[:, 0], MU[0] + 0.2)
    keys = jax.random.split(jax.random.PRNGKey(7), c)
    eye = jnp.eye(3, dtype=jnp.float32)
    vg = jax.value_and_grad(jpot)

    def jax_eps(th, k):
        u, g = vg(th)
        return jnuts._find_reasonable_eps(vg, jnuts.ChainState(th, u, g), eye, eye, k)

    ref = np.asarray(jax.jit(jax.vmap(jax_eps))(theta, keys))
    p0 = np.stack([np.asarray(jnuts._sample_momentum(jax.random.split(k)[1], eye, 3, jnp.float32)) for k in keys])
    th = torch.as_tensor(theta)
    u, g = value_and_grad(pot, th)
    eye_b = torch.eye(3).expand(c, 3, 3)
    got = nuts._find_reasonable_eps(pot, nuts.ChainState(th, u, g), torch.as_tensor(p0), eye_b)
    np.testing.assert_array_equal(got.numpy(), ref)
    if case == "nan_region":  # some chains' first step (eps = 1) lands where the energy is NaN
        _, p1, u1, _ = nuts._leapfrog(lambda x: value_and_grad(pot, x), th, torch.as_tensor(p0), g,
                                      torch.ones(c), eye_b)
        assert torch.isnan(u1 + nuts._kinetic(p1, eye_b)).sum() >= 3
    if case == "flat":
        assert (got == 2.0 ** 60).all()
    else:
        assert len(set(got.tolist())) >= 4


# ---------------------------------------------------------------- the update functions


def _jstate(cls, x):
    return cls(*(jnp.asarray(v.numpy()) for v in x))


def _assert_states(got, ref, rtol=1e-6):
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=rtol * np.abs(np.asarray(r)).max(),
                                   err_msg=name)


def test_dual_averaging_matches_jax():
    c, steps = 8, 120
    rng = np.random.default_rng(3)
    eps = torch.as_tensor(np.exp(rng.uniform(-5, 0, c)).astype(np.float32))
    accept = rng.beta(2.0, 1.0, size=(steps, c)).astype(np.float32)
    cfg = nuts.NutsConfig(target_accept=0.75, da_gamma=0.06, da_t0=9.0, da_kappa=0.7)
    jcfg = jnuts.NutsConfig(target_accept=0.75, da_gamma=0.06, da_t0=9.0, da_kappa=0.7)
    da, jda = nuts._da_init(eps), jax.vmap(lambda e: jnuts._da_init(e, jnp.float32))(jnp.asarray(eps.numpy()))
    _assert_states(da, jda)
    jupdate = jax.jit(jax.vmap(lambda d, a: jnuts._da_update(d, a, jcfg)))
    for a in accept:
        da, jda = nuts._da_update(da, torch.as_tensor(a), cfg), jupdate(jda, a)
    _assert_states(da, jda)


def _welford_pair(c=6, dim=4, n=200, seed=4):
    rng = np.random.default_rng(seed)
    xs = (rng.normal(size=(n, c, dim)) @ rng.normal(size=(dim, dim)) + 3.0).astype(np.float32)
    wf = nuts._welford_init(c, dim, torch.zeros(1))
    jwf = jnuts._batched_welford_init(c, dim, jnp.float32)
    jupdate = jax.jit(jax.vmap(jnuts._welford_update))
    for x in xs:
        wf, jwf = nuts._welford_update(wf, torch.as_tensor(x)), jupdate(jwf, x)
    return wf, jwf


def test_welford_matches_jax():
    wf, jwf = _welford_pair()
    _assert_states(wf, jwf)
    for reg in (True, False):
        ref = jax.vmap(lambda w: jnuts._welford_cov(w, regularize=reg))(jwf)
        np.testing.assert_allclose(nuts._welford_cov(wf, regularize=reg).numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(ref)).max())


def test_pool_welford_matches_jax():
    wf, jwf = _welford_pair(seed=5)
    # chains that saw different numbers of draws
    counts = torch.tensor([200.0, 50.0, 3.0, 0.0, 120.0, 1.0])
    wf = wf._replace(count=counts)
    jwf = jwf._replace(count=jnp.asarray(counts.numpy()))
    _assert_states(nuts._pool_welford(wf), jnuts._pool_welford(jwf))


@pytest.mark.parametrize("shared_mass", [False, True])
def test_end_window_matches_jax(shared_mass):
    """Chain 2's window covariance is not positive definite: unpooled it keeps its old matrices."""
    c, dim = 6, 4
    wf, jwf = _welford_pair(c, dim, seed=6)
    m2 = wf.m2.clone()
    m2[2] = torch.diag(torch.tensor([1.0, 1.0, -1.0, 1.0])) * 199.0
    wf, jwf = wf._replace(m2=m2), jwf._replace(m2=jnp.asarray(m2.numpy()))
    rng = np.random.default_rng(7)
    a = rng.normal(size=(c, dim, dim)).astype(np.float32)
    cov = torch.as_tensor(a @ a.transpose(0, 2, 1) + np.eye(dim, dtype=np.float32))
    chol = torch.linalg.cholesky(cov)
    da = nuts._da_init(torch.as_tensor(np.exp(rng.uniform(-4, 0, c)).astype(np.float32)))
    da = nuts._da_update(da, torch.full((c,), 0.6), nuts.NutsConfig())
    got = nuts._end_window(cov, chol, da, wf, shared_mass=shared_mass)
    ref = jnuts._end_window(*(jnp.asarray(x.numpy()) for x in (cov, chol)), _jstate(jnuts._DualAveragingState, da),
                            jwf, shared_mass=shared_mass)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6 * np.abs(np.asarray(r)).max())
    _assert_states(got[2], ref[2])
    _assert_states(got[3], ref[3])
    kept = torch.equal(got[0][2], cov[2]) and torch.equal(got[1][2], chol[2])
    assert kept != shared_mass
    assert not torch.equal(got[0][0], cov[0])


def test_warmup_schedule_matches_jax():
    for n in list(range(401)) + [1000, 2000]:
        assert nuts.warmup_schedule(n) == jnuts.warmup_schedule(n), n
    for kw in ({"init_buffer": 30, "term_buffer": 20, "base_window": 10},
               {"init_buffer": 0, "term_buffer": 0, "base_window": 7}, {"init_buffer": 100, "base_window": 50}):
        for n in (20, 37, 64, 150, 333, 1000):
            assert nuts.warmup_schedule(n, **kw) == jnuts.warmup_schedule(n, **kw), (n, kw)


# ---------------------------------------------------------------- covariance recovery


@pytest.mark.parametrize("shared_mass", [False, True])
def test_run_warmup_recovers_the_gaussian_covariance(shared_mass):
    """The last slow window of ``warmup_schedule(300)`` holds 100 draws a
    chain, 1,600 over 16 chains.  With an effective sample size of at least
    half of them, the standard error of a covariance entry is
    sqrt((S_ii S_jj + S_ij^2) / 800); the adapted matrix (pooled, or the mean
    over chains) must lie within four of them of the Gaussian's covariance
    after Stan's shrinkage (n / (n + 5), n the window's draws)."""
    c, num_warmup = 16, 300
    gen = torch.Generator().manual_seed(11)
    theta0 = torch.as_tensor(MU) + 2.0 * torch.randn((c, 3), generator=gen)
    warm, stats = nuts.run_warmup(_tgauss, theta0, num_warmup, nuts.NutsConfig(max_depth=6, shared_mass=shared_mass),
                                  generator=gen, device="cpu")
    assert stats.accept_prob.shape == (c, num_warmup)
    assert torch.isfinite(warm.eps).all() and (warm.eps > 0).all()
    n_window = 100 * (c if shared_mass else 1)
    shrink = n_window / (n_window + 5.0)
    target = shrink * COV + 1e-3 * (1 - shrink) * np.eye(3)
    se = np.sqrt((np.outer(np.diag(COV), np.diag(COV)) + COV ** 2) / 800.0)
    est = warm.cov.mean(0).numpy()
    assert (np.abs(est - target) < 4 * se).all(), (est, target)
    torch.testing.assert_close(warm.chol_cov @ warm.chol_cov.mT, warm.cov, rtol=1e-5, atol=1e-6)
    if shared_mass:
        assert all(torch.equal(warm.cov[0], x) for x in warm.cov)
    # the step size adapts to the target accept probability of 0.8 (each window's
    # dual-averaging reset tries ten times the step first, so the early steps diverge)
    assert 0.6 < float(stats.accept_prob[:, -20:].mean()) < 0.95


# ---------------------------------------------------------------- checkpoints


def _random_warm(c=4, dim=3, seed=8):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(c, dim, dim)).astype(np.float32)
    cov = a @ a.transpose(0, 2, 1) + np.eye(dim, dtype=np.float32)
    arrays = [rng.normal(size=(c, dim)), rng.normal(size=c), rng.normal(size=(c, dim)), rng.uniform(0.1, 1, c), cov,
              np.linalg.cholesky(cov)]
    return [np.asarray(x, np.float32) for x in arrays]


def test_warmup_checkpoint_round_trips_across_packages(tmp_path):
    from bumpcosmology_tpu.utils.checkpoint import load_warmup as jload
    from bumpcosmology_tpu.utils.checkpoint import save_warmup as jsave
    from bumpcosmology_torch.utils.checkpoint import load_warmup, save_warmup

    theta, u, grad, eps, cov, chol = _random_warm()
    warm = nuts.WarmupResult(nuts.ChainState(*map(torch.as_tensor, (theta, u, grad))),
                             *map(torch.as_tensor, (eps, cov, chol)))
    save_warmup(tmp_path / "port", warm)  # the suffix is added, as the JAX package does
    back = jload(str(tmp_path / "port"))
    for a, b in zip((*warm.state, *warm[1:]), (*back.state, *back[1:])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jsave(str(tmp_path / "ref.npz"), jnuts.WarmupResult(jnuts.ChainState(theta, u, grad), eps, cov, chol))
    mine = load_warmup(tmp_path / "ref.npz", device="cpu")
    for a, b in zip((theta, u, grad, eps, cov, chol), (*mine.state, *mine[1:])):
        np.testing.assert_array_equal(a, b.numpy())


class _Stop(Exception):
    pass


def test_sampling_checkpoint_resumes_to_the_same_draws(tmp_path):
    c = 4
    gen = torch.Generator().manual_seed(3)
    theta0 = torch.as_tensor(MU) + torch.randn((c, 3), generator=gen)
    u, g = value_and_grad(_tgauss, theta0)
    cov = torch.as_tensor(COV).expand(c, 3, 3).contiguous()
    warm = nuts.WarmupResult(nuts.ChainState(theta0, u, g), torch.full((c,), 0.6), cov, torch.linalg.cholesky(cov))
    cfg = nuts.NutsConfig(max_depth=5)
    full = nuts.run_sampling(_tgauss, warm, 7, cfg, seed=21, device="cpu")

    path = tmp_path / "fit"
    ckpt = nuts.sampling_checkpoint_file(path)
    assert ckpt == str(tmp_path / "fit.sampling.npz")

    def stop_at_five(done, total):
        if done == 5:
            raise _Stop

    with pytest.raises(_Stop):
        nuts.run_sampling(_tgauss, warm, 7, cfg, seed=21, device="cpu", progress=stop_at_five,
                          checkpoint_path=path, checkpoint_every=2)
    with np.load(ckpt) as d:  # the reference's array names; the last save was after draw 4
        assert int(d["done"]) == 4 and d["thetas"].shape == (4, c, 3) and d["stats_accept_prob"].shape == (4, c)
        assert {"key", "state_theta", "state_u", "state_grad"} <= set(d.files)
    resumed = nuts.run_sampling(_tgauss, warm, 7, cfg, seed=999, device="cpu", checkpoint_path=path,
                                checkpoint_every=2)
    assert torch.equal(resumed.thetas, full.thetas)
    for a, b in zip(resumed.stats, full.stats):
        assert torch.equal(a, b)
    assert not (tmp_path / "fit.sampling.npz").exists()
