"""Batched multinomial NUTS with a dense mass matrix and Stan's windowed
warmup (L2); counterpart of the JAX package's ``inference/nuts.py``.

The JAX package ``vmap``s a per-chain ``while_loop``.  Here the same
iterative scheme (tree doubling, progressive multinomial sampling, the
O(log n) checkpoint stack for the U-turn tests, ``nuts.py:197-424``) runs as
one loop over the whole chain batch: every chain carries an active mask,
updates are masked, and each leapfrog makes one batched value+grad for the
chains still integrating.  While any chain is active the host must know it,
so each leapfrog reads the device twice (the active-chain check and the
active chains' indices), and each subtree once more.  :data:`COUNTS` counts
these reads; while the torch profiler records, each draw is the span
``nuts.transition`` (:mod:`~bumpcosmology_torch.utils.profiling`).

All chains that are still building a subtree share its leaf index, so the
leaf index and the checkpoint pointer are plain integers; a chain that has
stopped keeps its values through the masks.

Warmup runs the same way: the step-size search is a masked batch (one
batched value+grad per doubling or halving for the chains still searching),
and the dual-averaging, Welford and window updates act on every chain at
once.  Each chain adapts its own step size and mass matrix unless
``shared_mass`` pools the window's statistics.

Mass-matrix products, Welford's outer products and the pooled sums are
elementwise multiply-and-sum in full fp32 (never a matmul, so TF32 cannot
reach them).  A window whose covariance is not positive definite keeps that
chain's old matrices: ``torch.linalg.cholesky_ex`` reports it where the
reference's Cholesky returns NaN.
"""
from __future__ import annotations

import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.model import value_and_grad
from bumpcosmology_torch.utils.profiling import span

__all__ = ["NutsConfig", "ChainState", "WarmupResult", "NutsStats", "SamplingResult",
           "nuts_transition", "warmup_schedule", "run_warmup", "run_sampling", "run_nuts"]

_DIVERGENCE_THRESHOLD = 1000.0
# reads of the device by the transitions and the step-size search
COUNTS = {"host_syncs": 0}


class NutsConfig(NamedTuple):
    max_depth: int = 10
    target_accept: float = 0.8
    # dual averaging (Hoffman & Gelman 2014 defaults)
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75
    dense_mass: bool = True
    # pool the window's Welford statistics over the chain batch (one shared mass matrix)
    shared_mass: bool = False


class ChainState(NamedTuple):
    theta: torch.Tensor  # (C, dim)
    u: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, dim)


class WarmupResult(NamedTuple):
    """Adapted sampler state: positions, step sizes, mass-matrix inverses."""

    state: ChainState
    eps: torch.Tensor  # (C,)
    cov: torch.Tensor  # (C, dim, dim)
    chol_cov: torch.Tensor  # (C, dim, dim) lower Cholesky of cov

    def to(self, device, dtype=torch.float32) -> "WarmupResult":
        f = lambda x: x.to(device=device, dtype=dtype)  # noqa: E731
        return WarmupResult(ChainState(*(f(x) for x in self.state)), f(self.eps), f(self.cov),
                            f(self.chol_cov))


class _DualAveragingState(NamedTuple):
    log_eps: torch.Tensor  # each (C,)
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    t: torch.Tensor


class _WelfordState(NamedTuple):
    count: torch.Tensor  # (C,)
    mean: torch.Tensor  # (C, dim)
    m2: torch.Tensor  # (C, dim, dim)


class NutsStats(NamedTuple):
    accept_prob: torch.Tensor
    diverging: torch.Tensor
    tree_depth: torch.Tensor
    n_leapfrog: torch.Tensor
    energy: torch.Tensor
    step_size: torch.Tensor


class SamplingResult(NamedTuple):
    thetas: torch.Tensor  # (C, num_samples, dim)
    stats: NutsStats  # each (C, num_samples)
    warm: WarmupResult  # the final state, with the same kernel
    max_abs_du: float  # largest |u| change when the stored state was recomputed


def _matvec(cov, p):
    """(C, d, d) @ (C, d) in full fp32 (elementwise, never a TF32 matmul)."""
    return (cov * p[:, None, :]).sum(-1)


def _dot(x, y):
    return (x * y).sum(-1)


def _kinetic(p, cov):
    return 0.5 * _dot(p, _matvec(cov, p))


def _leapfrog(vg: Callable, theta, p, grad, eps, cov):
    """One leapfrog step of every chain; ``eps`` is (C,) (signed)."""
    e = eps[:, None]
    p_half = p - 0.5 * e * grad
    theta_new = theta + e * _matvec(cov, p_half)
    u_new, grad_new = vg(theta_new)
    return theta_new, p_half - 0.5 * e * grad_new, u_new, grad_new


def _sample_momentum(chol_cov, xi):
    """p ~ N(0, Σ⁻¹) from standard-normal ``xi``: solve chol(Σ)ᵀ p = ξ."""
    return torch.linalg.solve_triangular(chol_cov.mT, xi[..., None], upper=True)[..., 0]


def _trailing_zeros(n: int) -> int:
    return (n & -n).bit_length() - 1


def _masked_vg(potential: Callable, active: torch.Tensor) -> Callable:
    """value_and_grad over the active chains only; other rows come back 0
    (every caller masks them out).  A potential whose chains read data of
    their own (a fleet, chain ``s`` reading catalog ``s``) has
    ``on_chains(idx)``, the potential of the chains ``idx``; the subset is
    evaluated on that."""

    def vg(theta):
        COUNTS["host_syncs"] += 1
        idx = active.nonzero().squeeze(1)
        if idx.numel() == theta.shape[0]:
            return value_and_grad(potential, theta)
        on_chains = getattr(potential, "on_chains", None)
        sub = potential if on_chains is None else on_chains(idx)
        u_sub, g_sub = value_and_grad(sub, theta[idx])
        u = torch.zeros_like(theta[:, 0]).index_copy_(0, idx, u_sub)
        g = torch.zeros_like(theta).index_copy_(0, idx, g_sub)
        return u, g

    return vg


def _w(mask, new, old):
    """Masked update: rows of ``mask`` take ``new``."""
    return torch.where(mask.view(-1, *([1] * (new.dim() - 1))), new, old)


def _build_subtree(potential, gen, active0, n_leaf: int, theta, p, grad, eps_signed, cov, h0,
                   max_depth: int):
    """Up to ``n_leaf`` leaves in one direction for the chains of ``active0``,
    with the checkpoint-stack U-turn tests (``_build_subtree``, nuts.py:208-283)."""
    c, dim = theta.shape
    dev, dt = theta.device, theta.dtype
    u = torch.zeros(c, device=dev, dtype=dt)
    theta_prop, grad_prop = theta, grad
    u_prop = torch.full((c,), math.inf, device=dev, dtype=dt)
    log_w = torch.full((c,), -math.inf, device=dev, dtype=dt)
    p_sum = torch.zeros_like(p)
    accept_sum = torch.zeros(c, device=dev, dtype=dt)
    leaf = torch.zeros(c, device=dev, dtype=torch.int64)
    turning = torch.zeros(c, device=dev, dtype=torch.bool)
    diverging = torch.zeros_like(turning)
    p_ckpt = torch.zeros((c, max_depth + 1, dim), device=dev, dtype=dt)
    s_ckpt = torch.zeros_like(p_ckpt)
    ptr = 0
    for k in range(n_leaf):
        act = active0 & ~turning & ~diverging
        COUNTS["host_syncs"] += 1
        if not bool(act.any()):  # one host sync per leapfrog
            break
        th_n, p_n, u_n, g_n = _leapfrog(_masked_vg(potential, act), theta, p, grad, eps_signed, cov)
        h = u_n + _kinetic(p_n, cov)
        h = torch.where(torch.isnan(h), math.inf, h)
        dh = h - h0
        log_w_leaf = -dh
        log_w_new = torch.logaddexp(log_w, log_w_leaf)
        u01 = torch.rand(c, generator=gen, device=dev, dtype=dt)
        take = act & (torch.log(u01) < log_w_leaf - log_w_new)
        theta_prop = _w(take, th_n, theta_prop)
        u_prop = _w(take, u_n, u_prop)
        grad_prop = _w(take, g_n, grad_prop)

        p_sum_new = p_sum + p_n
        if k % 2 == 0:  # left end of a new power-of-2 block
            p_ckpt[:, ptr] = p_n
            s_ckpt[:, ptr] = p_sum
            ptr += 1
        ncheck = _trailing_zeros(k + 1)
        turn = torch.zeros_like(turning)
        v_end = _matvec(cov, p_n)
        for j in range(ncheck):
            idx = max(ptr - 1 - j, 0)
            rho = p_sum_new - s_ckpt[:, idx]
            v_start = _matvec(cov, p_ckpt[:, idx])
            turn = turn | (_dot(v_start, rho) <= 0.0) | (_dot(v_end, rho) <= 0.0)
        ptr -= max(ncheck - 1, 0)

        theta, p, u, grad = _w(act, th_n, theta), _w(act, p_n, p), _w(act, u_n, u), _w(act, g_n, grad)
        log_w = _w(act, log_w_new, log_w)
        p_sum = _w(act, p_sum_new, p_sum)
        accept_sum = accept_sum + torch.where(act, torch.exp(torch.clamp_max(-dh, 0.0)), 0.0)
        leaf = leaf + act.long()
        turning = turning | (act & turn)
        diverging = diverging | (act & (dh > _DIVERGENCE_THRESHOLD))
    return dict(theta=theta, p=p, grad=grad, theta_prop=theta_prop, u_prop=u_prop,
                grad_prop=grad_prop, log_w=log_w, p_sum=p_sum, accept_sum=accept_sum, leaf=leaf,
                turning=turning, diverging=diverging)


def nuts_transition(potential: Callable, state: ChainState, eps, cov, chol_cov,
                    gen: torch.Generator, max_depth: int = 10):
    """One NUTS draw for every chain of ``state`` (``nuts_transition``, nuts.py:286-424)."""
    with span("nuts.transition"):
        return _transition(potential, state, eps, cov, chol_cov, gen, max_depth)


def _transition(potential, state: ChainState, eps, cov, chol_cov, gen: torch.Generator, max_depth: int):
    c, dim = state.theta.shape
    dev, dt = state.theta.device, state.theta.dtype
    xi = torch.randn((c, dim), generator=gen, device=dev, dtype=dt)
    p0 = _sample_momentum(chol_cov, xi)
    h0 = state.u + _kinetic(p0, cov)

    theta_l = theta_r = state.theta
    p_l = p_r = p0
    grad_l = grad_r = state.grad
    theta_prop, u_prop, grad_prop = state.theta, state.u, state.grad
    log_w = torch.zeros(c, device=dev, dtype=dt)
    p_sum = p0
    depth = torch.zeros(c, device=dev, dtype=torch.int64)
    n_leaf = torch.zeros_like(depth)
    done = torch.zeros(c, device=dev, dtype=torch.bool)
    diverging = torch.zeros_like(done)
    accept_sum = torch.zeros(c, device=dev, dtype=dt)

    for d in range(max_depth):
        active = ~done
        COUNTS["host_syncs"] += 1
        if not bool(active.any()):
            break
        go_right = torch.rand(c, generator=gen, device=dev, dtype=dt) < 0.5
        eps_signed = torch.where(go_right, eps, -eps)
        sub = _build_subtree(
            potential, gen, active, 1 << d,
            _w(go_right, theta_r, theta_l), _w(go_right, p_r, p_l), _w(go_right, grad_r, grad_l),
            eps_signed, cov, h0, max_depth,
        )
        valid = active & ~sub["turning"] & ~sub["diverging"]
        u01 = torch.rand(c, generator=gen, device=dev, dtype=dt)
        log_ratio = sub["log_w"] - log_w
        take = valid & (torch.log(u01) < torch.clamp_max(log_ratio, 0.0))
        theta_prop = _w(take, sub["theta_prop"], theta_prop)
        u_prop = _w(take, sub["u_prop"], u_prop)
        grad_prop = _w(take, sub["grad_prop"], grad_prop)
        log_w = _w(valid, torch.logaddexp(log_w, sub["log_w"]), log_w)

        ext_l, ext_r = valid & ~go_right, valid & go_right
        theta_l, p_l, grad_l = (_w(ext_l, sub[k], x) for k, x in
                                (("theta", theta_l), ("p", p_l), ("grad", grad_l)))
        theta_r, p_r, grad_r = (_w(ext_r, sub[k], x) for k, x in
                                (("theta", theta_r), ("p", p_r), ("grad", grad_r)))
        p_sum = _w(valid, p_sum + sub["p_sum"], p_sum)
        turning_global = (_dot(_matvec(cov, p_l), p_sum) <= 0.0) | (_dot(_matvec(cov, p_r), p_sum) <= 0.0)

        depth = depth + active.long()
        diverging = diverging | (active & sub["diverging"])
        accept_sum = accept_sum + torch.where(active, sub["accept_sum"], 0.0)
        n_leaf = n_leaf + torch.where(active, sub["leaf"], 0)
        done = done | (active & (~valid | turning_global))

    accept_prob = accept_sum / torch.clamp_min(n_leaf, 1).to(dt)
    stats = NutsStats(accept_prob=accept_prob, diverging=diverging, tree_depth=depth,
                      n_leapfrog=n_leaf, energy=u_prop, step_size=eps)
    return ChainState(theta_prop, u_prop, grad_prop), stats


def _find_reasonable_eps(potential: Callable, state: ChainState, p0, cov, max_steps: int = 60):
    """Double or halve each chain's step from 1 until its one-step accept
    probability crosses 0.5 (``_find_reasonable_eps``, nuts.py:432-465), from
    the momentum ``p0`` (C, dim).  One batched value+grad per doubling or
    halving, for the chains still searching; at most ``max_steps`` of them."""
    h0 = state.u + _kinetic(p0, cov)

    def accept_prob(eps, active):
        _, p1, u1, _ = _leapfrog(_masked_vg(potential, active), state.theta, p0, state.grad, eps, cov)
        h1 = u1 + _kinetic(p1, cov)
        h1 = torch.where(torch.isnan(h1), math.inf, h1)
        return torch.exp(torch.clamp_max(h0 - h1, 0.0))

    eps = torch.ones_like(state.u)
    ap = accept_prob(eps, torch.ones_like(eps, dtype=torch.bool))
    up = ap > 0.5
    factor = torch.where(up, 2.0, 0.5).to(eps.dtype)
    for _ in range(max_steps):
        searching = torch.where(up, ap > 0.5, ap < 0.5)
        COUNTS["host_syncs"] += 1
        if not bool(searching.any()):  # one host sync per step
            break
        eps = torch.where(searching, eps * factor, eps)
        ap = torch.where(searching, accept_prob(eps, searching), ap)
    return eps


def _da_init(eps) -> _DualAveragingState:
    zero = torch.zeros_like(eps)
    return _DualAveragingState(torch.log(eps), zero, zero, torch.log(10.0 * eps), zero)


def _da_update(da: _DualAveragingState, accept_prob, cfg: NutsConfig) -> _DualAveragingState:
    t = da.t + 1.0
    eta_h = 1.0 / (t + cfg.da_t0)
    h_bar = (1.0 - eta_h) * da.h_bar + eta_h * (cfg.target_accept - accept_prob)
    log_eps = da.mu - torch.sqrt(t) / cfg.da_gamma * h_bar
    eta_x = t ** (-cfg.da_kappa)
    log_eps_bar = eta_x * log_eps + (1.0 - eta_x) * da.log_eps_bar
    return _DualAveragingState(log_eps, log_eps_bar, h_bar, da.mu, t)


def _welford_init(c: int, dim: int, like: torch.Tensor) -> _WelfordState:
    return _WelfordState(like.new_zeros(c), like.new_zeros((c, dim)), like.new_zeros((c, dim, dim)))


def _welford_update(w: _WelfordState, x) -> _WelfordState:
    count = w.count + 1.0
    delta = x - w.mean
    mean = w.mean + delta / count[:, None]
    m2 = w.m2 + delta[:, :, None] * (x - mean)[:, None, :]
    return _WelfordState(count, mean, m2)


def _welford_cov(w: _WelfordState, regularize: bool = True):
    n = torch.clamp_min(w.count, 2.0)[:, None, None]
    cov = w.m2 / (n - 1.0)
    if regularize:  # Stan's shrinkage toward a scaled identity
        shrink = n / (n + 5.0)
        cov = shrink * cov + 1e-3 * (1.0 - shrink) * torch.eye(cov.shape[-1], dtype=cov.dtype,
                                                                 device=cov.device)
    return cov


def _pool_welford(w: _WelfordState) -> _WelfordState:
    """The chains' Welford states combined (Chan et al.), broadcast back over the chains."""
    c = w.count.shape[0]
    n_total = w.count.sum()
    mean = (w.count[:, None] * w.mean).sum(0) / torch.clamp_min(n_total, 1.0)
    delta = w.mean - mean
    m2 = w.m2.sum(0) + (w.count[:, None, None] * delta[:, :, None] * delta[:, None, :]).sum(0)
    return _WelfordState(n_total.expand(c), mean.expand_as(w.mean), m2.expand_as(w.m2))


def _end_window(cov, chol, da: _DualAveragingState, wf: _WelfordState, shared_mass: bool = False):
    """The window's mass-matrix update and the dual-averaging reset; a chain
    whose new covariance has no Cholesky factor keeps its old matrices."""
    if shared_mass:
        wf = _pool_welford(wf)
    new_cov = _welford_cov(wf)
    new_chol, info = torch.linalg.cholesky_ex(new_cov)
    bad = (info != 0) | torch.isnan(new_chol).flatten(1).any(1)
    c, dim = wf.mean.shape
    return (_w(bad, cov, new_cov), _w(bad, chol, new_chol), _da_init(torch.exp(da.log_eps)),
            _welford_init(c, dim, cov))


def warmup_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan-style windows as segments ``[(n_steps, update_mass_at_end), ...]``:
    fast buffers adapt the step size only; slow windows double in length and
    each ends with a dense-mass update and a dual-averaging reset."""
    if num_warmup < 20:
        return [(num_warmup, False)] if num_warmup else []
    if init_buffer + term_buffer + base_window > num_warmup:
        scale = num_warmup / (init_buffer + term_buffer + base_window)
        init_buffer = int(init_buffer * scale)
        term_buffer = int(term_buffer * scale)
        base_window = num_warmup - init_buffer - term_buffer
    segments = [(init_buffer, False)]
    start = init_buffer
    size = base_window
    while start < num_warmup - term_buffer:
        end = start + size
        if end + 2 * size > num_warmup - term_buffer:
            end = num_warmup - term_buffer
        segments.append((end - start, True))
        start = end
        size *= 2
    if term_buffer:
        segments.append((term_buffer, False))
    return segments


def _stack_stats(stats) -> NutsStats:
    return NutsStats(*(torch.stack(xs, dim=1) for xs in zip(*stats)))


def _generator(generator, seed, dev):
    return generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)


def run_warmup(potential: Callable, theta0: torch.Tensor, num_warmup: int,
               cfg: NutsConfig = NutsConfig(), generator: Optional[torch.Generator] = None,
               seed: int = 0, device=None,
               progress: Optional[Callable[[int, int, float], None]] = None,
               chunk_size: Optional[int] = None):
    """Windowed warmup of every chain of ``theta0`` (C, dim) (``run_warmup``,
    nuts.py:663-711): returns ``(WarmupResult, NutsStats)``, the second with
    each warmup transition's statistics, (C, num_warmup) each (``None``
    without transitions).  The final step size is ``exp(log_eps_bar)``.

    ``device=None`` means CUDA and raises without it.  The step-size search
    starts from a standard-normal momentum and the identity mass matrix.
    ``progress(step, num_warmup, mean_accept)`` is called after every chunk
    of at most ``chunk_size`` transitions of a window (``None``: after every
    transition).  In the JAX package ``chunk_size`` bounds the steps of one
    compiled execution; here nothing is compiled, so it only spaces the
    reports, as the fleet's ``chunk_size`` does.
    """
    dev = resolve_device(device)
    gen = _generator(generator, seed, dev)
    theta0 = theta0.to(dev)
    c, dim = theta0.shape
    u, grad = value_and_grad(potential, theta0)
    state = ChainState(theta0, u, grad)
    eye = torch.eye(dim, dtype=theta0.dtype, device=dev).expand(c, dim, dim).contiguous()
    p0 = torch.randn((c, dim), generator=gen, device=dev, dtype=theta0.dtype)
    eps = _find_reasonable_eps(potential, state, p0, eye)
    cov, chol = eye, eye
    da, wf = _da_init(eps), _welford_init(c, dim, theta0)
    stats, step = [], 0
    for n_steps, update_mass in warmup_schedule(num_warmup):
        for k in range(n_steps):
            state, st = nuts_transition(potential, state, torch.exp(da.log_eps), cov, chol, gen,
                                        cfg.max_depth)
            da = _da_update(da, st.accept_prob, cfg)
            wf = _welford_update(wf, state.theta)
            stats.append(st)
            step += 1
            if progress is not None and (chunk_size is None or (k + 1) % chunk_size == 0 or k + 1 == n_steps):
                progress(step, num_warmup, float(st.accept_prob.mean()))
        if update_mass:
            cov, chol, da, wf = _end_window(cov, chol, da, wf, cfg.shared_mass)
        else:  # a fast buffer's statistics are dropped; the step size carries on
            wf = _welford_init(c, dim, theta0)
    warm = WarmupResult(state, torch.exp(da.log_eps_bar), cov, chol)
    return warm, (_stack_stats(stats) if stats else None)


def sampling_checkpoint_file(checkpoint_path) -> str:
    """``<path>.sampling.npz``, the mid-sampling checkpoint beside a warmup checkpoint."""
    from bumpcosmology_torch.utils.checkpoint import checkpoint_file

    return checkpoint_file(checkpoint_path)[: -len(".npz")] + ".sampling.npz"


def _save_sampling_ckpt(path: str, done: int, gen: torch.Generator, state: ChainState, thetas, stats):
    """The reference's array names and draws-first layout; ``key`` holds the
    generator's state."""
    payload = {"done": np.asarray(done), "key": gen.get_state().numpy(),
               "state_theta": state.theta.cpu().numpy(), "state_u": state.u.cpu().numpy(),
               "state_grad": state.grad.cpu().numpy(), "thetas": torch.stack(thetas).cpu().numpy()}
    for name, xs in zip(NutsStats._fields, zip(*stats)):
        payload["stats_" + name] = torch.stack(xs).cpu().numpy()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_sampling_ckpt(path: str, gen: torch.Generator, dtype, dev):
    with np.load(path) as d:
        if d["key"].dtype != np.uint8:
            raise ValueError(f"{path}: 'key' is not a torch generator state (written by another package?)")
        gen.set_state(torch.as_tensor(d["key"]))
        t = lambda k: torch.as_tensor(d[k], device=dev)  # noqa: E731
        state = ChainState(t("state_theta").to(dtype), t("state_u").to(dtype), t("state_grad").to(dtype))
        thetas = list(t("thetas").to(dtype).unbind(0))
        stats = [NutsStats(*s) for s in zip(*(t("stats_" + name).unbind(0) for name in NutsStats._fields))]
        return state, thetas, stats


def run_sampling(potential: Callable, warm: WarmupResult, num_samples: int,
                 cfg: NutsConfig = NutsConfig(), generator: Optional[torch.Generator] = None,
                 seed: int = 0, device=None,
                 progress: Optional[Callable[[int, int], None]] = None,
                 checkpoint_path=None, checkpoint_every: int = 100) -> SamplingResult:
    """Post-warmup sampling of every chain of ``warm`` (``run_sampling``,
    nuts.py:773-835).

    ``device=None`` means CUDA and raises without it.  The stored ``u`` and
    ``grad`` are recomputed with this package's potential first — a state
    saved by another implementation (e.g. the TPU bracket path at
    ``n_det=256``) carries that implementation's values — and the largest
    ``|Δu|`` is returned in the result.

    With ``checkpoint_path``, the draws so far, the chain state and the
    generator's state go to ``<path>.sampling.npz`` every ``checkpoint_every``
    draws; a later call with the same path resumes there and makes the draws
    an uninterrupted run would have made.  The file is removed at the end.
    """
    dev = resolve_device(device)
    warm = warm.to(dev)
    gen = _generator(generator, seed, dev)
    u, grad = value_and_grad(potential, warm.state.theta)
    max_abs_du = float((u - warm.state.u).abs().max())
    state = ChainState(warm.state.theta, u, grad)
    thetas, stats = [], []
    ckpt = sampling_checkpoint_file(checkpoint_path) if checkpoint_path is not None else None
    if ckpt is not None and os.path.exists(ckpt):
        state, thetas, stats = _load_sampling_ckpt(ckpt, gen, u.dtype, dev)
        thetas, stats = thetas[:num_samples], stats[:num_samples]
        if progress is not None:
            progress(len(thetas), num_samples)
    since_ckpt = 0
    while len(thetas) < num_samples:
        state, st = nuts_transition(potential, state, warm.eps, warm.cov, warm.chol_cov, gen,
                                    cfg.max_depth)
        thetas.append(state.theta)
        stats.append(st)
        since_ckpt += 1
        if ckpt is not None and since_ckpt >= checkpoint_every and len(thetas) < num_samples:
            _save_sampling_ckpt(ckpt, len(thetas), gen, state, thetas, stats)
            since_ckpt = 0
        if progress is not None:
            progress(len(thetas), num_samples)
    if ckpt is not None and os.path.exists(ckpt):
        os.remove(ckpt)
    return SamplingResult(torch.stack(thetas, dim=1), _stack_stats(stats),
                          WarmupResult(state, warm.eps, warm.cov, warm.chol_cov), max_abs_du)


def run_nuts(potential: Callable, theta0: torch.Tensor, num_warmup: int = 1000,
             num_samples: int = 1000, cfg: NutsConfig = NutsConfig(),
             generator: Optional[torch.Generator] = None, seed: int = 0, device=None):
    """Warmup, then sampling, from one generator (``run_nuts``, nuts.py:838-851):
    returns ``(draws (C, num_samples, dim), NutsStats, warmup state, final state)``."""
    dev = resolve_device(device)
    gen = _generator(generator, seed, dev)
    warm, _ = run_warmup(potential, theta0, num_warmup, cfg, generator=gen, device=dev)
    res = run_sampling(potential, warm, num_samples, cfg, generator=gen, device=dev)
    return res.thetas, res.stats, warm, res.warm
