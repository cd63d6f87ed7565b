"""Batched multinomial NUTS with a dense mass matrix — sampling only (L2);
counterpart of the sampling half of the JAX package's ``inference/nuts.py``.

The JAX package ``vmap``s a per-chain ``while_loop``.  Here the same
iterative scheme (tree doubling, progressive multinomial sampling, the
O(log n) checkpoint stack for the U-turn tests, ``nuts.py:197-424``) runs as
one loop over the whole chain batch: every chain carries an active mask,
updates are masked, and each leapfrog makes one batched value+grad for the
chains still integrating.  While any chain is active the host must know it,
so each leapfrog costs one host synchronisation.

All chains that are still building a subtree share its leaf index, so the
leaf index and the checkpoint pointer are plain integers; a chain that has
stopped keeps its values through the masks.

Mass-matrix products are elementwise multiply-and-sum in full fp32 (never a
matmul, so TF32 cannot reach them).  Warmup (dual averaging, Welford,
windows) and the diagnostics are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.model import value_and_grad

__all__ = ["NutsConfig", "ChainState", "WarmupResult", "NutsStats", "SamplingResult",
           "nuts_transition", "run_sampling"]

_DIVERGENCE_THRESHOLD = 1000.0


class NutsConfig(NamedTuple):
    """Sampling settings.  The JAX package's warmup fields (target accept,
    dual-averaging constants, mass pooling) arrive with the warmup port."""

    max_depth: int = 10


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
    (every caller masks them out)."""

    def vg(theta):
        idx = active.nonzero().squeeze(1)
        if idx.numel() == theta.shape[0]:
            return value_and_grad(potential, theta)
        u_sub, g_sub = value_and_grad(potential, theta[idx])
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


def run_sampling(potential: Callable, warm: WarmupResult, num_samples: int,
                 cfg: NutsConfig = NutsConfig(), generator: Optional[torch.Generator] = None,
                 seed: int = 0, device=None,
                 progress: Optional[Callable[[int, int], None]] = None) -> SamplingResult:
    """Post-warmup sampling of every chain of ``warm`` (``run_sampling``,
    nuts.py:773-835, without the checkpoint file).

    ``device=None`` means CUDA and raises without it.  The stored ``u`` and
    ``grad`` are recomputed with this package's potential first — a state
    saved by another implementation (e.g. the TPU bracket path at
    ``n_det=256``) carries that implementation's values — and the largest
    ``|Δu|`` is returned in the result.
    """
    dev = resolve_device(device)
    warm = warm.to(dev)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    u, grad = value_and_grad(potential, warm.state.theta)
    max_abs_du = float((u - warm.state.u).abs().max())
    state = ChainState(warm.state.theta, u, grad)
    thetas, stats = [], []
    for i in range(num_samples):
        state, st = nuts_transition(potential, state, warm.eps, warm.cov, warm.chol_cov, gen,
                                    cfg.max_depth)
        thetas.append(state.theta)
        stats.append(st)
        if progress is not None:
            progress(i + 1, num_samples)
    stacked = NutsStats(*(torch.stack(xs, dim=1) for xs in zip(*stats)))
    return SamplingResult(torch.stack(thetas, dim=1), stacked,
                          WarmupResult(state, warm.eps, warm.cov, warm.chol_cov), max_abs_du)
