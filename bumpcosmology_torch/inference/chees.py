"""ChEES-HMC: jittered fixed-length HMC with cross-chain trajectory
adaptation (L2); counterpart of the JAX package's ``inference/chees.py``
(Hoffman, Radul & Sountsov 2021).

Every chain takes the same number of leapfrog steps in an iteration,
``ceil(u · T / eps)`` with ``u`` a base-2 Halton jitter shared by the chains,
clipped to ``[1, max_leapfrogs]``.  The count is a host ``int`` fixed before
the trajectory starts, so a trajectory is a plain loop of batched value+grads
over the whole chain batch: no mask, no ``nonzero``, no read of a device
tensor inside it (batched NUTS, :mod:`bumpcosmology_torch.inference.nuts`,
makes one host sync per leapfrog).  An iteration reads the device once, for
``T`` (and ``eps`` with it while ``run_chees`` adapts the step size), and
the mean accept only where ``verbose`` prints it.

The kernel is shared by the chains: one step size, one dense mass matrix and
one trajectory length, taken from chain 0 where a state carries one per
chain.  ``T`` is adapted by Adam on ``log T`` along the ChEES gradient,
estimated across the chain batch; ``run_chees`` also adapts the step size by
dual averaging on the mean accept (its state is one chain's, ``(1,)``) and
the mass matrix from the pooled Welford statistics of Stan's windows.  The
ChEES gradient, Adam, the means over chains and the mass-matrix products are
elementwise sums in full fp32 (no matmul, so TF32 cannot reach them).

Choices of the port, not faults:

* One ``torch.Generator`` draws an iteration's momentum noise ``(C, dim)``
  and then its accept uniforms ``(C,)``; draws cannot match the JAX
  package's key by key.  :func:`_hmc_step` takes both draws as arguments.
* :func:`run_chees_from_warmup` recomputes the warm state's ``u`` and
  ``grad`` with this package's potential before the first iteration and
  returns the largest ``|Δu|``, as ``run_sampling`` does: a state saved by
  another implementation (the TPU bracket path at ``n_det=256``) carries
  that implementation's values, and the first trajectory's ``h0`` would mix
  them in.  On a state of this package's own the recompute changes nothing.
* A chain whose proposal is not finite (a diverging trajectory can reach
  NaN parameters) is left out of the ChEES gradient's means and weights; in
  the JAX package its NaN would reach ``log T`` and stop the run.  With every
  proposal finite the arithmetic is the JAX package's.
* A window's covariance goes through ``cholesky_ex``; the old matrices stay
  where ``info != 0`` or the factor has a NaN.
* Sampling runs one iteration at a time (the JAX package cuts it into
  chunks for the TPU host's 60 s execution deadline) with the Halton index
  running on exactly as there.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.model import value_and_grad
from bumpcosmology_torch.inference.nuts import (
    _DIVERGENCE_THRESHOLD,
    ChainState,
    WarmupResult,
    _da_init,
    _da_update,
    _generator,
    _kinetic,
    _leapfrog,
    _pool_welford,
    _sample_momentum,
    _w,
    _welford_cov,
    _welford_init,
    _welford_update,
    warmup_schedule,
)

__all__ = ["CheesConfig", "CheesResult", "run_chees", "run_chees_from_warmup"]


class CheesConfig(NamedTuple):
    target_accept: float = 0.75
    init_trajectory_length: float = 1.0
    # Adam-style updates on log T (paper defaults)
    adam_lr: float = 0.025
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    max_leapfrogs: int = 1000
    da_gamma: float = 0.05
    da_t0: float = 10.0
    da_kappa: float = 0.75
    # sampling-phase trajectory jitter: lengths are u·T with u ~ halton over
    # [jitter_floor, 1].  A floor > 0 stops spending draws on near-zero
    # trajectories (high autocorrelation per unit cost) while keeping the
    # resonance-breaking jitter; adaptation always jitters over (0, 1] as the
    # ChEES criterion assumes.
    jitter_floor: float = 0.0


class _AdamState(NamedTuple):
    log_t: torch.Tensor  # each (1,)
    m: torch.Tensor
    v: torch.Tensor
    count: torch.Tensor


class CheesResult(NamedTuple):
    thetas: torch.Tensor  # (C, draws, dim)
    accept: torch.Tensor  # (C, draws)
    eps: float
    trajectory_length: float
    n_leapfrog: int  # the sampling phase's mean count, ceil(E[u] T / eps)
    warm: WarmupResult  # the final state with the shared kernel, per chain
    diverging: torch.Tensor  # (C, draws)
    max_abs_du: float = 0.0  # largest |u| change when the warm state was recomputed


def _halton(i: int, base: int = 2) -> float:
    """i-th element of the base-2 Halton sequence in (0, 1)."""
    f, r = 1.0, 0.0
    i = int(i) + 1
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def _n_steps(u: float, t: float, eps: float, max_leapfrogs: int) -> int:
    """``ceil(u T / eps)`` clipped to ``[1, max_leapfrogs]``, in host floats."""
    return int(np.clip(math.ceil(u * t / max(eps, 1e-6)), 1, max_leapfrogs))


def _jitter_steps(i: int, t: float, eps: float, cfg: CheesConfig) -> int:
    """The sampling phase's count for iteration ``i``: ``u`` is the Halton
    jitter stretched over ``[jitter_floor, 1]``."""
    floor = float(cfg.jitter_floor)
    return _n_steps(floor + (1.0 - floor) * _halton(i), t, eps, cfg.max_leapfrogs)


def _hmc_step(vg: Callable, state: ChainState, eps, n_steps: int, cov, chol, xi, uniform):
    """One fixed-length HMC proposal for every chain (``_hmc_step``, the JAX
    package's ``chees.py:90-119``): ``eps`` (C,), ``cov``/``chol`` (C, d, d),
    the momentum noise ``xi`` (C, d) and the accept uniforms (C,).  Returns
    the new state, the accept probabilities, the divergence flags (an energy
    error above 1000 nats) and the proposal (θ', p') for the ChEES gradient.
    The loop makes ``n_steps`` batched value+grads and reads nothing back."""
    p0 = _sample_momentum(chol, xi)
    h0 = state.u + _kinetic(p0, cov)
    theta, p, u, grad = state.theta, p0, state.u, state.grad
    for _ in range(n_steps):
        theta, p, u, grad = _leapfrog(vg, theta, p, grad, eps, cov)
    h1 = u + _kinetic(p, cov)
    h1 = torch.where(torch.isnan(h1), math.inf, h1)
    accept = torch.exp(torch.clamp_max(h0 - h1, 0.0))
    diverging = (h1 - h0) > _DIVERGENCE_THRESHOLD
    take = uniform < accept
    new = ChainState(_w(take, theta, state.theta), _w(take, u, state.u), _w(take, grad, state.grad))
    return new, accept, diverging, theta, p


def _draws(gen: torch.Generator, theta: torch.Tensor):
    """An iteration's draws from ``gen``: the momentum noise (C, d), then the accept uniforms (C,)."""
    c, dim = theta.shape
    xi = torch.randn((c, dim), generator=gen, device=theta.device, dtype=theta.dtype)
    return xi, torch.rand((c,), generator=gen, device=theta.device, dtype=theta.dtype)


def _vg(potential: Callable) -> Callable:
    return lambda th: value_and_grad(potential, th)


def _chees_grad(theta, theta_prop, p_prop, accept):
    """The ChEES criterion's gradient in T, estimated over the chain batch
    (paper eq. 14) from the chains whose proposal is finite; ``(1,)``."""
    ok = torch.isfinite(theta_prop).all(1) & torch.isfinite(p_prop).all(1)
    theta_prop, p_prop = torch.where(ok[:, None], theta_prop, 0.0), torch.where(ok[:, None], p_prop, 0.0)
    d_old = theta - theta.mean(0)
    d_prop = theta_prop - theta_prop.sum(0) / ok.sum().to(theta.dtype)
    delta = (d_prop * d_prop).sum(1) - (d_old * d_old).sum(1)
    proj = (d_prop * p_prop).sum(1)
    accept = torch.where(ok, accept, 0.0)
    w = accept / torch.clamp_min(accept.sum(), 1e-6)
    return torch.where(ok, w * delta * proj, 0.0).sum().reshape(1)


def _adam_update(adam: _AdamState, grad_t, cfg: CheesConfig) -> _AdamState:
    """One Adam ascent step on log T."""
    b1, b2 = cfg.adam_b1, cfg.adam_b2
    count = adam.count + 1.0
    m = b1 * adam.m + (1 - b1) * grad_t
    v = b2 * adam.v + (1 - b2) * grad_t * grad_t
    m_hat = m / (1 - b1 ** count)
    v_hat = v / (1 - b2 ** count)
    return _AdamState(adam.log_t + cfg.adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8), m, v, count)


def _adam_init(t: float, like: torch.Tensor) -> _AdamState:
    zero = like.new_zeros(1)
    return _AdamState(torch.log(like.new_full((1,), t)), zero, zero, zero)


def _t_adapt_iteration(potential, state, eps, n_steps, cov, chol, adam, xi, uniform, cfg: CheesConfig):
    """One trajectory-length iteration at fixed (eps, mass) (``_t_adapt_iteration``,
    ``chees.py:193-223``): the batched HMC step and Adam on log T.  Returns the
    new state, the new Adam state and the mean accept (a device tensor)."""
    new, accept, _, theta_prop, p_prop = _hmc_step(_vg(potential), state, eps, n_steps, cov, chol, xi, uniform)
    adam = _adam_update(adam, _chees_grad(state.theta, theta_prop, p_prop, accept), cfg)
    return new, adam, accept.mean()


def _chees_iteration(potential, state, eps, n_steps, cov, chol, adam, da, wf, xi, uniform, cfg: CheesConfig):
    """One adaptation iteration (``_chees_iteration``, ``chees.py:122-158``):
    the batched HMC step, Adam on log T, dual averaging on the mean accept and
    the chains' Welford update.  ``da`` holds one chain's state, ``(1,)``."""
    new, adam, mean_accept = _t_adapt_iteration(potential, state, eps, n_steps, cov, chol, adam, xi, uniform, cfg)
    return new, adam, _da_update(da, mean_accept.reshape(1), cfg), _welford_update(wf, new.theta), mean_accept


def _sample(potential, state, eps, t: float, eps_host: float, cov, chol, gen, cfg: CheesConfig,
            num_samples: int, it0: int):
    """The sampling phase: ``num_samples`` iterations at fixed (eps, T, mass)
    with the Halton jitter running on from ``it0``.  Returns the final state
    and the draws, accept probabilities and divergences, (C, num_samples[, d])."""
    thetas, accepts, divs = [], [], []
    for i in range(num_samples):
        n = _jitter_steps(it0 + i, t, eps_host, cfg)
        state, accept, div, _, _ = _hmc_step(_vg(potential), state, eps, n, cov, chol, *_draws(gen, state.theta))
        thetas.append(state.theta)
        accepts.append(accept)
        divs.append(div)
    c, dim = state.theta.shape
    if not thetas:  # an adapt-only call (e.g. to measure T)
        x = state.theta
        return state, x.new_zeros((c, 0, dim)), x.new_zeros((c, 0)), x.new_zeros((c, 0), dtype=torch.bool)
    return state, torch.stack(thetas, 1), torch.stack(accepts, 1), torch.stack(divs, 1)


def _mean_steps(t: float, eps: float, cfg: CheesConfig) -> int:
    """The sampling phase's mean count: ``ceil(E[u] T / eps)``."""
    return _n_steps(0.5 * (1.0 + float(cfg.jitter_floor)), t, eps, cfg.max_leapfrogs)


def _shared_kernel(eps, cov, chol, c: int):
    """Chain 0's kernel, broadcast over ``c`` chains: eps (C,), cov and chol (C, d, d)."""
    dim = cov.shape[-1]
    return (eps[:1].expand(c), cov[:1].expand(c, dim, dim), chol[:1].expand(c, dim, dim))


def run_chees_from_warmup(potential: Callable, warm: WarmupResult, num_adapt: int = 150,
                          num_samples: int = 500, cfg: CheesConfig = CheesConfig(max_leapfrogs=96),
                          init_steps: int = 16, generator: Optional[torch.Generator] = None, seed: int = 0,
                          device=None, verbose: bool = False) -> CheesResult:
    """ChEES sampling from a NUTS-adapted state (``run_chees_from_warmup``,
    ``chees.py:226-343``): ``warm``'s step size and mass matrix (chain 0's,
    shared) stay fixed; only T is adapted, for ``num_adapt`` iterations from
    ``init_steps · eps``; then ``num_samples`` draws with Halton-jittered
    lengths.  ``device=None`` means CUDA and raises without it."""
    dev = resolve_device(device)
    warm = warm.to(dev)
    gen = _generator(generator, seed, dev)
    c, dim = warm.state.theta.shape
    u, grad = value_and_grad(potential, warm.state.theta)
    max_abs_du = float((u - warm.state.u).abs().max())
    state = ChainState(warm.state.theta, u, grad)
    eps, cov, chol = _shared_kernel(warm.eps, warm.cov, warm.chol_cov, c)
    eps_host = float(eps[0])
    adam = _adam_init(float(init_steps) * eps_host, warm.state.theta)

    accs = []
    for it in range(num_adapt):
        t_now = float(torch.exp(adam.log_t))  # the iteration's one host read
        n = _n_steps(_halton(it), t_now, eps_host, cfg.max_leapfrogs)
        state, adam, acc = _t_adapt_iteration(potential, state, eps, n, cov, chol, adam, *_draws(gen, state.theta),
                                              cfg)
        accs.append(acc)
        if verbose and (it + 1) % 50 == 0:
            print(f"[chees/adapt] {it + 1}/{num_adapt} T={t_now:.3g} "
                  f"accept={float(torch.stack(accs[-50:]).mean()):.3f}")

    t_final = float(torch.exp(adam.log_t))
    n_mean = _mean_steps(t_final, eps_host, cfg)
    if verbose:
        print(f"[chees] T={t_final:.4g} eps={eps_host:.4g} -> ~{n_mean} leapfrogs/draw (jittered)")
    state, thetas, accepts, divs = _sample(potential, state, eps, t_final, eps_host, cov, chol, gen, cfg,
                                           num_samples, num_adapt)
    out_warm = WarmupResult(state, eps.contiguous(), cov.contiguous(), chol.contiguous())
    return CheesResult(thetas=thetas, accept=accepts, eps=eps_host, trajectory_length=t_final,
                       n_leapfrog=n_mean, warm=out_warm, diverging=divs, max_abs_du=max_abs_du)


def run_chees(potential: Callable, theta0: torch.Tensor, num_warmup: int = 500, num_samples: int = 500,
              cfg: CheesConfig = CheesConfig(), generator: Optional[torch.Generator] = None, seed: int = 0,
              device=None, verbose: bool = False) -> CheesResult:
    """Adaptive ChEES-HMC from ``theta0`` (C, dim) (``run_chees``,
    ``chees.py:346-446``): a shared step size (dual averaging from 0.1), T
    (Adam from ``cfg.init_trajectory_length``) and dense mass matrix (the
    pooled Welford covariance at the end of each of Stan's slow windows), then
    ``num_samples`` draws at ``exp(log_eps_bar)`` with jittered lengths.
    ``device=None`` means CUDA and raises without it."""
    dev = resolve_device(device)
    gen = _generator(generator, seed, dev)
    theta0 = theta0.to(dev)
    c, dim = theta0.shape
    u, grad = value_and_grad(potential, theta0)
    state = ChainState(theta0, u, grad)
    eye = torch.eye(dim, dtype=theta0.dtype, device=dev)
    cov = chol = eye.expand(c, dim, dim)
    da = _da_init(theta0.new_full((1,), 0.1))
    adam = _adam_init(cfg.init_trajectory_length, theta0)
    wf = _welford_init(c, dim, theta0)

    it = 0
    for seg_len, update_mass in warmup_schedule(num_warmup):
        for _ in range(seg_len):
            eps = torch.exp(da.log_eps)
            t_now, eps_host = torch.cat([torch.exp(adam.log_t), eps]).tolist()  # the iteration's one host read
            n = _n_steps(_halton(it), t_now, eps_host, cfg.max_leapfrogs)
            state, adam, da, wf, _ = _chees_iteration(potential, state, eps.expand(c), n, cov, chol, adam, da,
                                                      wf, *_draws(gen, theta0), cfg)
            it += 1
        if update_mass:  # the pooled covariance, unless it has no Cholesky factor
            new_cov = _welford_cov(_pool_welford(wf))[:1]
            new_chol, info = torch.linalg.cholesky_ex(new_cov)
            bad = ((info != 0) | torch.isnan(new_chol).flatten(1).any(1))[:, None, None]
            cov = torch.where(bad, cov[:1], new_cov).expand(c, dim, dim)
            chol = torch.where(bad, chol[:1], new_chol).expand(c, dim, dim)
            da = _da_init(torch.exp(da.log_eps))
        wf = _welford_init(c, dim, theta0)

    eps = torch.exp(da.log_eps_bar)
    t_final, eps_host = torch.cat([torch.exp(adam.log_t), eps]).tolist()
    n_mean = _mean_steps(t_final, eps_host, cfg)
    if verbose:
        print(f"[chees] adapted eps={eps_host:.4g} T={t_final:.4g} -> ~{n_mean} leapfrogs/draw (jittered)")
    state, thetas, accepts, divs = _sample(potential, state, eps.expand(c), t_final, eps_host, cov, chol, gen,
                                           cfg, num_samples, it)
    warm = WarmupResult(state, eps.expand(c).contiguous(), cov.contiguous(), chol.contiguous())
    return CheesResult(thetas=thetas, accept=accepts, eps=eps_host, trajectory_length=t_final,
                       n_leapfrog=n_mean, warm=warm, diverging=divs)
