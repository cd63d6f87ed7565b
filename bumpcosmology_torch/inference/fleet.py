"""Fleet fits: many independent single-chain NUTS fits in lockstep (L2);
counterpart of the JAX package's ``inference/fleet.py``.

The calibration suite fits S small catalogs, each with one chain.  The JAX
package stacks the catalogs on a fleet axis and ``vmap``s each NUTS
transition over paired (chain state, catalog) slices inside jitted chunks of
steps.  Here the catalogs are one fleet's data
(:func:`~bumpcosmology_torch.inference.likelihoods.stack_fleet`) and the S
fits are the S chains of one batched NUTS run, chain ``s`` reading catalog
``s``: every batched value+grad serves the whole fleet (on the joint model,
one kernel-B launch each way over S per-chain query tables).  Each fit keeps
its own step size and mass matrix: the dual averaging, Welford and window
updates of :mod:`~bumpcosmology_torch.inference.nuts` act per chain
(``shared_mass=False``), through the same Stan windows.

``chunk_size``: in the JAX package, the steps of one compiled execution (a
deadline bounds an execution on a remote TPU).  Here nothing is compiled and
every leapfrog already meets the host (NUTS's active-chain test), so
``chunk_size`` only sets how many transitions pass between two ``progress``
reports — the same report points as the JAX package's, each window cut into
chunks of at most ``chunk_size`` steps.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference import nuts as N
from bumpcosmology_torch.inference.likelihoods import take_fleet
from bumpcosmology_torch.inference.model import value_and_grad

__all__ = ["fleet_fit", "FleetResult", "FleetPotential"]

_CHUNK = 25


class FleetResult(NamedTuple):
    thetas: torch.Tensor  # (S, num_samples, dim) unconstrained draws
    accept: torch.Tensor  # (S, num_samples)
    eps: torch.Tensor  # (S,) adapted step sizes
    warmup_s: float = 0.0  # host clock, the step-size search included
    sampling_s: float = 0.0


class FleetPotential:
    """U(θ) ``(S, dim) → (S,)`` of a fleet: ``make_pot(datas)``, and for a
    subset of the chains (``on_chains``, which NUTS calls while only some
    chains still integrate) ``make_pot`` of those chains' catalogs."""

    def __init__(self, make_pot: Callable, datas):
        self.make_pot, self.datas = make_pot, datas
        self._pot = make_pot(datas)

    def __call__(self, theta: torch.Tensor) -> torch.Tensor:
        return self._pot(theta)

    def on_chains(self, idx: torch.Tensor) -> Callable:
        return self.make_pot(take_fleet(self.datas, idx))


def fleet_fit(
    make_pot: Callable,
    datas,
    theta0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_warmup: int = 300,
    num_samples: int = 256,
    cfg: N.NutsConfig = N.NutsConfig(),
    progress: Optional[Callable[[str, int, int], None]] = None,
    chunk_size: int = _CHUNK,
    seed: int = 0,
    device=None,
) -> FleetResult:
    """Run ``S`` independent single-chain NUTS fits in lockstep.

    ``make_pot(datas) -> potential(theta)`` builds the batched potential of
    a fleet's data (chain ``s`` reading catalog ``s``); ``datas`` is the
    fleet (leading axis S), ``theta0`` is (S, dim).  ``progress(phase, done,
    total)`` is called after every chunk of at most ``chunk_size``
    transitions, ``phase`` "warmup" or "sampling".  Draws come from
    ``generator`` (or a generator seeded with ``seed``) on ``device``
    (``None`` means CUDA; it raises without it).
    """
    dev = resolve_device(device)
    gen = N._generator(generator, seed, dev)
    theta0 = theta0.to(dev)
    n_sims, dim = theta0.shape
    pot = FleetPotential(make_pot, datas)

    t0 = time.perf_counter()
    u, grad = value_and_grad(pot, theta0)
    state = N.ChainState(theta0, u, grad)
    eye = torch.eye(dim, dtype=theta0.dtype, device=dev).expand(n_sims, dim, dim).contiguous()
    p0 = torch.randn((n_sims, dim), generator=gen, device=dev, dtype=theta0.dtype)
    eps = N._find_reasonable_eps(pot, state, p0, eye)
    cov, chol = eye, eye
    da, wf = N._da_init(eps), N._welford_init(n_sims, dim, theta0)

    done = 0
    for n_steps, update_mass in N.warmup_schedule(num_warmup):
        left = n_steps
        while left > 0:
            n = min(chunk_size, left)
            for _ in range(n):
                state, st = N.nuts_transition(pot, state, torch.exp(da.log_eps), cov, chol, gen, cfg.max_depth)
                da = N._da_update(da, st.accept_prob, cfg)
                wf = N._welford_update(wf, state.theta)
            left -= n
            done += n
            if progress is not None:
                progress("warmup", done, num_warmup)
        if update_mass:
            cov, chol, da, wf = N._end_window(cov, chol, da, wf, shared_mass=False)
        else:  # a fast buffer's statistics are dropped; the step size carries on
            wf = N._welford_init(n_sims, dim, theta0)
    eps_final = torch.exp(da.log_eps_bar)
    t1 = time.perf_counter()

    thetas, accept = [], []
    while len(thetas) < num_samples:
        for _ in range(min(chunk_size, num_samples - len(thetas))):
            state, st = N.nuts_transition(pot, state, eps_final, cov, chol, gen, cfg.max_depth)
            thetas.append(state.theta)
            accept.append(st.accept_prob)
        if progress is not None:
            progress("sampling", len(thetas), num_samples)
    draws = torch.stack(thetas, dim=1) if thetas else theta0.new_zeros((n_sims, 0, dim))
    acc = torch.stack(accept, dim=1) if accept else theta0.new_zeros((n_sims, 0))
    return FleetResult(draws, acc, eps_final, t1 - t0, time.perf_counter() - t1)
