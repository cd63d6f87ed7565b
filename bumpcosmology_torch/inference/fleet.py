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

import os
import time
from typing import Callable, NamedTuple, Optional

import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference import nuts as N
from bumpcosmology_torch.inference.likelihoods import take_fleet
from bumpcosmology_torch.inference.model import value_and_grad
from bumpcosmology_torch.utils.checkpoint import checkpoint_file, load_generator_state, load_warmup, save_warmup

__all__ = ["fleet_fit", "FleetResult", "FleetPotential"]

_CHUNK = 25


class FleetResult(NamedTuple):
    thetas: torch.Tensor  # (S, num_samples, dim) unconstrained draws
    accept: torch.Tensor  # (S, num_samples)
    eps: torch.Tensor  # (S,) adapted step sizes
    warmup_s: float = 0.0  # host clock, the step-size search included
    sampling_s: float = 0.0
    warmup_evals: int = 0  # batched value+grads of the fleet (or of its chains still integrating)
    sampling_evals: int = 0
    divergences: int = 0  # divergent transitions among the draws, over every fit


class FleetPotential:
    """U(θ) ``(S, dim) → (S,)`` of a fleet: ``make_pot(datas)``, and for a
    subset of the chains (``on_chains``, which NUTS calls while only some
    chains still integrate) ``make_pot`` of those chains' catalogs.
    ``calls`` counts the evaluations of either."""

    def __init__(self, make_pot: Callable, datas):
        self.make_pot, self.datas = make_pot, datas
        self._pot = make_pot(datas)
        self.calls = 0

    def __call__(self, theta: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        return self._pot(theta)

    def on_chains(self, idx: torch.Tensor) -> Callable:
        pot = self.make_pot(take_fleet(self.datas, idx))

        def counted(theta):
            self.calls += 1
            return pot(theta)

        return counted


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
    checkpoint_path: Optional[str] = None,
) -> FleetResult:
    """Run ``S`` independent single-chain NUTS fits in lockstep.

    ``make_pot(datas) -> potential(theta)`` builds the batched potential of
    a fleet's data (chain ``s`` reading catalog ``s``); ``datas`` is the
    fleet (leading axis S), ``theta0`` is (S, dim).  ``progress(phase, done,
    total)`` is called after every chunk of at most ``chunk_size``
    transitions, ``phase`` "warmup" or "sampling".  Draws come from
    ``generator`` (or a generator seeded with ``seed``) on ``device``
    (``None`` means CUDA; it raises without it).

    ``checkpoint_path`` splits a fit into two runs (the JAX package's fleet
    has no such option; a suite longer than one job needs it): the adapted
    state and the generator's state are written there after the warmup,
    and a fit that finds them there skips its warmup and samples from them,
    giving the draws of the unsplit fit bit for bit.  ``None`` (the
    default) changes nothing.
    """
    dev = resolve_device(device)
    gen = N._generator(generator, seed, dev)
    theta0 = theta0.to(dev)
    n_sims, dim = theta0.shape
    pot = FleetPotential(make_pot, datas)

    t0 = time.perf_counter()
    if checkpoint_path is not None and os.path.exists(checkpoint_file(checkpoint_path)):
        warm = load_warmup(checkpoint_path, device=dev, dtype=theta0.dtype)
        if warm.state.theta.shape != theta0.shape:
            raise ValueError(f"fleet_fit: the checkpoint holds {tuple(warm.state.theta.shape)} positions, "
                             f"this fleet {tuple(theta0.shape)}")
        gen.set_state(load_generator_state(checkpoint_path))
        return _sample(pot, warm.state, warm.eps, warm.cov, warm.chol_cov, gen, num_samples, cfg, progress,
                       chunk_size, dev, 0.0, 0, time.perf_counter())
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
    if checkpoint_path is not None:
        save_warmup(checkpoint_path, N.WarmupResult(state, eps_final, cov, chol), generator=gen)
    t1 = time.perf_counter()
    return _sample(pot, state, eps_final, cov, chol, gen, num_samples, cfg, progress, chunk_size, dev, t1 - t0,
                   pot.calls, t1)


def _sample(pot, state, eps, cov, chol, gen, num_samples, cfg, progress, chunk_size, dev, warmup_s,
            warmup_evals, t1) -> FleetResult:
    """The sampling phase of :func:`fleet_fit` from an adapted state."""
    n_sims, dim = state.theta.shape
    thetas, accept = [], []
    divergences = torch.zeros((), dtype=torch.int64, device=dev)
    while len(thetas) < num_samples:
        for _ in range(min(chunk_size, num_samples - len(thetas))):
            state, st = N.nuts_transition(pot, state, eps, cov, chol, gen, cfg.max_depth)
            thetas.append(state.theta)
            accept.append(st.accept_prob)
            divergences += st.diverging.sum()
        if progress is not None:
            progress("sampling", len(thetas), num_samples)
    draws = torch.stack(thetas, dim=1) if thetas else state.theta.new_zeros((n_sims, 0, dim))
    acc = torch.stack(accept, dim=1) if accept else state.theta.new_zeros((n_sims, 0))
    return FleetResult(draws, acc, eps, warmup_s, time.perf_counter() - t1, warmup_evals, pot.calls - warmup_evals,
                       int(divergences))
