"""Fitting: ModelSpec → posterior draws, statistics and adapted state
(L4); counterpart of the JAX package's ``inference/sampler.py`` with its
three samplers: ``"nuts"``, ``"chees"`` and ``"nuts+chees"``
(:mod:`bumpcosmology_torch.inference.chees`).

Chains run as one batch on ``device`` (``None`` means CUDA).  The
deterministic sites are a separate post-pass in chunks of draws, each chunk
one chain batch of the model, so the sampling loop carries no
predictive-grid work.  One ``torch.Generator`` drives the prior draws, the
warmup and the sampling, in that order.

On a mesh (:func:`~bumpcosmology_torch.parallel.make_mesh`) each chain row
runs its share of the chains on a spec built from data split along the
mesh's ``data`` axis; the ranks of a row draw from one seed and so take the
same steps, and the rows' draws are gathered on every rank.
"""
from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.chees import run_chees, run_chees_from_warmup
from bumpcosmology_torch.inference.diagnostics import summary
from bumpcosmology_torch.inference.model import ModelSpec, constrain, make_potential, prior_sample
from bumpcosmology_torch.inference.nuts import NutsConfig, WarmupResult, run_sampling, run_warmup
from bumpcosmology_torch.utils.checkpoint import checkpoint_file, load_warmup, save_warmup

__all__ = ["FitResult", "fit", "compute_deterministics"]


def _finite_prior_init(spec: ModelSpec, potential: Callable, gen: torch.Generator, num_chains: int,
                       max_tries: int = 50) -> torch.Tensor:
    """Prior draws (unconstrained, ``(num_chains, dim)``) with a finite
    potential: only the chains whose potential is not finite are redrawn, up
    to ``max_tries`` times (``_finite_prior_init``, sampler.py:34-56).  A prior
    draw can put every PE sample of an event outside the bump's support,
    where the likelihood is exactly zero."""
    theta = prior_sample(spec, gen, (num_chains,))
    for _ in range(max_tries):
        with torch.no_grad():
            bad = ~torch.isfinite(potential(theta))
        if not bool(bad.any()):
            return theta
        theta = torch.where(bad[:, None], prior_sample(spec, gen, (num_chains,)), theta)
    raise RuntimeError(
        f"could not find finite-potential initializations for {int(bad.sum())} "
        f"chain(s) after {max_tries} prior redraws — check the model/data"
    )


class FitResult(NamedTuple):
    posterior: Dict[str, np.ndarray]  # site -> (chains, draws) or (chains, draws, k)
    sample_stats: Dict[str, np.ndarray]
    warmup_state: WarmupResult  # adapted state (checkpointable)
    final_state: WarmupResult  # post-sampling state (for continuation)
    timings: Dict[str, float]

    def summary(self):
        return summary({k: v for k, v in self.posterior.items() if np.ndim(v) == 2})


def compute_deterministics(spec: ModelSpec, theta: torch.Tensor,
                           det_fn: Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]],
                           batch_size: int = 128) -> Dict[str, np.ndarray]:
    """Deterministic sites of every draw of ``theta`` (chains, draws, dim):
    ``det_fn`` takes batched sites ``(B,)`` and is called on chunks of
    ``batch_size`` draws (``compute_deterministics``, sampler.py:70-86)."""
    nchains, ndraws, dim = theta.shape
    flat = theta.reshape(nchains * ndraws, dim)
    chunks = []
    with torch.no_grad():
        for lo in range(0, flat.shape[0], batch_size):
            out = det_fn(constrain(spec, flat[lo:lo + batch_size]))
            chunks.append({k: v.cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([ch[k] for ch in chunks]).reshape((nchains, ndraws) + chunks[0][k].shape[1:])
            for k in chunks[0]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _fit_chees(spec, potential, gen, num_warmup, num_samples, num_chains, deterministics_fn, verbose,
               dev) -> FitResult:
    """The self-contained ChEES-HMC backend of :func:`fit` (``_fit_chees``,
    sampler.py:89-123): from prior draws, with its own adaptation."""
    timings: Dict[str, float] = {}
    init_theta = _finite_prior_init(spec, potential, gen, num_chains)
    t0 = time.perf_counter()
    res = run_chees(potential, init_theta, num_warmup=num_warmup, num_samples=num_samples, generator=gen,
                    device=dev, verbose=verbose)
    _sync(dev)
    timings["sampling_s"] = time.perf_counter() - t0
    with torch.no_grad():
        posterior = {name: v.cpu().numpy() for name, v in constrain(spec, res.thetas).items()}
    sample_stats = _chees_stats(res)
    if deterministics_fn is not None:
        posterior.update(compute_deterministics(spec, res.thetas, deterministics_fn))
    if verbose:
        print(f"[fit/chees] {num_chains * num_samples} draws in {timings['sampling_s']:.1f}s "
              f"({res.n_leapfrog} leapfrogs/draw, eps={res.eps:.4g})")
    return FitResult(posterior=posterior, sample_stats=sample_stats, warmup_state=res.warm,
                     final_state=res.warm, timings=timings)


def _chees_stats(res) -> Dict[str, np.ndarray]:
    """ChEES's sample statistics; ``n_leapfrog`` holds the mean count."""
    acc = res.accept.cpu().numpy()
    return {"accept_prob": acc, "diverging": res.diverging.cpu().numpy(),
            "n_leapfrog": np.full_like(acc, res.n_leapfrog)}


def fit(
    spec: ModelSpec,
    seed: Union[int, torch.Generator] = 0,
    num_warmup: int = 1000,
    num_samples: int = 1000,
    num_chains: int = 4,
    cfg: NutsConfig = NutsConfig(),
    deterministics_fn: Optional[Callable] = None,
    init_theta=None,
    warmup_state: Optional[WarmupResult] = None,
    mesh=None,
    checkpoint_path: Optional[str] = None,
    sampler: str = "nuts",
    warmup_chunk_size: Optional[int] = None,
    chees_num_adapt: int = 150,
    verbose: bool = True,
    device=None,
) -> FitResult:
    """Sample ``spec``: constrained posterior, statistics and states
    (``fit``, sampler.py:126-324).

    ``sampler`` is ``"nuts"``, ``"chees"`` (self-contained ChEES-HMC from
    prior draws; it ignores ``init_theta``, ``warmup_state`` and
    ``checkpoint_path``) or ``"nuts+chees"`` (the NUTS warmup, then
    ``chees_num_adapt`` iterations of trajectory-length adaptation and
    fixed-length jittered sampling on the NUTS kernel).

    ``seed`` is an int or a ``torch.Generator`` on ``device``.  ``device``
    (``None`` means CUDA; it raises without it) must be where ``spec``'s data
    lie.  ``warmup_state`` skips adaptation; so does an existing warmup
    checkpoint at ``checkpoint_path``, which is otherwise written after
    warmup (beside NUTS's mid-sampling checkpoint).  ``deterministics_fn``
    takes batched sites and returns batched deterministic sites.

    ``mesh``: chain row ``r`` of the mesh runs chains ``r·n .. (r+1)·n - 1``,
    ``n = num_chains / rows``, on ``spec`` (built from
    :func:`~bumpcosmology_torch.parallel.shard_pop_data` or
    ``shard_pop_cosmo_data`` of the catalog, so that the ranks of a row
    evaluate one potential together).  The ranks of a row keep in lockstep:
    they draw from one generator seed and see the same all-reduced values,
    so they take the same accept and U-turn decisions.  With more than one
    row, row ``r`` seeds its generator from (``seed``, ``r``).  The posterior,
    the statistics and the states are gathered over the rows, so every rank
    returns ``(num_chains, num_samples)``; ``timings`` are the rank's own.
    ``init_theta`` and ``warmup_state`` hold every chain, and each row takes
    its own.  A mesh takes no ``checkpoint_path``.  On a 1 x 1 mesh the fit
    is :func:`fit` without one, bit for bit.

    ``warmup_chunk_size`` spaces the warmup's ``progress`` reports (every
    chunk of at most that many transitions of a window; the fleet's
    ``chunk_size`` does the same).  In the JAX package it bounds the steps of
    one compiled execution, which the port does not have.
    """
    if mesh is not None:
        return _fit_on_mesh(mesh, spec, seed, num_warmup, num_samples, num_chains, cfg, deterministics_fn,
                            init_theta, warmup_state, checkpoint_path, sampler, warmup_chunk_size,
                            chees_num_adapt, verbose, device)
    dev = resolve_device(device)
    if spec.device.type != dev.type:
        raise ValueError(f"the spec's data lie on {spec.device}, but the fit was asked to run on {dev}")
    gen = seed if isinstance(seed, torch.Generator) else torch.Generator(device=dev).manual_seed(seed)
    potential = make_potential(spec)
    if sampler == "chees":
        return _fit_chees(spec, potential, gen, num_warmup, num_samples, num_chains, deterministics_fn, verbose,
                          dev)
    if sampler not in ("nuts", "nuts+chees"):
        raise ValueError(f"unknown sampler {sampler!r}; use 'nuts', 'chees', or 'nuts+chees'")
    timings: Dict[str, float] = {}

    if warmup_state is None and checkpoint_path is not None and os.path.exists(checkpoint_file(checkpoint_path)):
        warmup_state = load_warmup(checkpoint_path, device=dev)
        if verbose:
            print(f"[fit] resuming from warmup checkpoint {checkpoint_path}")
    if warmup_state is None:
        if init_theta is None:
            init_theta = _finite_prior_init(spec, potential, gen, num_chains)
        init_theta = torch.as_tensor(init_theta, dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        progress = None
        if verbose:
            def progress(step, total, accept):
                if step % 100 == 0 or step == total:
                    print(f"[fit] warmup {step}/{total} (accept {accept:.2f}, "
                          f"{time.perf_counter() - t0:.0f}s)", flush=True)
        warm, _ = run_warmup(potential, init_theta, num_warmup, cfg, generator=gen, device=dev,
                             progress=progress, chunk_size=warmup_chunk_size)
        _sync(dev)
        timings["warmup_s"] = time.perf_counter() - t0
        if verbose:
            print(f"[fit] warmup: {num_warmup} steps x {num_chains} chains in {timings['warmup_s']:.1f}s")
        if checkpoint_path is not None:
            save_warmup(checkpoint_path, warm)
            if verbose:
                print(f"[fit] warmup checkpoint saved to {checkpoint_path}")
    else:
        warm = warmup_state

    t0 = time.perf_counter()
    if sampler == "nuts+chees":
        # NUTS-quality windowed adaptation (above), then fixed-length jittered
        # HMC: no ragged trees, and only the trajectory length is adapted here
        res = run_chees_from_warmup(potential, warm, num_adapt=chees_num_adapt, num_samples=num_samples,
                                    generator=gen, device=dev, verbose=verbose)
        _sync(dev)
        timings["sampling_s"] = time.perf_counter() - t0
        thetas, final, sample_stats = res.thetas, res.warm, _chees_stats(res)
    else:
        sample_progress = None
        if verbose:
            def sample_progress(done, total):
                if done % 100 == 0 or done == total:
                    print(f"[fit] sampling {done}/{total} ({time.perf_counter() - t0:.0f}s)", flush=True)
        res = run_sampling(potential, warm, num_samples, cfg, generator=gen, device=dev,
                           progress=sample_progress, checkpoint_path=checkpoint_path)
        _sync(dev)
        timings["sampling_s"] = time.perf_counter() - t0
        thetas, final, st = res.thetas, res.warm, res.stats
        sample_stats = {
            "accept_prob": st.accept_prob, "diverging": st.diverging, "tree_depth": st.tree_depth,
            "n_leapfrog": st.n_leapfrog, "potential_energy": st.energy, "step_size": st.step_size,
        }
        sample_stats = {k: v.cpu().numpy() for k, v in sample_stats.items()}

    with torch.no_grad():
        posterior = {name: v.cpu().numpy() for name, v in constrain(spec, thetas).items()}
    if deterministics_fn is not None:
        t0 = time.perf_counter()
        posterior.update(compute_deterministics(spec, thetas, deterministics_fn))
        timings["deterministics_s"] = time.perf_counter() - t0

    if verbose:
        total = num_chains * num_samples
        sam_s = timings["sampling_s"]
        scalar = {k: v for k, v in posterior.items() if np.ndim(v) == 2}
        ess_min = min(s["ess"] for s in summary(scalar).values()) if scalar else float("nan")
        print(f"[fit] sampling: {total} draws in {sam_s:.1f}s ({total / sam_s:.1f} draws/s, "
              f"min-ESS/s {ess_min / sam_s:.2f}, divergences {sample_stats['diverging'].sum():.0f})")
    if "selection_noise_nats" in posterior:
        noise = float(np.median(posterior["selection_noise_nats"]))
        if verbose:
            print(f"[fit] selection-integral MC noise: {noise:.2f} nats (median)")
        if noise > 1.0:
            warnings.warn(
                f"selection-integral MC noise {noise:.2f} nats > 1.0: the posterior itself is "
                "likely corrupted by pseudo-modes from the finite injection set — increase the "
                "number of selection injections (docs/DESIGN.md §5a)",
                stacklevel=2,
            )

    return FitResult(posterior=posterior, sample_stats=sample_stats, warmup_state=warm,
                     final_state=final, timings=timings)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equally shaped named tuples (or of bare leaves)."""
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _row_seed(seed: Union[int, torch.Generator], row: int) -> int:
    base = seed.initial_seed() if isinstance(seed, torch.Generator) else int(seed)
    return int(np.random.SeedSequence([base, row]).generate_state(1, np.uint64)[0])


def _fit_on_mesh(mesh, spec, seed, num_warmup, num_samples, num_chains, cfg, deterministics_fn, init_theta,
                 warmup_state, checkpoint_path, sampler, warmup_chunk_size, chees_num_adapt, verbose,
                 device) -> FitResult:
    """:func:`fit` of this rank's chain row, gathered over the rows."""
    import torch.distributed as dist

    from bumpcosmology_torch.parallel.mesh import CHAIN_AXIS

    rows, row = mesh.shape[CHAIN_AXIS], mesh.index(CHAIN_AXIS)
    if num_chains % rows:
        raise ValueError(f"{num_chains} chains do not divide into {rows} chain rows")
    if checkpoint_path is not None:
        raise ValueError("fit: a mesh takes no checkpoint_path (each row adapts its own chains)")
    n = num_chains // rows
    mine = slice(row * n, (row + 1) * n)
    if init_theta is not None:
        init_theta = torch.as_tensor(init_theta)[mine]
    if warmup_state is not None:
        warmup_state = _tree_map(lambda t: t[mine], warmup_state)
    res = fit(spec, _row_seed(seed, row) if rows > 1 else seed, num_warmup, num_samples, n, cfg, deterministics_fn,
              init_theta, warmup_state, sampler=sampler, warmup_chunk_size=warmup_chunk_size,
              chees_num_adapt=chees_num_adapt, verbose=verbose, device=device)

    def host(t):
        return t.cpu().numpy()

    mine_parts = (res.posterior, res.sample_stats, _tree_map(host, res.warmup_state), _tree_map(host, res.final_state))
    group = mesh.group(CHAIN_AXIS)
    parts = [None] * dist.get_world_size(group)
    dist.all_gather_object(parts, mine_parts, group=group)
    dev = resolve_device(device)

    def state(i):
        return _tree_map(lambda *xs: torch.as_tensor(np.concatenate(xs), device=dev), *(p[i] for p in parts))

    return FitResult(
        posterior={k: np.concatenate([p[0][k] for p in parts]) for k in res.posterior},
        sample_stats={k: np.concatenate([p[1][k] for p in parts]) for k in res.sample_stats},
        warmup_state=state(2), final_state=state(3), timings=res.timings)
