"""Fitting: ModelSpec → posterior draws, statistics and adapted state
(L4); counterpart of the JAX package's ``inference/sampler.py`` with its
three samplers: ``"nuts"``, ``"chees"`` and ``"nuts+chees"``
(:mod:`bumpcosmology_torch.inference.chees`).

Chains run as one batch on ``device`` (``None`` means CUDA).  The
deterministic sites are a separate post-pass in chunks of draws, each chunk
one chain batch of the model, so the sampling loop carries no
predictive-grid work.  One ``torch.Generator`` drives the prior draws, the
warmup and the sampling, in that order.
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
    checkpoint_path: Optional[str] = None,
    sampler: str = "nuts",
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
    """
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
                             progress=progress)
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
