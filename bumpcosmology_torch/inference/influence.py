"""Leave-one-out event-influence diagnostics: one fleet, nobs refits (L2);
counterpart of the JAX package's ``inference/influence.py``.

The nobs leave-one-out catalogs (each the catalog with one event removed)
stack on a fleet axis (:func:`make_loo_datas`,
:func:`~bumpcosmology_torch.inference.likelihoods.stack_fleet`) and refit
as the nobs chains of one batched NUTS run
(:func:`~bumpcosmology_torch.inference.fleet.fleet_fit`), chain ``i``
reading catalog ``i``: on the joint bump, every batched value+grad is one
kernel-B launch each way over nobs per-chain query tables, and one kernel-A
launch each way.

Influence is reported in posterior-sd units:

    z_i[site] = (E[site | data without event i] − E[site | full data]) / sd[site | full data]

|z| ≳ 1 flags an event that single-handedly moves that hyperparameter by a
posterior standard deviation.

The start candidates and the sampler's momenta come from one
``torch.Generator`` where the JAX package splits keys, so the fits cannot
match the JAX package's draw for draw (as for the SBC fleet); the catalogs
and :func:`influence_summary` match it exactly.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.likelihoods import stack_fleet
from bumpcosmology_torch.inference.model import ModelSpec, constrain, data_potential, prior_sample

__all__ = ["LooResult", "make_loo_datas", "loo_fit", "influence_summary"]

_N_CAND = 32


class LooResult(NamedTuple):
    posterior: Dict[str, np.ndarray]  # site -> (nobs, num_samples) constrained
    accept: np.ndarray  # (nobs, num_samples)
    eps: np.ndarray  # (nobs,) adapted step sizes


def make_loo_datas(data):
    """Stack the nobs leave-one-out catalogs on a leading fleet axis.

    ``data`` is a :class:`PopData` or :class:`PopCosmoData`; fleet member i
    carries the event block with row i deleted — shape (nobs-1, nsamp), one
    common shape for the whole fleet — while the selection set is
    replicated (a :class:`PopData` fleet shares its Planck18 grid).
    """
    ev = data.events
    nobs = ev.a.shape[0]
    if nobs < 2:
        raise ValueError("leave-one-out needs at least 2 events")
    keep = torch.as_tensor(np.stack([np.delete(np.arange(nobs), i) for i in range(nobs)]), device=ev.a.device)
    return stack_fleet([data._replace(events=type(ev)(*(x[keep[i]] for x in ev))) for i in range(nobs)])


def loo_fit(
    spec: ModelSpec,
    loglike: Callable,
    data,
    generator=None,
    num_warmup: int = 300,
    num_samples: int = 256,
    cfg=None,
    chunk_size: int = 25,
    verbose: bool = True,
    device=None,
) -> LooResult:
    """Fit all nobs leave-one-out catalogs as one lockstep fleet.

    ``spec`` is the full-catalog :class:`ModelSpec` (only its priors and site
    transform are used); ``loglike(sites, data_slice)`` is the
    data-as-argument likelihood for sites of shape ``(S',)`` and a fleet of
    S' catalogs (e.g. ``pop_loglike``, or ``pop_cosmo_loglike`` with fixed dL
    bounds covering the full catalog).  ``generator`` is a
    ``torch.Generator`` or an int seed; the fit runs on ``device`` (``None``
    means CUDA; it raises without it), where ``data`` must lie.

    Each catalog's fit starts from the first of 32 prior candidates whose
    potential is finite on that catalog: 32 evaluations of the whole fleet's
    potential, one candidate per catalog each, never one 32·nobs-chain table.
    """
    from bumpcosmology_torch.inference.fleet import fleet_fit
    from bumpcosmology_torch.inference.nuts import NutsConfig

    dev = resolve_device(device)
    gen = (generator if isinstance(generator, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(generator or 0)))
    nobs = data.events.a.shape[0]
    datas = make_loo_datas(data)

    def make_pot(d):
        return data_potential(spec, loglike, d)

    # finite inits from prior candidates (the pattern of the SBC fleet)
    cands = prior_sample(spec, gen, shape=(nobs, _N_CAND))  # (nobs, n_cand, dim)
    pot = make_pot(datas)
    with torch.inference_mode():
        finite = torch.stack([torch.isfinite(pot(cands[:, j])) for j in range(_N_CAND)], dim=1)
    if not bool(finite.any(dim=1).all()):
        raise RuntimeError(
            "no finite-potential init found for some leave-one-out catalog "
            f"in {_N_CAND} prior draws"
        )
    idx = torch.argmax(finite.int(), dim=1)
    theta0 = cands[torch.arange(nobs, device=cands.device), idx]

    progress = None
    if verbose:

        def progress(phase, done, total):
            if done % 100 == 0 or done == total:
                print(f"[loo/fleet] {phase} {done}/{total}", flush=True)

    res = fleet_fit(make_pot, datas, theta0, gen, num_warmup=num_warmup, num_samples=num_samples,
                    cfg=cfg or NutsConfig(), progress=progress, chunk_size=chunk_size, device=dev)
    if not bool(torch.isfinite(res.thetas).all()):
        raise RuntimeError("non-finite draws in the leave-one-out fleet")
    post = {k: v.cpu().numpy() for k, v in constrain(spec, res.thetas).items()}
    return LooResult(posterior=post, accept=res.accept.cpu().numpy(), eps=res.eps.cpu().numpy())


def influence_summary(
    loo: LooResult, full_posterior: Dict[str, np.ndarray]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-site influence of each event, in full-posterior-sd units.

    ``full_posterior``: site -> (chains, draws) from the full-catalog fit.
    Returns site -> {"mean_loo": (nobs,), "delta_mean": (nobs,), "z": (nobs,)}
    for every scalar site present in both inputs.
    """
    out = {}
    for site, loo_draws in loo.posterior.items():
        if site not in full_posterior or np.ndim(loo_draws) != 2:
            continue
        full = np.asarray(full_posterior[site])
        if full.ndim != 2:
            continue
        mu, sd = float(np.mean(full)), float(np.std(full))
        mean_loo = loo_draws.mean(axis=1)
        delta = mean_loo - mu
        out[site] = {
            "mean_loo": mean_loo,
            "delta_mean": delta,
            "z": delta / (sd if sd > 0 else np.inf),
        }
    return out
