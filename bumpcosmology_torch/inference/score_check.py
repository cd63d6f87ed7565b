"""Score-identity check: E_{data|θ₀}[∇_θ log L̂(θ₀; data)] = 0 (L2);
counterpart of the JAX package's ``inference/score_check.py``.

If catalogs are really drawn from the model at θ₀, the expected score of the
fitted log-likelihood at θ₀ vanishes — for the TOTAL (event + selection)
score only.  The per-event marginal and the selection factor separately have
equal-and-opposite nonzero expectations, so the per-term rows are
attribution aids (which term moved when the total breaks), not pass
criteria; the stage gates on the TOTAL |z| alone.  A significantly nonzero
TOTAL mean score is a generative/model mismatch (a simulator channel the
likelihood omits, a support clip, a biased estimator), attributed to one
hyperparameter direction, without a single fit.

The per-catalog cost is one value-and-grad at fixed θ₀.  Here the event and
selection terms come from the joint model's fused route: kernel B's ``lse``
epilogue for the bump (the JAX package takes its non-fused route; both
interpolate the same cosmology, on different knots).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device

__all__ = ["ScoreCheckResult", "score_identity_check", "joint_term_grads"]


class ScoreCheckResult(NamedTuple):
    """Mean scores with standard errors, per (term, site).

    ``mean``/``se``/``z``: arrays of shape (3, n_sites) — rows are the event
    term, the selection term, and their total.  ``z = mean / se``; under the
    null every entry is asymptotically standard normal.
    """

    sites: tuple
    mean: np.ndarray
    se: np.ndarray
    z: np.ndarray
    n_catalogs: int

    def max_abs_z(self) -> float:
        return float(np.max(np.abs(self.z[2])))

    def table(self) -> str:
        rows = ["term      site        mean      se        z"]
        for t, name in ((0, "event"), (1, "selection"), (2, "TOTAL")):
            for j, k in enumerate(self.sites):
                rows.append(
                    f"{name:9s} {k:10s} {self.mean[t, j]:+.4f}  "
                    f"{self.se[t, j]:.4f}  {self.z[t, j]:+.1f}"
                )
        return "\n".join(rows)


def joint_term_grads(
    sites0: Dict[str, float],
    grad_sites: Sequence[str],
    nobs: int,
    n_grid: int = 256,
    n_z: int = 1024,
    build=None,
    device=None,
):
    """(data) → (g_event, g_selection), numpy ``(len(grad_sites),)`` each, for
    the joint detector-frame models at θ₀ = ``sites0``.

    ``build`` selects the mass family as in
    :func:`~bumpcosmology_torch.inference.likelihoods.pop_cosmo_loglike`
    (``None``: the bump, through kernels A and B).  The two terms are
    Σ_events [logsumexp − log nsamp] and −nobs·(logsumexp − log Ndraw),
    evaluated on the detector table over the catalog's dL range
    (``dl_bounds_of``).  Both gradients come from ONE backward of a 2-row
    batch: row 0 carries the event term's cotangent and row 1 the selection
    term's, so each kernel launches once forward and once backward a catalog
    (kernel B's backward skips the rows whose cotangent is 0).
    """
    from bumpcosmology_torch.inference.likelihoods import dl_bounds_of, pop_cosmo_segment_lse, query_table

    dev = resolve_device(device)
    grad_sites = tuple(grad_sites)
    fixed = {k: torch.full((2,), float(v), dtype=torch.float32, device=dev) for k, v in sites0.items()}
    vals0 = torch.tensor([[float(sites0[k]) for k in grad_sites]] * 2, dtype=torch.float32, device=dev)

    def term_grads(data):
        data = data.to(dev)
        nsamp = data.events.a.shape[-1]
        vals = vals0.clone().requires_grad_(True)
        with torch.enable_grad():
            sites = dict(fixed)
            sites.update({k: vals[:, j] for j, k in enumerate(grad_sites)})
            lse_ev, lse_sel = pop_cosmo_segment_lse(sites, data, n_grid, n_z, dl_bounds_of(data), query_table(data),
                                                    build=build)
            ev = lse_ev[0].sum() - lse_ev.shape[1] * math.log(nsamp)
            sel = -float(nobs) * (lse_sel[1] - data.selection.log_ndraw)
            (g,) = torch.autograd.grad(ev + sel, vals)
        g = g.cpu().numpy()
        return g[0], g[1]

    return term_grads


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def score_identity_check(
    simulate: Callable,
    sites0: Dict[str, np.ndarray],
    term_grads: Callable,
    grad_sites: Sequence[str],
    n_catalogs: int = 200,
    seed: int = 0,
    progress: Optional[Callable[[int, int], None]] = None,
) -> ScoreCheckResult:
    """Simulate ``n_catalogs`` at θ₀ = ``sites0`` and average the per-term
    scores ``term_grads(data)`` returns (tensors or arrays).

    ``simulate(rng, sites0)`` draws one catalog from the model at θ₀ (the
    SBC simulators qualify).  The standard errors are empirical across
    catalogs, so correlated terms within one catalog are handled exactly.
    """
    rng = np.random.default_rng(seed)
    np_sites = {k: np.asarray(v) for k, v in sites0.items()}
    scores = []
    for i in range(n_catalogs):
        data = simulate(rng, np_sites)
        g_ev, g_sel = term_grads(data)
        scores.append(np.stack([_host(g_ev), _host(g_sel)]))
        if progress is not None:
            progress(i + 1, n_catalogs)
    arr = np.asarray(scores)  # (n, 2, k)
    arr = np.concatenate([arr, arr.sum(axis=1, keepdims=True)], axis=1)  # + total
    mean = arr.mean(axis=0)
    se = arr.std(axis=0, ddof=1) / np.sqrt(len(arr))
    # a zero-variance nonzero score is an (infinitely significant)
    # deterministic bias, not a pass — keep the sign, not a silent 0
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(
            se > 0, mean / np.where(se > 0, se, 1.0),
            np.where(mean == 0, 0.0, np.sign(mean) * np.inf),
        )
    return ScoreCheckResult(sites=tuple(grad_sites), mean=mean, se=se, z=z, n_catalogs=n_catalogs)
