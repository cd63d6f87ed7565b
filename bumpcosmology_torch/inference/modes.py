"""Multimodality: mode assignment, per-mode diagnostics, mode weights (L2);
counterpart of the JAX package's ``inference/modes.py``.

1. :func:`assign_modes` clusters the chains of a fit from overdispersed
   prior inits into modes by their posterior means, in within-chain-sd units
   (single-linkage agglomeration; no number of modes chosen in advance);
2. :func:`split_rhat_per_mode` computes the convergence diagnostics
   (:mod:`~bumpcosmology_torch.inference.diagnostics`) within each mode;
3. :func:`mode_weights_by_bridge` estimates each mode's evidence with the
   bridge sampler (a mode-local Gaussian proposal) → posterior mode weights;
   :func:`mode_weighted_resample` draws a mode-weighted posterior (numpy
   ``Generator``, as the JAX package).

**A difference from the JAX package, on purpose.**  When the bridge fails
for every mode, every ``log_z`` is −inf and the JAX package returns NaN
weights; :func:`mode_weights_by_bridge` raises ``ValueError`` instead.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = [
    "assign_modes",
    "split_rhat_per_mode",
    "mode_weights_by_bridge",
    "mode_weighted_resample",
]


def _chain_stats(posterior: Dict[str, np.ndarray], names: List[str]):
    """Per-chain means and pooled within-chain sds, stacked (chains, sites)."""
    means = np.stack(
        [np.asarray(posterior[k], dtype=np.float64).mean(axis=1) for k in names], axis=1
    )
    sds = np.stack(
        [np.asarray(posterior[k], dtype=np.float64).std(axis=1, ddof=1) for k in names],
        axis=1,
    )
    pooled = np.sqrt(np.mean(sds**2, axis=0))  # (sites,)
    return means, np.maximum(pooled, 1e-12)


def assign_modes(
    posterior: Dict[str, np.ndarray],
    names: Optional[List[str]] = None,
    threshold: float = 4.0,
) -> np.ndarray:
    """Cluster chains into modes; returns an int label per chain (0-based,
    ordered by descending mode size).

    Two chains belong to the same mode when their posterior means differ by
    less than ``threshold`` pooled within-chain standard deviations along
    some connected path (single linkage on the standardized chain-mean
    distance matrix).
    """
    names = names or sorted(posterior)
    means, pooled = _chain_stats(posterior, names)
    z = means / pooled  # standardized chain means
    n = z.shape[0]
    # single-linkage union-find on pairwise distances
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    d = np.sqrt(((z[:, None, :] - z[None, :, :]) ** 2).mean(axis=2))
    for i in range(n):
        for j in range(i + 1, n):
            if d[i, j] < threshold:
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[ri] = rj
    roots = np.array([find(i) for i in range(n)])
    labels_raw, counts = np.unique(roots, return_counts=True)
    order = labels_raw[np.argsort(-counts)]
    remap = {r: m for m, r in enumerate(order)}
    return np.array([remap[r] for r in roots], dtype=int)


def split_rhat_per_mode(
    posterior: Dict[str, np.ndarray], labels: np.ndarray
) -> Dict[int, Dict[str, float]]:
    """Max split-R-hat and min ESS per mode (over all sites).

    Modes with a single chain report R-hat from that chain's two halves
    (split-chain definition still applies).
    """
    from bumpcosmology_torch.inference.diagnostics import ess as _ess
    from bumpcosmology_torch.inference.diagnostics import split_rhat as _rhat

    out: Dict[int, Dict[str, float]] = {}
    for m in np.unique(labels):
        idx = np.flatnonzero(labels == m)
        rmax, emin = 0.0, np.inf
        for k, v in posterior.items():
            arr = np.asarray(v)[idx]
            rmax = max(rmax, float(_rhat(arr)))
            emin = min(emin, float(_ess(arr)))
        out[int(m)] = {"max_rhat": rmax, "min_ess": emin, "n_chains": len(idx)}
    return out


def mode_weights_by_bridge(
    spec,
    posterior: Dict[str, np.ndarray],
    labels: np.ndarray,
    seed: int = 0,
    **bridge_kwargs,
):
    """Per-mode bridge-sampling evidence → posterior mode weights.

    Each mode's draws feed :func:`~bumpcosmology_torch.inference.evidence.
    log_evidence_bridge` separately (a mode-local proposal, so the estimate
    is that basin's share Z_m of the evidence); w_m = Z_m / Σ Z.

    Returns ``(weights, results)``: (n_modes,) weights and the per-mode
    ``EvidenceResult`` list.  A mode too small for the bridge (< 64 draws)
    gets weight 0 and a ``None`` result.  When no mode has an estimate,
    raises ``ValueError`` (the JAX package returns NaN weights there).
    """
    from bumpcosmology_torch.inference.evidence import log_evidence_bridge

    modes = np.unique(labels)
    results = []
    logzs = []
    for m in modes:
        idx = np.flatnonzero(labels == m)
        sub = {k: np.asarray(v)[idx] for k, v in posterior.items() if k in spec.priors}
        try:
            res = log_evidence_bridge(spec, sub, seed=seed + int(m), **bridge_kwargs)
            results.append(res)
            logzs.append(res.log_z)
        except ValueError:
            results.append(None)
            logzs.append(-np.inf)
    logzs = np.asarray(logzs, dtype=np.float64)
    if not np.any(np.isfinite(logzs)):
        raise ValueError(
            f"mode weights: the bridge gave no evidence for any of the {modes.size} mode(s) "
            "(each has fewer than 64 draws or no finite log Z)"
        )
    mx = np.max(logzs)
    w = np.exp(logzs - mx)
    return w / w.sum(), results


def mode_weighted_resample(
    posterior: Dict[str, np.ndarray],
    labels: np.ndarray,
    weights: np.ndarray,
    n_out: int,
    rng: np.random.Generator,
) -> Dict[str, np.ndarray]:
    """A single mode-weighted posterior sample: draws resampled from each
    mode's pool in proportion to its bridge weight (shape (1, n_out) per
    site, arviz-style)."""
    modes = np.unique(labels)
    counts = rng.multinomial(n_out, np.asarray(weights) / np.sum(weights))
    out = {k: [] for k in posterior}
    for m, c in zip(modes, counts):
        if c == 0:
            continue
        idx = np.flatnonzero(labels == m)
        pool = {k: np.asarray(v)[idx].reshape(-1) for k, v in posterior.items()}
        npool = pool[next(iter(pool))].shape[0]
        pick = rng.choice(npool, size=c, replace=True)
        for k in out:
            out[k].append(pool[k][pick])
    return {k: np.concatenate(v)[None, :] for k, v in out.items()}
