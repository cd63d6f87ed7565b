"""Injection importance resampling (L3, host-side numpy); counterpart of the
JAX package's ``data/resample.py`` (``src/scripts/weighting.py:217-231``):
redraw an injection set in proportion to a target population weight, with an
Neff-sized output and a renormalized pdraw that keeps downstream selection
integrals unbiased.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["resample_injections", "importance_neff"]


def importance_neff(wt: np.ndarray) -> float:
    """(Σ w)² / Σ w² — the importance-sampling effective sample size."""
    wt = np.asarray(wt, dtype=np.float64)
    return float(np.sum(wt) ** 2 / np.sum(wt * wt))


def resample_injections(m1, q, z, pdraw, ndraw: float, wt_fn: Callable,
                        rng: Optional[np.random.Generator] = None):
    """Resample injections to the population defined by ``wt_fn(m1, q, z)``.

    Returns ``(m1, q, z, pdraw_new, neff)``: the output size is the rounded
    importance Neff and ``pdraw_new = pop_wt / (Σ(pop_wt/pdraw)/ndraw)``.
    """
    m1, q, z, pdraw = (np.asarray(x, dtype=np.float64) for x in (m1, q, z, pdraw))
    if rng is None:
        rng = np.random.default_rng()
    pop_wt = np.asarray(wt_fn(m1, q, z), dtype=np.float64)
    unnorm = pop_wt / pdraw
    norm = np.sum(unnorm) / ndraw
    neff = importance_neff(unnorm)
    inds = rng.choice(len(unnorm), size=int(round(neff)), p=unnorm / np.sum(unnorm))
    pdraw_new = pop_wt / norm
    return m1[inds], q[inds], z[inds], pdraw_new[inds], neff
