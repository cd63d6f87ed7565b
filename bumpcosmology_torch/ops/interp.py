"""Monotone 1-D linear interpolation (L0); counterpart of
the JAX package's ``ops/interp.py``.

Only the *gather* formulations are ported (``_interp_gather`` and
``_interp_unit_gather`` there).  The MXU matmul, tiled and static-bracket
forms were TPU data-movement workarounds; on a GPU a table fetch is a gather
through an (index, fraction) pair, in full fp32 — never a matmul, so no TF32
rounding can reach a table value.

Tables may carry leading batch (chain) dimensions: ``fp`` of shape
``(*batch, K)`` (or ``(*batch, K, ncol)`` for :func:`interp_unit_spaced`)
with queries ``x`` of shape ``(*batch, M)``.  A 1-D table takes queries of
any shape.  Clamped-end behaviour matches ``jnp.interp`` (constant
extrapolation); gradients flow to the queries and to the table values.
"""
from __future__ import annotations

import torch

__all__ = ["interp", "inverse_interp", "interp_unit_spaced", "interp_unit_spaced_columns", "unit_bracket"]


def _take(fp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """fp[..., idx] for a 1-D table or a batched ``(*batch, K)`` table."""
    if fp.dim() == 1:
        return fp[idx]
    return torch.gather(fp, -1, idx)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp`` given at increasing ``xp`` (searchsorted
    with ``right=True``, as the JAX package's gather form)."""
    n = xp.shape[-1]
    hi = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, n - 1)
    lo = hi - 1
    x_lo, x_hi = _take(xp, lo), _take(xp, hi)
    f_lo, f_hi = _take(fp, lo), _take(fp, hi)
    denom = x_hi - x_lo
    pos = denom > 0
    t = torch.where(pos, (x - x_lo) / torch.where(pos, denom, torch.ones_like(denom)), 0.0)
    t = t.clamp(0.0, 1.0)  # constant extrapolation at both ends
    return f_lo + t * (f_hi - f_lo)


def inverse_interp(y: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """The ``x`` at which ``interp(x, xp, fp)`` equals ``y``, for ``fp``
    strictly increasing (the distance tables): ``interp(y, fp, xp)``."""
    return interp(y, fp, xp)


def unit_bracket(x: torch.Tensor, x0, dx, n: int):
    """(lo, t) of a uniform grid ``x0 + k*dx``, ``k < n``: ``lo`` clipped to
    [0, n-2] and ``t`` to [0, 1], as ``_interp_unit_gather`` does.  A NaN
    position takes ``lo = 0`` and gives NaN (a diverging trajectory reaches
    NaN parameters; the gather must not see an index cast from NaN)."""
    pos = (x - x0) / dx
    lo = torch.floor(pos).nan_to_num(nan=0.0).clamp(0, n - 2)
    t = (pos - lo).clamp(0.0, 1.0)
    return lo.long(), t


def interp_unit_spaced(x: torch.Tensor, x0, dx, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation on the uniform grid ``x0 + k*dx``; ``fp`` is
    ``(K,)`` or ``(*batch, K)``."""
    lo, t = unit_bracket(x, x0, dx, fp.shape[-1])
    f_lo, f_hi = _take(fp, lo), _take(fp, lo + 1)
    return f_lo + t * (f_hi - f_lo)


def interp_unit_spaced_columns(x: torch.Tensor, x0, dx, cols: torch.Tensor) -> torch.Tensor:
    """:func:`interp_unit_spaced` of a ``(*batch, K, ncol)`` table whose
    columns share one bracket; returns ``(*batch, M, ncol)`` (the JAX
    package's ``(K, C)`` table case, with leading chain axes)."""
    lo, t = unit_bracket(x, x0, dx, cols.shape[-2])
    idx = lo.unsqueeze(-1).expand(*lo.shape, cols.shape[-1])
    f_lo = torch.gather(cols, -2, idx)
    f_hi = torch.gather(cols, -2, idx + 1)
    return f_lo + t.unsqueeze(-1) * (f_hi - f_lo)
