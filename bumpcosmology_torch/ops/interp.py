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

import math

import torch

__all__ = ["interp", "inverse_interp", "interp_unit_spaced", "interp_unit_spaced_columns", "unit_bracket", "take_rows",
           "rows_in_fixed_order"]

_LEAST_SUBNORMAL = 2.0 ** -1074  # float64's


class _Rows(torch.autograd.Function):
    """``flat[idx]`` for a table's flattened rows ``flat`` ``(R, ...)``, with a
    backward whose sums do not depend on the order of its atomics.

    ``torch.gather``'s backward adds the cotangents of the entries that share
    a row with float atomics, so the sum's rounding changes from launch to
    launch on CUDA.  Here each row (and column) takes a power of two ``q``
    with ``2^52 q`` above its largest cotangent times the count ``n`` of all
    entries; the row's cotangents are rounded to multiples of ``q``, so every
    partial sum is a multiple of ``q`` below ``2^53 q``, exact in float64,
    and the row's sum is the same in any order.  A cotangent moves by at most
    ``q/2``, below ``n 2^-52`` of its row's largest (5.6e-10 at ``n = 2.5e6``,
    under the float32 rounding of the result unless the row's cotangents
    cancel a hundredfold; a count per row would sharpen that for one more
    pass over ``idx``); a row's scale never reaches another's, so chains that
    diverge leave the others' rows as they are.  A row with a non-finite
    cotangent is non-finite.  A float64 row whose cotangents are all
    subnormal takes the least subnormal for ``q``, of which each of them is a
    whole multiple, where ``2^(e - 52)`` would round to zero; a float32 row's
    ``e`` is never below -149, so its ``q`` needs no floor."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = flat.shape, flat.dtype
        return flat[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g, rows = g.reshape(idx.numel(), -1), idx.reshape(-1)
        largest = torch.zeros((ctx.shape[0], g.shape[1]), dtype=g.dtype, device=g.device).scatter_reduce_(
            0, rows[:, None].expand_as(g), g.abs(), "amax")
        # largest < 2^e (frexp); a row's total stays below n 2^e <= 2^(e + ceil(log2 n))
        q = torch.exp2(torch.frexp(largest)[1].double() + (math.ceil(math.log2(max(rows.numel(), 1))) - 52))
        if ctx.dtype == torch.float64:
            q = q.clamp_min(_LEAST_SUBNORMAL)
        sums = torch.zeros_like(q).index_add_(0, rows, torch.round(g.double() / q[rows]))
        return (sums * q).to(ctx.dtype).reshape(ctx.shape), None


def _bracket_rows(table: torch.Tensor, lo: torch.Tensor, row_dim: int):
    """(rows ``lo``, rows ``lo + 1``) of ``table`` along ``row_dim`` (-1: a
    value per row; -2: trailing columns), with the table's leading batch
    axes matching ``lo``'s (``(*batch, M)``) or none.  On the card both rows
    come from one index of the flattened table, whose backward sums in a
    fixed order (:class:`_Rows`); the CPU's ``gather`` backward adds in
    order already, so there it is kept."""
    batch = table.shape[: table.dim() + row_dim]
    if table.device.type == "cpu":
        if row_dim == -1 and not batch:
            take = lambda i: torch.gather(table, 0, i.reshape(-1)).reshape(i.shape)  # noqa: E731
        elif row_dim == -1:
            take = lambda i: torch.gather(table, -1, i)  # noqa: E731
        else:
            take = lambda i: torch.gather(table, -2, i.unsqueeze(-1).expand(*i.shape, table.shape[-1]))  # noqa: E731
        return take(lo), take(lo + 1)
    k = table.shape[row_dim]
    starts = (torch.arange(batch.numel(), device=table.device).reshape(*batch, 1) * k if batch
              else torch.zeros((1,) * lo.dim(), dtype=torch.long, device=table.device))
    idx = lo + torch.stack((starts, starts + 1))
    return _Rows.apply(table.reshape(-1, *table.shape[table.dim() + row_dim + 1:]), idx).unbind(0)


def rows_in_fixed_order(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` ``(*batch, M)`` of a ``(*batch, R, ncol)`` table, as
    ``(*batch, M, ncol)``, through one index of the flattened table whose
    backward sums in a fixed order (:class:`_Rows`), on any device."""
    batch, r = table.shape[:-2], table.shape[-2]
    starts = torch.arange(batch.numel(), device=table.device).reshape(*batch, 1) * r
    return _Rows.apply(table.reshape(-1, table.shape[-1]), idx + starts)


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` ``(*batch, M)`` of a ``(*batch, R, ncol)`` table (a row a
    query, such as a spline's interval), as ``(*batch, M, ncol)``.  On the
    card :func:`rows_in_fixed_order`, so that the table's cotangent repeats
    bit for bit; the CPU's ``gather`` backward adds in order already."""
    if table.device.type == "cpu":
        return torch.gather(table, -2, idx.unsqueeze(-1).expand(*idx.shape, table.shape[-1]))
    return rows_in_fixed_order(table, idx)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of ``fp`` given at increasing ``xp`` (searchsorted
    with ``right=True``, as the JAX package's gather form)."""
    n = xp.shape[-1]
    lo = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, n - 1) - 1
    x_lo, x_hi = _bracket_rows(xp, lo, -1)
    f_lo, f_hi = _bracket_rows(fp, lo, -1)
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
    f_lo, f_hi = _bracket_rows(fp, lo, -1)
    return f_lo + t * (f_hi - f_lo)


def interp_unit_spaced_columns(x: torch.Tensor, x0, dx, cols: torch.Tensor) -> torch.Tensor:
    """:func:`interp_unit_spaced` of a ``(*batch, K, ncol)`` table whose
    columns share one bracket; returns ``(*batch, M, ncol)`` (the JAX
    package's ``(K, C)`` table case, with leading chain axes)."""
    lo, t = unit_bracket(x, x0, dx, cols.shape[-2])
    f_lo, f_hi = _bracket_rows(cols, lo, -2)
    return f_lo + t.unsqueeze(-1) * (f_hi - f_lo)
