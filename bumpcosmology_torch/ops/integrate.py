"""Quadrature primitives (L0); counterpart of the JAX package's ``ops/integrate.py``.

``cumtrapz``, ``trapz``, ``log_trapz`` and ``log_cumtrapz`` with the same conventions as the
JAX package: any axis, any leading batch shape, ``xs`` broadcast against
``ys`` when it has fewer dimensions.
"""
from __future__ import annotations

import torch

__all__ = ["cumtrapz", "trapz", "log_trapz", "log_cumtrapz"]


def _pairs(ys: torch.Tensor, xs: torch.Tensor, axis: int):
    xs = xs.expand_as(ys) if xs.dim() != ys.dim() else xs
    n = ys.shape[axis]
    dx = torch.diff(xs, dim=axis)
    ya = ys.narrow(axis, 0, n - 1)
    yb = ys.narrow(axis, 1, n - 1)
    return dx, ya, yb


def cumtrapz(ys: torch.Tensor, xs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Cumulative trapezoidal integral; the first entry along ``axis`` is 0."""
    dx, ya, yb = _pairs(ys, xs, axis)
    csum = torch.cumsum(0.5 * dx * (ya + yb), dim=axis)
    zero = torch.zeros_like(csum.narrow(axis, 0, 1))
    return torch.cat([zero, csum], dim=axis)


def trapz(ys: torch.Tensor, xs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Plain trapezoidal integral along ``axis``."""
    dx, ya, yb = _pairs(ys, xs, axis)
    return torch.sum(0.5 * dx * (ya + yb), dim=axis)


def log_trapz(log_ys: torch.Tensor, xs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """log ∫ exp(log_ys) dx by the trapezoid rule, as one log-sum-exp over
    segments with a per-segment log-measure (as the JAX package does)."""
    dx, wa, wb = _pairs(log_ys, xs, axis)
    log_seg = torch.logaddexp(wa, wb) + torch.log(0.5 * dx)
    return torch.logsumexp(log_seg, dim=axis)


def log_cumtrapz(log_ys: torch.Tensor, xs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Cumulative :func:`log_trapz`: the first entry along ``axis`` is ``-inf``
    (an integral of zero width), and a slice that is all ``-inf`` stays so.
    A cumulative sum shifted by the slice's largest segment, as the JAX
    package does."""
    dx, wa, wb = _pairs(log_ys, xs, axis)
    log_seg = torch.logaddexp(wa, wb) + torch.log(0.5 * dx)
    m = torch.amax(log_seg, dim=axis, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    out = torch.log(torch.cumsum(torch.exp(log_seg - m), dim=axis)) + m
    return torch.cat([torch.full_like(out.narrow(axis, 0, 1), -torch.inf), out], dim=axis)
