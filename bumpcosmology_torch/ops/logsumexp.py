"""Log-domain reductions (L0); counterpart of the JAX package's ``ops/logsumexp.py``.

``axis=None`` reduces over every element, as the JAX package's ``logsumexp``
does; a slice that is all ``-inf`` reduces to ``-inf``.  The mesh-sharded
form (``sharded_logsumexp``) waits for the port's scale-out slice.
"""
from __future__ import annotations

import math

import torch

__all__ = ["logsumexp", "logmeanexp", "log_neff", "neff"]


def logsumexp(a: torch.Tensor, axis=None) -> torch.Tensor:
    """log Σ exp(a) along ``axis`` (every element when ``None``)."""
    return torch.logsumexp(a.reshape(-1), dim=0) if axis is None else torch.logsumexp(a, dim=axis)


def logmeanexp(a: torch.Tensor, axis=None) -> torch.Tensor:
    """log of the mean of exp(a) along ``axis`` (stable)."""
    n = a.numel() if axis is None else a.shape[axis]
    return logsumexp(a, axis) - math.log(n)


def log_neff(log_wts: torch.Tensor, axis=None) -> torch.Tensor:
    """log of the importance-sampling effective sample size (Σw)² / Σw²:
    ``2 logsumexp(log w) - logsumexp(2 log w)``."""
    return 2.0 * logsumexp(log_wts, axis) - logsumexp(2.0 * log_wts, axis)


def neff(log_wts: torch.Tensor, axis=None) -> torch.Tensor:
    """Importance-sampling effective sample size (see :func:`log_neff`)."""
    return torch.exp(log_neff(log_wts, axis))
