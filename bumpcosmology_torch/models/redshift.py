"""Madau-Dickinson-like merger-rate density over redshift (L1); counterpart of
the JAX package's ``models/redshift.py``:

    dN/dV/dt ∝ (1+z)^lam / (1 + ((1+z)/(1+zp))^kappa),  normalized to 1 at z = 0.

``log1p(x**kappa)`` is spelled ``softplus(kappa log x)`` — the same function
for x > 0, and the form kernel B evaluates.
"""
from __future__ import annotations

import torch

from bumpcosmology_torch.models.parameters import RedshiftParams
from bumpcosmology_torch.ops.special import softplus

__all__ = ["log_dndv", "ZREF"]

ZREF = 0.0


def _log_shape(z, params: RedshiftParams):
    z = torch.as_tensor(z)
    return params.lam * torch.log1p(z) - softplus(
        params.kappa * torch.log((1.0 + z) / (1.0 + params.zp))
    )


def log_dndv(z, params: RedshiftParams, zref: float = ZREF):
    """log merger-rate density at ``z``, 0 at ``zref``.  Parameters broadcast
    against ``z`` (pass ``(C, 1)`` leaves for ``(C, N)`` queries)."""
    z = torch.as_tensor(z)
    return _log_shape(z, params) - _log_shape(torch.full_like(z, zref), params)
