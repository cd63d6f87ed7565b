"""PISN-bump black-hole mass function (L1); counterpart of
the JAX package's ``models/mass.py``.

The bump table is built per draw by kernel A (:mod:`bumpcosmology_torch.ops.cuda_bump`)
on a static ``(G, G)`` grid whose coordinates move with the hyperparameters.
Every function here is batched over chains: :class:`MassParams` leaves are
``(C,)`` tensors, tables are ``(C, G)``, and masses queried against a table
are ``(C, M)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bumpcosmology_torch.models.parameters import MassParams
from bumpcosmology_torch.ops.cuda_bump import bump_log_dn, bump_log_dn_plain
from bumpcosmology_torch.ops.interp import interp_unit_spaced
from bumpcosmology_torch.ops.special import softplus

__all__ = [
    "MBH_MIN",
    "MREF",
    "DEFAULT_N_GRID",
    "mean_mbh_from_mco",
    "largest_mco",
    "log_dndm_co",
    "log_smooth_turnon",
    "pisn_bump_log_dndm_grid",
    "MassFunctionTable",
    "build_mass_function",
    "log_dndm",
]

MBH_MIN = 5.0
MREF = 30.0
MCO_BREAK = 20.0
DEFAULT_N_GRID = 256
_GRID_MBH_LO = 3.0


def mean_mbh_from_mco(mco, mpisn, mbhmax):
    """Identity below ``mpisn``; above, an inverted parabola peaking at ``mbhmax``."""
    curv = 1.0 / (4.0 * (mpisn - mbhmax))
    mco_peak = 2.0 * mbhmax - mpisn
    return torch.where(mco < mpisn, mco, mbhmax + curv * torch.square(mco - mco_peak))


def largest_mco(mpisn, mbhmax):
    """Largest CO core mass yielding a positive BH mass."""
    mco_peak = 2.0 * mbhmax - mpisn
    return mco_peak + torch.sqrt(4.0 * mbhmax * (mbhmax - mpisn))


def log_dndm_co(mco, a, b):
    """Broken power law CO core-mass function, break at 20 Msun."""
    x = torch.log(mco / MCO_BREAK)
    return torch.where(mco < MCO_BREAK, -a * x, -b * x)


def log_smooth_turnon(m, mmin, width=0.05):
    """log(2 sigmoid((m - mmin)/(width mmin))) = log 2 - softplus(-x)."""
    return math.log(2.0) - softplus(-(m - mmin) / (mmin * width))


def pisn_bump_log_dndm_grid(params: MassParams, n_grid: int = DEFAULT_N_GRID, plain: bool = False):
    """``(mbh_lo, dmbh, log_dn)``: log dN/dm of the bump on ``mbh_lo + i*dmbh``,
    ``i < n_grid``, spanning ``[3, mbhmax + 7 sigma]``; ``dmbh`` is ``(C,)`` and
    ``log_dn`` ``(C, n_grid)``.

    The fill + log-trapezoid is kernel A; ``plain=True`` takes its plain twin
    whatever the device (the on-card comparison uses it).
    """
    mbh_hi = params.mbhmax + 7.0 * params.sigma
    dmbh = (mbh_hi - _GRID_MBH_LO) / (n_grid - 1)
    p5 = torch.stack([params.a, params.b, params.mpisn, params.mbhmax, params.sigma], dim=1)
    log_dn = (bump_log_dn_plain if plain else bump_log_dn)(p5, n_grid)
    return _GRID_MBH_LO, dmbh, log_dn


class MassFunctionTable(NamedTuple):
    """Mass-function state for one draw per chain."""

    params: MassParams
    mbh_lo: float  # bump-grid origin (3.0)
    dmbh: torch.Tensor  # (C,)
    mbh_hi: torch.Tensor  # (C,) = mbhmax + 7 sigma
    log_bump: torch.Tensor  # (C, G)
    log_pl_norm: torch.Tensor  # (C,) tail amplitude at mbhmax
    log_norm: torch.Tensor  # (C,) overall normalization: m dN/dm = 1 at MREF


def _log_dndm_unnormed(table: MassFunctionTable, m: torch.Tensor) -> torch.Tensor:
    """Bump + tail without the overall normalization; ``m`` is ``(C, M)``."""
    p = table.params
    mbhmax, c = p.mbhmax[:, None], p.c[:, None]
    log_bump = interp_unit_spaced(m, table.mbh_lo, table.dmbh[:, None], table.log_bump)
    log_bump = torch.where((m <= table.mbh_lo) | (m >= table.mbh_hi[:, None]), -math.inf, log_bump)
    log_tail = -c * torch.log(m / mbhmax) + table.log_pl_norm[:, None] + log_smooth_turnon(m, mbhmax)
    out = torch.logaddexp(log_bump, log_tail)
    return torch.where(m < MBH_MIN, -math.inf, out)


def build_mass_function(params: MassParams, n_grid: int = DEFAULT_N_GRID,
                        plain: bool = False) -> MassFunctionTable:
    """Tabulate the bump, anchor the tail at ``fpl`` times the bump at
    ``mbhmax``, normalize so that ``m dN/dm = 1`` at ``MREF``."""
    mbh_lo, dmbh, log_bump = pisn_bump_log_dndm_grid(params, n_grid, plain)
    mbh_hi = params.mbhmax + 7.0 * params.sigma
    at_max = interp_unit_spaced(params.mbhmax[:, None], mbh_lo, dmbh[:, None], log_bump)[:, 0]
    table = MassFunctionTable(
        params=params,
        mbh_lo=mbh_lo,
        dmbh=dmbh,
        mbh_hi=mbh_hi,
        log_bump=log_bump,
        log_pl_norm=torch.log(params.fpl) + at_max,
        log_norm=torch.zeros_like(dmbh),
    )
    mref = torch.full_like(dmbh[:, None], MREF)
    log_norm = -(_log_dndm_unnormed(table, mref)[:, 0] + math.log(MREF))
    return table._replace(log_norm=log_norm)


def log_dndm(table: MassFunctionTable, m: torch.Tensor) -> torch.Tensor:
    """log dN/dm at BH masses ``m`` of shape ``(C, M)``."""
    return _log_dndm_unnormed(table, m) + table.log_norm[:, None]
