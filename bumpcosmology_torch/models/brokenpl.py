"""BROKEN POWER LAW black-hole mass model (L1); counterpart of the JAX
package's ``models/brokenpl.py``, the third mass-model family.

The LVK appendix-B alternative: a power law with a break,

    p(m1) ∝ m1^{-α1}                      mmin < m1 < mbreak
    p(m1) ∝ m1^{-α2} · mbreak^{α2-α1}     mbreak ≤ m1 < mmax
    mbreak = mmin + b·(mmax − mmin)

times the Planck taper, continuous at the break; the pairing is the
POWER-LAW+PEAK family's q^{β_q}·S(q·m1), so the taper, the power-law norm and
the q-normalization table come from :mod:`bumpcosmology_torch.models.plpeak`,
as the JAX module takes them from its sibling.  Same pivot convention, same
batching (``(C,)`` parameters, ``(C, M)`` queries), plain PyTorch with
autograd; on the card the joint fit's rows take kernel F
(``ops/cuda_families.py``), whose plain twin this module is.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bumpcosmology_torch.models.parameters import RedshiftParams
from bumpcosmology_torch.models.plpeak import (
    DEFAULT_N_M,
    DEFAULT_N_Q,
    M_TAB_HI,
    WALL_SLOPE,
    _log_dndmdqdv,
    _log_nq_grid,
    _log_pl_norm_inv,
    _pivot_log_norm,
    _relu,
    log_planck_taper,
)

__all__ = [
    "BrokenPLMassParams",
    "BrokenPLPopulationParams",
    "BrokenPLIntensity",
    "DEFAULT_BROKENPL_MASS",
    "DEFAULT_BROKENPL_POPULATION",
    "log_pm1_brokenpl",
    "build_brokenpl_population",
]


class BrokenPLMassParams(NamedTuple):
    """BROKEN POWER LAW hyperparameters, each ``(C,)``: slopes ``alpha1``
    below and ``alpha2`` above the break, the break at ``bfrac`` of
    (mmax - mmin), the pairing power ``beta_q``, ``mmin``, ``mmax`` and the
    taper width ``delta_m`` (Msun)."""

    alpha1: torch.Tensor
    alpha2: torch.Tensor
    bfrac: torch.Tensor
    beta_q: torch.Tensor
    mmin: torch.Tensor
    mmax: torch.Tensor
    delta_m: torch.Tensor


class BrokenPLPopulationParams(NamedTuple):
    """BrokenPL mass family × Madau-Dickinson redshift."""

    mass: BrokenPLMassParams
    redshift: RedshiftParams


DEFAULT_BROKENPL_MASS = BrokenPLMassParams(
    alpha1=1.6, alpha2=5.6, bfrac=0.43, beta_q=1.4, mmin=4.0, mmax=87.0, delta_m=4.8,
)
DEFAULT_BROKENPL_POPULATION = BrokenPLPopulationParams(
    mass=DEFAULT_BROKENPL_MASS,
    redshift=RedshiftParams(lam=4.7, kappa=7.0, zp=3.0),
)


def log_pm1_brokenpl(p: BrokenPLMassParams, m1: torch.Tensor) -> torch.Tensor:
    """log of the normalized-then-tapered primary-mass density at ``(C, M)``
    masses.  The normalizer I1 + I2 (each by the ``expm1(x)/x`` form) is
    analytic; the taper is applied on top and absorbed by the pivot.

    Two soft walls: at ``mmax``, and at exactly ``M_TAB_HI`` (not inside it,
    as the other family has it), because this family's mmax prior reaches
    ``M_TAB_HI``.  The break selects one of two finite branches."""
    col = lambda x: x[:, None]  # noqa: E731
    mbreak = p.mmin + p.bfrac * (p.mmax - p.mmin)
    log_m1 = torch.log(m1)
    log_lo = -col(p.alpha1) * log_m1
    log_hi = -col(p.alpha2) * log_m1 + col((p.alpha2 - p.alpha1) * torch.log(mbreak))
    log_i1 = _log_pl_norm_inv(p.alpha1, p.mmin, mbreak)
    log_i2 = (p.alpha2 - p.alpha1) * torch.log(mbreak) + _log_pl_norm_inv(p.alpha2, mbreak, p.mmax)
    log_norm = torch.logaddexp(log_i1, log_i2)
    out = (
        torch.where(m1 < col(mbreak), log_lo, log_hi)
        - col(log_norm)
        + log_planck_taper(m1, col(p.mmin), col(p.delta_m))
    )
    return out - WALL_SLOPE * _relu(m1 - col(p.mmax)) - WALL_SLOPE * _relu(m1 - M_TAB_HI)


class BrokenPLIntensity(NamedTuple):
    """Per-draw BrokenPL state for ``C`` chains: params, the shared q-norm
    table and the pivot normalization; the generic ``log_dndmdqdv`` calls the
    method."""

    params: BrokenPLPopulationParams
    dm: float  # q-norm table spacing (origin M_TAB_LO)
    log_nq: torch.Tensor  # (C, n_m)
    log_norm: torch.Tensor  # (C,)

    def log_dndmdqdv(self, m1: torch.Tensor, q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """log dN/dm1/dq/dV/dt at ``(C, M)`` queries under the pivot convention."""
        p = self.params
        return _log_dndmdqdv(log_pm1_brokenpl, p.mass, p.redshift, self.log_nq, self.dm, self.log_norm,
                             m1, q, z)


def build_brokenpl_population(params: BrokenPLPopulationParams, n_m: int = DEFAULT_N_M,
                              n_q: int = DEFAULT_N_Q, pivot: bool = True) -> BrokenPLIntensity:
    """The per-draw BrokenPL intensity of ``C`` chains (q-norm table + pivot
    normalization).  ``pivot=False`` leaves ``log_norm`` at 0, for a caller
    that computes the pivot itself (kernel F does, in the kernel)."""
    p = params.mass
    dm, log_nq = _log_nq_grid(p.beta_q, p.mmin, p.delta_m, n_m, n_q)
    intensity = BrokenPLIntensity(params=params, dm=dm, log_nq=log_nq, log_norm=torch.zeros_like(p.alpha1))
    return intensity._replace(log_norm=_pivot_log_norm(intensity)) if pivot else intensity
