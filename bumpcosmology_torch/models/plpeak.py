"""POWER-LAW + PEAK black-hole mass model (L1); counterpart of the JAX
package's ``models/plpeak.py``, the second mass-model family.

The GWTC-3 fiducial phenomenological population: the primary-mass density is
a truncated power law plus a Gaussian peak, both times a Planck-taper turn-on
at ``mmin``; the pairing is a power law in q with the same taper on the
secondary mass, normalized over q per primary mass:

    p(m1)      ∝ [ (1-λ)·PL(m1 | -α, mmin, mmax) + λ·N(m1 | μ_m, σ_m) ] · S(m1)
    p(q | m1)  ∝ q^{β_q} · S(q·m1) / N_q(m1),   N_q(m1) = ∫ dq q^{β_q} S(q·m1)

under the pivot convention m·dN/dm1 dq dV dt = 1 at (MREF, QREF, ZREF).  The
hard supports are soft walls (linear log-density ramps), as in the JAX
package, with the same constants.

Batched over chains like the rest of the port: parameter leaves are ``(C,)``,
queries ``(C, M)``, the q-normalization table ``(C, n_m)``.  Everything here
is plain PyTorch with autograd (the JAX package sends the family through
XLA).  On the card the joint fit's rows, pivot and segment log-sum-exps take
kernel F (``ops/cuda_families.py``, ``csrc/families_math.cuh``), whose plain
twin this module is; only :func:`_log_nq_grid` runs there in PyTorch.  The
gradient guards are the JAX package's: the taper's interior is evaluated at a clamped ``x``, the norm
swaps in ``x_safe`` near ``α = 1``, and every ``clip``/``maximum`` that a
test point can tie (the taper's clamp and ramps, the walls) is
``torch.maximum``/``torch.minimum``, whose gradient at a tie splits as JAX's does.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bumpcosmology_torch.models.mass import MREF
from bumpcosmology_torch.models.parameters import RedshiftParams
from bumpcosmology_torch.models.redshift import ZREF, log_dndv
from bumpcosmology_torch.ops.integrate import log_trapz
from bumpcosmology_torch.ops.interp import interp_unit_spaced

__all__ = [
    "PLPeakMassParams",
    "PLPeakPopulationParams",
    "PLPeakIntensity",
    "DEFAULT_PLPEAK_MASS",
    "DEFAULT_PLPEAK_POPULATION",
    "log_planck_taper",
    "log_pm1_plpeak",
    "build_plpeak_population",
]

# Static q-normalization table coordinates (the JAX package's values): the m1
# axis covers every queried primary mass of any prior draw; above M_TAB_HI the
# table extrapolates as a constant.
M_TAB_LO = 2.0
M_TAB_HI = 200.0
Q_TAB_LO = 1e-3  # q-quadrature lower edge (log-spaced nodes)
DEFAULT_N_M = 256
DEFAULT_N_Q = 128
QREF = 1.0  # pivot mass ratio, shared with the bump family

# Soft-wall slope [nats/Msun] replacing the hard truncations at mmax and the
# q-table edge, where the density is continuous.
WALL_SLOPE = 25.0
# The taper is exact down to log S = -8, at x = X_C·δ (the smaller root of
# 8x² − 10δx + δ² = 0), and continues below as a ramp of FOOT_SLOPE.
X_C = (10.0 - math.sqrt(68.0)) / 16.0
FOOT_SLOPE = 4.0


class PLPeakMassParams(NamedTuple):
    """POWER-LAW+PEAK hyperparameters, each ``(C,)``: the slope ``alpha``,
    the pairing power ``beta_q``, ``mmin``, ``mmax``, the peak fraction
    ``lam_peak``, location ``mu_m`` and width ``sigma_m``, the taper width
    ``delta_m`` (Msun)."""

    alpha: torch.Tensor
    beta_q: torch.Tensor
    mmin: torch.Tensor
    mmax: torch.Tensor
    lam_peak: torch.Tensor
    mu_m: torch.Tensor
    sigma_m: torch.Tensor
    delta_m: torch.Tensor


class PLPeakPopulationParams(NamedTuple):
    """PLPeak mass family × Madau-Dickinson redshift."""

    mass: PLPeakMassParams
    redshift: RedshiftParams


DEFAULT_PLPEAK_MASS = PLPeakMassParams(
    alpha=3.5, beta_q=1.1, mmin=5.0, mmax=87.0, lam_peak=0.04,
    mu_m=34.0, sigma_m=3.6, delta_m=4.9,
)
DEFAULT_PLPEAK_POPULATION = PLPeakPopulationParams(
    mass=DEFAULT_PLPEAK_MASS,
    redshift=RedshiftParams(lam=4.7, kappa=7.0, zp=3.0),
)


def _relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with JAX's gradient at the tie (half)."""
    return torch.maximum(x, x.new_zeros(()))


def log_planck_taper(m: torch.Tensor, mmin: torch.Tensor, delta_m: torch.Tensor) -> torch.Tensor:
    """log S(m): the Planck-taper turn-on, exact where S ≥ e⁻⁸, a linear ramp
    of slope ``FOOT_SLOPE`` below, 0 above ``mmin + delta_m``.  Arguments
    broadcast (pass ``(C, 1)`` parameters against ``(C, M)`` masses).

    The interior ``-softplus(δ/x + δ/(x-δ))`` is evaluated at ``x`` clamped to
    [X_C·δ, 0.98δ], so reverse mode never meets an inf·0; at ``δ = 0`` the
    taper is an 8-nat soft step at ``mmin``.  Constants are made on the
    device (``new_full``), never copied from the host."""
    x = m - mmin
    dm_safe = torch.maximum(delta_m, delta_m.new_full((), 1e-6))
    x_lo = X_C * dm_safe
    x_in = torch.minimum(torch.maximum(x, x_lo), 0.98 * dm_safe)
    f = dm_safe / x_in + dm_safe / (x_in - dm_safe)
    f = torch.clamp(f, -80.0, 80.0)
    mid = -torch.logaddexp(f, f.new_zeros(()))  # -softplus(f), as the JAX package computes it
    below = mid - FOOT_SLOPE * _relu(x_lo - x)
    return torch.where(x >= dm_safe, 0.0, below)


def _log_pl_norm_inv(alpha: torch.Tensor, mmin: torch.Tensor, mmax: torch.Tensor) -> torch.Tensor:
    """log ∫_mmin^mmax m^{-α} dm, stable through α = 1: with t = 1-α and
    L = log(mmax/mmin), ∫ = mmin^t · L · expm1(tL)/(tL)."""
    t = 1.0 - alpha
    L = torch.log(mmax / mmin)
    x = t * L
    small = torch.abs(x) < 1e-12
    x_safe = torch.where(small, 1.0, x)
    ratio = torch.where(small, 1.0 + 0.5 * x, torch.expm1(x_safe) / x_safe)
    return t * torch.log(mmin) + torch.log(L) + torch.log(ratio)


def log_pm1_plpeak(p: PLPeakMassParams, m1: torch.Tensor) -> torch.Tensor:
    """log of the primary-mass density at ``(C, M)`` masses: the mixture of the
    truncated power law and the Gaussian peak (each normalized), times the
    taper, with the soft walls at ``mmax`` (power law) and ``M_TAB_HI - 10``."""
    col = lambda x: x[:, None]  # noqa: E731
    log_pl = (
        torch.log1p(-col(p.lam_peak))
        - col(p.alpha) * torch.log(m1)
        - col(_log_pl_norm_inv(p.alpha, p.mmin, p.mmax))
    )
    log_pl = log_pl - WALL_SLOPE * _relu(m1 - col(p.mmax))
    log_peak = (
        torch.log(col(p.lam_peak))
        - 0.5 * torch.square((m1 - col(p.mu_m)) / col(p.sigma_m))
        - torch.log(col(p.sigma_m))
        - 0.5 * math.log(2.0 * math.pi)
    )
    out = torch.logaddexp(log_pl, log_peak) + log_planck_taper(m1, col(p.mmin), col(p.delta_m))
    return out - WALL_SLOPE * _relu(m1 - (M_TAB_HI - 10.0))


def _log_dndmdqdv(log_pm1, mass, redshift: RedshiftParams, log_nq_table, dm, log_norm, m1, q, z):
    """The pairing, the q-norm lookup, the rate and the pivot on top of
    ``log_pm1(mass, m1)``; shared with the broken power law."""
    col = lambda x: x[:, None]  # noqa: E731
    log_nq = interp_unit_spaced(m1, M_TAB_LO, dm, log_nq_table)
    return (
        log_pm1(mass, m1)
        + col(mass.beta_q) * torch.log(q)
        + log_planck_taper(q * m1, col(mass.mmin), col(mass.delta_m))
        - log_nq
        + log_dndv(z, RedshiftParams(*(col(x) for x in redshift)))
        + col(log_norm)
    )


class PLPeakIntensity(NamedTuple):
    """Per-draw PLPeak state for ``C`` chains: params, the q-norm table and
    the pivot normalization; the generic ``log_dndmdqdv`` calls the method."""

    params: PLPeakPopulationParams
    dm: float  # q-norm table spacing (origin M_TAB_LO)
    log_nq: torch.Tensor  # (C, n_m) log ∫ dq q^β S(q·m1) on the uniform m1 grid
    log_norm: torch.Tensor  # (C,) pivot normalization

    def log_dndmdqdv(self, m1: torch.Tensor, q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """log dN/dm1/dq/dV/dt at ``(C, M)`` queries under the pivot convention."""
        p = self.params
        return _log_dndmdqdv(log_pm1_plpeak, p.mass, p.redshift, self.log_nq, self.dm, self.log_norm, m1, q, z)


def _linspace(start: float, stop: float, n: int, like: torch.Tensor) -> torch.Tensor:
    """``start (1 - s) + stop s`` with s = k/(n-1), the last point ``stop``: the
    nodes of the JAX package's ``linspace`` in the table's dtype."""
    s = torch.arange(n - 1, dtype=like.dtype, device=like.device) / (n - 1)
    start_t, stop_t = like.new_full((), start), like.new_full((), stop)
    return torch.cat([start_t * (1 - s) + stop_t * s, stop_t[None]])


def _log_nq_grid(beta_q: torch.Tensor, mmin: torch.Tensor, delta_m: torch.Tensor, n_m: int, n_q: int):
    """``(dm, log_nq (C, n_m))``: log N_q(m1) = log ∫_{Q_TAB_LO}^1 dq q^β S(q·m1)
    on the uniform m1 grid, by the trapezoid rule in u = log q over a ``(C,
    n_m, n_q)`` integrand (a log-sum-exp, never a matrix product).  Shared by
    both power-law-in-q families."""
    dm = (M_TAB_HI - M_TAB_LO) / (n_m - 1)
    m1 = M_TAB_LO + dm * torch.arange(n_m, dtype=beta_q.dtype, device=beta_q.device)
    u = _linspace(math.log(Q_TAB_LO), 0.0, n_q, beta_q)
    cube = lambda x: x[:, None, None]  # noqa: E731
    log_integrand = (cube(beta_q) + 1.0) * u + log_planck_taper(
        torch.exp(u) * m1[:, None], cube(mmin), cube(delta_m))
    # the floor guards only underflow corners; the soft foot keeps every entry finite
    return dm, log_trapz(torch.maximum(log_integrand, log_integrand.new_full((), -1e4)), u, axis=-1)


def _pivot_log_norm(intensity) -> torch.Tensor:
    """-(log m dN/dm1dqdVdt at (MREF, QREF, ZREF) + log MREF), ``(C,)``."""
    c = intensity.log_norm.shape[0]
    at = lambda v: intensity.log_norm.new_full((c, 1), v)  # noqa: E731
    return -(intensity.log_dndmdqdv(at(MREF), at(QREF), at(ZREF))[:, 0] + math.log(MREF))


def build_plpeak_population(params: PLPeakPopulationParams, n_m: int = DEFAULT_N_M,
                            n_q: int = DEFAULT_N_Q, pivot: bool = True) -> PLPeakIntensity:
    """The per-draw PLPeak intensity of ``C`` chains (q-norm table + pivot
    normalization).  ``pivot=False`` leaves ``log_norm`` at 0, for a caller
    that computes the pivot itself (kernel F does, in the kernel)."""
    p = params.mass
    dm, log_nq = _log_nq_grid(p.beta_q, p.mmin, p.delta_m, n_m, n_q)
    intensity = PLPeakIntensity(params=params, dm=dm, log_nq=log_nq, log_norm=torch.zeros_like(p.alpha))
    return intensity._replace(log_norm=_pivot_log_norm(intensity)) if pivot else intensity
