"""POWER LAW + SPLINE black-hole mass model (L1), the fourth mass-model
family; no counterpart in the JAX package.

The semi-parametric mass function of Edelman, Doctor, Godfrey & Farr, "Ain't
No Mountain High Enough" (arXiv:2109.06137), one of the BBH mass models of
the GWTC-3 population paper (arXiv:2111.03634): the truncated power law
times the Planck taper, modulated by exp f(log m1), where f is a natural
cubic spline through fixed knots whose heights are sampled:

    p(m1)     ∝ m1^{-α} · S(m1 | mmin, δm) · exp f(log m1),   soft wall above mmax
    p(q | m1) ∝ q^{β_q} · S(q·m1 | mmin, δm) / N_q(m1)     (POWER-LAW+PEAK's pairing)
    f         natural cubic spline in x = log m1 through K = 20 knots
              x_i = log 2 + i h, h = log(100/2) / 19, heights (0, f_1 … f_18, 0)

Across the knots f is linear in the heights: the second derivatives solve a
fixed tridiagonal system (f'' = 0 at both ends), so the four cubic
coefficients of every interval are one fixed ``(18, 19·4)`` matrix applied
to the heights (:func:`spline_coefficients`; the matrix is built once in
float64 and cast to the heights' dtype).  A row reads its interval's four
coefficients through :func:`~bumpcosmology_torch.ops.interp.take_rows`,
whose backward on the card sums in a fixed order, so a value+grad repeats
bit for bit there.  On the card the joint fit's rows take kernel F
(``ops/cuda_families.py``, ``csrc/families_math.cuh``), whose plain twin
this module is, with the coefficient table as a second per-chain table.

Where the port departs from arXiv:2109.06137:

* soft walls in place of hard truncations, as POWER-LAW+PEAK's
  (:mod:`~bumpcosmology_torch.models.plpeak`): the power law falls by
  ``WALL_SLOPE`` nats/Msun above mmax and the whole density by as much above
  ``M_TAB_HI - 10``; the taper has POWER-LAW+PEAK's foot below log S = -8;
* the power law is left unnormalised: the pivot (m dN/dm1 dq dV dt = 1 at
  (MREF, QREF, ZREF)) fixes the rate's scale, and the log-likelihood does not
  depend on a constant of the chain;
* the redshift distribution is the port's Madau–Dickinson rate, not the
  paper's power law in (1 + z);
* f = 0 outside [log 2, log 100] (the knots' span), where a natural spline
  would continue linearly; the pinned end heights keep f continuous there;
* N_q(m1) is POWER-LAW+PEAK's trapezoid table read by linear interpolation.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from bumpcosmology_torch.models.parameters import RedshiftParams
from bumpcosmology_torch.models.plpeak import (
    DEFAULT_N_M,
    DEFAULT_N_Q,
    M_TAB_HI,
    WALL_SLOPE,
    _log_dndmdqdv,
    _log_nq_grid,
    _pivot_log_norm,
    _relu,
    log_planck_taper,
)
from bumpcosmology_torch.ops.interp import take_rows, unit_bracket

__all__ = [
    "N_KNOTS",
    "N_HEIGHTS",
    "M_KNOT_LO",
    "M_KNOT_HI",
    "PSplineMassParams",
    "PSplinePopulationParams",
    "PSplineIntensity",
    "coefficient_matrix",
    "spline_coefficients",
    "log_spline",
    "log_pm1_pspline",
    "build_pspline_population",
]

N_KNOTS = 20
N_HEIGHTS = N_KNOTS - 2  # the end heights are pinned at 0
M_KNOT_LO, M_KNOT_HI = 2.0, 100.0
X0 = math.log(M_KNOT_LO)  # the first knot in x = log m1
H = math.log(M_KNOT_HI / M_KNOT_LO) / (N_KNOTS - 1)  # the knots' spacing in x


class PSplineMassParams(NamedTuple):
    """POWER LAW + SPLINE hyperparameters: the slope ``alpha``, the pairing
    power ``beta_q``, ``mmin``, ``mmax`` and the taper width ``delta_m``
    (Msun), each ``(C,)``, and the spline's interior ``heights`` ``(C, 18)``."""

    alpha: torch.Tensor
    beta_q: torch.Tensor
    mmin: torch.Tensor
    mmax: torch.Tensor
    delta_m: torch.Tensor
    heights: torch.Tensor


class PSplinePopulationParams(NamedTuple):
    """PS mass family × Madau-Dickinson redshift."""

    mass: PSplineMassParams
    redshift: RedshiftParams


def _coefficient_matrix_f64() -> np.ndarray:
    """``(N_HEIGHTS, (N_KNOTS - 1) * 4)`` in float64: the interior heights to
    every interval's ``(c0, c1, c2, c3)``, where on interval i, with
    t = (x - x_i) / h, f = c0 + c1 t + c2 t² + c3 t³.

    The second derivatives M solve M_{i-1} + 4 M_i + M_{i+1} = 6 (y_{i+1} -
    2 y_i + y_{i-1}) / h² at the interior knots with M = 0 at both ends; then
    c0 = y_i, c1 = y_{i+1} - y_i - h² (2 M_i + M_{i+1}) / 6, c2 = h² M_i / 2,
    c3 = h² (M_{i+1} - M_i) / 6."""
    k, n = N_KNOTS, N_HEIGHTS
    y = np.zeros((k, n))
    y[1:-1] = np.eye(n)  # the knots' heights of each unit height
    a = 4.0 * np.eye(n) + np.eye(n, k=1) + np.eye(n, k=-1)
    rhs = 6.0 / (H * H) * (y[2:] - 2.0 * y[1:-1] + y[:-2])
    m = np.zeros((k, n))
    m[1:-1] = np.linalg.solve(a, rhs)
    h2 = H * H
    coef = np.stack([y[:-1], (y[1:] - y[:-1]) - h2 * (2.0 * m[:-1] + m[1:]) / 6.0, 0.5 * h2 * m[:-1],
                     h2 * (m[1:] - m[:-1]) / 6.0], axis=1)  # (K - 1, 4, n)
    return coef.reshape((k - 1) * 4, n).T.copy()


_MATRIX_F64 = _coefficient_matrix_f64()
_MATRICES: Dict[tuple, torch.Tensor] = {}


def coefficient_matrix(dtype: torch.dtype, device) -> torch.Tensor:
    """The coefficient map ``(18, 76)`` in ``dtype`` on ``device``, cast
    once from float64 and kept."""
    key = (dtype, torch.device(device))
    mat = _MATRICES.get(key)
    if mat is None:
        mat = _MATRICES[key] = torch.as_tensor(_MATRIX_F64).to(device=device, dtype=dtype)
    return mat


def spline_coefficients(heights: torch.Tensor) -> torch.Tensor:
    """``(C, 19, 4)``: every interval's cubic coefficients of the spline
    through ``(0, heights, 0)``, for ``heights`` ``(C, 18)``.  A product and
    a sum over the heights, never a matrix product, so no TF32 rounding can
    reach a coefficient."""
    mat = coefficient_matrix(heights.dtype, heights.device)
    return (heights[:, :, None] * mat).sum(1).reshape(-1, N_KNOTS - 1, 4)


def log_spline(coef: torch.Tensor, m1: torch.Tensor, log_m1: torch.Tensor) -> torch.Tensor:
    """f(log m1) at ``(C, M)`` masses from the chains' coefficient tables
    ``(C, 19, 4)``: the interval's cubic in t by Horner's rule, 0 outside
    [M_KNOT_LO, M_KNOT_HI].  ``log_m1`` is ``log(m1)``, shared with the power law."""
    lo, t = unit_bracket(log_m1, X0, H, N_KNOTS)
    c0, c1, c2, c3 = take_rows(coef, lo).unbind(-1)
    f = c0 + t * (c1 + t * (c2 + t * c3))
    return torch.where((m1 >= M_KNOT_LO) & (m1 <= M_KNOT_HI), f, 0.0)


def log_pm1_pspline(p: PSplineMassParams, m1: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """log of the primary-mass density at ``(C, M)`` masses, unnormalised:
    the power law with its wall at ``mmax``, the taper, the spline, and the
    wall at ``M_TAB_HI - 10``."""
    col = lambda x: x[:, None]  # noqa: E731
    log_m = torch.log(m1)
    log_pl = -col(p.alpha) * log_m - WALL_SLOPE * _relu(m1 - col(p.mmax))
    out = log_pl + log_planck_taper(m1, col(p.mmin), col(p.delta_m)) + log_spline(coef, m1, log_m)
    return out - WALL_SLOPE * _relu(m1 - (M_TAB_HI - 10.0))


class PSplineIntensity(NamedTuple):
    """Per-draw PS state for ``C`` chains: params, the q-norm table, the
    pivot normalization and the spline's coefficient table."""

    params: PSplinePopulationParams
    dm: float  # q-norm table spacing (origin M_TAB_LO)
    log_nq: torch.Tensor  # (C, n_m)
    log_norm: torch.Tensor  # (C,)
    coef: torch.Tensor  # (C, 19, 4)

    def log_dndmdqdv(self, m1: torch.Tensor, q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """log dN/dm1/dq/dV/dt at ``(C, M)`` queries under the pivot convention."""
        p = self.params
        return _log_dndmdqdv(lambda mass, m: log_pm1_pspline(mass, m, self.coef), p.mass, p.redshift, self.log_nq,
                             self.dm, self.log_norm, m1, q, z)


def build_pspline_population(params: PSplinePopulationParams, n_m: int = DEFAULT_N_M, n_q: int = DEFAULT_N_Q,
                             pivot: bool = True, coef=None) -> PSplineIntensity:
    """The per-draw PS intensity of ``C`` chains (q-norm table, pivot
    normalization, coefficient table; ``coef`` when given, else computed).
    ``pivot=False`` leaves ``log_norm`` at 0, for kernel F to compute."""
    p = params.mass
    coef = spline_coefficients(p.heights) if coef is None else coef
    dm, log_nq = _log_nq_grid(p.beta_q, p.mmin, p.delta_m, n_m, n_q)
    intensity = PSplineIntensity(params=params, dm=dm, log_nq=log_nq, log_norm=torch.zeros_like(p.alpha), coef=coef)
    return intensity._replace(log_norm=_pivot_log_norm(intensity)) if pivot else intensity
