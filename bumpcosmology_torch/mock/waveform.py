"""PhenomA-family frequency-domain amplitude (tensor code); counterpart of the
JAX package's ``mock/waveform.py``.

Only |h(f)| enters the SNR, so the campaign uses the closed-form piecewise
amplitude of Ajith et al. 2008 (Phys. Rev. D 77, 104017):

    A(f) = A_N f_merg^{-7/6} *  (f/f_merg)^{-7/6}        f < f_merg
                                (f/f_merg)^{-2/3}        f_merg <= f < f_ring
                                w L(f; f_ring, sigma)    f_ring <= f < f_cut

with transition frequencies (a eta^2 + b eta + c) / (pi M) and the Newtonian
SPA normalization A_N = sqrt(5/24) pi^{-2/3} (G Mc/c^3)^{5/6} c / dL.
Kernel C (:mod:`bumpcosmology_torch.mock.cuda_snr`) fuses this amplitude into
the SNR integral; the function here is the one the tests hold it against.
"""
from __future__ import annotations

import math

import torch

__all__ = ["MSUN_S", "C_SI", "GPC_M", "chirp_mass", "phenom_a_amplitude", "chirp_time_bound"]

MSUN_S = 4.925490947641267e-6  # G Msun / c^3 [s]
C_SI = 2.99792458e8  # [m/s]
GPC_M = 3.0856775814913673e25  # [m]

# PhenomA transition-frequency polynomial coefficients (Ajith et al. 2008,
# Table I): f_X = (a eta^2 + b eta + c) / (pi M_total) with M in seconds.
FMERG = (2.9740e-1, 4.4810e-2, 9.5560e-2)
FRING = (5.9411e-1, 8.9794e-2, 1.9111e-1)
SIGMA = (5.0801e-1, 7.7515e-2, 2.2369e-2)
FCUT = (8.4845e-1, 1.2848e-1, 2.7299e-1)


def transition(coeffs, eta, m_total_s):
    """(a eta^2 + b eta + c) / (pi M_s), in the operation order kernel C uses."""
    a, b, c = coeffs
    return (a * eta * eta + b * eta + c) / (math.pi * m_total_s)


def chirp_mass(m1, m2):
    return (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2


def chirp_time_bound(fmin, m1_det, m2_det):
    """Newtonian chirp-time upper bound [s] from ``fmin`` (diagnostics only:
    the static log-f grid needs no per-injection FFT length)."""
    mc_s = chirp_mass(m1_det, m2_det) * MSUN_S
    return 5.0 / 256.0 * mc_s * (math.pi * mc_s * fmin) ** (-8.0 / 3.0)


def phenom_a_amplitude(f, m1_det, m2_det, dl_gpc):
    """|h(f)| of the dominant mode for an optimally oriented source [1/Hz].

    Tensors broadcast: ``f`` may be a frequency grid, masses and distance may
    carry a batch dimension.  Detector-frame masses in Msun, dL in Gpc.
    """
    m_total = m1_det + m2_det
    eta = m1_det * m2_det / (m_total * m_total)
    m_total_s = m_total * MSUN_S
    mc_s = chirp_mass(m1_det, m2_det) * MSUN_S

    f_merg = transition(FMERG, eta, m_total_s)
    f_ring = transition(FRING, eta, m_total_s)
    sigma = transition(SIGMA, eta, m_total_s)
    f_cut = transition(FCUT, eta, m_total_s)

    a_newt = math.sqrt(5.0 / 24.0) * math.pi ** (-2.0 / 3.0) * mc_s ** (5.0 / 6.0) * (C_SI / (dl_gpc * GPC_M))

    x = f / f_merg
    insp = x ** (-7.0 / 6.0)
    merg = x ** (-2.0 / 3.0)
    # Lorentzian ringdown, continuous at f_ring
    lor = (sigma / 2.0) ** 2 / ((f - f_ring) ** 2 + (sigma / 2.0) ** 2)
    ring = (f_ring / f_merg) ** (-2.0 / 3.0) * lor

    amp = torch.where(f < f_merg, insp, torch.where(f < f_ring, merg, ring))
    amp = torch.where((f >= f_cut) | (f <= 0.0), 0.0, amp)
    # the piecewise form is relative to f_merg; restore the absolute scale so
    # the inspiral branch equals the Newtonian SPA a_newt * f^{-7/6}
    return a_newt * f_merg ** (-7.0 / 6.0) * amp
