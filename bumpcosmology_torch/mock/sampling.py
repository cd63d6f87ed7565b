"""Inverse-CDF samplers for the injection campaign (host numpy, float64);
counterpart of the JAX package's ``mock/sampling.py``.

Drawing 10^7 parameter tuples is a host task; the device work of the campaign
is the SNR (:mod:`bumpcosmology_torch.mock.snr`).  The samplers use the same
float64 formulas, seeds and call order as the JAX package's, so the port
draws the same injections bit for bit.
"""
from __future__ import annotations

import numpy as np

from bumpcosmology_torch.models.cosmology import _planck18_numpy

__all__ = ["MadauZPDF", "PowerLawPDF", "InterpolatedPDF"]


class PowerLawPDF:
    """p(x) ~ x^-alpha on [a, b], alpha > 1; closed-form icdf.  Bounds may be
    arrays (p(mtotal | m1) ~ mt^-2 on [m1+5, 2 m1])."""

    def __init__(self, alpha, a, b):
        if not np.all(np.asarray(alpha) > 1):
            raise ValueError(f"PowerLawPDF needs alpha > 1, got {alpha}")
        self.alpha = alpha
        self.a = np.asarray(a, dtype=float)
        self.b = np.asarray(b, dtype=float)
        self.norm = (self.a - (self.a / self.b) ** alpha * self.b) / (self.a * (alpha - 1))

    def __call__(self, x):
        return (self.a / x) ** self.alpha / self.a / self.norm

    def icdf(self, c):
        a, b, al = self.a, self.b, self.alpha
        return ((a**al * b * c + a * b**al * (1 - c)) / (a * b) ** al) ** (1 / (1 - al))


class InterpolatedPDF:
    """PDF defined by a tabulated CDF."""

    def __init__(self, xs, cdfs):
        self.xs = np.asarray(xs, dtype=float)
        self.cdfs = np.asarray(cdfs, dtype=float) / cdfs[-1]
        self.pdfs = np.diff(self.cdfs) / np.diff(self.xs)

    def __call__(self, x):
        i = np.clip(np.searchsorted(self.xs, np.atleast_1d(x)) - 1, 0, len(self.pdfs) - 1)
        return self.pdfs[i]

    def icdf(self, c):
        return np.interp(c, self.cdfs, self.xs)


class MadauZPDF:
    """p(z) ~ (1+z)^lam / (1 + ((1+z)/(1+zp))^kappa) x dVc/dz/(1+z), z < zmax.

    Fiducial (lam, kappa, zp) = (2.7, 5.6, 1.9) under fixed Planck18; icdf
    through a 1024-point cumulative-trapezoid table.
    """

    def __init__(self, lam=2.7, kappa=5.6, zp=1.9, zmax=3.5, n=1024):
        self.lam, self.kappa, self.zp, self.zmax = lam, kappa, zp, zmax
        self.zinterp = np.expm1(np.linspace(0.0, np.log1p(zmax), n))
        z, _, _, _, dvc = _planck18_numpy(zmax, n)
        # dVc/dz includes the 4 pi solid angle; per-steradian measure below
        self._dvdz_dt = dvc / (1.0 + z) / (4.0 * np.pi)
        self.norm = 1.0
        unnorm = self(self.zinterp)
        self.norm = 1.0 / np.trapezoid(unnorm, self.zinterp)
        self.pdfinterp = unnorm * self.norm
        seg = 0.5 * np.diff(self.zinterp) * (self.pdfinterp[:-1] + self.pdfinterp[1:])
        self.cdfinterp = np.concatenate([[0.0], np.cumsum(seg)])

    def _measure(self, z):
        return np.interp(z, self.zinterp, self._dvdz_dt)

    def __call__(self, z):
        shape = (1.0 + z) ** self.lam / (1.0 + ((1.0 + z) / (1.0 + self.zp)) ** self.kappa)
        return self.norm * shape * self._measure(z)

    def icdf(self, c):
        return np.interp(c, self.cdfinterp, self.zinterp)
