"""Batched network SNR of the injection campaign; counterpart of the JAX
package's ``mock/snr.py``.

    rho_det^2 = 4 int A(f)^2 [F+^2 ((1+cos^2 i)/2)^2 + Fx^2 cos^2 i] / S_n(f) df

on a static log-spaced frequency grid, so every injection shares one kernel
and no per-injection FFT length is needed.  The frequency integral is kernel C
(:func:`bumpcosmology_torch.mock.cuda_snr.snr_integral`): on the card it is
the kernel, on the CPU its plain twin.  There is no switch between the two;
the device of the tensors decides.

All default design PSDs share one spectral shape (V1 is an amplitude-rescaled
aLIGO curve), so the integral against the aLIGO shape is computed once per
injection and the per-detector SNRs differ by the antenna projection and a
scalar PSD ratio.  A detector given its own PSD (``psds``) gets its own
integral, and that integral also runs through kernel C with the detector's
``inv_psd`` on the same grid.  The JAX package integrates such a detector
with a plain XLA trapezoid on ``frequency_grid()``; the two agree to about
1e-6 relative.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.mock.cuda_snr import AMP_SCALE, DEFAULT_CHUNK, snr_integral
from bumpcosmology_torch.mock.detector import DETECTORS, antenna_pattern
from bumpcosmology_torch.mock.psd import PSDS

__all__ = [
    "AMP_SCALE",
    "frequency_grid",
    "network_snr",
    "network_snr_batched",
    "amplitude_factor",
    "projection_factor",
    "draw_projection_factors",
]

DEFAULT_F_MIN = 10.0  # psdstart of the reference campaign
DEFAULT_F_MAX = 2048.0
DEFAULT_N_F = 512
_DEFAULT_DETECTORS = ("H1", "L1", "V1")


def frequency_grid(f_min=DEFAULT_F_MIN, f_max=DEFAULT_F_MAX, n=DEFAULT_N_F, device=None):
    """Static log-spaced frequency grid [Hz], float32 on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    return torch.exp(torch.linspace(math.log(f_min), math.log(f_max), n, device=dev))


def _integral(m1_det, m2_det, dl_gpc, inv_psd, f_grid, chunk):
    return snr_integral(m1_det, m2_det, dl_gpc, inv_psd, f_min=float(f_grid[0]), f_max=float(f_grid[-1]),
                        n_f=f_grid.shape[0], amp_scale=AMP_SCALE, chunk=chunk)


def _psd_ratio(det: str, device) -> torch.Tensor:
    """S_H1 / S_det at 100 Hz: 1 for H1/L1, 0.55^2 for V1."""
    f_probe = torch.tensor([100.0], device=device)
    return PSDS["H1"](f_probe)[0] / PSDS[det](f_probe)[0]


def network_snr(m1_det, m2_det, dl_gpc, iota, ra, dec, psi, gmst, f_grid,
                detectors: Sequence[str] = _DEFAULT_DETECTORS, psds=None, chunk: int = DEFAULT_CHUNK):
    """Per-detector and network SNR for a batch of injections.

    Source arguments are float32 tensors of shape ``(batch,)`` on one device;
    returns a dict of per-detector SNRs and ``net`` = sqrt(sum of squares),
    on that device.  ``psds``: optional ``{detector: psd_callable}``
    overriding the design curves (e.g. :func:`~bumpcosmology_torch.mock.psd.tabulated_psd`).
    ``chunk`` bounds the plain twin's ``(chunk, n_f)`` intermediate on the
    CPU; the kernel ignores it.  (The JAX function's ``use_pallas`` switch has
    no counterpart: the device decides.)
    """
    ci = torch.cos(iota)
    plus_fac = (0.5 * (1.0 + ci * ci)) ** 2
    cross_fac = ci * ci
    integral = _integral(m1_det, m2_det, dl_gpc, 1.0 / PSDS["H1"](f_grid), f_grid, chunk)
    psds = psds or {}
    out = {}
    net2 = 0.0
    for det in detectors:
        if det in psds:  # own shape -> own frequency integral
            det_integral = _integral(m1_det, m2_det, dl_gpc, 1.0 / psds[det](f_grid), f_grid, chunk)
            scale = 1.0
        else:
            det_integral = integral
            scale = _psd_ratio(det, f_grid.device)
        fp, fc = antenna_pattern(DETECTORS[det], ra, dec, psi, gmst)
        proj = fp * fp * plus_fac + fc * fc * cross_fac
        rho2 = 4.0 * proj * det_integral * scale
        out[det] = torch.sqrt(rho2)
        net2 = net2 + rho2
    out["net"] = torch.sqrt(net2)
    return out


def _tensors(arrays, device):
    return [torch.as_tensor(np.array(x, dtype=np.float32), device=device) for x in arrays]


def network_snr_batched(m1_det, m2_det, dl_gpc, iota, ra, dec, psi, gmst, chunk: int = DEFAULT_CHUNK,
                        detectors: Sequence[str] = _DEFAULT_DETECTORS, n_f: int = DEFAULT_N_F, psds=None,
                        device=None):
    """SNRs of a large injection batch (10^7 scale), numpy float32 out.

    The rows move to ``device`` once (``None`` means CUDA) and kernel C runs
    once over all of them; on the CPU the plain twin takes ``chunk`` rows at
    a time.  The result does not depend on ``chunk``.
    """
    dev = resolve_device(device)
    args = _tensors((m1_det, m2_det, dl_gpc, iota, ra, dec, psi, gmst), dev)
    out = network_snr(*args, frequency_grid(n=n_f, device=dev), tuple(detectors), psds=psds, chunk=chunk)
    return {k: v.cpu().numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# Exact SNR separability under the default design PSDs: with one shared
# spectral shape and |h| ~ 1/dL the network SNR factorizes as
#     snr = A(m1_det, m2_det) * Theta(angles) / dL,
# A^2 = 4 int |h(f; dL = 1)|^2 / S_H1 df and Theta^2 = sum_det proj_det S_H1/S_det.


def amplitude_factor(m1_det, m2_det, n_f: int = DEFAULT_N_F, chunk: int = DEFAULT_CHUNK, device=None):
    """A(m1_det, m2_det): network SNR per unit Theta at dL = 1 Gpc (numpy
    float32 out, the shape of ``m1_det``).  Valid for the default design PSDs."""
    dev = resolve_device(device)
    shape = np.shape(m1_det)
    m1, m2 = (t.reshape(-1) for t in _tensors((m1_det, m2_det), dev))
    f_grid = frequency_grid(n=n_f, device=dev)
    integral = _integral(m1, m2, torch.ones_like(m1), 1.0 / PSDS["H1"](f_grid), f_grid, chunk)
    return torch.sqrt(4.0 * integral).cpu().numpy().reshape(shape)


def projection_factor(iota, ra, dec, psi, gmst, device=None):
    """Theta(angles): the H1/L1/V1 network projection factor (numpy float32 out)."""
    dev = resolve_device(device)
    iota, ra, dec, psi, gmst = _tensors((iota, ra, dec, psi, gmst), dev)
    ci = torch.cos(iota)
    plus_fac = (0.5 * (1.0 + ci * ci)) ** 2
    cross_fac = ci * ci
    tot = 0.0
    for det in _DEFAULT_DETECTORS:
        fp, fc = antenna_pattern(DETECTORS[det], ra, dec, psi, gmst)
        tot = tot + (fp * fp * plus_fac + fc * fc * cross_fac) * _psd_ratio(det, dev)
    return torch.sqrt(tot).cpu().numpy()


def draw_projection_factors(rng: np.random.Generator, size, device=None):
    """Theta draws under the campaign's isotropic angle law (uniform cos i,
    sky, psi and GMST)."""
    iota = np.arccos(rng.uniform(-1.0, 1.0, size=size))
    ra = rng.uniform(0.0, 2.0 * np.pi, size=size)
    dec = np.arcsin(rng.uniform(-1.0, 1.0, size=size))
    psi = rng.uniform(0.0, np.pi, size=size)
    gmst = rng.uniform(0.0, 2.0 * np.pi, size=size)
    return projection_factor(iota, ra, dec, psi, gmst, device=device)
