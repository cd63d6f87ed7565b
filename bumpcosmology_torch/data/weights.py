"""Population and PE-prior weights at fixed Planck18; counterpart of the JAX
package's ``data/weights.py``.

The Planck18 helpers are host numpy, float64, on the 8,192-knot master table
(the same float64 code as the JAX package's).  :func:`default_pop_wt`
evaluates the fiducial population's log intensity on ``device`` (``None``
means CUDA), where building the population launches kernel A's forward once
per device, and returns numpy float64 as the JAX function does.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.models.cosmology import DEFAULT_ZMAX, HUBBLE_DISTANCE_H, _planck18_numpy
from bumpcosmology_torch.models.parameters import (
    DEFAULT_POPULATION,
    PLANCK18,
    MassParams,
    PopulationParams,
    RedshiftParams,
)
from bumpcosmology_torch.models.population import PopulationIntensity, build_population, log_dndmdqdv

__all__ = [
    "planck18_efunc_np",
    "planck18_dc_np",
    "planck18_dl_np",
    "planck18_z_of_dl_np",
    "planck18_dvc_dz_np",
    "default_pop_wt",
    "li_prior_wt",
    "dm1sqz_dm1ddqdl",
]

DH = HUBBLE_DISTANCE_H / PLANCK18.h  # Gpc
_Z, _DC, _DL, _DDL, _DVC = _planck18_numpy(DEFAULT_ZMAX, 8192)


def planck18_efunc_np(z):
    opz = 1.0 + np.asarray(z, dtype=np.float64)
    de = (1.0 - PLANCK18.Om) * opz ** (3.0 * (1.0 + PLANCK18.w))
    return np.sqrt(PLANCK18.Om * opz**3 + de)


def planck18_dc_np(z):
    """Comoving distance [Gpc]."""
    return np.interp(np.asarray(z, dtype=np.float64), _Z, _DC)


def planck18_dl_np(z):
    """Luminosity distance [Gpc]."""
    return np.interp(np.asarray(z, dtype=np.float64), _Z, _DL)


def planck18_z_of_dl_np(dl):
    return np.interp(np.asarray(dl, dtype=np.float64), _DL, _Z)


def planck18_dvc_dz_np(z):
    """dVc/dz [Gpc^3], full 4 pi solid angle."""
    return np.interp(np.asarray(z, dtype=np.float64), _Z, _DVC)


@functools.lru_cache(maxsize=None)
def _default_pop(device: torch.device) -> PopulationIntensity:
    """The fiducial population as a one-chain intensity (leaves of shape (1,)),
    built once per device."""
    one = lambda v: torch.full((1,), v, dtype=torch.float32, device=device)  # noqa: E731
    params = PopulationParams(MassParams(*map(one, DEFAULT_POPULATION.mass)),
                              RedshiftParams(*map(one, DEFAULT_POPULATION.redshift)))
    with torch.no_grad():
        return build_population(params)


def default_pop_wt(m1, q, z, device=None):
    """Weight in (m1, q, z) of the fiducial population x comoving-volume
    measure: e^{log dN} dVc/dz/(1+z), numpy float64 of the inputs' shape."""
    dev = resolve_device(device)
    m1 = np.asarray(m1, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    rows = [torch.as_tensor(x.astype(np.float32).reshape(1, -1), device=dev) for x in (m1, q, z)]
    with torch.no_grad():
        log_dn = log_dndmdqdv(_default_pop(dev), *rows)[0].cpu().numpy().astype(np.float64)
    return np.exp(log_dn.reshape(m1.shape)) * planck18_dvc_dz_np(z) / (1.0 + z)


def li_prior_wt(m1, q, z, cosmology_weighted: bool = False):
    """LALInference/Bilby PE prior over (m1, q, z): uniform in detector-frame
    masses and dL^2 by default, so the Jacobian to the source frame gives
    (1+z)^2 m1 dL^2 (dC + (1+z) dH/E); with ``cosmology_weighted``, uniform in
    comoving volume and source time."""
    m1 = np.asarray(m1, dtype=np.float64)
    z = np.asarray(z, dtype=np.float64)
    if cosmology_weighted:
        return (1.0 + z) ** 2 * m1 * planck18_dvc_dz_np(z) / (1.0 + z)
    dl = planck18_dl_np(z)
    dc = planck18_dc_np(z)
    return (1.0 + z) ** 2 * m1 * dl**2 * (dc + (1.0 + z) * DH / planck18_efunc_np(z))


def dm1sqz_dm1ddqdl(m1, q, z):
    """|d(m1_src, q, z)/d(m1_det, q, dL)| at fixed Planck18."""
    z = np.asarray(z, dtype=np.float64)
    dc = planck18_dc_np(z)
    return 1.0 / (1.0 + z) / (dc + (1.0 + z) * DH / planck18_efunc_np(z))
