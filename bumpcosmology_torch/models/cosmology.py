"""Flat wCDM cosmology with interpolated distance/volume tables (L1);
counterpart of the JAX package's ``models/cosmology.py``.

Tables are built per draw and per chain: :class:`CosmoParams` leaves are
``(C,)``, the redshift knots ``z`` are shared (uniform in ``log1p z``), and
every distance column is ``(C, n)``.  Forward lookups are O(1) gathers on the
uniform grid; the inverse lookup z(dL) is a batched searchsorted gather.

Units: distances in Gpc, volumes in Gpc^3, ``dH = c / (100 h km/s/Mpc)``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.models.parameters import PLANCK18, CosmoParams
from bumpcosmology_torch.ops import cuda_tables
from bumpcosmology_torch.ops.integrate import cumtrapz
from bumpcosmology_torch.ops.interp import interp, interp_unit_spaced, interp_unit_spaced_columns

__all__ = [
    "HUBBLE_DISTANCE_H",
    "efunc",
    "hubble_distance",
    "CosmologyTable",
    "build_cosmology",
    "DetectorFrameTable",
    "build_detector_table",
    "kernel_detector_table",
    "z_and_logjac_at_dl",
    "z_at_dl",
    "z_at_dc",
    "dc_at_z",
    "dl_at_z",
    "ddl_dz_at_z",
    "vc_at_z",
    "dvc_dz_at_z",
    "dvc_and_ddl_at_z",
    "log_diff_comoving_volume_rate",
    "planck18_table",
    "planck18_log_dvdz_grid",
]

HUBBLE_DISTANCE_H = 2.99792458  # c / (100 km/s/Mpc) in Gpc
DEFAULT_ZMAX = 100.0
DEFAULT_NZ = 1024


def efunc(z, params: CosmoParams):
    """E(z) = H(z)/H0 for flat wCDM; parameters broadcast against ``z``."""
    opz = 1.0 + z
    return torch.sqrt(params.Om * opz * opz * opz + (1.0 - params.Om) * opz ** (3.0 * (1.0 + params.w)))


def hubble_distance(params: CosmoParams):
    """Hubble distance c/H0 in Gpc."""
    return HUBBLE_DISTANCE_H / params.h


class CosmologyTable(NamedTuple):
    """Distance/volume tables for one draw per chain; knots ``z[i] = expm1(u0 + i du)``."""

    params: CosmoParams
    u0: float
    du: float
    z: torch.Tensor  # (n,) shared redshift knots
    dc: torch.Tensor  # (C, n) comoving distance
    dl: torch.Tensor  # (C, n) luminosity distance
    ddl: torch.Tensor  # (C, n) d(dL)/dz
    dvc: torch.Tensor  # (C, n) dVc/dz = 4 pi dc^2 dH / E

    @property
    def vc(self) -> torch.Tensor:
        """(C, n) comoving volume 4/3 pi dc^3, formed when read: the likelihood never reads it."""
        return (4.0 / 3.0) * math.pi * self.dc * self.dc * self.dc


def build_cosmology(params: CosmoParams, zmax: float = DEFAULT_ZMAX, n: int = DEFAULT_NZ) -> CosmologyTable:
    """Build the tables by cumulative trapezoid of dH/E on a log1p(z)-uniform grid."""
    h = params.h
    u = torch.linspace(0.0, math.log1p(zmax), n, dtype=h.dtype, device=h.device)
    z = torch.expm1(u)
    col = lambda x: x[:, None]  # noqa: E731  (C,) -> (C, 1)
    dh = HUBBLE_DISTANCE_H / col(h)
    inv_e = 1.0 / efunc(z, CosmoParams(col(h), col(params.Om), col(params.w)))
    dc = dh * cumtrapz(inv_e, z)
    return CosmologyTable(
        params=params,
        u0=0.0,
        du=math.log1p(zmax) / (n - 1),
        z=z,
        dc=dc,
        dl=dc * (1.0 + z),
        ddl=dc + dh * (1.0 + z) * inv_e,
        dvc=4.0 * math.pi * dc * dc * dh * inv_e,
    )


def _forward(table: CosmologyTable, z: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """O(1) lookup of a ``(C, n)`` table column at redshifts ``z`` of shape ``(C, M)``."""
    return interp_unit_spaced(torch.log1p(z), table.u0, table.du, col)


def dc_at_z(table: CosmologyTable, z: torch.Tensor) -> torch.Tensor:
    """Comoving distance at redshifts ``z`` of shape ``(C, M)``."""
    return _forward(table, z, table.dc)


def dl_at_z(table: CosmologyTable, z: torch.Tensor) -> torch.Tensor:
    """Luminosity distance at redshifts ``z`` of shape ``(C, M)``."""
    return _forward(table, z, table.dl)


def ddl_dz_at_z(table: CosmologyTable, z: torch.Tensor) -> torch.Tensor:
    """d(dL)/dz at redshifts ``z`` of shape ``(C, M)``."""
    return _forward(table, z, table.ddl)


def vc_at_z(table: CosmologyTable, z: torch.Tensor) -> torch.Tensor:
    """Comoving volume at redshifts ``z`` of shape ``(C, M)``."""
    return _forward(table, z, table.vc)


def dvc_dz_at_z(table: CosmologyTable, z: torch.Tensor) -> torch.Tensor:
    """dVc/dz at redshifts ``z`` of shape ``(C, M)``."""
    return _forward(table, z, table.dvc)


def log_diff_comoving_volume_rate(table: CosmologyTable, z: torch.Tensor) -> torch.Tensor:
    """log of 4 pi dVc/dz / (1+z), the comoving-volume x time-dilation measure
    (``dvc`` already spans the 4 pi of sky)."""
    return torch.log(_forward(table, z, table.dvc)) - torch.log1p(z)


def dvc_and_ddl_at_z(table: CosmologyTable, z: torch.Tensor):
    """(dVc/dz, ddL/dz) at ``z`` ``(C, M)``, sharing one bracket."""
    cols = torch.stack([table.dvc, table.ddl], dim=-1)  # (C, n, 2)
    out = interp_unit_spaced_columns(torch.log1p(z), table.u0, table.du, cols)
    return out[..., 0], out[..., 1]


def z_at_dl(table: CosmologyTable, dl: torch.Tensor) -> torch.Tensor:
    """Inverse lookup z(dL) for ``dl`` of shape ``(C, M)``."""
    return interp(dl, table.dl, table.z)


def z_at_dc(table: CosmologyTable, dc: torch.Tensor) -> torch.Tensor:
    """Inverse lookup z(dC) for ``dc`` of shape ``(C, M)``."""
    return interp(dc, table.dc, table.z)


class DetectorFrameTable(NamedTuple):
    """Per-draw inverse table keyed on v = log(dL): ``cols[c, k] = [z, log_jac]``
    at ``v0 + k dv``, with log_jac = log dVc/dz - log ddL/dz."""

    params: CosmoParams
    v0: float
    dv: float
    cols: torch.Tensor  # (C, n, 2)


def build_detector_table(table: CosmologyTable, dl_lo: float, dl_hi: float,
                         n: int = DEFAULT_NZ) -> DetectorFrameTable:
    """The log(dL)-keyed inverse table, per draw and chain.

    The joint likelihood builds it at ``n = n_z`` points, as the JAX package's
    fused/Pallas route does (``likelihoods.py:472``)."""
    v0 = math.log(float(dl_lo))
    v1 = math.log(float(dl_hi))
    c = table.dl.shape[0]
    v = torch.linspace(v0, v1, n, dtype=table.dl.dtype, device=table.dl.device)
    z = z_at_dl(table, torch.exp(v).expand(c, n))
    dvc, ddl = dvc_and_ddl_at_z(table, z)
    # finite-table guard (cosmology.py:205-209): a dl_lo at z ~ 0 would give a
    # -inf entry; -1e4 is zero weight in any downstream exp
    log_jac = torch.clamp_min(torch.log(dvc) - torch.log(ddl), -1e4)
    return DetectorFrameTable(params=table.params, v0=v0, dv=(v1 - v0) / (n - 1),
                              cols=torch.stack([z, log_jac], dim=-1))


def kernel_detector_table(params: CosmoParams, dl_lo: float, dl_hi: float, n: int = DEFAULT_NZ,
                          zmax: float = DEFAULT_ZMAX) -> DetectorFrameTable:
    """``build_detector_table(build_cosmology(params, zmax, n), dl_lo, dl_hi, n)``
    from CUDA sites ``(C,)`` by kernel T (:mod:`~bumpcosmology_torch.ops.cuda_tables`),
    one launch forward and one backward, with no cosmology table.  Sites that
    are strided views (a batch of sites cut from one tensor) are copied first."""
    v0, v1 = math.log(float(dl_lo)), math.log(float(dl_hi))
    cols = cuda_tables.detector_table(*(x.contiguous() for x in params), n, dl_lo, dl_hi, zmax)
    return DetectorFrameTable(params=params, v0=v0, dv=(v1 - v0) / (n - 1), cols=cols)


def z_and_logjac_at_dl(det: DetectorFrameTable, dl: torch.Tensor):
    """(z, log_jac) at luminosity distances ``dl`` of shape ``(C, M)``."""
    out = interp_unit_spaced_columns(torch.log(dl), det.v0, det.dv, det.cols)
    return out[..., 0], out[..., 1]


def _planck18_numpy(zmax: float, n: int):
    u = np.linspace(0.0, np.log1p(zmax), n)
    z = np.expm1(u)
    dh = HUBBLE_DISTANCE_H / PLANCK18.h
    opz = 1.0 + z
    inv_e = 1.0 / np.sqrt(PLANCK18.Om * opz**3 + (1.0 - PLANCK18.Om) * opz ** (3.0 * (1.0 + PLANCK18.w)))
    seg = 0.5 * np.diff(z) * (inv_e[:-1] + inv_e[1:])
    dc = dh * np.concatenate([[0.0], np.cumsum(seg)])
    return z, dc, dc * opz, dc + dh * opz * inv_e, 4.0 * np.pi * dc**2 * dh * inv_e


def planck18_table(device=None, dtype=torch.float32, n: int = 8192) -> CosmologyTable:
    """The fixed Planck18 table (float64 numpy, 8192 knots) as a one-chain
    :class:`CosmologyTable` on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    z, dc, dl, ddl, dvc = (torch.as_tensor(x, dtype=dtype, device=dev) for x in
                           _planck18_numpy(DEFAULT_ZMAX, n))
    one = lambda x: torch.full((1,), x, dtype=dtype, device=dev)  # noqa: E731
    return CosmologyTable(
        params=CosmoParams(one(PLANCK18.h), one(PLANCK18.Om), one(PLANCK18.w)),
        u0=0.0, du=math.log1p(DEFAULT_ZMAX) / (n - 1),
        z=z, dc=dc[None], dl=dl[None], ddl=ddl[None], dvc=dvc[None],
    )


def planck18_log_dvdz_grid(zmax: float = DEFAULT_ZMAX, n: int = DEFAULT_NZ):
    """``(z, log[4 pi dVc/dz / (1+z)])`` at fixed Planck18, float64 numpy on a
    log1p(z)-uniform grid, ``-inf`` at z = 0: the measure the population-only
    likelihood interpolates (``planck18_log_dvdz_grid``, the JAX package's
    ``models/cosmology.py:286-301``).  ``dvc`` already spans the 4 pi of sky."""
    z, _, _, _, dvc = _planck18_numpy(zmax, n)
    log_dvc = np.log(dvc, out=np.full_like(dvc, -np.inf), where=dvc > 0)
    return z, np.where(z > 0, log_dvc - np.log1p(z), -np.inf)
