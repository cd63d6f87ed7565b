"""Detector geometry and antenna response; counterpart of the JAX package's
``mock/detector.py``.

A detector is its response tensor D = (u u^T - v v^T)/2 from the arm unit
vectors at its site (numpy float64, built once); F+ and Fx contract D with
the wave-frame polarization vectors built from (ra, dec, psi, gmst).  The
geometry follows the public LAL detector tables (LIGO-T980044).

The (..., 3) x (3, 3) contraction is written out as elementwise sums over the
nine entries of D, not as a matrix product: a GPU matmul of float32 may run
in TF32, and a 3x3 product gains nothing from a GEMM.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["DETECTORS", "Detector", "antenna_pattern", "make_response_tensor"]


class Detector(NamedTuple):
    name: str
    response: np.ndarray  # (3,3) response tensor D


def _site_frame(lat_rad, lon_rad):
    """(east, north, up) unit vectors of a site in the Earth-fixed frame."""
    sphi, cphi = math.sin(lat_rad), math.cos(lat_rad)
    slam, clam = math.sin(lon_rad), math.cos(lon_rad)
    east = np.array([-slam, clam, 0.0])
    north = np.array([-sphi * clam, -sphi * slam, cphi])
    up = np.array([cphi * clam, cphi * slam, sphi])
    return east, north, up


def _arm_vector(lat_rad, lon_rad, azimuth_rad):
    """Unit vector of a horizontal arm; azimuth clockwise from North."""
    east, north, _ = _site_frame(lat_rad, lon_rad)
    return north * math.cos(azimuth_rad) + east * math.sin(azimuth_rad)


def make_response_tensor(lat_deg, lon_deg, x_azi_deg, y_azi_deg) -> np.ndarray:
    u = _arm_vector(math.radians(lat_deg), math.radians(lon_deg), math.radians(x_azi_deg))
    v = _arm_vector(math.radians(lat_deg), math.radians(lon_deg), math.radians(y_azi_deg))
    return 0.5 * (np.outer(u, u) - np.outer(v, v))


# latitude, longitude, x/y arm azimuths in degrees (LIGO-T980044; LALDetectors.h)
DETECTORS = {
    "H1": Detector("H1", make_response_tensor(46.4552, -119.4077, 324.0006, 234.0006)),
    "L1": Detector("L1", make_response_tensor(30.5629, -90.7742, 252.2835, 162.2835)),
    "V1": Detector("V1", make_response_tensor(43.6314, 10.5045, 70.5674, 160.5674)),
}


def antenna_pattern(det: Detector, ra, dec, psi, gmst):
    """(F+, Fx) for batched sky positions, tensors of any broadcastable shape.

    Convention: effective source longitude l = ra - gmst in the Earth-fixed
    frame; psi rotates the (north-on-sky, east-on-sky) basis.
    """
    ra, dec, psi, gmst = (torch.as_tensor(x) for x in (ra, dec, psi, gmst))
    ell = ra - gmst
    sd, cd = torch.sin(dec), torch.cos(dec)
    sl, cl = torch.sin(ell), torch.cos(ell)
    cp, sp = torch.cos(psi), torch.sin(psi)

    # sky-local basis: u along +dec (north), v along +ra (east); v has no z part
    u = (-sd * cl, -sd * sl, cd)
    v = (-sl, cl)
    ex = (u[0] * cp + v[0] * sp, u[1] * cp + v[1] * sp, u[2] * cp)
    ey = (-u[0] * sp + v[0] * cp, -u[1] * sp + v[1] * cp, -u[2] * sp)

    # D's entries rounded to the inputs' precision, as the JAX package rounds them
    d = torch.as_tensor(det.response, dtype=ell.dtype).tolist()
    dx = [ex[0] * d[0][j] + ex[1] * d[1][j] + ex[2] * d[2][j] for j in range(3)]
    dy = [ey[0] * d[0][j] + ey[1] * d[1][j] + ey[2] * d[2][j] for j in range(3)]
    fplus = (dx[0] * ex[0] + dx[1] * ex[1] + dx[2] * ex[2]) - (dy[0] * ey[0] + dy[1] * ey[1] + dy[2] * ey[2])
    fcross = (dx[0] * ey[0] + dx[1] * ey[1] + dx[2] * ey[2]) + (dy[0] * ex[0] + dy[1] * ex[1] + dy[2] * ex[2])
    return fplus, fcross
