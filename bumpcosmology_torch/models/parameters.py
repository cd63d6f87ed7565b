"""Hyperparameter containers for the population and cosmology models (L1).

Counterpart of the JAX package's ``models/parameters.py`` (this package keeps
its own copy of the fiducial values).  Leaves are tensors of shape ``(C,)``
— one value per chain — or Python floats for the fixed fiducial sets.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "MassParams",
    "RedshiftParams",
    "CosmoParams",
    "PopulationParams",
    "DEFAULT_MASS",
    "DEFAULT_REDSHIFT",
    "DEFAULT_RATE",
    "DEFAULT_POPULATION",
    "PLANCK18",
]


class MassParams(NamedTuple):
    """Mass-function hyperparameters (a, b, c, mpisn, mbhmax, sigma, fpl, beta)."""

    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    mpisn: torch.Tensor
    mbhmax: torch.Tensor
    sigma: torch.Tensor
    fpl: torch.Tensor
    beta: torch.Tensor


class RedshiftParams(NamedTuple):
    """Madau-Dickinson merger-rate hyperparameters."""

    lam: torch.Tensor
    kappa: torch.Tensor
    zp: torch.Tensor


class CosmoParams(NamedTuple):
    """Flat wCDM cosmology parameters."""

    h: torch.Tensor
    Om: torch.Tensor
    w: torch.Tensor


class PopulationParams(NamedTuple):
    mass: MassParams
    redshift: RedshiftParams


DEFAULT_MASS = MassParams(
    a=1.8, b=-0.71, c=2.9, mpisn=31.0, mbhmax=36.0, sigma=2.3, fpl=0.21, beta=-2.2
)
DEFAULT_REDSHIFT = RedshiftParams(lam=4.7, kappa=7.0, zp=3.0)
DEFAULT_RATE = 2.3
DEFAULT_POPULATION = PopulationParams(mass=DEFAULT_MASS, redshift=DEFAULT_REDSHIFT)

# Planck 2018 flat LambdaCDM: H0 = 67.66 km/s/Mpc, Om0 = 0.30966.
PLANCK18 = CosmoParams(h=0.6766, Om=0.30966, w=-1.0)
