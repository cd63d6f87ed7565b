"""Joint BBH population intensity over (m1, q, z) (L1); counterpart of
the JAX package's ``models/population.py``.  For the PISN-bump family:

    log dN/dm1 dq dV dt = log dN/dm(m1) + log dN/dm(q m1)
                        + beta log[(m1 + m2) / (MREF (1 + QREF))] + log m1 + log dN/dV(z)

:func:`log_dndmdqdv` takes any family's intensity: the other families
(:mod:`~bumpcosmology_torch.models.plpeak`, :mod:`~bumpcosmology_torch.models.brokenpl`)
answer through their own ``log_dndmdqdv`` method, as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bumpcosmology_torch.models.mass import (
    DEFAULT_N_GRID,
    MREF,
    MassFunctionTable,
    build_mass_function,
    log_dndm,
)
from bumpcosmology_torch.models.parameters import PopulationParams, RedshiftParams
from bumpcosmology_torch.models.redshift import log_dndv

__all__ = ["QREF", "PopulationIntensity", "build_population", "log_dndmdqdv", "COORDS"]

QREF = 1.0


class PopulationIntensity(NamedTuple):
    """Per-draw population state: mass table + redshift/pairing parameters."""

    mass_table: MassFunctionTable
    params: PopulationParams


def build_population(params: PopulationParams, n_grid: int = DEFAULT_N_GRID,
                     plain: bool = False) -> PopulationIntensity:
    return PopulationIntensity(mass_table=build_mass_function(params.mass, n_grid, plain),
                               params=params)


def log_dndmdqdv(pop, m1: torch.Tensor, q: torch.Tensor, z: torch.Tensor):
    """log dN/dm1/dq/dV/dt at ``(C, M)`` queries.  An intensity that is not a
    :class:`PopulationIntensity` answers through its own ``log_dndmdqdv``;
    for the bump, both mass evaluations share one table lookup."""
    if not isinstance(pop, PopulationIntensity):
        return pop.log_dndmdqdv(m1, q, z)
    m2 = q * m1
    beta = pop.params.mass.beta[:, None]
    m1_b, m2_b = torch.broadcast_tensors(m1, m2)
    both = log_dndm(pop.mass_table, torch.cat([m1_b, m2_b], dim=1))
    n = m1_b.shape[1]
    rs = pop.params.redshift
    col = RedshiftParams(rs.lam[:, None], rs.kappa[:, None], rs.zp[:, None])
    return (
        both[:, :n]
        + both[:, n:]
        + beta * torch.log((m1 + m2) / (MREF * (1.0 + QREF)))
        + torch.log(m1)
        + log_dndv(z, col)
    )


# Posterior-predictive output grids (``intensity_models.py:275-279``): the
# deterministic rate curves recorded in the trace are evaluated on these axes.
COORDS = {
    "m_grid": np.exp(np.linspace(np.log(5.0), np.log(150.0), 128)),
    "q_grid": np.linspace(0.0, 1.0, 129)[1:],
    "z_grid": np.expm1(np.linspace(np.log1p(0.0), np.log1p(3.0), 128)),
}
