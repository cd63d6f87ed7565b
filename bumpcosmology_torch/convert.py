"""Carry the JAX package's parameters and data across into this package.

Each function takes the JAX package's containers (or anything with the same
field names) whose leaves convert with ``numpy.asarray`` — the JAX arrays
themselves, or numpy arrays — and returns this package's container with
torch tensors on ``device``.  Nothing here imports JAX: the tests hand both
packages identical inputs through these functions.
"""
from __future__ import annotations

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.likelihoods import EventData, FixedCosmoGrid, PopCosmoData, PopData, SelectionData
from bumpcosmology_torch.inference.nuts import ChainState, WarmupResult
from bumpcosmology_torch.models.brokenpl import BrokenPLMassParams, BrokenPLPopulationParams
from bumpcosmology_torch.models.parameters import (
    CosmoParams,
    MassParams,
    PopulationParams,
    RedshiftParams,
)
from bumpcosmology_torch.models.plpeak import PLPeakMassParams, PLPeakPopulationParams

__all__ = ["tensor", "theta_batch", "population_params", "plpeak_params", "brokenpl_params", "cosmo_params",
           "pop_data", "pop_cosmo_data", "warmup_result", "columns"]


def columns(frame) -> dict:
    """A table (anything indexable by column name with a ``keys()``, such as
    the DataFrame the JAX package's mock campaign returns) as this package's
    ``{column: numpy array}`` dict, columns in their order."""
    return {name: np.asarray(frame[name]) for name in frame.keys()}


def tensor(x, device=None, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=resolve_device(device))


def theta_batch(theta, device=None) -> torch.Tensor:
    """An unconstrained position batch ``(C, dim)`` (a single ``(dim,)`` becomes ``C=1``)."""
    t = tensor(theta, device)
    return t[None] if t.dim() == 1 else t


def _leaves(cls, obj, device):
    # scalar leaves become (1,): one chain
    return cls(*(tensor(getattr(obj, f), device).reshape(-1) for f in cls._fields))


def population_params(p, device=None) -> PopulationParams:
    """``PopulationParams`` (mass + redshift leaves) → batched ``(C,)`` leaves."""
    return PopulationParams(_leaves(MassParams, p.mass, device), _leaves(RedshiftParams, p.redshift, device))


def plpeak_params(p, device=None) -> PLPeakPopulationParams:
    """``PLPeakPopulationParams`` (mass + redshift leaves) → batched ``(C,)`` leaves."""
    return PLPeakPopulationParams(_leaves(PLPeakMassParams, p.mass, device),
                                  _leaves(RedshiftParams, p.redshift, device))


def brokenpl_params(p, device=None) -> BrokenPLPopulationParams:
    """``BrokenPLPopulationParams`` (mass + redshift leaves) → batched ``(C,)`` leaves."""
    return BrokenPLPopulationParams(_leaves(BrokenPLMassParams, p.mass, device),
                                    _leaves(RedshiftParams, p.redshift, device))


def cosmo_params(p, device=None) -> CosmoParams:
    return _leaves(CosmoParams, p, device)


def _events_selection(data, device):
    ev = EventData(*(tensor(getattr(data.events, f), device) for f in EventData._fields))
    sel = SelectionData(*(tensor(getattr(data.selection, f), device) for f in SelectionData._fields))
    return ev, sel


def pop_cosmo_data(data, device=None) -> PopCosmoData:
    """``PopCosmoData`` (events + selection) with every leaf cast to float32;
    a fleet (catalogs stacked on a leading axis) stays one."""
    return PopCosmoData(*_events_selection(data, device))


def pop_data(data, device=None) -> PopData:
    """``PopData`` (events + selection + the Planck18 grid) with every leaf
    cast to float32.  A fleet (catalogs stacked on a leading axis, the grid
    stacked too) becomes this package's fleet, whose catalogs share the first
    catalog's grid."""
    grid = data.planck
    log_dv = np.asarray(grid.log_dv)
    planck = FixedCosmoGrid(u0=float(np.asarray(grid.u0).reshape(-1)[0]), du=float(np.asarray(grid.du).reshape(-1)[0]),
                            log_dv=tensor(log_dv.reshape(-1, log_dv.shape[-1])[0], device))
    return PopData(*_events_selection(data, device), planck)


def warmup_result(warm, device=None) -> WarmupResult:
    """``WarmupResult`` (state + eps + cov + chol_cov)."""
    st = warm.state
    return WarmupResult(ChainState(tensor(st.theta, device), tensor(st.u, device), tensor(st.grad, device)),
                        tensor(warm.eps, device), tensor(warm.cov, device), tensor(warm.chol_cov, device))
