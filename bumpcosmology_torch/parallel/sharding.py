"""The likelihood data split over the ``data`` axis of a mesh (L3);
counterpart of the JAX package's ``parallel/sharding.py``.

The event sample axis and the injection axis are split along ``data``;
``log_ndraw`` and the Planck18 grid are replicated (:func:`pop_data_pspecs`,
:func:`pop_cosmo_data_pspecs` name the split axis of each field, as the JAX
package's partition specs do).  :func:`shard_pop_data` and
:func:`shard_pop_cosmo_data` give each rank its slice of a catalog that every
rank holds, with the data's ``shard`` field filled in
(:class:`~bumpcosmology_torch.inference.likelihoods.DataShard`): the axis's
process group and the catalog's global sizes.

The JAX package has two paths, GSPMD (placed data, collectives inserted by
XLA) and ``shard_map`` (collectives spelled out).  The port has one
mechanism, the explicit collectives of the likelihoods, reached two ways:

1. **A spec built on a shard** — ``pop_model_spec(shard_pop_data(...))``,
   ``make_potential`` and ``fit`` work on it unchanged, because
   :func:`~bumpcosmology_torch.inference.likelihoods.pop_loglike` and
   ``pop_cosmo_loglike`` see the ``shard`` field (the GSPMD analogue).
2. **A log-likelihood made for the mesh** —
   :func:`make_sharded_pop_loglike`, :func:`make_sharded_pop_cosmo_loglike`
   (the ``shard_map`` path): the rows, query table and global dL range are
   fixed once; each call rebuilds the replicated per-draw tables (the bump
   table: kernel A; the cosmology and detector tables), weighs the rank's
   rows (the joint model: one kernel-B launch each way a value+grad, the
   ``lse`` epilogue over the rank's own rows), and combines the partial
   log-sum-exps with :func:`~bumpcosmology_torch.ops.logsumexp.sharded_logsumexp`.

Both return ``Σ log_like − nobs · log μ_sel`` of the whole catalog on every
rank of the group, and its gradient (the sites' gradient summed over the
group once).
"""
from __future__ import annotations

from typing import Callable

import torch

from bumpcosmology_torch.inference.likelihoods import (
    DataShard,
    EventData,
    PopCosmoData,
    PopData,
    SelectionData,
    dl_bounds_of,
    dl_range,
    pop_cosmo_loglike,
    pop_loglike,
    pop_rows,
    query_table,
)
from bumpcosmology_torch.models.mass import DEFAULT_N_GRID
from bumpcosmology_torch.parallel.mesh import DATA_AXIS, Mesh

__all__ = [
    "DataShard",
    "pop_data_pspecs",
    "pop_cosmo_data_pspecs",
    "shard_pop_data",
    "shard_pop_cosmo_data",
    "make_sharded_pop_loglike",
    "make_sharded_pop_cosmo_loglike",
]


def _event_sel_pspecs():
    """The split axis of each field (``None``: replicated): the sample axis of
    the events, the injection axis of the selection."""
    ev = EventData(a=(None, DATA_AXIS), q=(None, DATA_AXIS), c=(None, DATA_AXIS), log_pdraw=(None, DATA_AXIS))
    sel = SelectionData(a=(DATA_AXIS,), q=(DATA_AXIS,), c=(DATA_AXIS,), log_pdraw=(DATA_AXIS,), log_ndraw=())
    return ev, sel


def pop_data_pspecs(data: PopData) -> PopData:
    """Per field, the mesh axis of each array axis (the JAX package's ``PartitionSpec``s)."""
    ev, sel = _event_sel_pspecs()
    return PopData(events=ev, selection=sel, planck=data.planck._replace(log_dv=(None,)))


def pop_cosmo_data_pspecs(data: PopCosmoData) -> PopCosmoData:
    ev, sel = _event_sel_pspecs()
    return PopCosmoData(events=ev, selection=sel)


def _shard(data, mesh: Mesh):
    """``data`` cut to this rank's events ``(nobs, nsamp/k)`` and selection
    ``(nsel/k,)``, with its :class:`DataShard`."""
    k, i = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
    nobs, nsamp = data.events.a.shape
    nsel = data.selection.a.shape[0]
    if nsamp % k or nsel % k:
        raise ValueError(f"{nsamp} PE samples per event and {nsel} injections do not divide into {k} "
                         f"'{DATA_AXIS}' shards")
    ps, pi = nsamp // k, nsel // k
    ev = EventData(*(x[:, i * ps:(i + 1) * ps].contiguous() for x in data.events))
    sel = data.selection._replace(**{f: getattr(data.selection, f)[i * pi:(i + 1) * pi].contiguous()
                                     for f in ("a", "q", "c", "log_pdraw")})
    dl = dl_range(data) if isinstance(data, PopCosmoData) else None
    return data._replace(events=ev, selection=sel, shard=DataShard(mesh.group(DATA_AXIS), nsamp, dl))


def shard_pop_data(data: PopData, mesh: Mesh) -> PopData:
    """This rank's slice of ``data`` (every rank holds the whole catalog).
    Raises ``ValueError`` unless the sample and injection axes divide by the
    ``data`` axis's size."""
    return _shard(data, mesh)


def shard_pop_cosmo_data(data: PopCosmoData, mesh: Mesh) -> PopCosmoData:
    """As :func:`shard_pop_data`, for the joint model; the shard keeps the
    whole catalog's dL range, so that every rank builds the same detector table."""
    return _shard(data, mesh)


def make_sharded_pop_loglike(mesh: Mesh, data: PopData, n_grid: int = DEFAULT_N_GRID) -> Callable:
    """``loglike(sites) → (C,)``: the population-only log-likelihood of the
    whole catalog, each rank weighing its slice of ``data``
    (``make_sharded_pop_loglike``, the JAX package's ``sharding.py:97-131``)."""
    shard = shard_pop_data(data, mesh)
    rows = pop_rows(shard)

    def loglike(sites) -> torch.Tensor:
        return pop_loglike(sites, shard, n_grid, rows)

    return loglike


def make_sharded_pop_cosmo_loglike(mesh: Mesh, data: PopCosmoData, n_grid: int = DEFAULT_N_GRID,
                                   n_z: int = 1024) -> Callable:
    """``loglike(sites) → (C,)``: the joint log-likelihood of the whole
    catalog, each rank weighing its slice of ``data`` through kernel B's
    ``lse`` epilogue against tables built on the whole catalog's dL range
    (``make_sharded_pop_cosmo_loglike``, the JAX package's ``sharding.py:134-167``)."""
    shard = shard_pop_cosmo_data(data, mesh)
    bounds, qry = dl_bounds_of(shard), query_table(shard)

    def loglike(sites) -> torch.Tensor:
        return pop_cosmo_loglike(sites, shard, n_grid, n_z, bounds, qry)

    return loglike
