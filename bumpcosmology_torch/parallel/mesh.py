"""The (chains, data) layout of the ranks (L3); counterpart of the JAX
package's ``parallel/mesh.py``.

* ``chains`` — the rows: each row runs its share of the NUTS chains (no
  communication inside a transition).
* ``data`` — the columns: the PE-sample and injection axes of the
  likelihood are split along it, and the per-event and selection
  log-sum-exps are combined over its process group.

The ranks are those of an initialised ``torch.distributed`` world (the
caller gives ``init_process_group`` its address, world size and rank).  The
mesh wraps a ``DeviceMesh`` whose sub-groups are the rows and columns, and
reads its size along each axis by name, as the JAX ``Mesh`` does
(``mesh.shape["chains"]``).  Several ranks may share one card: they then
use the gloo backend, whose collectives run on the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["CHAIN_AXIS", "DATA_AXIS", "Mesh", "make_mesh", "replicated", "chain_sharding"]

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


class Mesh:
    """A ``(chains, data)`` grid of ranks: ``shape`` maps each axis name to
    its size, ``group(axis)`` is this rank's process group along it and
    ``index(axis)`` this rank's place in that group."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = {name: device_mesh.size(i) for i, name in enumerate(self.axis_names)}

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)


def make_mesh(n_chain_shards: Optional[int] = None, devices: Optional[Sequence[int]] = None) -> Mesh:
    """A (chains, data) mesh over the ranks ``devices`` (default: the whole
    initialised world), ``n_chain_shards`` rows (default 1: every rank along
    ``data``).  Raises ``ValueError`` when the ranks do not divide into the rows
    (``make_mesh``, the JAX package's ``parallel/mesh.py:31-48``)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised (call init_process_group first)")
    ranks = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(ranks)
    rows = 1 if n_chain_shards is None else n_chain_shards
    if rows < 1 or n % rows != 0:
        raise ValueError(f"{n} devices not divisible into {rows} chain rows")
    # the DeviceMesh's device type names where its collectives run: NCCL on the
    # cards, gloo (also for several ranks on one card) on the host
    device_type = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(rows, n // rows)
    return Mesh(DeviceMesh(device_type, grid, mesh_dim_names=(CHAIN_AXIS, DATA_AXIS)))


def replicated(mesh: Mesh):
    """The DTensor placements of a value held whole on every rank: ``Replicate()`` on both axes."""
    from torch.distributed.tensor import Replicate

    return tuple(Replicate() for _ in mesh.axis_names)


def chain_sharding(mesh: Mesh):
    """The DTensor placements of per-chain state ``(n_chains, ...)``: ``Shard(0)``
    on ``chains``, ``Replicate()`` on ``data``."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if axis == CHAIN_AXIS else Replicate() for axis in mesh.axis_names)
