"""Collectives of the scale-out layer over a ``torch.distributed`` process group.

The JAX package's sharded likelihoods run inside ``shard_map`` or under
GSPMD, where ``pmax``/``psum`` over a mesh axis are differentiable and the
compiler knows which values are replicated.  Here each rank runs its own
autograd graph, so the gradient of a replicated input needs a conjugate
pair of functions (the tensor-parallel pair of Megatron-LM):

* :func:`copy_to_group` — identity forward, ``all_reduce(SUM)`` of the
  gradient backward.  Applied to the replicated sites before the per-shard
  work, it turns each rank's share of the gradient into the whole.
* :func:`reduce_from_group` — ``all_reduce(SUM)`` forward, identity
  backward.  Applied to the partial sums, it keeps each rank's backward on
  its own share.

Every rank of a group computes the same total and seeds its backward with
1, so ``torch.distributed.nn``'s all-reduce, whose backward all-reduces the
output gradient, would count the sites' gradient ``world`` times; a purely
local backward would count one rank's share.  With the pair, terms outside
the sharded part (the priors, the Jacobians) are counted once.

Gloo, the backend that runs several ranks on one card and the CPU ranks of
the tests, reduces on the host: a CUDA tensor given to a gloo group is
staged through host memory here.  NCCL takes CUDA tensors as they are.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["all_reduce", "all_gather_cat", "copy_to_group", "reduce_from_group"]


def _staged(t: torch.Tensor, group) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """A new tensor holding ``t`` reduced with ``op`` over ``group`` (``t`` is not changed)."""
    if _staged(t, group):
        host = t.detach().cpu().contiguous()
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    out = t.detach().clone().contiguous()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_cat(t: torch.Tensor, group=None, dim: int = -1) -> torch.Tensor:
    """Every rank's ``t`` (one shape on every rank), concatenated along ``dim`` in rank order."""
    src = t.detach().cpu().contiguous() if _staged(t, group) else t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = all_reduce(torch.cat([g.reshape(-1) for g in gs]), dist.ReduceOp.SUM, ctx.group)
        parts = flat.split([g.numel() for g in gs])
        return (None, *(p.view_as(g) for p, g in zip(parts, gs)))


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


def copy_to_group(sites: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """``sites`` unchanged; backward, their gradients summed over ``group`` in one all-reduce."""
    names = list(sites)
    return dict(zip(names, _CopyToGroup.apply(group, *(sites[k] for k in names))))


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``; backward, the gradient passes to this rank's ``x`` unchanged."""
    return _ReduceFromGroup.apply(group, x)
