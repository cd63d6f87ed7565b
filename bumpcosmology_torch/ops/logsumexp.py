"""Log-domain reductions, local and sharded (L0); counterpart of the JAX
package's ``ops/logsumexp.py``.

``axis=None`` reduces over every element, as the JAX package's ``logsumexp``
does; a slice that is all ``-inf`` reduces to ``-inf``.  The sharded form
takes a ``torch.distributed`` process group where the JAX package takes a
mesh axis name: each rank reduces its shard with a max-shifted sum, and the
partial ``(max, sum)`` pairs are combined with ``all_reduce(MAX)`` and
``all_reduce(SUM)`` over the group (:mod:`~bumpcosmology_torch.ops.collectives`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from bumpcosmology_torch.ops.collectives import all_reduce, reduce_from_group

__all__ = ["logsumexp", "logmeanexp", "sharded_logsumexp", "log_neff", "neff"]


def logsumexp(a: torch.Tensor, axis=None) -> torch.Tensor:
    """log Σ exp(a) along ``axis`` (every element when ``None``)."""
    return torch.logsumexp(a.reshape(-1), dim=0) if axis is None else torch.logsumexp(a, dim=axis)


def logmeanexp(a: torch.Tensor, axis=None) -> torch.Tensor:
    """log of the mean of exp(a) along ``axis`` (stable)."""
    n = a.numel() if axis is None else a.shape[axis]
    return logsumexp(a, axis) - math.log(n)


def sharded_logsumexp(a: torch.Tensor, group, axis=None) -> torch.Tensor:
    """logsumexp over the local ``axis`` and over the ranks of ``group``: the
    single-device logsumexp of the array gathered along ``axis``.

    The max shift is detached (its gradient cancels exactly), and the sum's
    all-reduce passes the gradient back to this rank's own elements, so the
    gradient with respect to ``a`` is this rank's slice of the gathered
    array's.  A shard that is all ``-inf`` adds nothing, and the global max
    is replaced by 0 when it is not finite, so no NaN appears
    (``sharded_logsumexp``, the JAX package's ``ops/logsumexp.py:41-57``)."""
    local_max = (a.amax() if axis is None else a.amax(dim=axis)).detach()
    global_max = all_reduce(local_max, dist.ReduceOp.MAX, group)
    safe_max = torch.where(torch.isfinite(global_max), global_max, torch.zeros_like(global_max))
    shift = safe_max if axis is None else safe_max.unsqueeze(axis)
    local_sum = torch.exp(a - shift).sum() if axis is None else torch.exp(a - shift).sum(dim=axis)
    return safe_max + torch.log(reduce_from_group(local_sum, group))


def log_neff(log_wts: torch.Tensor, axis=None, group=None) -> torch.Tensor:
    """log of the importance-sampling effective sample size (Σw)² / Σw²:
    ``2 logsumexp(log w) - logsumexp(2 log w)``; with ``group`` the sums also
    span its ranks (the JAX package's ``axis_name``)."""
    if group is None:
        return 2.0 * logsumexp(log_wts, axis) - logsumexp(2.0 * log_wts, axis)
    return 2.0 * sharded_logsumexp(log_wts, group, axis) - sharded_logsumexp(2.0 * log_wts, group, axis)


def neff(log_wts: torch.Tensor, axis=None, group=None) -> torch.Tensor:
    """Importance-sampling effective sample size (see :func:`log_neff`)."""
    return torch.exp(log_neff(log_wts, axis, group))
