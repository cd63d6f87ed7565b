"""The launch bookkeeping that kernels B and F share, beside the skeleton they share in ``csrc/rows.cuh``.

Both wrappers (``ops/cuda_logwts.py``, ``ops/cuda_families.py``) check the
segments of the ``lse`` epilogue, ask their library once per shape which
route the backward takes (the detector table's bins in shared memory, or in
a zeroed ``(C, 2, 2K)`` int64 scratch in device memory), and count their
launches under one key scheme.  Nothing here launches a kernel.
"""
from __future__ import annotations

import ctypes

import torch

from bumpcosmology_torch.ops._build import kernel_function

__all__ = ["ERR_SMEM", "ROUTE_GLOBAL", "check_segments", "bwd_scratch", "counter"]

ERR_SMEM = -1  # csrc/rows.cuh's ERR_SMEM: the launch needs more shared memory than a block has
ROUTE_GLOBAL = 1  # csrc/rows.cuh's ROUTE_GLOBAL: the backward's detector bins in device memory
_ROUTES = {}  # (source, device, the route function's arguments) -> the backward's route


def check_segments(what: str, n: int, nobs: int, nsamp: int) -> None:
    """Raises ``ValueError`` unless ``nobs`` events of ``nsamp`` rows fit in ``n`` query rows."""
    if nobs < 0 or (nobs > 0 and nsamp < 1) or nobs * nsamp > n:
        raise ValueError(f"{what}: {nobs} events x {nsamp} samples do not fit in {n} query rows")


def bwd_scratch(source: str, signatures: dict, route_args: tuple, det: torch.Tensor, on_error):
    """None on the backward's route with the detector's bins in shared
    memory; a ``(C, 2, 2K)`` int64 tensor for ``det`` ``(C, K, 2)`` (the
    launch zeroes it) on the route with them in device memory.  The route is
    ``<source>_bwd_route(*route_args, &out)``'s, read once per source,
    device and arguments; ``on_error(rc)`` raises on its error code."""
    key = (source, det.device, *route_args)
    route = _ROUTES.get(key)
    if route is None:
        out = ctypes.c_int(-1)
        on_error(kernel_function(source, f"{source}_bwd_route", signatures)(*route_args, ctypes.byref(out)))
        route = _ROUTES[key] = out.value
    if route != ROUTE_GLOBAL:
        return None
    c, k = det.shape[0], det.shape[1]
    return torch.empty((c, 2, 2 * k), dtype=torch.int64, device=det.device)


def counter(what: str, qry_cs: int, scratch=None) -> str:
    """The ``LAUNCHES`` key of a launch ``what``: ``_global`` on the backward's
    device-memory route (``scratch`` given), ``_per_chain`` with a query
    table a chain (``qry_cs`` > 0)."""
    return what + ("" if scratch is None else "_global") + ("_per_chain" if qry_cs else "")
