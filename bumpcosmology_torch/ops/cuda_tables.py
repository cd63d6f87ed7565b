"""Kernel T: the joint log-likelihood's cosmology and detector tables on the card.

Every joint route (the bump's kernel B, the q-normalised families' kernel F)
reads one table a chain: the detector table ``(C, n, 2)`` = ``[z, log_jac]`` on
``n`` points of log dL from ``log dl_lo`` to ``log dl_hi``, built from the
chain's flat-wCDM cosmology table on ``n`` knots of log1p z from 0 to
``log1p zmax`` (``models/cosmology.py``: ``build_cosmology``, then
``build_detector_table``).  In eager autograd that is about 170 launches a
value+grad.  Kernel T (``csrc/tables.cu``, its arithmetic in
``csrc/tables_math.cuh``) builds the detector table from the sites ``h``,
``Om``, ``w`` in one launch, one block a chain, and its backward, one more
launch, recomputes the tables and takes the table's cotangent back to the
three sites; nothing but the sites is saved between the two.  Neither reads
anything back to the host.

The plain twin is the eager code itself: the CPU, ``plain=True`` and every
route that needs the cosmology table take it (``inference/likelihoods.py``,
``_Family.tables``).  This module only launches: a tensor that is not on
CUDA, not float32 or float64, not contiguous or not of the expected shape
raises ``ValueError``.  Every sum runs in a fixed order, so two launches give
the same bits, and a chain's bits do not depend on the other chains.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bumpcosmology_torch.ops._build import cuda_stream, kernel_function, raise_on

__all__ = ["LAUNCHES", "detector_table"]

LAUNCHES = {"tables_fwd": 0, "tables_bwd": 0}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "tables_fwd": ([_I] + [_P] * 5 + [_I, _I] + [_D] * 4 + [_P], _I),
    "tables_bwd": ([_I] + [_P] * 6 + [_I, _I] + [_D] * 4 + [_P], _I),
    "tables_work": ([_I, _I, _I, _P], _I),
}
_DSIZE = {torch.float32: 4, torch.float64: 8}
ERR_SMEM = -1  # csrc/tables.cu's: a chain's arrays need device scratch, and none was given
_WORK = {}  # (device, dsize, n, backward) -> the bytes of device scratch a chain needs (0: none)


def _check(h, om, w) -> int:
    """The chains ``C`` of the launch; raises ``ValueError`` unless ``h``,
    ``om`` and ``w`` are contiguous ``(C,)`` CUDA tensors of one float type
    (float32 or float64) on one device."""
    for name, t in (("h", h), ("Om", om), ("w", w)):
        if t.device.type != "cuda" or t.device != h.device or t.dtype != h.dtype or t.dtype not in _DSIZE:
            raise ValueError(f"{name}: expected a float32 or float64 CUDA tensor of the type and device of h "
                             f"({h.dtype} on {h.device}), got {t.dtype} on {t.device}")
        if t.dim() != 1 or t.shape != h.shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor of shape ({h.shape[0] if h.dim() else '?'},), "
                             f"got {tuple(t.shape)} with strides {t.stride()}")
    return h.shape[0]


def _work(like: torch.Tensor, c: int, n: int, backward: bool):
    """None where a chain's arrays fit in a block's shared memory, else a
    ``(C, bytes)`` scratch; the route is ``tables_work``'s, read once per
    device, type and shape."""
    dsize = _DSIZE[like.dtype]
    key = (like.device, dsize, n, backward)
    bytes_ = _WORK.get(key)
    if bytes_ is None:
        out = ctypes.c_longlong(-1)
        raise_on(kernel_function("tables", "tables_work", _SIGNATURES)(dsize, n, int(backward), ctypes.byref(out)),
                 "tables_work")
        bytes_ = _WORK[key] = out.value
    return None if bytes_ == 0 else torch.empty((c, bytes_), dtype=torch.uint8, device=like.device)


def _raise_on(rc: int, what: str, n: int) -> None:
    if rc == ERR_SMEM:
        raise RuntimeError(f"{what}: n = {n} needs device scratch, and none was given")
    raise_on(rc, what)


def _grid(n: int, dl_lo: float, dl_hi: float, zmax: float):
    """(log1p zmax, du, v0, v1): the knots' and the detector table's grids, as the eager table code takes them."""
    return math.log1p(zmax), math.log1p(zmax) / (n - 1), math.log(float(dl_lo)), math.log(float(dl_hi))


def _fwd(h, om, w, n, grid):
    c = _check(h, om, w)
    out = h.new_empty((c, n, 2))
    work = _work(h, c, n, False)
    rc = kernel_function("tables", "tables_fwd", _SIGNATURES)(
        _DSIZE[h.dtype], h.data_ptr(), om.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), c, n, *grid, cuda_stream(h))
    _raise_on(rc, "tables_fwd", n)
    LAUNCHES["tables_fwd"] += 1
    return out


def _bwd(h, om, w, g, n, grid):
    """``(3, C)``: the cotangents of ``h``, ``Om`` and ``w`` from ``g``, that of the ``(C, n, 2)`` table."""
    c = _check(h, om, w)
    if g.device != h.device or g.dtype != h.dtype or tuple(g.shape) != (c, n, 2):
        raise ValueError(f"g: expected a {h.dtype} tensor of shape {(c, n, 2)} on {h.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    g = g.contiguous()
    d = h.new_empty((3, c))
    work = _work(h, c, n, True)
    rc = kernel_function("tables", "tables_bwd", _SIGNATURES)(
        _DSIZE[h.dtype], h.data_ptr(), om.data_ptr(), w.data_ptr(), g.data_ptr(), d.data_ptr(),
        None if work is None else work.data_ptr(), c, n, *grid, cuda_stream(h))
    _raise_on(rc, "tables_bwd", n)
    LAUNCHES["tables_bwd"] += 1
    return d


class _Tables(torch.autograd.Function):
    """Saves the sites alone; the backward recomputes the tables."""

    @staticmethod
    def forward(ctx, h, om, w, n, grid):
        ctx.save_for_backward(h, om, w)
        ctx.args = (n, grid)
        return _fwd(h, om, w, n, grid)

    @staticmethod
    def backward(ctx, g):
        d = _bwd(*ctx.saved_tensors, g, *ctx.args)
        return d[0], d[1], d[2], None, None


def detector_table(h: torch.Tensor, om: torch.Tensor, w: torch.Tensor, n: int, dl_lo: float, dl_hi: float,
                   zmax: float) -> torch.Tensor:
    """``(C, n, 2)`` = ``[z, log_jac]``: ``build_detector_table(build_cosmology(
    CosmoParams(h, om, w), zmax, n), dl_lo, dl_hi, n).cols`` (``models/cosmology.py``),
    differentiable in the sites ``h``, ``om`` and ``w`` (each ``(C,)``): kernel T,
    one launch forward and one backward."""
    if n < 2:
        raise ValueError(f"detector_table: the tables need two entries at least, got n = {n}")
    return _Tables.apply(h, om, w, n, _grid(n, dl_lo, dl_hi, zmax))
