"""Kernel P: the priors and transforms of a model's sites, one launch forward and one backward.

The kernel is ``csrc/priors.cu``.  Its plain twin is the per-site code of
``inference/model.py`` (``_log_prior_and_jac`` and ``constrain`` over the
families of ``inference/distributions.py``), which the CPU takes;
``model.log_prior_and_sites`` dispatches on the device of ``theta``.  A CUDA
tensor launches the kernel or raises: nothing falls back to the twin.

The kernel reads each site's prior from a table, one row a site
(:data:`COLUMNS`; :func:`table_row` makes a row from a prior, in float64),
which :func:`device_table` copies to the card once per set of priors, device
and dtype, cast once.  So any model of the three families takes the same
kernel.  Float32 and float64 are both built.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from bumpcosmology_torch.ops._build import cuda_stream, kernel_function, raise_on

__all__ = ["log_prior_and_sites", "table_row", "table_rows", "device_table", "LAUNCHES", "COLUMNS", "IDENTITY",
           "SIGMOID", "EXP_ABOVE_LOW", "EXP_BELOW_HIGH", "NORMAL", "TRUNCATED_NORMAL", "UNIFORM"]

LAUNCHES = {"priors_fwd": 0, "priors_bwd": 0}

# a site's row of the table (csrc/priors.cu's column constants)
COLUMNS = ("transform", "density", "loc", "scale", "low", "high", "width", "log_width", "log_scale", "log_z")
# transform codes: x = u; low + width * sigmoid(u); low + exp(u); high - exp(u)
IDENTITY, SIGMOID, EXP_ABOVE_LOW, EXP_BELOW_HIGH = 0, 1, 2, 3
# density codes: normal; normal on [low, high] less log Z; uniform on [low, high]
NORMAL, TRUNCATED_NORMAL, UNIFORM = 0, 1, 2

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "priors_fwd_f32": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "priors_bwd_f32": ([_P, _P, _P, _P, _P, _I, _I, _P], _I),
    "priors_fwd_f64": ([_P, _P, _P, _P, _I, _I, _P], _I),
    "priors_bwd_f64": ([_P, _P, _P, _P, _P, _I, _I, _P], _I),
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

_TABLES: Dict[tuple, torch.Tensor] = {}


def table_row(dist) -> Tuple[float, ...]:
    """The prior ``dist`` as the kernel's row of float64 numbers, in the order
    of :data:`COLUMNS`: its transform and density codes, its parameters (an
    open side at ±inf) and the constants that its methods compute in float64
    (width, log width, log scale, log Z).  Raises ``ValueError`` for any
    other type of prior."""
    from bumpcosmology_torch.inference.distributions import Distribution, Normal, TruncatedNormal, Uniform

    inf = math.inf
    if isinstance(dist, Normal):
        return (IDENTITY, NORMAL, float(dist.loc), float(dist.scale), -inf, inf, 0.0, 0.0, math.log(dist.scale), 0.0)
    if isinstance(dist, Uniform):
        width = dist.high - dist.low
        return (SIGMOID, UNIFORM, 0.0, 1.0, float(dist.low), float(dist.high), float(width), math.log(width), 0.0,
                0.0)
    if isinstance(dist, TruncatedNormal):
        low = -inf if dist.low is None else float(dist.low)
        high = inf if dist.high is None else float(dist.high)
        width, log_width = 0.0, 0.0
        if dist.low is not None and dist.high is not None:
            transform, width = SIGMOID, dist.high - dist.low
            log_width = math.log(width)
        elif dist.low is not None:
            transform = EXP_ABOVE_LOW
        elif dist.high is not None:
            transform = EXP_BELOW_HIGH
        else:
            transform = IDENTITY
        return (transform, TRUNCATED_NORMAL, float(dist.loc), float(dist.scale), low, high, float(width), log_width,
                math.log(dist.scale), float(dist._log_z()))
    raise ValueError(f"no kernel row for a prior of type {type(dist).__name__}: the priors are "
                     f"{', '.join(t.__name__ for t in Distribution)}")


def table_rows(priors: Dict[str, object]) -> Tuple[Tuple[float, ...], ...]:
    """The priors as the kernel's table, a row a site (:func:`table_row`);
    ``ValueError`` for a prior of another type."""
    return tuple(table_row(d) for d in priors.values())


def device_table(priors: Dict[str, object], device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The ``(dim, len(COLUMNS))`` table of ``priors`` on ``device`` in
    ``dtype``, made once and kept, keyed on each prior's type and numbers
    (two families with the same numbers are two tables)."""
    key = (tuple((type(d), *d) for d in priors.values()), device, dtype)
    table = _TABLES.get(key)
    if table is None:
        table = _TABLES[key] = torch.tensor(table_rows(priors), dtype=torch.float64).to(device=device, dtype=dtype)
    return table


def _check(theta: torch.Tensor, dim: int) -> None:
    """Raise unless the kernel takes ``theta`` for a table of ``dim`` sites."""
    if theta.dtype not in _SUFFIX:
        raise ValueError(f"theta: expected float32 or float64, got {theta.dtype}")
    if theta.dim() != 2 or theta.shape[1] != dim:
        raise ValueError(f"theta: expected (C, {dim}) for {dim} sites, got shape {tuple(theta.shape)}")
    if not 1 <= theta.shape[0] * dim < 2 ** 31:
        raise ValueError(f"theta: expected 1 to 2^31 - 1 entries, got {theta.shape[0]} x {dim}")


def _priors_fwd_cuda(theta: torch.Tensor, table: torch.Tensor):
    c, dim = theta.shape
    sites = theta.new_empty((dim, c))  # site-major: each site's column is contiguous
    log_prior = theta.new_empty((c,))
    rc = kernel_function("priors", f"priors_fwd_{_SUFFIX[theta.dtype]}", _SIGNATURES)(
        theta.data_ptr(), table.data_ptr(), sites.data_ptr(), log_prior.data_ptr(), c, dim, cuda_stream(theta))
    raise_on(rc, "priors_fwd")
    LAUNCHES["priors_fwd"] += 1
    return log_prior, sites


def _priors_bwd_cuda(theta, table, g_sites, g_log_prior) -> torch.Tensor:
    c, dim = theta.shape
    dtheta = torch.empty_like(theta)  # every entry is stored
    rc = kernel_function("priors", f"priors_bwd_{_SUFFIX[theta.dtype]}", _SIGNATURES)(
        theta.data_ptr(), table.data_ptr(), g_sites.data_ptr(), g_log_prior.data_ptr(), dtheta.data_ptr(), c, dim,
        cuda_stream(theta))
    raise_on(rc, "priors_bwd")
    LAUNCHES["priors_bwd"] += 1
    return dtheta


class _PriorsCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, theta, table):
        log_prior, sites = _priors_fwd_cuda(theta, table)
        ctx.save_for_backward(theta, table)
        return log_prior, sites

    @staticmethod
    def backward(ctx, g_log_prior, g_sites):
        theta, table = ctx.saved_tensors
        return _priors_bwd_cuda(theta, table, g_sites.contiguous(), g_log_prior.contiguous()), None


def log_prior_and_sites(priors: Dict[str, object], theta: torch.Tensor):
    """``(log_prior (C,), sites (dim, C))`` of ``theta`` ``(C, dim)`` on the
    card, differentiable: the sum over sites of log prior density and
    log-Jacobian, and every site's constrained value (site-major, so that
    ``sites[i]`` is contiguous), from the table of ``priors``."""
    _check(theta, len(priors))
    table = device_table(priors, theta.device, theta.dtype)
    return _PriorsCuda.apply(theta if theta.is_contiguous() else theta.contiguous(), table)
