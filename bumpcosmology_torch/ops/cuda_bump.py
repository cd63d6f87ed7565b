"""Kernel A: the fused PISN-bump table (fill + log-trapezoid), batched over chains.

Counterpart of the JAX package's ``ops/pallas_bump.py``.  The CUDA kernel is
``csrc/bump.cu``; beside it here is its plain PyTorch twin, an
``autograd.Function`` whose backward is the same hand-derived VJP written in
tensor code.  :func:`bump_log_dn` dispatches on the device of ``params``: a
CPU tensor takes the plain twin, a CUDA tensor launches the kernel (forward
and backward) or raises.

Inputs are ``params`` of shape ``(C, 5)`` = ``[a, b, mpisn, mbhmax, sigma]``
per chain; the output is the ``(C, G)`` log dN/dm table on the BH-mass grid
``3 + i*dmbh``.  The grids are written ``lo + j*d`` as the Pallas kernel
does; the JAX package's jnp path uses ``linspace``, which differs by about
1e-6 relative.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bumpcosmology_torch.ops._build import check_cuda, cuda_stream, load_kernel, raise_on

__all__ = ["bump_log_dn", "bump_log_dn_plain", "LAUNCHES", "PARAM_NAMES"]

PARAM_NAMES = ("a", "b", "mpisn", "mbhmax", "sigma")
LAUNCHES = {"bump_fwd": 0, "bump_bwd": 0}

_LOG_2PI = math.log(2.0 * math.pi)
_MCO_BREAK = 20.0
_GRID_MBH_LO = 3.0
_GRID_MCO_LO = 1.0


def _packed(params: torch.Tensor, n_grid: int):
    """Per-chain scalars of ``_pack_scalars`` (pallas_bump.py:140-155), each (C, 1)."""
    a, b, mpisn, mbhmax, sigma = (params[:, k : k + 1] for k in range(5))
    gm1 = n_grid - 1.0
    mbh_hi = mbhmax + 7.0 * sigma
    root = torch.sqrt(mbhmax * (mbhmax - mpisn))
    mco_hi = 2.0 * mbhmax - mpisn + 2.0 * root
    return dict(
        a=a, b=b, mpisn=mpisn, mbhmax=mbhmax, sigma=sigma,
        dmbh=(mbh_hi - _GRID_MBH_LO) / gm1,
        dmco=(mco_hi - _GRID_MCO_LO) / gm1,
        dmcohi_dmpisn=-1.0 - mbhmax / root,
        dmcohi_dmbhmax=2.0 + (2.0 * mbhmax - mpisn) / root,
    )


def _cells(params: torch.Tensor, n_grid: int):
    """The (C, G, G) cell quantities shared by the plain forward and backward."""
    s = _packed(params, n_grid)
    idx = torch.arange(n_grid, device=params.device, dtype=params.dtype)
    mbh = _GRID_MBH_LO + idx * s["dmbh"]  # (C, G) rows i
    mco = _GRID_MCO_LO + idx * s["dmco"]  # (C, G) columns j
    curv = 1.0 / (4.0 * (s["mpisn"] - s["mbhmax"]))
    d = mco - (2.0 * s["mbhmax"] - s["mpisn"])
    parab = mco >= s["mpisn"]
    mu = torch.where(parab, s["mbhmax"] + curv * d * d, mco)
    lj = torch.log(mco / _MCO_BREAK)
    high = mco >= _MCO_BREAK
    logc = torch.where(high, -s["b"] * lj, -s["a"] * lj)
    trap = torch.full((n_grid,), math.log(2.0), device=params.device, dtype=params.dtype)
    trap[0] = 0.0
    trap[-1] = 0.0
    logc_w = logc + trap - 0.5 * _LOG_2PI - torch.log(s["sigma"])  # (C, G)
    r = (mbh[:, :, None] - mu[:, None, :]) / s["sigma"][:, :, None]  # (C, G, G)
    k_w = logc_w[:, None, :] - 0.5 * r * r
    return s, idx, mco, curv, d, parab, lj, high, r, k_w


def _bump_fwd_plain(params: torch.Tensor, n_grid: int) -> torch.Tensor:
    s, *_, k_w = _cells(params, n_grid)
    return torch.logsumexp(k_w, dim=-1) + torch.log(0.5 * s["dmco"])


def _bump_bwd_plain(params, logdn, g, n_grid: int) -> torch.Tensor:
    """The analytic VJP of pallas_bump.py:87-137, in tensor code."""
    s, idx, mco, curv, d, parab, lj, high, r, k_w = _cells(params, n_grid)
    sig = s["sigma"][:, :, None]
    L = logdn - torch.log(0.5 * s["dmco"])  # (C, G)
    gw = g[:, :, None] * torch.exp(k_w - L[:, :, None])  # g_i c_j exp(K_ij - L_i)
    zero = torch.zeros_like(d)
    dmu_dmco = torch.where(parab, 2.0 * curv * d, torch.ones_like(d))
    dmu_dmpisn = torch.where(parab, -4.0 * curv * curv * d * d + 2.0 * curv * d, zero)
    dmu_dmbhmax = torch.where(parab, 1.0 + 4.0 * curv * curv * d * d - 4.0 * curv * d, zero)
    dc_dmco = torch.where(high, -s["b"], -s["a"]) / mco
    ros = r / sig
    dk_dmco = dc_dmco[:, None, :] + ros * dmu_dmco[:, None, :]
    phi = idx / (n_grid - 1.0)
    phi_i = phi[None, :, None]
    phi_j = phi[None, None, :]
    dmco_j_dmpisn = phi_j * s["dmcohi_dmpisn"][:, :, None]
    dmco_j_dmbhmax = phi_j * s["dmcohi_dmbhmax"][:, :, None]
    da = (gw * torch.where(high, zero, -lj)[:, None, :]).sum((1, 2))
    db = (gw * torch.where(high, -lj, zero)[:, None, :]).sum((1, 2))
    dsig = (gw * ((r * r - 1.0) / sig - ros * (7.0 * phi_i))).sum((1, 2))
    meas = g.sum(1) / ((n_grid - 1.0) * s["dmco"][:, 0])
    dmp = (gw * (ros * dmu_dmpisn[:, None, :] + dk_dmco * dmco_j_dmpisn)).sum((1, 2)) \
        + meas * s["dmcohi_dmpisn"][:, 0]
    dmb = (gw * (ros * dmu_dmbhmax[:, None, :] - ros * phi_i + dk_dmco * dmco_j_dmbhmax)).sum((1, 2)) \
        + meas * s["dmcohi_dmbhmax"][:, 0]
    return torch.stack([da, db, dmp, dmb, dsig], dim=1)


class _BumpPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, n_grid):
        out = _bump_fwd_plain(params, n_grid)
        ctx.save_for_backward(params, out)
        ctx.n_grid = n_grid
        return out

    @staticmethod
    def backward(ctx, g):
        params, out = ctx.saved_tensors
        return _bump_bwd_plain(params, out, g.contiguous(), ctx.n_grid), None


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bump_fwd": ([_P, _P, _I, _I, _P], _I),
    "bump_bwd": ([_P, _P, _P, _P, _I, _I, _P], _I),
}


def _lib():
    return load_kernel("bump", _SIGNATURES)


def _bump_fwd_cuda(params: torch.Tensor, n_grid: int) -> torch.Tensor:
    c = params.shape[0]
    check_cuda(params, (c, 5), "params")
    out = torch.empty((c, n_grid), device=params.device, dtype=torch.float32)
    rc = _lib().bump_fwd(params.data_ptr(), out.data_ptr(), c, n_grid, cuda_stream(params))
    raise_on(rc, "bump_fwd")
    LAUNCHES["bump_fwd"] += 1
    return out


def _bump_bwd_cuda(params, logdn, g, n_grid: int) -> torch.Tensor:
    c = params.shape[0]
    check_cuda(params, (c, 5), "params")
    check_cuda(logdn, (c, n_grid), "logdn")
    check_cuda(g, (c, n_grid), "g")
    dparams = torch.empty((c, 5), device=params.device, dtype=torch.float32)
    rc = _lib().bump_bwd(params.data_ptr(), logdn.data_ptr(), g.data_ptr(), dparams.data_ptr(),
                         c, n_grid, cuda_stream(params))
    raise_on(rc, "bump_bwd")
    LAUNCHES["bump_bwd"] += 1
    return dparams


class _BumpCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, params, n_grid):
        out = _bump_fwd_cuda(params, n_grid)
        ctx.save_for_backward(params, out)
        ctx.n_grid = n_grid
        return out

    @staticmethod
    def backward(ctx, g):
        params, out = ctx.saved_tensors
        return _bump_bwd_cuda(params, out, g.contiguous(), ctx.n_grid), None


def bump_log_dn_plain(params: torch.Tensor, n_grid: int = 256) -> torch.Tensor:
    """The plain PyTorch twin of the kernel, on any device (the tests and the
    on-card comparison call it; the main path does not)."""
    return _BumpPlain.apply(params, n_grid)


def bump_log_dn(params: torch.Tensor, n_grid: int = 256) -> torch.Tensor:
    """(C, G) log dN/dm of the PISN bump for ``params`` (C, 5), differentiable.

    CPU tensors take the plain twin; CUDA tensors launch ``csrc/bump.cu``."""
    if params.device.type == "cuda":
        return _BumpCuda.apply(params.contiguous(), n_grid)
    if params.device.type == "cpu":
        return _BumpPlain.apply(params, n_grid)
    raise ValueError(f"bump_log_dn: unsupported device {params.device}")
