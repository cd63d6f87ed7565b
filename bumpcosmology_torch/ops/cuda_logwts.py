"""Kernel B: the fused detector-frame log-weight evaluation, batched over chains.

Counterpart of the JAX package's ``ops/pallas_logwts.py`` — the flagship
joint likelihood's hot loop.  For every PE sample and injection (the rows of
a query array ``[m1_det, q, log dL, log pdraw]``, built by :func:`query_rows`;
``log dL`` is per row and not per chain, so it is taken once, when the table
is built) and every chain it computes

    z, log_jac = lerp(detector table @ log dL);  m1 = m1_det/(1+z);  m2 = q m1
    out = log dN/dm(m1) + log dN/dm(m2) + beta log((m1+m2)/60) + log m1
          + log dN/dV(z) - 2 log1p z + log_jac - log pdraw

from per-chain tables: the detector table ``(C, K, 2)`` = [z, log_jac] on the
uniform log(dL) grid, the bump table ``(C, G)``, and 15 scalars ``(C, 15)``
in the Pallas slot order (:data:`SLOTS`).

The query array is ``(N, 4)``, one table shared by every chain (the chains of
one fit), or ``(C, N, 4)``, chain ``c`` reading its own rows ``qry[c]`` (a
fleet of fits, one catalog a chain: the calibration suite).  Both layouts go
through the same launches; the kernel takes the rows between two chains'
tables (0 or N) as an argument.

The CUDA kernel is ``csrc/logwts.cu``.  The backward is hand-derived (the
Pallas kernel recomputed under a JAX vjp); its plain PyTorch twin below
writes the same formulas in tensor code, and the CPU tests hold it against
JAX autodiff of the JAX package's fused path.  The backward has two routes,
chosen from the shape before the launch (``logwts_bwd_route``): the
detector table's cotangent bins in shared memory while they fit (K up to
4,347 at G = 256 on an H100), else in a zeroed ``(C, 2, 2K)`` int64 scratch
in device memory (``_global`` in :data:`LAUNCHES`), up to the forward's own
limit (about 28,900); both are deterministic.

Two epilogues share the kernel body.  :func:`logwts` (``rows``) returns the
``(C, N)`` log-weights, the Pallas kernel's own function.  :func:`logwts_lse`
(``lse``) returns what the joint likelihood takes from them straight after:
the log-sum-exp of each event's ``nsamp`` contiguous rows, ``(C, nobs)``, and
of the selection rows that follow them, ``(C,)``; its backward forms each
row's cotangent as ``g_seg * exp(out - lse_seg)`` (0 for a ``-inf`` row) and
never holds a ``(C, N)`` tensor.  A segment whose rows are all ``-inf``
returns ``-inf`` and zero cotangents, never NaN.  Both dispatch on the device
of their tensors: CPU takes the twin, CUDA launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bumpcosmology_torch.ops._build import kernel_function, raise_on
from bumpcosmology_torch.ops._rows import ERR_SMEM, bwd_scratch, check_segments, counter
from bumpcosmology_torch.ops.special import softplus

__all__ = ["SLOTS", "LAUNCHES", "query_rows", "logwts", "logwts_plain", "logwts_lse",
           "logwts_lse_plain", "pack_scalars", "cosmo_frame_logwts", "cosmo_frame_logwts_lse"]

SLOTS = ("v0", "dv", "mbh_lo", "dmbh", "mbh_hi", "c", "mbhmax", "log_pl_norm", "log_norm",
         "beta", "lam", "kappa", "zp", "k_det", "k_bump")
# launches by entry point; "_global": the backward's route for a detector table too large for its bins in
# shared memory; "_per_chain": with a (C, N, 4) query table, one a chain
LAUNCHES = {name + layout: 0 for name in ("logwts_fwd", "logwts_bwd", "logwts_lse_fwd", "logwts_lse_bwd",
                                          "logwts_bwd_global", "logwts_lse_bwd_global")
            for layout in ("", "_per_chain")}

_LOG2 = math.log(2.0)
_MBH_MIN = 5.0  # models/mass.py::MBH_MIN
_MREF = 30.0  # models/mass.py::MREF
_QREF = 1.0  # models/population.py::QREF


def query_rows(a, q, dl, log_pdraw) -> torch.Tensor:
    """(..., 4) query rows ``[m1_det, q, log dL, log pdraw]`` from tensors of one shape ``(...)``."""
    return torch.stack([a, q, torch.log(dl), log_pdraw], dim=-1).contiguous()


def _bracket(pos, n: int):
    """(lo, t, slope): the fused path's ``_interp_unit_gather`` bracket; the
    slope term of a gradient is taken where ``pos - lo`` lies in [0, 1].  A NaN
    position takes ``lo = 0``, as the kernel's ``fmaxf`` does."""
    lo = torch.floor(pos).nan_to_num(nan=0.0).clamp(0, n - 2)
    traw = pos - lo
    return lo.long(), traw.clamp(0.0, 1.0), (traw >= 0.0) & (traw <= 1.0)


def _mass(m, s, bump):
    pos = (m - s["mbh_lo"]) / s["dmbh"]
    lo, t, slope = _bracket(pos, bump.shape[1])
    b0 = torch.gather(bump, 1, lo)
    b1 = torch.gather(bump, 1, lo + 1)
    lb = b0 + t * (b1 - b0)
    cut = (m <= s["mbh_lo"]) | (m >= s["mbh_hi"])
    lr = torch.log(m / s["mbhmax"])
    x = (m - s["mbhmax"]) / (0.05 * s["mbhmax"])
    lt = -s["c"] * lr + s["log_pl_norm"] + _LOG2 - softplus(-x)
    ld = torch.where(cut, lt, torch.logaddexp(lb, lt))
    dead = m < _MBH_MIN
    return dict(pos=pos, lo=lo, t=t, slope=slope, b0=b0, b1=b1, lb=lb, cut=cut, lr=lr, x=x,
                lt=lt, dead=dead, ld=torch.where(dead, -math.inf, ld))


def _evaluate(det, bump, scal, qry):
    s = {name: scal[:, k : k + 1] for k, name in enumerate(SLOTS)}
    rows = qry if qry.dim() == 3 else qry[None]  # (C or 1, N, 4)
    a, q, log_dl, log_pdraw = (rows[..., k] for k in range(4))
    posz = (log_dl - s["v0"]) / s["dv"]
    lo, t, slope = _bracket(posz, det.shape[1])
    idx = lo.unsqueeze(-1).expand(*lo.shape, 2)
    e0 = torch.gather(det, 1, idx)
    e1 = torch.gather(det, 1, idx + 1)
    z0, j0, z1, j1 = e0[..., 0], e0[..., 1], e1[..., 0], e1[..., 1]
    z = z0 + t * (z1 - z0)
    lj = j0 + t * (j1 - j0)
    opz = 1.0 + z
    m1 = a / opz
    m2 = q * m1
    w1, w2 = _mass(m1, s, bump), _mass(m2, s, bump)
    l1pz = torch.log1p(z)
    lzp = torch.log1p(s["zp"])
    lr_zp = torch.log(opz / (1.0 + s["zp"]))
    log_dndv = s["lam"] * l1pz - softplus(s["kappa"] * lr_zp) + softplus(-s["kappa"] * lzp)
    out = (w1["ld"] + s["log_norm"]) + (w2["ld"] + s["log_norm"]) \
        + s["beta"] * torch.log((m1 + m2) / (_MREF * (1.0 + _QREF))) + torch.log(m1) \
        + log_dndv - 2.0 * l1pz + lj - log_pdraw
    return dict(s=s, q=q, posz=posz, lo=lo, t=t, slope=slope, z0=z0, z1=z1, j0=j0, j1=j1,
                z=z, m1=m1, m2=m2, w1=w1, w2=w2, l1pz=l1pz, lzp=lzp, lr_zp=lr_zp, out=out)


def _mass_bwd(w, m, g, s, d_bump, acc):
    """Cotangents of one mass term (into ``d_bump`` and ``acc``); returns d ld/d m.

    A dead row (m < 5) contributes nothing, and the bump branch of a cut row
    has weight exactly 0 — neither is ever formed as 0 * inf."""
    live = ~w["dead"]
    zero = torch.zeros_like(m)
    wb = torch.where(w["cut"] | w["dead"], zero, torch.exp(w["lb"] - w["ld"]))
    wt = torch.where(w["dead"], zero, torch.where(w["cut"], torch.ones_like(m),
                                                   torch.exp(w["lt"] - w["ld"])))
    inv_w = 1.0 / (0.05 * s["mbhmax"])
    sg = torch.sigmoid(-w["x"])
    slope = torch.where(w["slope"], w["b1"] - w["b0"], zero)
    gwb = g * wb
    d_bump.scatter_add_(1, w["lo"], gwb * (1.0 - w["t"]))
    d_bump.scatter_add_(1, w["lo"] + 1, gwb * w["t"])
    gs = gwb * slope / s["dmbh"]
    lr = torch.where(live, w["lr"], zero)
    acc["mbh_lo"] = acc["mbh_lo"] - gs.sum(1)
    acc["dmbh"] = acc["dmbh"] - (gs * w["pos"]).sum(1)
    acc["c"] = acc["c"] - (g * wt * lr).sum(1)
    acc["log_pl_norm"] = acc["log_pl_norm"] + (g * wt).sum(1)
    acc["mbhmax"] = acc["mbhmax"] + (g * wt * (s["c"] / s["mbhmax"]
                                               - sg * m * inv_w / s["mbhmax"])).sum(1)
    return wb * slope / s["dmbh"] + wt * (-s["c"] / m + sg * inv_w)


def _logwts_bwd_plain(det, bump, scal, qry, g):
    """The hand-derived backward of ``csrc/logwts.cu`` in tensor code."""
    return _bwd_of_rows(_evaluate(det, bump, scal, qry), det, bump, scal, g)


def _bwd_of_rows(r, det, bump, scal, g):
    """Table and scalar cotangents from the evaluation ``r`` and the (C, N) row cotangent ``g``."""
    s = r["s"]
    acc = {name: torch.zeros_like(scal[:, 0]) for name in SLOTS}
    d_bump = torch.zeros_like(bump)
    acc["log_norm"] = 2.0 * g.sum(1)  # enters both mass terms after the cut
    d1 = _mass_bwd(r["w1"], r["m1"], g, s, d_bump, acc)
    d2 = _mass_bwd(r["w2"], r["m2"], g, s, d_bump, acc)
    q, m1, m2 = r["q"], r["m1"], r["m2"]
    mt = m1 + m2
    acc["beta"] = (g * torch.log(mt / (_MREF * (1.0 + _QREF)))).sum(1)
    dout_dm1 = d1 + q * d2 + s["beta"] * (1.0 + q) / mt + 1.0 / m1
    opz = 1.0 + r["z"]
    sk = torch.sigmoid(s["kappa"] * r["lr_zp"])
    sz = torch.sigmoid(-s["kappa"] * r["lzp"])
    dout_dz = dout_dm1 * (-m1 / opz) + s["lam"] / opz - sk * s["kappa"] / opz - 2.0 / opz
    acc["lam"] = (g * r["l1pz"]).sum(1)
    acc["kappa"] = (g * (-sk * r["lr_zp"] - sz * r["lzp"])).sum(1)
    acc["zp"] = (g * (sk - sz) * s["kappa"] / (1.0 + s["zp"])).sum(1)
    gz = g * dout_dz
    lo, t = r["lo"], r["t"]
    d_z = torch.zeros_like(det[..., 0])
    d_j = torch.zeros_like(det[..., 1])
    d_z.scatter_add_(1, lo, gz * (1.0 - t)).scatter_add_(1, lo + 1, gz * t)
    d_j.scatter_add_(1, lo, g * (1.0 - t)).scatter_add_(1, lo + 1, g * t)
    dpos = torch.where(r["slope"], gz * (r["z1"] - r["z0"]) + g * (r["j1"] - r["j0"]),
                       torch.zeros_like(gz))
    acc["v0"] = -(dpos / s["dv"]).sum(1)
    acc["dv"] = -(dpos * r["posz"] / s["dv"]).sum(1)
    d_scal = torch.stack([acc[name] for name in SLOTS], dim=1)
    return torch.stack([d_z, d_j], dim=-1), d_bump, d_scal


class _LogwtsPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, det, bump, scal, qry):
        ctx.save_for_backward(det, bump, scal, qry)
        return _evaluate(det, bump, scal, qry)["out"]

    @staticmethod
    def backward(ctx, g):
        det, bump, scal, qry = ctx.saved_tensors
        d_det, d_bump, d_scal = _logwts_bwd_plain(det, bump, scal, qry, g)
        return d_det, d_bump, d_scal, None


def _check_segments(n: int, nobs: int, nsamp: int) -> None:
    check_segments("logwts_lse", n, nobs, nsamp)


def _segment_lse(out, nobs: int, nsamp: int):
    """Log-sum-exp of each event's rows, (C, nobs), and of the rows after them, (C,).
    ``torch.logsumexp`` of an all ``-inf`` (or empty) segment is ``-inf``."""
    c, n_ev = out.shape[0], nobs * nsamp
    return (torch.logsumexp(out[:, :n_ev].reshape(c, nobs, nsamp), dim=-1),
            torch.logsumexp(out[:, n_ev:], dim=-1))


def _lse_row_cotangent(out, lse_ev, lse_sel, g_ev, g_sel, nobs: int, nsamp: int):
    """(C, N) row cotangents ``g_seg exp(out - lse_seg)``.  A ``-inf`` row gets
    exactly 0 — so does every row of a segment whose log-sum-exp is ``-inf`` —
    where autograd of ``torch.logsumexp`` would form ``exp(-inf + inf)`` = NaN."""
    c, n = out.shape
    n_sel = n - nobs * nsamp
    per_row = lambda ev, sel: torch.cat(  # noqa: E731
        [ev.repeat_interleave(nsamp, dim=1), sel[:, None].expand(c, n_sel)], dim=1)
    g = per_row(g_ev, g_sel) * torch.exp(out - per_row(lse_ev, lse_sel))
    return torch.where(torch.isneginf(out), torch.zeros_like(out), g)


class _LogwtsLsePlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, det, bump, scal, qry, nobs, nsamp):
        lse_ev, lse_sel = _segment_lse(_evaluate(det, bump, scal, qry)["out"], nobs, nsamp)
        ctx.save_for_backward(det, bump, scal, qry, lse_ev, lse_sel)
        ctx.segments = (nobs, nsamp)
        return lse_ev, lse_sel

    @staticmethod
    def backward(ctx, g_ev, g_sel):
        det, bump, scal, qry, lse_ev, lse_sel = ctx.saved_tensors
        r = _evaluate(det, bump, scal, qry)
        g = _lse_row_cotangent(r["out"], lse_ev, lse_sel, g_ev, g_sel, *ctx.segments)
        d_det, d_bump, d_scal = _bwd_of_rows(r, det, bump, scal, g)
        return d_det, d_bump, d_scal, None, None, None


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "logwts_fwd": ([_P] * 5 + [_I] * 5 + [_P], _I),
    "logwts_bwd": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "logwts_lse_fwd": ([_P] * 6 + [_I] * 7 + [_P], _I),
    "logwts_lse_bwd": ([_P] * 7 + [_I, _I, _P, _I] + [_P] * 4 + [_I] * 7 + [_P], _I),
    "logwts_bwd_route": ([_I] * 6 + [_P], _I),
    "logwts_max_k": ([_I] * 5, _I),
}
def _raise_on(rc: int, what: str, k: int, g_len: int, n: int, nobs: int = 0, nsamp: int = 1) -> None:
    """:func:`raise_on`, but a shape refused for its shared memory raises a
    ``ValueError`` that names the most detector-table rows K (``fit.n_z``)
    that fit at this shape: the forward's limit, which the backward shares
    (about 28,900 at G = 256 on an H100 at the flagship's shape)."""
    if rc == ERR_SMEM:
        most = _max_k(what.endswith("_bwd"), g_len, n, nobs, nsamp)
        raise ValueError(f"{what}: a detector table of K = {k} rows (fit.n_z) with G = {g_len} bump bins needs "
                         f"more shared memory than a block of this device has; at most K = {most} fit at "
                         f"{n} query rows")
    raise_on(rc, what)


def _max_k(backward: bool, g_len: int, n: int, nobs: int = 0, nsamp: int = 1) -> int:
    """The most detector-table rows K that a launch of the ``rows`` (``nobs``
    = 0) or ``lse`` epilogue at this shape fits on the current device."""
    most = kernel_function("logwts", "logwts_max_k", _SIGNATURES)(int(backward), g_len, n, nobs, nsamp)
    if most < 0:
        raise_on(-most, "logwts_max_k")
    return most


def _require_cuda_f32(t, name: str) -> None:
    if t.device.type != "cuda" or t.dtype != torch.float32:
        raise ValueError(f"{name}: expected a float32 CUDA tensor, got {t.dtype} on {t.device}")


def _launch_args(det, bump, scal, qry):
    """Validates the four inputs once and returns ``(C, K, G, N, qry_cs, stream)``,
    ``qry_cs`` the rows between two chains' query tables (0: ``qry`` is one
    ``(N, 4)`` table for every chain; N: ``qry`` is ``(C, N, 4)``).

    Raises unless every tensor is a contiguous float32 CUDA tensor of the
    kernel's shape on one device (``qry`` 16-byte aligned: it is read as float4).
    """
    c, k, g_len, n = det.shape[0], det.shape[1], bump.shape[-1], qry.shape[-2]
    q_shape = (c, n, 4) if qry.dim() == 3 else (n, 4)
    for name, t, shape in (("det", det, (c, k, 2)), ("bump", bump, (c, g_len)),
                           ("scal", scal, (c, len(SLOTS))), ("qry", qry, q_shape)):
        _require_cuda_f32(t, name)
        if t.shape != shape or not t.is_contiguous() or t.device != det.device:
            raise ValueError(f"{name}: expected a contiguous tensor of shape {shape} on {det.device}, got "
                             f"{tuple(t.shape)} with strides {t.stride()} on {t.device}")
    if qry.data_ptr() % 16:
        raise ValueError("qry: expected 16-byte aligned storage")
    qry_cs = n if qry.dim() == 3 else 0
    return c, k, g_len, n, qry_cs, ctypes.c_void_p(torch.cuda.current_stream(det.device).cuda_stream)


def _cotangent_outputs(det, bump, scal):
    # torch.empty: the kernel stores every element exactly once
    return torch.empty_like(det), torch.empty_like(bump), torch.empty_like(scal)


def _logwts_fwd_cuda(det, bump, scal, qry):
    c, k, g_len, n, qry_cs, stream = _launch_args(det, bump, scal, qry)
    out = torch.empty((c, n), device=det.device, dtype=torch.float32)
    rc = kernel_function("logwts", "logwts_fwd", _SIGNATURES)(
        det.data_ptr(), bump.data_ptr(), scal.data_ptr(), qry.data_ptr(), out.data_ptr(),
        c, k, g_len, n, qry_cs, stream)
    _raise_on(rc, "logwts_fwd", k, g_len, n)
    LAUNCHES[counter("logwts_fwd", qry_cs)] += 1
    return out


def _bwd_scratch(what: str, det, k: int, g_len: int, n: int, nobs: int = 0, nsamp: int = 1):
    """The scratch of the backward ``what`` at this shape (``_rows.bwd_scratch``,
    the route ``csrc/logwts.cu``'s from the shape alone).  Raises beyond the
    forward's limit."""
    return bwd_scratch("logwts", _SIGNATURES, (int(what == "logwts_lse_bwd"), k, g_len, n, nobs, nsamp), det,
                       lambda rc: _raise_on(rc, what, k, g_len, n, nobs, nsamp))


def _logwts_bwd_cuda(det, bump, scal, qry, g):
    c, k, g_len, n, qry_cs, stream = _launch_args(det, bump, scal, qry)
    _require_cuda_f32(g, "g")
    if g.shape != (c, n) or not g.is_contiguous():
        raise ValueError(f"g: expected a contiguous tensor of shape {(c, n)}, got {tuple(g.shape)} "
                         f"with strides {g.stride()}")
    bins = _bwd_scratch("logwts_bwd", det, k, g_len, n)
    d_det, d_bump, d_scal = _cotangent_outputs(det, bump, scal)
    rc = kernel_function("logwts", "logwts_bwd", _SIGNATURES)(
        det.data_ptr(), bump.data_ptr(), scal.data_ptr(), qry.data_ptr(), g.data_ptr(),
        d_det.data_ptr(), d_bump.data_ptr(), d_scal.data_ptr(), None if bins is None else bins.data_ptr(),
        c, k, g_len, n, qry_cs, stream)
    _raise_on(rc, "logwts_bwd", k, g_len, n)
    LAUNCHES[counter("logwts_bwd", qry_cs, bins)] += 1
    return d_det, d_bump, d_scal


def _logwts_lse_fwd_cuda(det, bump, scal, qry, nobs: int, nsamp: int):
    c, k, g_len, n, qry_cs, stream = _launch_args(det, bump, scal, qry)
    _check_segments(n, nobs, nsamp)
    lse_ev = torch.empty((c, nobs), device=det.device, dtype=torch.float32)
    lse_sel = torch.empty((c,), device=det.device, dtype=torch.float32)
    rc = kernel_function("logwts", "logwts_lse_fwd", _SIGNATURES)(
        det.data_ptr(), bump.data_ptr(), scal.data_ptr(), qry.data_ptr(), lse_ev.data_ptr(),
        lse_sel.data_ptr(), c, k, g_len, n, qry_cs, nobs, nsamp, stream)
    _raise_on(rc, "logwts_lse_fwd", k, g_len, n, nobs, nsamp)
    LAUNCHES[counter("logwts_lse_fwd", qry_cs)] += 1
    return lse_ev, lse_sel


def _logwts_lse_bwd_cuda(det, bump, scal, qry, lse_ev, lse_sel, g_ev, g_sel, nobs: int, nsamp: int):
    """The cotangents ``g_ev`` (C, nobs) and ``g_sel`` (C,) may have any strides
    (autograd hands over broadcast views); everything else is contiguous."""
    c, k, g_len, n, qry_cs, stream = _launch_args(det, bump, scal, qry)
    _check_segments(n, nobs, nsamp)
    for name, t, shape in (("lse_ev", lse_ev, (c, nobs)), ("lse_sel", lse_sel, (c,)),
                           ("g_ev", g_ev, (c, nobs)), ("g_sel", g_sel, (c,))):
        _require_cuda_f32(t, name)
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not (lse_ev.is_contiguous() and lse_sel.is_contiguous()):
        raise ValueError("lse_ev, lse_sel: expected contiguous tensors")
    bins = _bwd_scratch("logwts_lse_bwd", det, k, g_len, n, nobs, nsamp)
    d_det, d_bump, d_scal = _cotangent_outputs(det, bump, scal)
    rc = kernel_function("logwts", "logwts_lse_bwd", _SIGNATURES)(
        det.data_ptr(), bump.data_ptr(), scal.data_ptr(), qry.data_ptr(), lse_ev.data_ptr(),
        lse_sel.data_ptr(), g_ev.data_ptr(), g_ev.stride(0), g_ev.stride(1), g_sel.data_ptr(),
        g_sel.stride(0), d_det.data_ptr(), d_bump.data_ptr(), d_scal.data_ptr(),
        None if bins is None else bins.data_ptr(), c, k, g_len, n, qry_cs, nobs, nsamp, stream)
    _raise_on(rc, "logwts_lse_bwd", k, g_len, n, nobs, nsamp)
    LAUNCHES[counter("logwts_lse_bwd", qry_cs, bins)] += 1
    return d_det, d_bump, d_scal


class _LogwtsCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, det, bump, scal, qry):
        ctx.save_for_backward(det, bump, scal, qry)
        return _logwts_fwd_cuda(det, bump, scal, qry)

    @staticmethod
    def backward(ctx, g):
        det, bump, scal, qry = ctx.saved_tensors
        d_det, d_bump, d_scal = _logwts_bwd_cuda(det, bump, scal, qry, g.contiguous())
        return d_det, d_bump, d_scal, None


class _LogwtsLseCuda(torch.autograd.Function):
    """Saves the tables, the queries and the log-sum-exps; no (C, N) tensor exists."""

    @staticmethod
    def forward(ctx, det, bump, scal, qry, nobs, nsamp):
        lse_ev, lse_sel = _logwts_lse_fwd_cuda(det, bump, scal, qry, nobs, nsamp)
        ctx.save_for_backward(det, bump, scal, qry, lse_ev, lse_sel)
        ctx.segments = (nobs, nsamp)
        return lse_ev, lse_sel

    @staticmethod
    def backward(ctx, g_ev, g_sel):
        d_det, d_bump, d_scal = _logwts_lse_bwd_cuda(*ctx.saved_tensors, g_ev, g_sel, *ctx.segments)
        return d_det, d_bump, d_scal, None, None, None


def logwts_plain(det, bump, scal, qry):
    """The plain PyTorch twin of the kernel, on any device (tests and the
    on-card comparison call it; the main path does not)."""
    return _LogwtsPlain.apply(det, bump, scal, qry)


def logwts(det, bump, scal, qry):
    """(C, N) log-weights of the queries ``qry``, ``(N, 4)`` shared by the
    chains or ``(C, N, 4)`` one table a chain; CPU tensors take the plain twin,
    CUDA tensors launch ``csrc/logwts.cu`` (forward and backward)."""
    if det.device.type == "cuda":
        return _LogwtsCuda.apply(det, bump, scal, qry)
    if det.device.type == "cpu":
        return _LogwtsPlain.apply(det, bump, scal, qry)
    raise ValueError(f"logwts: unsupported device {det.device}")


def logwts_lse_plain(det, bump, scal, qry, nobs: int, nsamp: int):
    """The plain PyTorch twin of the ``lse`` epilogue, on any device: the
    ``rows`` twin followed by ``torch.logsumexp`` over each segment, with the
    backward of an all-dead segment written out as zeros."""
    _check_segments(qry.shape[-2], nobs, nsamp)
    return _LogwtsLsePlain.apply(det, bump, scal, qry, nobs, nsamp)


def logwts_lse(det, bump, scal, qry, nobs: int, nsamp: int):
    """Segment log-sum-exps of the log-weights: ``(C, nobs)`` over each event's
    ``nsamp`` contiguous rows (the first ``nobs * nsamp`` rows of ``qry``) and
    ``(C,)`` over the rows after them (the injections).  ``qry`` is ``(N, 4)``,
    shared by the chains, or ``(C, N, 4)``, one table a chain.

    CPU tensors take the plain twin; CUDA tensors launch the ``lse`` kernels
    of ``csrc/logwts.cu``, one launch forward and one backward."""
    if det.device.type == "cuda":
        return _LogwtsLseCuda.apply(det, bump, scal, qry, nobs, nsamp)
    if det.device.type == "cpu":
        return logwts_lse_plain(det, bump, scal, qry, nobs, nsamp)
    raise ValueError(f"logwts_lse: unsupported device {det.device}")


def pack_scalars(pop, det) -> torch.Tensor:
    """(C, 15) scalar slots from a batched population intensity and detector
    table (``cosmo_frame_logwts_pallas``'s packing, pallas_logwts.py:287-298)."""
    mt = pop.mass_table
    rs = pop.params.redshift
    c = mt.log_bump.shape[0]
    like = mt.log_bump.new_ones((c,))
    cols = [det.v0 * like, det.dv * like, mt.mbh_lo * like, mt.dmbh, mt.mbh_hi,
            mt.params.c, mt.params.mbhmax, mt.log_pl_norm, mt.log_norm,
            pop.params.mass.beta, rs.lam, rs.kappa, rs.zp,
            float(det.cols.shape[1]) * like, float(mt.log_bump.shape[1]) * like]
    return torch.stack([x.expand(c) for x in cols], dim=1)


def _tables(pop, det):
    return det.cols.contiguous(), pop.mass_table.log_bump.contiguous(), pack_scalars(pop, det)


def cosmo_frame_logwts(pop, det, qry, plain: bool = False):
    """Drop-in twin of ``cosmo_frame_logwts_pallas`` for all chains at once:
    (C, N) log-weights of the queries ``qry``, (N, 4) shared or (C, N, 4) one
    table a chain, see :func:`query_rows`.

    ``plain=True`` takes the plain twin whatever the device (the on-card
    comparison uses it)."""
    fn = logwts_plain if plain else logwts
    return fn(*_tables(pop, det), qry)


def cosmo_frame_logwts_lse(pop, det, qry, nobs: int, nsamp: int, plain: bool = False):
    """The joint likelihood's use of the log-weights, fused: ``(C, nobs)``
    per-event and ``(C,)`` selection log-sum-exps of the queries ``qry``, (N, 4)
    shared or (C, N, 4) one table a chain (``nobs * nsamp`` PE-sample rows,
    then the injections).

    ``plain=True`` takes the plain twin whatever the device."""
    fn = logwts_lse_plain if plain else logwts_lse
    return fn(*_tables(pop, det), qry, nobs, nsamp)
