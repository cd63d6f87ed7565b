"""Kernel B: the fused detector-frame log-weight evaluation, batched over chains.

Counterpart of the JAX package's ``ops/pallas_logwts.py`` — the flagship
joint likelihood's hot loop.  For every PE sample and injection (the rows of
one shared ``(N, 4)`` query array ``[m1_det, q, dL, log pdraw]``) and every
chain it computes

    z, log_jac = lerp(detector table @ log dL);  m1 = m1_det/(1+z);  m2 = q m1
    out = log dN/dm(m1) + log dN/dm(m2) + beta log((m1+m2)/60) + log m1
          + log dN/dV(z) - 2 log1p z + log_jac - log pdraw

from per-chain tables: the detector table ``(C, K, 2)`` = [z, log_jac] on the
uniform log(dL) grid, the bump table ``(C, G)``, and 15 scalars ``(C, 15)``
in the Pallas slot order (:data:`SLOTS`).

The CUDA kernel is ``csrc/logwts.cu``.  The backward is hand-derived (the
Pallas kernel recomputed under a JAX vjp); its plain PyTorch twin below
writes the same formulas in tensor code, and the CPU tests hold it against
JAX autodiff of the JAX package's fused path.  :func:`logwts` dispatches on
the device of its tensors: CPU takes the twin, CUDA launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bumpcosmology_torch.ops._build import check_cuda, cuda_stream, load_kernel, raise_on
from bumpcosmology_torch.ops.special import softplus

__all__ = ["SLOTS", "LAUNCHES", "logwts", "logwts_plain", "pack_scalars", "cosmo_frame_logwts"]

SLOTS = ("v0", "dv", "mbh_lo", "dmbh", "mbh_hi", "c", "mbhmax", "log_pl_norm", "log_norm",
         "beta", "lam", "kappa", "zp", "k_det", "k_bump")
LAUNCHES = {"logwts_fwd": 0, "logwts_bwd": 0}

_LOG2 = math.log(2.0)
_MBH_MIN = 5.0  # models/mass.py::MBH_MIN
_MREF = 30.0  # models/mass.py::MREF
_QREF = 1.0  # models/population.py::QREF


def _bracket(pos, n: int):
    """(lo, t, slope): the fused path's ``_interp_unit_gather`` bracket; the
    slope term of a gradient is taken where ``pos - lo`` lies in [0, 1]."""
    lo = torch.floor(pos).clamp(0, n - 2)
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
    a, q, dl, log_pdraw = (qry[:, k][None, :] for k in range(4))
    posz = (torch.log(dl) - s["v0"]) / s["dv"]
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
    r = _evaluate(det, bump, scal, qry)
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


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "logwts_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "logwts_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
}


def _shapes(det, bump, scal, qry):
    c, k, g_len, n = det.shape[0], det.shape[1], bump.shape[1], qry.shape[0]
    check_cuda(det, (c, k, 2), "det")
    check_cuda(bump, (c, g_len), "bump")
    check_cuda(scal, (c, len(SLOTS)), "scal")
    check_cuda(qry, (n, 4), "qry")
    return c, k, g_len, n


def _logwts_fwd_cuda(det, bump, scal, qry):
    c, k, g_len, n = _shapes(det, bump, scal, qry)
    out = torch.empty((c, n), device=det.device, dtype=torch.float32)
    rc = load_kernel("logwts", _SIGNATURES).logwts_fwd(
        det.data_ptr(), bump.data_ptr(), scal.data_ptr(), qry.data_ptr(), out.data_ptr(),
        c, k, g_len, n, cuda_stream(det))
    raise_on(rc, "logwts_fwd")
    LAUNCHES["logwts_fwd"] += 1
    return out


def _logwts_bwd_cuda(det, bump, scal, qry, g):
    c, k, g_len, n = _shapes(det, bump, scal, qry)
    check_cuda(g, (c, n), "g")
    d_det = torch.zeros_like(det)
    d_bump = torch.zeros_like(bump)
    d_scal = torch.zeros_like(scal)
    rc = load_kernel("logwts", _SIGNATURES).logwts_bwd(
        det.data_ptr(), bump.data_ptr(), scal.data_ptr(), qry.data_ptr(), g.data_ptr(),
        d_det.data_ptr(), d_bump.data_ptr(), d_scal.data_ptr(), c, k, g_len, n, cuda_stream(det))
    raise_on(rc, "logwts_bwd")
    LAUNCHES["logwts_bwd"] += 1
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


def logwts_plain(det, bump, scal, qry):
    """The plain PyTorch twin of the kernel, on any device (tests and the
    on-card comparison call it; the main path does not)."""
    return _LogwtsPlain.apply(det, bump, scal, qry)


def logwts(det, bump, scal, qry):
    """(C, N) log-weights; CPU tensors take the plain twin, CUDA tensors
    launch ``csrc/logwts.cu`` (forward and backward)."""
    if det.device.type == "cuda":
        return _LogwtsCuda.apply(det.contiguous(), bump.contiguous(), scal.contiguous(),
                                 qry.contiguous())
    if det.device.type == "cpu":
        return _LogwtsPlain.apply(det, bump, scal, qry)
    raise ValueError(f"logwts: unsupported device {det.device}")


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


def cosmo_frame_logwts(pop, det, qry, plain: bool = False):
    """Drop-in twin of ``cosmo_frame_logwts_pallas`` for all chains at once:
    (C, N) log-weights of the shared queries ``qry`` (N, 4).

    ``plain=True`` takes the plain twin whatever the device (the on-card
    comparison uses it)."""
    fn = logwts_plain if plain else logwts
    return fn(det.cols, pop.mass_table.log_bump, pack_scalars(pop, det), qry)
