"""Kernel F: the q-normalised mass families' joint log-weights and their segment log-sum-exps on the card.

POWER-LAW+PEAK, BROKEN POWER LAW and POWER LAW + SPLINE pair the primary
mass with a power law in q normalised by a q-norm table ``N_q(m1)``.  Their
joint route (the fused detector-table route of ``inference/likelihoods.py``)
weighs every PE sample and injection of every chain and reduces the weights
to the per-event and selection log-sum-exps.  In eager autograd that is about 870 launches a
value+grad: the rows' weights, the segment log-sum-exps and the pivot (the
same density at ``(MREF, QREF, ZREF)``), forward and backward.  Kernel F
(``csrc/families.cu``, its arithmetic in ``csrc/families_math.cuh``) does it
in one launch forward and one backward, and ends in kernel B's ``lse``
epilogue, so no ``(C, N)`` tensor is held.

Inputs: the detector table ``(C, K, 2)`` on its uniform log(dL) grid, the
``(C, n_m)`` q-norm table on ``2 + k dm`` (``models/plpeak.py::_log_nq_grid``,
built outside with autograd), the sites ``(C, len(SLOTS))`` in the order of
the family's :data:`SLOTS` and the query rows ``(N, 4)``, shared by the
chains, or ``(C, N, 4)``, one table a chain (:func:`~bumpcosmology_torch.ops.cuda_logwts.query_rows`).
POWER LAW + SPLINE adds a second per-chain table, its spline's cubic
coefficients ``(C, 19, 4)`` (``models/pspline.py::spline_coefficients``).
The backward returns the cotangents of every input: the tables' reach the
sites through the eager code that built them.

The plain twin is the eager code itself: the CPU, and ``plain=True`` on the
card, take it (the families' ``lse`` in ``inference/likelihoods.py``).  This module only
launches: a tensor that is not on CUDA, not float32 or float64, not
contiguous or not of the expected shape raises ``ValueError``.  The table
cotangents are summed in fixed point (kernel B's), so two launches give the
same bits.
"""
from __future__ import annotations

import ctypes

import torch

from bumpcosmology_torch.ops._build import cuda_stream, kernel_function, raise_on
from bumpcosmology_torch.ops._rows import ERR_SMEM, bwd_scratch, check_segments, counter

__all__ = ["FAMILIES", "SLOTS", "LAUNCHES", "BY_FAMILY", "family_scalars", "family_lse"]

FAMILIES = {"plpeak": 0, "brokenpl": 1, "pspline": 2}  # csrc/families_math.cuh's Family codes
# the sites of a chain, in csrc/families_math.cuh's Slot order; None: a slot the family leaves at 0
SLOTS = {
    "plpeak": ("beta_q", "mmin", "mmax", "delta_m", "lam", "kappa", "zp", "alpha", "lam_peak", "mu_m", "sigma_m"),
    "brokenpl": ("beta_q", "mmin", "mmax", "delta_m", "lam", "kappa", "zp", "alpha1", "alpha2", "bfrac", None),
    "pspline": ("beta_q", "mmin", "mmax", "delta_m", "lam", "kappa", "zp", "alpha", None, None, None),
}
_NS = 11
SPLINE_SHAPE = (19, 4)  # csrc/families_math.cuh's SPL_COEFS: a chain's spline coefficients, an interval a row
# launches by direction; "_global": the backward's route for a detector table too large for its bins in shared
# memory; "_per_chain": with a (C, N, 4) query table, one a chain
LAUNCHES = {name + layout: 0 for name in ("families_fwd", "families_bwd", "families_bwd_global")
            for layout in ("", "_per_chain")}
# the same launches by family and direction, whatever their layout and route
BY_FAMILY = {f"{family}_{way}": 0 for family in FAMILIES for way in ("fwd", "bwd")}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "families_fwd": ([_I, _I] + [_P] * 7 + [_I] * 7 + [_D] * 3 + [_P], _I),
    "families_bwd": ([_I, _I] + [_P] * 8 + [_I, _I, _P, _I] + [_P] * 5 + [_I] * 7 + [_D] * 3 + [_P], _I),
    "families_bwd_route": ([_I] * 7 + [_P], _I),
}
_DSIZE = {torch.float32: 4, torch.float64: 8}


def family_scalars(family: str, mass, redshift) -> torch.Tensor:
    """``(C, 11)`` sites of ``family`` in its :data:`SLOTS` order, from its
    mass parameters (a named tuple of ``(C,)`` tensors, ``PLPeakMassParams``
    or ``BrokenPLMassParams``) and its ``RedshiftParams``."""
    values = {**mass._asdict(), **redshift._asdict()}
    zero = torch.zeros_like(values["mmin"])
    return torch.stack([zero if k is None else values[k] for k in SLOTS[family]], dim=1)


def _check(family: str, det, nq, scal, qry, spl=None):
    """``(C, K, n_m, N, qry_cs)`` of the launch; raises ``ValueError`` unless
    every tensor is a contiguous CUDA tensor of one float type (float32 or
    float64) on one device, of the kernel's shape (``qry`` 16-byte aligned),
    and ``spl`` is given for POWER LAW + SPLINE alone."""
    if family not in FAMILIES:
        raise ValueError(f"family_lse: family {family!r} is none of {', '.join(FAMILIES)}")
    if (spl is None) != (family != "pspline"):
        raise ValueError(f"spline: family {family!r} takes {'a' if family == 'pspline' else 'no'} spline table")
    if det.dim() != 3 or nq.dim() != 2 or qry.dim() not in (2, 3):
        raise ValueError(f"family_lse: expected det (C, K, 2), nq (C, n_m) and qry (N, 4) or (C, N, 4), got "
                         f"{tuple(det.shape)}, {tuple(nq.shape)} and {tuple(qry.shape)}")
    c, k, n_m, n = det.shape[0], det.shape[1], nq.shape[1], qry.shape[-2]
    q_shape = (c, n, 4) if qry.dim() == 3 else (n, 4)
    tables = (("det", det, (c, k, 2)), ("nq", nq, (c, n_m)), ("scal", scal, (c, _NS)), ("qry", qry, q_shape))
    for name, t, shape in tables + ((("spline", spl, (c, *SPLINE_SHAPE)),) if spl is not None else ()):
        if t.device.type != "cuda" or t.device != det.device or t.dtype != det.dtype or t.dtype not in _DSIZE:
            raise ValueError(f"{name}: expected a float32 or float64 CUDA tensor of the type and device of det "
                             f"({det.dtype} on {det.device}), got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor of shape {shape}, got {tuple(t.shape)} with "
                             f"strides {t.stride()}")
    if k < 2 or n_m < 2:
        raise ValueError(f"family_lse: the tables need two entries at least, got K = {k} and n_m = {n_m}")
    if qry.data_ptr() % 16:
        raise ValueError("qry: expected 16-byte aligned storage")
    return c, k, n_m, n, n if qry.dim() == 3 else 0


def _raise_on(rc: int, what: str, k: int, n_m: int, n: int) -> None:
    if rc == ERR_SMEM:
        raise ValueError(f"{what}: a detector table of K = {k} rows (fit.n_z) with a q-norm table of {n_m} "
                         f"(fit.n_grid) at {n} query rows needs more shared memory than a block of this device has")
    raise_on(rc, what)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd(family, det, nq, scal, qry, v0, dv, dm, nobs, nsamp, spl=None):
    c, k, n_m, n, qry_cs = _check(family, det, nq, scal, qry, spl)
    check_segments("family_lse", n, nobs, nsamp)
    lse_ev = det.new_empty((c, nobs))
    lse_sel = det.new_empty((c,))
    rc = kernel_function("families", "families_fwd", _SIGNATURES)(
        FAMILIES[family], _DSIZE[det.dtype], det.data_ptr(), nq.data_ptr(), _ptr(spl), scal.data_ptr(),
        qry.data_ptr(), lse_ev.data_ptr(), lse_sel.data_ptr(), c, k, n_m, n, qry_cs, nobs, nsamp, v0, dv, dm,
        cuda_stream(det))
    _raise_on(rc, "families_fwd", k, n_m, n)
    LAUNCHES[counter("families_fwd", qry_cs)] += 1
    BY_FAMILY[family + "_fwd"] += 1
    return lse_ev, lse_sel


def _bwd(family, det, nq, scal, qry, lse_ev, lse_sel, g_ev, g_sel, v0, dv, dm, nobs, nsamp, spl=None):
    """The cotangents ``g_ev`` (C, nobs) and ``g_sel`` (C,) may have any
    strides (autograd hands over broadcast views); the rest is contiguous.
    Returns the cotangents of ``det``, ``nq``, ``scal`` and ``spl`` (``None``
    without one)."""
    c, k, n_m, n, qry_cs = _check(family, det, nq, scal, qry, spl)
    check_segments("family_lse", n, nobs, nsamp)
    for name, t, shape in (("lse_ev", lse_ev, (c, nobs)), ("lse_sel", lse_sel, (c,)), ("g_ev", g_ev, (c, nobs)),
                           ("g_sel", g_sel, (c,))):
        if t.device != det.device or t.dtype != det.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected a {det.dtype} tensor of shape {shape} on {det.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not (lse_ev.is_contiguous() and lse_sel.is_contiguous()):
        raise ValueError("lse_ev, lse_sel: expected contiguous tensors")
    # the route is csrc/families.cu's, from the shape and type alone
    bins = bwd_scratch("families", _SIGNATURES, (FAMILIES[family], _DSIZE[det.dtype], k, n_m, n, nobs, nsamp), det,
                       lambda rc: _raise_on(rc, "families_bwd", k, n_m, n))
    d_det, d_nq, d_scal = torch.empty_like(det), torch.empty_like(nq), torch.empty_like(scal)  # stored in full
    d_spl = None if spl is None else torch.empty_like(spl)
    rc = kernel_function("families", "families_bwd", _SIGNATURES)(
        FAMILIES[family], _DSIZE[det.dtype], det.data_ptr(), nq.data_ptr(), _ptr(spl), scal.data_ptr(),
        qry.data_ptr(), lse_ev.data_ptr(), lse_sel.data_ptr(), g_ev.data_ptr(), g_ev.stride(0), g_ev.stride(1),
        g_sel.data_ptr(), g_sel.stride(0), d_det.data_ptr(), d_nq.data_ptr(), _ptr(d_spl), d_scal.data_ptr(),
        _ptr(bins), c, k, n_m, n, qry_cs, nobs, nsamp, v0, dv, dm, cuda_stream(det))
    _raise_on(rc, "families_bwd", k, n_m, n)
    LAUNCHES[counter("families_bwd", qry_cs, bins)] += 1
    BY_FAMILY[family + "_bwd"] += 1
    return d_det, d_nq, d_scal, d_spl


class _FamilyLse(torch.autograd.Function):
    """Saves the tables, the sites, the queries and the log-sum-exps; no (C, N) tensor exists."""

    @staticmethod
    def forward(ctx, det, nq, scal, qry, spl, family, v0, dv, dm, nobs, nsamp):
        lse_ev, lse_sel = _fwd(family, det, nq, scal, qry, v0, dv, dm, nobs, nsamp, spl)
        ctx.save_for_backward(det, nq, scal, qry, spl, lse_ev, lse_sel)
        ctx.args = (family, v0, dv, dm, nobs, nsamp)
        return lse_ev, lse_sel

    @staticmethod
    def backward(ctx, g_ev, g_sel):
        family, v0, dv, dm, nobs, nsamp = ctx.args
        det, nq, scal, qry, spl, lse_ev, lse_sel = ctx.saved_tensors
        d_det, d_nq, d_scal, d_spl = _bwd(family, det, nq, scal, qry, lse_ev, lse_sel, g_ev, g_sel, v0, dv, dm, nobs,
                                          nsamp, spl)
        return d_det, d_nq, d_scal, None, d_spl, None, None, None, None, None, None


def family_lse(family: str, det, log_nq: torch.Tensor, dm: float, scal: torch.Tensor, qry: torch.Tensor,
               nobs: int, nsamp: int, spline=None):
    """``(C, nobs)`` per-event and ``(C,)`` selection log-sum-exps of the
    joint model's weights under ``family`` (a key of :data:`FAMILIES`),
    differentiable in the detector table ``det`` (a ``DetectorFrameTable``:
    its ``cols``, on ``v0 + k dv``), the q-norm table ``log_nq`` (on
    ``2 + k dm``), POWER LAW + SPLINE's coefficient table ``spline``
    ``(C, 19, 4)`` (``None`` for the other families) and the sites ``scal``
    (:func:`family_scalars`): kernel F, one launch forward and one backward.
    ``qry`` is ``(N, 4)``, shared by the chains, or ``(C, N, 4)``, one table
    a chain; its first ``nobs * nsamp`` rows are the events' samples, the
    rest the injections.  A segment whose rows are all ``-inf`` gives
    ``-inf`` and zero cotangents."""
    return _FamilyLse.apply(det.cols, log_nq, scal, qry, spline, family, float(det.v0), float(det.dv), float(dm),
                            nobs, nsamp)
