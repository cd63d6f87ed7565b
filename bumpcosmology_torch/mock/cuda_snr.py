"""Kernel C: the fused waveform-amplitude / PSD / trapezoid SNR integral.

Counterpart of the JAX package's ``mock/pallas_snr.py``.  For a batch of
injections it computes

    integral_i = sum_k w_k (amp_scale A(f_k; i))^2 inv_psd_k

with the PhenomA amplitude of :mod:`bumpcosmology_torch.mock.waveform` on the
log-uniform grid ``f_k = exp(log f_min + k dlog)`` and the trapezoid rule's
closed-form weights on that grid.  Only the ``(N,)`` integrals are returned;
there is no gradient (the campaign is simulation, not inference).

The CUDA kernel is ``csrc/snr.cu``.  It sums each row's three segments
(inspiral, merger, ringdown) from float64 prefix tables over the grid and
loops only over the ringdown's few points; its header has the algebra.
Beside it here are two plain PyTorch renderings:

* :func:`snr_integral_plain`, the twin: the Pallas body as tensor code, which
  materializes the ``(chunk, n_f)`` integrand a chunk of rows at a time.  The
  kernel is held to it on the card, and CPU tensors take it.
* :func:`_snr_integral_segments_plain`: the kernel's segment algebra (float64
  tables, float32 row scalars, the same counts on the stored grid).  No entry
  point calls it; the CPU tests hold it to the JAX package, so that the
  algebra the kernel runs is proved where the kernel cannot run.

:func:`snr_integral` dispatches on the device of its inputs: a CPU tensor
takes the twin, a CUDA tensor launches the kernel or raises.  Kernel and twin
take their grid from :func:`log_grid`, so they cut at ``f >= f_cut`` on the
same float32 grid points.
"""
from __future__ import annotations

import ctypes
import math

import torch

from bumpcosmology_torch.mock.waveform import C_SI, FCUT, FMERG, FRING, GPC_M, MSUN_S, SIGMA, transition
from bumpcosmology_torch.ops._build import check_cuda, cuda_stream, load_kernel, raise_on

__all__ = ["AMP_SCALE", "LAUNCHES", "log_grid", "trapezoid_coefficients", "row_scalars",
           "snr_integral", "snr_integral_plain"]

# amplitudes are scaled by AMP_SCALE before squaring (A^2 ~ 1e-46 underflows
# float32); PSDs come in units of 1e-46, so AMP_SCALE^2 * PSD_SCALE = 1
AMP_SCALE = 1e23
LAUNCHES = {"snr_integral": 0}
DEFAULT_CHUNK = 65536


def log_grid(f_min: float, f_max: float, n_f: int, device) -> torch.Tensor:
    """The kernel's grid ``exp(log f_min + k dlog)``, ``k < n_f``, float32."""
    dlog = (math.log(f_max) - math.log(f_min)) / (n_f - 1)
    k = torch.arange(n_f, dtype=torch.float32, device=device)
    return torch.exp(math.log(f_min) + dlog * k)


def trapezoid_coefficients(f_min: float, f_max: float, n_f: int):
    """(c_first, c_mid, c_last): trapezoid weights ``w_k = c f_k`` on the log grid."""
    dlog = (math.log(f_max) - math.log(f_min)) / (n_f - 1)
    return (0.5 * (math.exp(dlog) - 1.0), 0.5 * (math.exp(dlog) - math.exp(-dlog)),
            0.5 * (1.0 - math.exp(-dlog)))


def row_scalars(m1_det: torch.Tensor, m2_det: torch.Tensor):
    """Per-injection ``(f_merg, f_ring, sigma, f_cut)``, rounded as the kernel rounds them."""
    m_total = m1_det + m2_det
    eta = m1_det * m2_det / (m_total * m_total)
    m_total_s = m_total * MSUN_S
    return tuple(transition(c, eta, m_total_s) for c in (FMERG, FRING, SIGMA, FCUT))


def _integral_rows(m1, m2, dl, f, w_psd, amp_scale: float):
    """The Pallas body (pallas_snr.py:37-92) for a block of rows, in tensor code."""
    f_merg, f_ring, sigma, f_cut = (x[:, None] for x in row_scalars(m1, m2))
    mc_s = (m1 * m2) ** 0.6 / (m1 + m2) ** 0.2 * MSUN_S
    a_newt = (math.sqrt(5.0 / 24.0) * math.pi ** (-2.0 / 3.0) * mc_s ** (5.0 / 6.0)
              * (C_SI / (dl * GPC_M)))[:, None] * amp_scale
    x = f / f_merg
    hw = 0.5 * sigma
    lor = hw * hw / ((f - f_ring) ** 2 + hw * hw)
    ring = (f_ring / f_merg) ** (-2.0 / 3.0) * lor
    shape = torch.where(f < f_merg, x ** (-7.0 / 6.0), torch.where(f < f_ring, x ** (-2.0 / 3.0), ring))
    shape = torch.where(f >= f_cut, 0.0, shape)
    amp = a_newt * f_merg ** (-7.0 / 6.0) * shape
    return (amp * amp * w_psd).sum(dim=1)


def snr_integral_plain(m1_det, m2_det, dl_gpc, inv_psd, f_min: float = 10.0, f_max: float = 2048.0,
                       n_f: int = 512, amp_scale: float = AMP_SCALE, chunk: int = DEFAULT_CHUNK):
    """The plain PyTorch twin of the kernel, on any device, ``chunk`` rows at a
    time (the tests and the on-card comparison call it; the main path on the
    card does not)."""
    f = log_grid(f_min, f_max, n_f, m1_det.device)
    c_first, c_mid, c_last = trapezoid_coefficients(f_min, f_max, n_f)
    w = c_mid * f
    w[0] = c_first * f[0]
    w[-1] = c_last * f[-1]
    w_psd = inv_psd.to(torch.float32) * w
    out = torch.empty(m1_det.shape[0], dtype=torch.float32, device=m1_det.device)
    for lo in range(0, m1_det.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        out[sl] = _integral_rows(m1_det[sl], m2_det[sl], dl_gpc[sl], f, w_psd, amp_scale)
    return out


def _count_below(f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``#{k : f_k < x}`` for each ``x`` on the stored grid ``f``, found as the
    kernel finds it: a guess from the log-uniform spacing, then moved until
    ``f_{k-1} < x <= f_k`` (int64, the shape of ``x``; NaN counts 0)."""
    n_f = f.shape[0]
    log_f0 = torch.log(f[0])
    guess = torch.ceil((torch.log(x) - log_f0) * ((n_f - 1) / (torch.log(f[-1]) - log_f0)))
    k = guess.nan_to_num(nan=0.0).clamp(0, n_f).long()
    inf = f.new_full((1,), math.inf)
    f_pad = torch.cat([-inf, f, inf])  # f_pad[k] = f_{k-1}
    while bool((down := f_pad[k] >= x).any()):
        k = k - down.long()
    while bool((up := f_pad[k + 1] < x).any()):
        k = k + up.long()
    return k


def _snr_integral_segments_plain(m1_det, m2_det, dl_gpc, inv_psd, f_min: float = 10.0, f_max: float = 2048.0,
                                 n_f: int = 512, amp_scale: float = AMP_SCALE):
    """The kernel's segment algebra (``csrc/snr.cu``) in plain PyTorch:

        out = a^2 (Gi[n1] + (Gm[n2] - Gm[n1] + f_ring^(-4/3) sum_{n2<=k<n3} L_k^2 g_k) / f_merg)

    with float64 prefix tables Gi, Gm of ``f^(-7/3) g`` and ``f^(-4/3) g``
    (``g_k = w_k inv_psd_k``), the row scalars in float32 and the counts of
    :func:`_count_below` on the grid of :func:`log_grid`.  ``a^2`` and the
    ringdown's factors are formed as the kernel forms them."""
    f = log_grid(f_min, f_max, n_f, m1_det.device)
    c = torch.full((n_f,), trapezoid_coefficients(f_min, f_max, n_f)[1], dtype=torch.float32)
    c[0], c[-1] = trapezoid_coefficients(f_min, f_max, n_f)[::2]  # the kernel takes the weights as floats
    g = c.to(f.device, torch.float64) * f.double() * inv_psd.to(torch.float32).double()
    log_f = torch.log(f.double())
    zero = g.new_zeros(1)
    g_insp = torch.cat([zero, torch.cumsum(torch.exp(-7.0 / 3.0 * log_f) * g, 0)])
    g_merg = torch.cat([zero, torch.cumsum(torch.exp(-4.0 / 3.0 * log_f) * g, 0)])

    f_merg, f_ring, sigma, f_cut = row_scalars(m1_det, m2_det)
    n3 = _count_below(f, f_cut)
    n1 = torch.minimum(_count_below(f, f_merg), n3)
    n2 = torch.maximum(torch.minimum(_count_below(f, f_ring), n3), n1)

    span = int((n3 - n2).max()) if n3.numel() else 0  # the longest ringdown
    idx = n2[:, None] + torch.arange(span, device=f.device)
    live = idx < n3[:, None]
    idx = idx.clamp(max=n_f - 1)
    hw2 = (0.5 * sigma) ** 2
    d = f[idx] - f_ring[:, None]
    r = 1.0 / (d * d + hw2[:, None])
    ring = torch.where(live, r * r * g.float()[idx], 0.0).sum(1)  # sum of L_k^2 g_k / hw^4

    # a^2 = A2_UNIT amp_scale^2 m1 m2 M^(-1/3) / dl^2; the ringdown's factor f_ring^(-4/3) hw^4
    amp = torch.tensor(amp_scale, dtype=torch.float32).double()  # the kernel takes it as a float
    a2 = (_A2_UNIT * amp * amp * m1_det.double() * m2_det.double() * ((m1_det + m2_det) ** (-1.0 / 3.0)).double()
          * (1.0 / (dl_gpc * dl_gpc)).double())
    r_ring2 = (f_ring ** (-1.0 / 3.0)) ** 2
    ring_scale = r_ring2.double() ** 2 * hw2.double() ** 2
    merg_ring = g_merg[n2] - g_merg[n1] + ring_scale * ring.double()
    return (a2 * (g_insp[n1] + (1.0 / f_merg).double() * merg_ring)).float()


# A_N^2 = _A2_UNIT m1 m2 M^(-1/3) / dl^2 (Msun, Gpc): Mc^(5/3) = m1 m2 M^(-1/3)
_A2_UNIT = 5.0 / 24.0 * math.pi ** (-4.0 / 3.0) * MSUN_S ** (5.0 / 3.0) * (C_SI / GPC_M) ** 2

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"snr_integral": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P], _I)}
_GRIDS: dict = {}


def _grid(f_min: float, f_max: float, n_f: int, device) -> torch.Tensor:
    """:func:`log_grid`, built once per (f_min, f_max, n_f, device) and kept."""
    key = (float(f_min), float(f_max), int(n_f), torch.device(device))
    f = _GRIDS.get(key)
    if f is None:
        f = _GRIDS[key] = log_grid(f_min, f_max, n_f, device)
    return f


def _snr_integral_cuda(m1_det, m2_det, dl_gpc, inv_psd, f_min, f_max, n_f, amp_scale):
    n = m1_det.shape[0]
    for name, t, shape in (("m1_det", m1_det, (n,)), ("m2_det", m2_det, (n,)), ("dl_gpc", dl_gpc, (n,)),
                           ("inv_psd", inv_psd, (n_f,))):
        check_cuda(t, shape, name)
    out = torch.empty(n, dtype=torch.float32, device=m1_det.device)
    if n == 0:
        return out
    f = _grid(f_min, f_max, n_f, m1_det.device)
    tables = torch.empty(2 * (n_f + 1), dtype=torch.float64, device=m1_det.device)  # (Gi, Gm) per knot
    lib = load_kernel("snr", _SIGNATURES)
    rc = lib.snr_integral(m1_det.data_ptr(), m2_det.data_ptr(), dl_gpc.data_ptr(), f.data_ptr(),
                          inv_psd.data_ptr(), tables.data_ptr(), out.data_ptr(), n, n_f,
                          *trapezoid_coefficients(f_min, f_max, n_f), amp_scale, cuda_stream(m1_det))
    raise_on(rc, "snr_integral")
    LAUNCHES["snr_integral"] += 1
    return out


def snr_integral(m1_det, m2_det, dl_gpc, inv_psd, f_min: float = 10.0, f_max: float = 2048.0,
                 n_f: int = 512, amp_scale: float = AMP_SCALE, chunk: int = DEFAULT_CHUNK):
    """(N,) integrals of (amp_scale A)^2 inv_psd df for float32 ``(N,)`` inputs;
    ``inv_psd`` is ``(n_f,)`` in scaled units (1/S_n times ``PSD_SCALE``).

    CPU tensors take the plain twin (``chunk`` rows at a time); CUDA tensors
    launch ``csrc/snr.cu``, which materializes nothing and ignores ``chunk``.
    """
    dev = m1_det.device
    if dev.type == "cuda":
        return _snr_integral_cuda(m1_det, m2_det, dl_gpc, inv_psd.contiguous(), f_min, f_max, n_f,
                                  amp_scale)
    if dev.type == "cpu":
        return snr_integral_plain(m1_det, m2_det, dl_gpc, inv_psd, f_min, f_max, n_f, amp_scale, chunk)
    raise ValueError(f"snr_integral: unsupported device {dev}")
