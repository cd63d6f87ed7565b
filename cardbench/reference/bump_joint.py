"""Plain reference of the bump joint potential (PISN-bump population +
flat-wCDM cosmology), batched over rows that each carry their own position
and catalog.

Frozen copy, with its imports rewritten and its kernels written out, of the
plain route of ``bumpcosmology_torch`` at commit fb8d8bd:
``inference/distributions.py`` (priors and transforms),
``inference/likelihoods.py`` (``POP_COSMO_PRIORS``,
``population_from_sites``, ``dl_bounds_of``, ``pop_cosmo_loglike``),
``models/{mass,population,redshift,cosmology}.py`` (bump table, mass
function, redshift rate, cosmology and detector tables),
``ops/{interp,integrate,special}.py``, ``ops/cuda_bump.py::_bump_fwd_plain``
(kernel A's twin) and ``ops/cuda_logwts.py::_evaluate`` and
``_segment_lse`` (kernel B's twin).  It imports torch, numpy and math
alone.

Everything runs in the dtype of the positions (float64 for the reference)
with autograd for the gradient: no hand-derived backward, no kernel, no
table made by the program.  ``rnd`` is applied to every tensor that crosses
a stage (positions, sites, catalog rows, the bump, cosmology and detector
tables, the row weights); the identity for the reference, a rounding to a
lower precision for the control.  ``move`` is applied to the sites and the
catalog rows alone, before ``rnd``: scaling them up and down by a little
more than float32's rounding shows the rows whose value or gradient the
reference itself cannot pin down at float32's resolution (a PE sample at
the model's cut at 5 Msun, a query at an interpolation knot).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
MBH_MIN, MREF, QREF, MCO_BREAK = 5.0, 30.0, 1.0, 20.0
GRID_MBH_LO, GRID_MCO_LO = 3.0, 1.0
HUBBLE_DISTANCE_H = 2.99792458  # c / (100 km/s/Mpc) in Gpc
ZMAX = 100.0

# (name, family, parameters): POP_COSMO_PRIORS in its order
PRIORS = (
    ("h", "tnormal", (0.7, 0.2, 0.35, 1.4)),
    ("Om", "tnormal", (0.3, 0.15, 0.0, 1.0)),
    ("w", "tnormal", (-1.0, 0.25, -1.5, -0.5)),
    ("a", "tnormal", (2.35, 2.0, -1.65, 6.35)),
    ("b", "tnormal", (1.9, 2.0, -2.1, 5.9)),
    ("c", "tnormal", (4.0, 2.0, 0.0, 8.0)),
    ("mpisn", "tnormal", (35.0, 5.0, 20.0, 50.0)),
    ("dmbhmax", "tnormal", (5.0, 2.0, 0.5, 11.0)),
    ("sigma", "tnormal", (2.0, 2.0, 1.0, None)),
    ("beta", "normal", (0.0, 2.0)),
    ("log_fpl", "uniform", (math.log(1e-3), math.log(0.5))),
    ("lam", "tnormal", (2.7, 2.0, -1.3, 6.7)),
    ("dkappa", "tnormal", (5.6 - 2.7, 2.0, 1.0, 9.6 - 2.7)),
    ("zp", "tnormal", (1.9, 1.0, 0.0, 3.9)),
    ("R_unit", "normal", (0.0, 1.0)),
)
NAMES = tuple(p[0] for p in PRIORS)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Catalogs(NamedTuple):
    """Detector-frame catalogs, one per row (or one shared by every row):
    events ``(R, nobs, nsamp)``, injections ``(R, nsel)``, ``log_ndraw``
    ``(R,)``; ``dl`` in Gpc."""

    ev_m1d: torch.Tensor
    ev_q: torch.Tensor
    ev_dl: torch.Tensor
    ev_log_pdraw: torch.Tensor
    sel_m1d: torch.Tensor
    sel_q: torch.Tensor
    sel_dl: torch.Tensor
    sel_log_pdraw: torch.Tensor
    log_ndraw: torch.Tensor


def catalogs(ev: Dict[str, np.ndarray], sel: Dict[str, np.ndarray], log_ndraw, dtype, device) -> Catalogs:
    """:class:`Catalogs` from numpy columns ``a, q, c, lp`` (events with a
    leading row axis ``(R, nobs, nsamp)``, injections ``(R, nsel)``)."""
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)  # noqa: E731
    return Catalogs(t(ev["a"]), t(ev["q"]), t(ev["c"]), t(ev["lp"]), t(sel["a"]), t(sel["q"]), t(sel["c"]),
                    t(sel["lp"]), t(log_ndraw))


def dl_bounds(ev_dl: np.ndarray, sel_dl: np.ndarray, margin: float):
    """(dl_lo, dl_hi) bracketing every event and selection dL (``dl_bounds_of``)."""
    lo = min(float(np.min(ev_dl)), float(np.min(sel_dl)))
    hi = max(float(np.max(ev_dl)), float(np.max(sel_dl)))
    return lo * (1.0 - margin), hi * (1.0 + margin)


# ---------------------------------------------------------------- priors

def _softplus(x):
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _tnormal_log_z(loc, scale, low, high) -> float:
    def log_ndtr(v):
        return float(torch.special.log_ndtr(torch.tensor(v, dtype=torch.float64)))

    if high is None:
        return log_ndtr(-(low - loc) / scale)
    la, lb = log_ndtr((low - loc) / scale), log_ndtr((high - loc) / scale)
    return lb + math.log1p(-math.exp(la - lb))


def _site(u, family, p):
    """(constrained value, log prior + log Jacobian) of one site's column ``u``."""
    if family == "normal":
        loc, scale = p
        z = (u - loc) / scale
        return u, -0.5 * z * z - 0.5 * LOG_2PI - math.log(scale)
    if family == "uniform":
        low, high = p
        x = low + (high - low) * torch.sigmoid(u)
        lp = torch.where((x >= low) & (x <= high), -math.log(high - low), -math.inf)
        return x, lp + math.log(high - low) - _softplus(-u) - _softplus(u)
    loc, scale, low, high = p
    if high is None:  # one-sided: exp shift
        x = low + torch.exp(u)
        jac = u
        inside = x >= low
    else:
        x = low + (high - low) * torch.sigmoid(u)
        jac = math.log(high - low) - _softplus(-u) - _softplus(u)
        inside = (x >= low) & (x <= high)
    z = (x - loc) / scale
    lp = -0.5 * z * z - 0.5 * LOG_2PI - math.log(scale) - _tnormal_log_z(loc, scale, low, high)
    return x, torch.where(inside, lp, -math.inf) + jac


def constrain(theta: torch.Tensor):
    """(sites, log prior + log Jacobian) of unconstrained ``theta`` ``(R, 15)``."""
    sites, total = {}, torch.zeros_like(theta[:, 0])
    for i, (name, family, p) in enumerate(PRIORS):
        sites[name], lp = _site(theta[:, i], family, p)
        total = total + lp
    return sites, total


# ---------------------------------------------------------------- tables

def _unit_interp(x, x0, dx, fp):
    """Linear interpolation of ``fp`` ``(R, K)`` (or ``(R, K, ncol)``) on the
    grid ``x0 + k dx`` at ``x`` ``(R, M)``: clamped bracket and fraction."""
    k = fp.shape[1]
    pos = (x - x0) / dx
    lo = torch.floor(pos).nan_to_num(nan=0.0).clamp(0, k - 2)
    t = (pos - lo).clamp(0.0, 1.0)
    lo = lo.long()
    if fp.dim() == 3:
        idx = lo.unsqueeze(-1).expand(*lo.shape, fp.shape[2])
        f0, f1 = torch.gather(fp, 1, idx), torch.gather(fp, 1, idx + 1)
        return f0 + t.unsqueeze(-1) * (f1 - f0)
    f0, f1 = torch.gather(fp, 1, lo), torch.gather(fp, 1, lo + 1)
    return f0 + t * (f1 - f0)


def _sorted_interp(x, xp, fp):
    """Linear interpolation of ``fp`` given at increasing ``xp`` (both
    ``(R, K)``) at ``x`` ``(R, M)``, constant beyond the ends."""
    n = xp.shape[1]
    lo = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True).clamp(1, n - 1) - 1
    x0, x1 = torch.gather(xp, 1, lo), torch.gather(xp, 1, lo + 1)
    f0, f1 = torch.gather(fp, 1, lo), torch.gather(fp, 1, lo + 1)
    den = x1 - x0
    pos = den > 0
    t = torch.where(pos, (x - x0) / torch.where(pos, den, torch.ones_like(den)), 0.0).clamp(0.0, 1.0)
    return f0 + t * (f1 - f0)


def bump_table(s, n_grid: int, rnd: Callable):
    """(dmbh, log dN/dm ``(R, G)``) of the bump on ``3 + i dmbh``: the
    trapezoid over the CO-core grid of the core-mass power law times a
    Gaussian around the mean BH mass (kernel A's function)."""
    a, b, mpisn, sigma = (s[k][:, None] for k in ("a", "b", "mpisn", "sigma"))
    mbhmax = s["mpisn"][:, None] + s["dmbhmax"][:, None]
    g1 = n_grid - 1.0
    dmbh = (mbhmax + 7.0 * sigma - GRID_MBH_LO) / g1
    mco_hi = 2.0 * mbhmax - mpisn + 2.0 * torch.sqrt(mbhmax * (mbhmax - mpisn))
    dmco = (mco_hi - GRID_MCO_LO) / g1
    idx = torch.arange(n_grid, device=a.device, dtype=a.dtype)
    mbh = GRID_MBH_LO + idx * dmbh
    mco = GRID_MCO_LO + idx * dmco
    curv = 1.0 / (4.0 * (mpisn - mbhmax))
    d = mco - (2.0 * mbhmax - mpisn)
    mu = torch.where(mco >= mpisn, mbhmax + curv * d * d, mco)
    lj = torch.log(mco / MCO_BREAK)
    logc = torch.where(mco >= MCO_BREAK, -b * lj, -a * lj)
    trap = torch.full((n_grid,), math.log(2.0), device=a.device, dtype=a.dtype)
    trap[0] = trap[-1] = 0.0
    logc_w = logc + trap - 0.5 * LOG_2PI - torch.log(sigma)
    r = (mbh[:, :, None] - mu[:, None, :]) / sigma[:, :, None]
    log_dn = torch.logsumexp(logc_w[:, None, :] - 0.5 * r * r, dim=-1) + torch.log(0.5 * dmco)
    return dmbh[:, 0], rnd(log_dn)


def cosmology_table(s, n_z: int, rnd: Callable):
    """(z, dl, ddl, dvc): flat wCDM by the cumulative trapezoid of dH/E on
    ``n_z`` knots uniform in log1p(z) to z = 100; each column ``(R, n_z)``."""
    h, om, w = (s[k][:, None] for k in ("h", "Om", "w"))
    u = torch.linspace(0.0, math.log1p(ZMAX), n_z, dtype=h.dtype, device=h.device)
    z = torch.expm1(u)
    opz = 1.0 + z
    dh = HUBBLE_DISTANCE_H / h
    inv_e = 1.0 / torch.sqrt(om * opz ** 3 + (1.0 - om) * opz ** (3.0 * (1.0 + w)))
    seg = 0.5 * torch.diff(z) * (inv_e[:, :-1] + inv_e[:, 1:])
    dc = dh * torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, dim=1)], dim=1)
    return (z.expand_as(dc), rnd(dc * opz), rnd(dc + dh * opz * inv_e), rnd(4.0 * math.pi * dc * dc * dh * inv_e))


def detector_table(s, n_z: int, bounds, rnd: Callable):
    """(v0, dv, cols ``(R, n_z, 2)``): [z, log dVc/dz - log ddL/dz] on
    ``n_z`` knots uniform in log dL over ``bounds``."""
    z_k, dl, ddl, dvc = cosmology_table(s, n_z, rnd)
    v0, v1 = math.log(bounds[0]), math.log(bounds[1])
    v = torch.linspace(v0, v1, n_z, dtype=dl.dtype, device=dl.device)
    z = _sorted_interp(torch.exp(v).expand_as(dl), dl, z_k)
    cols = torch.stack([dvc, ddl], dim=-1)
    dv_dd = _unit_interp(torch.log1p(z), 0.0, math.log1p(ZMAX) / (n_z - 1), cols)
    log_jac = torch.clamp_min(torch.log(dv_dd[..., 0]) - torch.log(dv_dd[..., 1]), -1e4)
    return v0, (v1 - v0) / (n_z - 1), rnd(torch.stack([z, log_jac], dim=-1))


def _log_dndm(m, s, dmbh, log_bump, log_pl_norm, log_norm):
    """log dN/dm at ``m`` ``(R, M)``: the bump table, cut outside (3,
    mbhmax + 7 sigma), and the tail above mbhmax, zero below 5."""
    mbhmax = (s["mpisn"] + s["dmbhmax"])[:, None]
    c = s["c"][:, None]
    lb = _unit_interp(m, GRID_MBH_LO, dmbh[:, None], log_bump)
    lb = torch.where((m <= GRID_MBH_LO) | (m >= (mbhmax + 7.0 * s["sigma"][:, None])), -math.inf, lb)
    lt = -c * torch.log(m / mbhmax) + log_pl_norm[:, None] + math.log(2.0) \
        - _softplus(-(m - mbhmax) / (0.05 * mbhmax))
    out = torch.logaddexp(lb, lt)
    return torch.where(m < MBH_MIN, -math.inf, out) + log_norm[:, None]


def loglike(sites, cat: Catalogs, n_grid: int, n_z: int, bounds, rnd: Callable = identity,
            move: Callable = identity) -> torch.Tensor:
    """The joint log-likelihood of every row ``(R,)``: the per-event
    log-mean of the PE samples' weights minus ``nobs`` times the log of the
    selection's Monte-Carlo mean."""
    s = {k: rnd(move(v)) for k, v in sites.items()}
    r = s["h"].shape[0]
    dmbh, log_bump = bump_table(s, n_grid, rnd)
    mbhmax = s["mpisn"] + s["dmbhmax"]
    at_max = _unit_interp(mbhmax[:, None], GRID_MBH_LO, dmbh[:, None], log_bump)[:, 0]
    log_pl_norm = s["log_fpl"] + at_max
    zero = torch.zeros_like(dmbh)
    log_norm = -(_log_dndm(torch.full_like(dmbh[:, None], MREF), s, dmbh, log_bump, log_pl_norm, zero)[:, 0]
                 + math.log(MREF))
    v0, dv, cols = detector_table(s, n_z, bounds, rnd)

    nobs, nsamp = cat.ev_m1d.shape[-2:]

    def rows(x):  # (1 or R, ...) -> (R, N)
        return rnd(move(x.reshape(x.shape[0], -1).expand(r, -1)))

    m1d = torch.cat([rows(cat.ev_m1d), rows(cat.sel_m1d)], dim=1)
    q = torch.cat([rows(cat.ev_q), rows(cat.sel_q)], dim=1)
    log_dl = torch.log(torch.cat([rows(cat.ev_dl), rows(cat.sel_dl)], dim=1))
    log_pdraw = torch.cat([rows(cat.ev_log_pdraw), rows(cat.sel_log_pdraw)], dim=1)
    zj = _unit_interp(log_dl, v0, dv, cols)
    z, log_jac = zj[..., 0], zj[..., 1]
    m1 = m1d / (1.0 + z)
    m2 = q * m1
    lam, kappa, zp = s["lam"][:, None], (s["lam"] + s["dkappa"])[:, None], s["zp"][:, None]
    log_dndv = lam * torch.log1p(z) - _softplus(kappa * torch.log((1.0 + z) / (1.0 + zp))) \
        + _softplus(kappa * torch.log(1.0 / (1.0 + zp)))
    lw = (_log_dndm(m1, s, dmbh, log_bump, log_pl_norm, log_norm)
          + _log_dndm(m2, s, dmbh, log_bump, log_pl_norm, log_norm)
          + s["beta"][:, None] * torch.log((m1 + m2) / (MREF * (1.0 + QREF))) + torch.log(m1)
          + log_dndv - 2.0 * torch.log1p(z) + log_jac - log_pdraw)
    lw = rnd(lw)
    n_ev = nobs * nsamp
    lse_ev = torch.logsumexp(lw[:, :n_ev].reshape(r, nobs, nsamp), dim=-1)
    lse_sel = torch.logsumexp(lw[:, n_ev:], dim=-1)
    log_ndraw = cat.log_ndraw.reshape(-1).expand(r)
    return lse_ev.sum(-1) - nobs * math.log(nsamp) - nobs * (lse_sel - log_ndraw)


def potential(theta, cat: Catalogs, n_grid: int, n_z: int, bounds, rnd: Callable = identity) -> torch.Tensor:
    """U(theta) = -(log prior + log Jacobian + log-likelihood), ``(R,)``."""
    sites, lp = constrain(rnd(theta))
    return -(lp + loglike(sites, cat, n_grid, n_z, bounds, rnd))


def value_and_grad(theta, cat: Catalogs, n_grid: int, n_z: int, bounds, rnd: Callable = identity):
    """(U, dU/dtheta) of every row, detached."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        u = potential(th, cat, n_grid, n_z, bounds, rnd)
        (g,) = torch.autograd.grad(u.sum(), th)
    return u.detach(), g


def loglike_and_site_grad(sites, cat: Catalogs, n_grid: int, n_z: int, bounds, rnd: Callable = identity,
                          move: Callable = identity):
    """(log-likelihood ``(R,)``, its gradient by the sites ``(R, 15)`` in
    :data:`NAMES`' order), detached; ``sites`` maps each name to ``(R,)``."""
    with torch.enable_grad():
        leaves = {k: sites[k].detach().requires_grad_(True) for k in NAMES}
        ll = loglike(leaves, cat, n_grid, n_z, bounds, rnd, move)
        grads = torch.autograd.grad(ll.sum(), [leaves[k] for k in NAMES], allow_unused=True)
    zero = torch.zeros_like(ll)
    return ll.detach(), torch.stack([zero if g is None else g for g in grads], dim=1)


def site_jacobian(sites) -> torch.Tensor:
    """d site / d theta of every site ``(R, 15)``, from the constrained
    values (each site is a function of its own coordinate alone)."""
    cols = []
    for name, family, p in PRIORS:
        x = sites[name]
        if family == "normal":
            cols.append(torch.ones_like(x))
        elif family == "uniform" or p[3] is not None:
            low, high = (p[0], p[1]) if family == "uniform" else (p[2], p[3])
            cols.append((x - low) * (high - x) / (high - low))
        else:  # one-sided: low + exp(u)
            cols.append(x - p[2])
    return torch.stack(cols, dim=1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32's 10 stored mantissa bits (to
    nearest), with the gradient passed through unchanged."""
    x32 = x.float()
    bits = x32.view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    delta = torch.where(torch.isfinite(x32) & torch.isfinite(rounded), rounded - x32, 0.0)
    return x32 + delta.detach()
