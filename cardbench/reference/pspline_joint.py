"""Plain reference of the POWER LAW + SPLINE joint potential (the
semi-parametric BBH mass model of Edelman, Doctor, Godfrey & Farr,
arXiv:2109.06137, one of the mass models of the GWTC-3 population paper,
arXiv:2111.03634, with a flat-wCDM cosmology fitted jointly, as the
spectral-siren analysis of arXiv:2111.03604 does), batched over rows that
each carry their own position and catalog.

Written from the model's equations as the port defines them (the port's
``models/pspline.py``, ``models/plpeak.py``, ``models/redshift.py``,
``models/cosmology.py`` and ``inference/likelihoods.py``:
``PSPLINE_COSMO_PRIORS``, ``_cosmo_frame_logwts_fused``,
``pop_cosmo_loglike``); it shares no code with the port, nor with the other
references, and imports torch, numpy and math alone.  Per chain, with S(m)
the Planck taper of width delta_m above mmin:

    p(m1)     ∝ m1^-alpha S(m1) exp f(log m1)
    p(q | m1) ∝ q^beta_q S(q m1) / N_q(m1),   N_q(m1) = ∫ dq q^beta_q S(q m1)
    dN/dV/dt  ∝ (1 + z)^lam / (1 + ((1 + z) / (1 + zp))^kappa),   kappa = lam + dkappa

where f is the natural cubic spline through the 20 knots log 2 + i h,
h = log(100 / 2) / 19, at heights (0, f_1, ..., f_18, 0), with f'' = 0 at
both ends: its second derivatives at the knots solve the tridiagonal system
of the natural spline (``torch.linalg.solve``, every row its own), and on
interval i, with t = (x - x_i) / h, f = (1 - t) y_i + t y_{i+1} + h² / 6
[((1 - t)³ - (1 - t)) M_i + (t³ - t) M_{i+1}].

and each PE sample and injection, given in the detector frame (m1_det, q,
dL), weighs log p(m1) + log p(q | m1) + log dN/dV/dt + log_norm - 2 log(1 + z)
+ log dVc/dz - log ddL/dz - log pdraw at z = z(dL), m1 = m1_det / (1 + z).
The log-likelihood is, per chain, the sum over events of the log-mean of
their samples' weights minus ``nobs`` times the log of the injections'
Monte-Carlo mean (the rate marginalised).

Where this follows the port and not the papers:

* soft walls in place of hard truncations: the power law falls by
  ``WALL_SLOPE`` = 25 nats/Msun above mmax, the whole density by as much
  above ``M_TAB_HI - 10`` = 190 Msun (the q-norm table's edge);
* the power law is left unnormalised (the pivot below fixes the scale);
* f = 0 outside [2, 100] Msun, the knots' span (the paper's spline
  continues linearly); the end heights are pinned at 0, so f is continuous;
* the redshift distribution is the Madau-Dickinson rate below, not the
  paper's power law in (1 + z);
* the taper is exact down to log S = -8, at m - mmin = ``X_C`` delta_m (the
  smaller root of 8x² - 10 delta x + delta² = 0), and below is a foot
  falling ``FOOT_SLOPE`` = 4 nats/Msun, not 0; its interior is evaluated at
  m - mmin clamped to at most 0.98 delta_m (log S there is -5e-22), and
  delta_m at least 1e-6;
* N_q(m1) is not an exact integral: the trapezoid rule in u = log q over
  ``N_Q`` = 128 nodes from q = 1e-3 to 1, on ``n_grid`` masses uniform in
  [2, 200] Msun, each log-integrand floored at -1e4, read by linear
  interpolation in m1 and constant beyond the table's ends;
* the pivot: log_norm = -(log p(m1 = 30) + log p(q = 1 | m1 = 30) + log 30),
  so that m dN/dm1 dq dV dt = 1 at (30 Msun, q = 1, z = 0).  It is a
  constant of the chain, so the log-likelihood does not depend on it: it
  cancels between the events' and the injections' terms;
* the cosmology and detector tables: the cumulative trapezoid of dH / E on
  ``n_z`` knots uniform in log(1 + z) to z = 100, and z(dL) and
  log dVc/dz - log ddL/dz on ``n_z`` knots uniform in log dL over the
  catalog's range widened by the configuration's ``dl_margin``, read by
  linear interpolation (the bump's reference, ``bump_joint.py``, builds the
  same two tables).

Everything runs in the dtype of the positions (float64 for the reference)
with autograd for the gradient: no hand-derived backward, no kernel, no
table made by the program.  ``rnd`` is applied to every tensor that crosses
a stage (positions, sites, catalog rows, the q-norm table and the pivot,
the spline's second derivatives, the cosmology and detector tables, the row
weights); ``move`` to the sites
and the catalog rows alone, before ``rnd`` (``reference/__init__.py``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)
MREF, QREF = 30.0, 1.0  # the pivot (ZREF = 0)
M_TAB_LO, M_TAB_HI, Q_TAB_LO, N_Q = 2.0, 200.0, 1e-3, 128
WALL_SLOPE, FOOT_SLOPE = 25.0, 4.0
X_C = (10.0 - math.sqrt(68.0)) / 16.0
HUBBLE_DISTANCE_H = 2.99792458  # c / (100 km/s/Mpc) in Gpc
ZMAX = 100.0

N_KNOTS, M_KNOT_LO, M_KNOT_HI = 20, 2.0, 100.0  # the spline's knots, uniform in log m1
HEIGHTS = tuple(f"f_{i}" for i in range(1, N_KNOTS - 1))

# (name, family, parameters): PSPLINE_COSMO_PRIORS in its order
PRIORS = (
    ("h", "tnormal", (0.7, 0.2, 0.35, 1.4)),
    ("Om", "tnormal", (0.3, 0.15, 0.0, 1.0)),
    ("w", "tnormal", (-1.0, 0.25, -1.5, -0.5)),
    ("alpha", "uniform", (-4.0, 12.0)),
    ("beta_q", "uniform", (-4.0, 12.0)),
    ("mmin", "uniform", (2.0, 10.0)),
    ("mmax", "uniform", (30.0, 100.0)),
    ("delta_m", "uniform", (0.0, 10.0)),
    *((name, "normal", (0.0, 1.0)) for name in HEIGHTS),
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
    def t(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device).to(dtype)

    return Catalogs(t(ev["a"]), t(ev["q"]), t(ev["c"]), t(ev["lp"]), t(sel["a"]), t(sel["q"]), t(sel["c"]),
                    t(sel["lp"]), t(log_ndraw))


def dl_bounds(ev_dl: np.ndarray, sel_dl: np.ndarray, margin: float):
    """(dl_lo, dl_hi): the smallest and largest event and injection dL,
    widened by ``margin`` of themselves."""
    lo = min(float(np.min(ev_dl)), float(np.min(sel_dl)))
    hi = max(float(np.max(ev_dl)), float(np.max(sel_dl)))
    return lo * (1.0 - margin), hi * (1.0 + margin)


# ---------------------------------------------------------------- priors

def _softplus(x):
    """log(1 + e^x)."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _tnormal_log_z(loc, scale, low, high) -> float:
    def log_ndtr(v):
        return float(torch.special.log_ndtr(torch.tensor(v, dtype=torch.float64)))

    la, lb = log_ndtr((low - loc) / scale), log_ndtr((high - loc) / scale)
    return lb + math.log1p(-math.exp(la - lb))


def _site(u, family, p):
    """(constrained value, log prior + log Jacobian) of one site's column
    ``u``: a normal is its own coordinate; a bounded site is
    low + (high - low) sigmoid(u)."""
    if family == "normal":
        loc, scale = p
        z = (u - loc) / scale
        return u, -0.5 * z * z - 0.5 * LOG_2PI - math.log(scale)
    low, high = p if family == "uniform" else p[2:]
    x = low + (high - low) * torch.sigmoid(u)
    log_jac = math.log(high - low) - _softplus(-u) - _softplus(u)
    if family == "uniform":
        lp = torch.full_like(u, -math.log(high - low))
    else:
        loc, scale = p[:2]
        z = (x - loc) / scale
        lp = -0.5 * z * z - 0.5 * LOG_2PI - math.log(scale) - _tnormal_log_z(loc, scale, low, high)
    return x, torch.where((x >= low) & (x <= high), lp, -math.inf) + log_jac


def constrain(theta: torch.Tensor):
    """(sites, log prior + log Jacobian) of unconstrained ``theta`` ``(R, 30)``."""
    sites, total = {}, torch.zeros_like(theta[:, 0])
    for i, (name, family, p) in enumerate(PRIORS):
        sites[name], lp = _site(theta[:, i], family, p)
        total = total + lp
    return sites, total


# ---------------------------------------------------------------- tables

def _grid_interp(x, x0, dx, fp):
    """Linear interpolation of ``fp`` ``(R, K)`` (or ``(R, K, ncol)``) given
    on ``x0 + k dx`` at ``x`` ``(R, M)``, constant beyond the ends."""
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


def _knot_interp(x, xp, fp):
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


def cosmology_table(s, n_z: int, rnd: Callable):
    """(z, dl, ddl, dvc) of flat wCDM, each ``(R, n_z)``: the comoving
    distance by the cumulative trapezoid of dH / E(z) on knots uniform in
    log(1 + z) from 0 to z = 100; dL = (1 + z) dC, ddL/dz = dC + (1 + z)
    dH / E, dVc/dz = 4 pi dC² dH / E."""
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
    ``n_z`` knots uniform in log dL over ``bounds`` (the second column
    floored at -1e4)."""
    z_k, dl, ddl, dvc = cosmology_table(s, n_z, rnd)
    v0, v1 = math.log(bounds[0]), math.log(bounds[1])
    v = torch.linspace(v0, v1, n_z, dtype=dl.dtype, device=dl.device)
    z = _knot_interp(torch.exp(v).expand_as(dl), dl, z_k)
    cols = torch.stack([dvc, ddl], dim=-1)
    at_z = _grid_interp(torch.log1p(z), 0.0, math.log1p(ZMAX) / (n_z - 1), cols)
    log_jac = torch.clamp_min(torch.log(at_z[..., 0]) - torch.log(at_z[..., 1]), -1e4)
    return v0, (v1 - v0) / (n_z - 1), rnd(torch.stack([z, log_jac], dim=-1))


# ---------------------------------------------------------------- the mass model

def log_taper(m, mmin, delta):
    """log S(m): 0 from mmin + delta up; -log(1 + exp(delta/x + delta/(x -
    delta))) at x = m - mmin between X_C delta and 0.98 delta (x clamped to
    that range); below X_C delta that value less FOOT_SLOPE (X_C delta - x)."""
    x = m - mmin
    d = torch.clamp_min(delta, 1e-6)
    x_lo = X_C * d
    xc = torch.minimum(torch.maximum(x, x_lo), 0.98 * d)
    f = torch.clamp(d / xc + d / (xc - d), -80.0, 80.0)
    inner = -_softplus(f) - FOOT_SLOPE * torch.clamp_min(x_lo - x, 0.0)
    return torch.where(x >= d, torch.zeros_like(inner), inner)


def spline_second_derivatives(s, rnd: Callable):
    """(knots' x ``(N_KNOTS,)``, their heights and second derivatives, each
    ``(R, N_KNOTS)``): the natural spline's tridiagonal system
    (h/6) M_{i-1} + (2h/3) M_i + (h/6) M_{i+1} = (y_{i+1} - 2 y_i + y_{i-1}) / h
    at the interior knots, M = 0 at the ends, solved row by row."""
    heights = torch.stack([s[k] for k in HEIGHTS], dim=1)
    zero = torch.zeros_like(heights[:, :1])
    y = torch.cat([zero, heights, zero], dim=1)
    x = torch.linspace(math.log(M_KNOT_LO), math.log(M_KNOT_HI), N_KNOTS, dtype=y.dtype, device=y.device)
    h = (math.log(M_KNOT_HI) - math.log(M_KNOT_LO)) / (N_KNOTS - 1)
    n = N_KNOTS - 2
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    a = (2.0 * h / 3.0) * eye + (h / 6.0) * (torch.diag_embed(torch.ones(n - 1, dtype=y.dtype, device=y.device), 1)
                                           + torch.diag_embed(torch.ones(n - 1, dtype=y.dtype, device=y.device), -1))
    rhs = (y[:, 2:] - 2.0 * y[:, 1:-1] + y[:, :-2]) / h
    m = torch.linalg.solve(a.expand(y.shape[0], n, n), rhs.unsqueeze(-1)).squeeze(-1)
    return x, y, rnd(torch.cat([zero, m, zero], dim=1))


def log_spline(s, m, rnd: Callable):
    """f(log m) at ``m`` ``(R, M)``: the natural spline on the interval that
    holds log m, 0 outside [M_KNOT_LO, M_KNOT_HI]."""
    x_k, y, m2 = spline_second_derivatives(s, rnd)
    h = (math.log(M_KNOT_HI) - math.log(M_KNOT_LO)) / (N_KNOTS - 1)
    x = torch.log(m)
    i = (torch.searchsorted(x_k, x.detach().contiguous(), right=True) - 1).clamp(0, N_KNOTS - 2)
    t = (x - x_k[i]) / h
    y0, y1 = torch.gather(y, 1, i), torch.gather(y, 1, i + 1)
    m0, m1 = torch.gather(m2, 1, i), torch.gather(m2, 1, i + 1)
    u = 1.0 - t
    f = u * y0 + t * y1 + (h * h / 6.0) * ((u ** 3 - u) * m0 + (t ** 3 - t) * m1)
    return torch.where((m >= M_KNOT_LO) & (m <= M_KNOT_HI), f, torch.zeros_like(f))


def log_pm1(s, m, rnd: Callable = identity):
    """log p(m1) at ``m`` ``(R, M)``, unnormalised: the power law (with its
    wall above mmax), the taper and exp f, with the wall above 190 Msun."""
    alpha, mmin, mmax, delta = (s[k][:, None] for k in ("alpha", "mmin", "mmax", "delta_m"))
    log_pl = -alpha * torch.log(m) - WALL_SLOPE * torch.clamp_min(m - mmax, 0.0)
    return (log_pl + log_taper(m, mmin, delta) + log_spline(s, m, rnd)
            - WALL_SLOPE * torch.clamp_min(m - (M_TAB_HI - 10.0), 0.0))


def qnorm_table(s, n_m: int, rnd: Callable):
    """(dm, log N_q ``(R, n_m)``): on masses 2 + i dm up to 200 Msun, the
    trapezoid rule in u = log q over ``N_Q`` uniform nodes from log 1e-3 to 0
    of exp((beta_q + 1) u) S(e^u m1), each log-integrand floored at -1e4."""
    beta, mmin, delta = (s[k][:, None, None] for k in ("beta_q", "mmin", "delta_m"))
    dm = (M_TAB_HI - M_TAB_LO) / (n_m - 1)
    m1 = M_TAB_LO + dm * torch.arange(n_m, dtype=beta.dtype, device=beta.device)
    u = torch.linspace(math.log(Q_TAB_LO), 0.0, N_Q, dtype=beta.dtype, device=beta.device)
    f = (beta + 1.0) * u + log_taper(torch.exp(u) * m1[:, None], mmin, delta)
    f = torch.clamp_min(f, -1e4)
    log_seg = torch.logaddexp(f[..., :-1], f[..., 1:]) + torch.log(0.5 * torch.diff(u))
    return dm, rnd(torch.logsumexp(log_seg, dim=-1))


def log_dndv(z, s):
    """log dN/dV/dt at ``z`` ``(R, M)``, 0 at z = 0: lam log(1 + z) -
    log(1 + ((1 + z) / (1 + zp))^kappa) + log(1 + (1 + zp)^-kappa)."""
    lam, kappa, zp = s["lam"][:, None], (s["lam"] + s["dkappa"])[:, None], s["zp"][:, None]
    return (lam * torch.log1p(z) - _softplus(kappa * (torch.log1p(z) - torch.log1p(zp)))
            + _softplus(-kappa * torch.log1p(zp)))


def log_rate(s, m1, q, z, dm, log_nq, log_norm, rnd: Callable = identity):
    """log dN/dm1/dq/dV/dt at ``(R, M)`` queries, pivot included."""
    return (log_pm1(s, m1, rnd) + s["beta_q"][:, None] * torch.log(q)
            + log_taper(q * m1, s["mmin"][:, None], s["delta_m"][:, None])
            - _grid_interp(m1, M_TAB_LO, dm, log_nq) + log_dndv(z, s) + log_norm[:, None])


def pivot(s, dm, log_nq, rnd: Callable = identity):
    """log_norm ``(R,)``: minus log m dN/dm1/dq/dV/dt at (30 Msun, q = 1, z = 0) before it."""
    at = torch.ones_like(s["h"][:, None])
    zero = torch.zeros_like(s["h"])
    return -(log_rate(s, MREF * at, QREF * at, 0.0 * at, dm, log_nq, zero, rnd)[:, 0] + math.log(MREF))


# ---------------------------------------------------------------- the likelihood

def loglike(sites, cat: Catalogs, n_grid: int, n_z: int, bounds, rnd: Callable = identity,
            move: Callable = identity) -> torch.Tensor:
    """The joint log-likelihood of every row ``(R,)``: the per-event
    log-mean of the PE samples' weights minus ``nobs`` times the log of the
    injections' Monte-Carlo mean."""
    s = {k: rnd(move(v)) for k, v in sites.items()}
    r = s["h"].shape[0]
    dm, log_nq = qnorm_table(s, n_grid, rnd)
    log_norm = rnd(pivot(s, dm, log_nq, rnd))
    v0, dv, cols = detector_table(s, n_z, bounds, rnd)

    nobs, nsamp = cat.ev_m1d.shape[-2:]

    def rows(x):  # (1 or R, ...) -> (R, N)
        return rnd(move(x.reshape(x.shape[0], -1).expand(r, -1)))

    m1d = torch.cat([rows(cat.ev_m1d), rows(cat.sel_m1d)], dim=1)
    q = torch.cat([rows(cat.ev_q), rows(cat.sel_q)], dim=1)
    log_dl = torch.log(torch.cat([rows(cat.ev_dl), rows(cat.sel_dl)], dim=1))
    log_pdraw = torch.cat([rows(cat.ev_log_pdraw), rows(cat.sel_log_pdraw)], dim=1)
    zj = _grid_interp(log_dl, v0, dv, cols)
    z, log_jac = zj[..., 0], zj[..., 1]
    m1 = m1d / (1.0 + z)
    lw = rnd(log_rate(s, m1, q, z, dm, log_nq, log_norm, rnd) - 2.0 * torch.log1p(z) + log_jac - log_pdraw)
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
    """(log-likelihood ``(R,)``, its gradient by the sites ``(R, 30)`` in
    :data:`NAMES`' order), detached; ``sites`` maps each name to ``(R,)``."""
    with torch.enable_grad():
        leaves = {k: sites[k].detach().requires_grad_(True) for k in NAMES}
        ll = loglike(leaves, cat, n_grid, n_z, bounds, rnd, move)
        grads = torch.autograd.grad(ll.sum(), [leaves[k] for k in NAMES], allow_unused=True)
    zero = torch.zeros_like(ll)
    return ll.detach(), torch.stack([zero if g is None else g for g in grads], dim=1)


def site_jacobian(sites) -> torch.Tensor:
    """d site / d theta of every site ``(R, 30)``, from the constrained
    values: 1 for a normal, (x - low)(high - x) / (high - low) for a bounded
    site."""
    cols = []
    for name, family, p in PRIORS:
        x = sites[name]
        if family == "normal":
            cols.append(torch.ones_like(x))
        else:
            low, high = p if family == "uniform" else p[2:]
            cols.append((x - low) * (high - x) / (high - low))
    return torch.stack(cols, dim=1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 rounded to TF32's 10 stored mantissa bits (to
    nearest), with the gradient passed through unchanged."""
    x32 = x.float()
    bits = x32.view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    delta = torch.where(torch.isfinite(x32) & torch.isfinite(rounded), rounded - x32, 0.0)
    return x32 + delta.detach()
