"""The PISN-bump family's likelihoods (L2); counterpart of the JAX package's
``inference/likelihoods.py``: the joint population + flat-wCDM model and the
population-only model at fixed Planck18, both batched over chains.

    log L = Σ_events [ logsumexp_samples(log w) − log nsamp ]  −  nobs·log μ_sel
    log μ_sel = logsumexp_injections(log w_sel) − log Ndraw

**Joint model.** Every PE sample and injection is one row of a shared
``(N, 4)`` query table; one kernel-B launch weighs all of them for all chains
and reduces them to the per-event and selection log-sum-exps (the ``lse``
epilogue), so the ``(C, N)`` weights never reach device memory on this path.
:func:`pop_cosmo_event_sel_logwts` returns the weights themselves (the ``rows``
epilogue) for the trace's deterministic sites (:func:`pop_cosmo_deterministics`).
This mirrors the JAX package's fused/Pallas route
(``_cosmo_frame_logwts_fused``, ``likelihoods.py:339-361``): the log(dL)-keyed
detector table is built at ``n_z`` points, as ``likelihoods.py:472`` does
(the TPU bracket path's ``n_det`` has no counterpart here).

**Population-only model.** The rows are source-frame (m1, q, z), weighed at
a fixed cosmology (:class:`FixedCosmoGrid`), so kernel B does not apply: the
JAX package computes these weights in XLA, and the port in plain PyTorch with
autograd (:func:`pop_loglike`).  Kernel A still builds the bump table.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.distributions import Normal, TruncatedNormal, Uniform
from bumpcosmology_torch.inference.model import ModelSpec
from bumpcosmology_torch.models.cosmology import (
    build_cosmology,
    build_detector_table,
    efunc,
    planck18_log_dvdz_grid,
)
from bumpcosmology_torch.models.mass import DEFAULT_N_GRID, MREF
from bumpcosmology_torch.models.parameters import (
    CosmoParams,
    MassParams,
    PopulationParams,
    RedshiftParams,
)
from bumpcosmology_torch.models.population import COORDS, QREF, build_population, log_dndmdqdv
from bumpcosmology_torch.models.redshift import ZREF
from bumpcosmology_torch.ops.cuda_logwts import cosmo_frame_logwts, cosmo_frame_logwts_lse, query_rows
from bumpcosmology_torch.ops.interp import interp_unit_spaced

__all__ = [
    "EventData",
    "SelectionData",
    "FixedCosmoGrid",
    "PopData",
    "PopCosmoData",
    "make_pop_data",
    "make_pop_cosmo_data",
    "population_from_sites",
    "cosmo_from_sites",
    "dl_bounds_of",
    "query_table",
    "selection_neff_terms",
    "pop_cosmo_event_sel_logwts",
    "pop_cosmo_loglike",
    "pop_cosmo_deterministics",
    "pop_rows",
    "pop_loglike",
    "pop_deterministics",
    "POP_PRIORS",
    "POP_COSMO_PRIORS",
    "pop_model_spec",
    "pop_cosmo_model_spec",
]


class EventData(NamedTuple):
    """Per-event PE samples, (nobs, nsamp) each: source-frame (m1, q, z) for
    the population-only model, detector-frame (m1_det, q, dL) for the joint one."""

    a: torch.Tensor  # m1 or m1_det
    q: torch.Tensor
    c: torch.Tensor  # z or dL [Gpc]
    log_pdraw: torch.Tensor


class SelectionData(NamedTuple):
    """Detected injections (nsel,) and the log of the number drawn."""

    a: torch.Tensor  # m1 or m1_det
    q: torch.Tensor
    c: torch.Tensor  # z or dL
    log_pdraw: torch.Tensor
    log_ndraw: torch.Tensor  # scalar


class FixedCosmoGrid(NamedTuple):
    """log[4π dVc/dz/(1+z)] at fixed Planck18 on the knots ``u0 + k du`` of
    u = log1p(z) (``FixedCosmoGrid``, the JAX package's ``likelihoods.py:129-143``)."""

    u0: float
    du: float
    log_dv: torch.Tensor  # (n,)

    def log_dvdz_dt(self, z: torch.Tensor) -> torch.Tensor:
        """The measure at redshifts ``z`` of any shape: a gather and lerp in full fp32."""
        return interp_unit_spaced(torch.log1p(z), self.u0, self.du, self.log_dv)


class PopData(NamedTuple):
    events: EventData  # source frame (m1, q, z)
    selection: SelectionData
    planck: FixedCosmoGrid

    def to(self, device) -> "PopData":
        return PopData(
            EventData(*(x.to(device) for x in self.events)),
            SelectionData(*(x.to(device) for x in self.selection)),
            self.planck._replace(log_dv=self.planck.log_dv.to(device)),
        )


class PopCosmoData(NamedTuple):
    events: EventData
    selection: SelectionData

    def to(self, device) -> "PopCosmoData":
        return PopCosmoData(
            EventData(*(x.to(device) for x in self.events)),
            SelectionData(*(x.to(device) for x in self.selection)),
        )


def _log_pdraw(pdraw, dtype, device):
    """log(pdraw) in float64 *before* casting: weights below the float32
    normal range must not flush to zero and become -inf."""
    pdraw = np.asarray(pdraw, dtype=np.float64)
    if np.any(pdraw <= 0) or not np.all(np.isfinite(pdraw)):
        raise ValueError("pdraw must be strictly positive and finite")
    return torch.as_tensor(np.log(pdraw), dtype=dtype, device=device)


def make_pop_data(m1s, qs, zs, pdraw, m1s_sel, qs_sel, zs_sel, pdraw_sel, ndraw,
                  dtype=torch.float32, device=None) -> PopData:
    """Assemble source-frame :class:`PopData` from raw arrays on ``device``
    (``None`` means CUDA), with the Planck18 measure at 1024 knots to z = 100."""
    dev = resolve_device(device)
    zgrid, log_dv = planck18_log_dvdz_grid()
    du = np.log1p(zgrid[-1]) / (len(zgrid) - 1)
    # the z = 0 knot is -inf (no comoving volume); the lerp f_lo + t (f_hi - f_lo)
    # would make NaN of it at t = 0, so it is clamped to a finite value that is
    # zero weight in float32, as the JAX package clamps it
    finite_min = np.min(log_dv[np.isfinite(log_dv)])
    log_dv = np.where(np.isfinite(log_dv), log_dv, finite_min - 200.0)
    # u0 and du rounded to the table's dtype, as the JAX package stores them
    as_dtype = lambda x: float(torch.tensor(x, dtype=dtype))  # noqa: E731
    planck = FixedCosmoGrid(u0=0.0, du=as_dtype(du), log_dv=torch.as_tensor(log_dv, dtype=dtype, device=dev))
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
    ev = EventData(a=t(m1s), q=t(qs), c=t(zs), log_pdraw=_log_pdraw(pdraw, dtype, dev))
    sel = SelectionData(
        a=t(m1s_sel), q=t(qs_sel), c=t(zs_sel),
        log_pdraw=_log_pdraw(pdraw_sel, dtype, dev),
        log_ndraw=torch.log(torch.tensor(float(ndraw), dtype=dtype, device=dev)),
    )
    return PopData(events=ev, selection=sel, planck=planck)


def make_pop_cosmo_data(m1s_det, qs, dls, pdraw, m1s_det_sel, qs_sel, dls_sel, pdraw_sel, ndraw,
                        dtype=torch.float32, device=None) -> PopCosmoData:
    """Assemble :class:`PopCosmoData` from raw arrays on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
    ev = EventData(a=t(m1s_det), q=t(qs), c=t(dls), log_pdraw=_log_pdraw(pdraw, dtype, dev))
    sel = SelectionData(
        a=t(m1s_det_sel), q=t(qs_sel), c=t(dls_sel),
        log_pdraw=_log_pdraw(pdraw_sel, dtype, dev),
        log_ndraw=torch.log(torch.tensor(float(ndraw), dtype=dtype, device=dev)),
    )
    return PopCosmoData(events=ev, selection=sel)


def population_from_sites(sites: Dict[str, torch.Tensor]) -> PopulationParams:
    """mbhmax = mpisn + dmbhmax,  fpl = exp(log_fpl),  kappa = lam + dkappa."""
    mass = MassParams(
        a=sites["a"], b=sites["b"], c=sites["c"], mpisn=sites["mpisn"],
        mbhmax=sites["mpisn"] + sites["dmbhmax"], sigma=sites["sigma"],
        fpl=torch.exp(sites["log_fpl"]), beta=sites["beta"],
    )
    redshift = RedshiftParams(lam=sites["lam"], kappa=sites["lam"] + sites["dkappa"], zp=sites["zp"])
    return PopulationParams(mass=mass, redshift=redshift)


def cosmo_from_sites(sites: Dict[str, torch.Tensor]) -> CosmoParams:
    return CosmoParams(h=sites["h"], Om=sites["Om"], w=sites["w"])


def dl_bounds_of(data: PopCosmoData, margin: float = 0.05):
    """(dl_lo, dl_hi) floats bracketing every event/selection dL."""
    lo = min(float(data.events.c.min()), float(data.selection.c.min()))
    hi = max(float(data.events.c.max()), float(data.selection.c.max()))
    return lo * (1.0 - margin), hi * (1.0 + margin)


def query_table(data: PopCosmoData) -> torch.Tensor:
    """(N, 4) rows [m1_det, q, log dL, log pdraw]: every PE sample, then every injection."""
    ev, sel = data.events, data.selection
    flat = lambda x: x.reshape(-1)  # noqa: E731
    return torch.cat([query_rows(flat(ev.a), flat(ev.q), flat(ev.c), flat(ev.log_pdraw)),
                      query_rows(sel.a, sel.q, sel.c, sel.log_pdraw)], dim=0).contiguous()


def selection_neff_terms(log_sel_wts: torch.Tensor, log_ndraw: torch.Tensor):
    """(log_mu_sel, neff_sel), each ``(C,)``, from selection log-weights ``(C, nsel)``:
    the selection mean and its effective sample size (the variance diagnostic of
    Farr 2019, as ``_selection_neff_terms`` of the JAX package's ``likelihoods.py:259-272``,
    with its float32-safe clamp on the ``log1p(-exp(x))`` argument)."""
    log_mu = torch.logsumexp(log_sel_wts, dim=-1) - log_ndraw
    log_mu2 = torch.logsumexp(2.0 * log_sel_wts, dim=-1) - 2.0 * log_ndraw
    x = torch.clamp_max(2.0 * log_mu - log_ndraw - log_mu2, -1e-7)
    log_s2 = log_mu2 + torch.log1p(-torch.exp(x))
    return log_mu, torch.exp(2.0 * log_mu - log_s2)


def _frame_tables(sites, n_grid: int, n_z: int, dl_bounds, plain: bool):
    pop = build_population(population_from_sites(sites), n_grid, plain)
    cosmo = build_cosmology(cosmo_from_sites(sites), n=n_z)
    return pop, cosmo, build_detector_table(cosmo, dl_bounds[0], dl_bounds[1], n=n_z)


def pop_cosmo_event_sel_logwts(sites: Dict[str, torch.Tensor], data: PopCosmoData,
                               n_grid: int = DEFAULT_N_GRID, n_z: int = 1024, dl_bounds=None,
                               qry=None, plain: bool = False):
    """``(pop, cosmo, log_wts (C, nobs, nsamp), log_sel_wts (C, nsel))``: the
    per-row detector-frame weights that the deterministics (``neff``,
    ``neff_sel``, ``selection_noise_nats``) consume; the fused branch of the
    JAX package's ``_pop_cosmo_event_sel_logwts`` (``likelihoods.py:472-476``),
    one kernel-B launch with the ``rows`` epilogue."""
    nobs, nsamp = data.events.a.shape
    dl_bounds = dl_bounds if dl_bounds is not None else dl_bounds_of(data)
    qry = query_table(data) if qry is None else qry
    pop, cosmo, det = _frame_tables(sites, n_grid, n_z, dl_bounds, plain)
    log_w = cosmo_frame_logwts(pop, det, qry, plain)  # (C, N)
    n_ev = nobs * nsamp
    return pop, cosmo, log_w[:, :n_ev].reshape(-1, nobs, nsamp), log_w[:, n_ev:]


def pop_cosmo_loglike(sites: Dict[str, torch.Tensor], data: PopCosmoData,
                      n_grid: int = DEFAULT_N_GRID, n_z: int = 1024, dl_bounds=None,
                      qry=None, plain: bool = False) -> torch.Tensor:
    """Joint log-likelihood for sites of shape ``(C,)``; returns ``(C,)``.

    ``qry`` is :func:`query_table` of ``data`` (computed if not given);
    ``plain=True`` takes the kernels' plain twins whatever the device.
    """
    nobs, nsamp = data.events.a.shape
    dl_bounds = dl_bounds if dl_bounds is not None else dl_bounds_of(data)
    qry = query_table(data) if qry is None else qry
    pop, _, det = _frame_tables(sites, n_grid, n_z, dl_bounds, plain)
    lse_ev, lse_sel = cosmo_frame_logwts_lse(pop, det, qry, nobs, nsamp, plain)
    log_mu_sel = lse_sel - data.selection.log_ndraw
    return lse_ev.sum(-1) - nobs * math.log(nsamp) - nobs * log_mu_sel


def _shared_deterministics(sites, pop, log_wts, log_sel_wts, log_ndraw, nobs: int):
    """Rate, effective sample sizes and rate curves of ``C`` draws
    (``_shared_deterministics``, the JAX package's ``likelihoods.py:518-546``)."""
    log_mu_sel, neff_sel = selection_neff_terms(log_sel_wts, log_ndraw)
    mu_sel = torch.exp(log_mu_sel)
    # rate via the unit-normal reparameterization
    R = nobs / mu_sel + math.sqrt(nobs) / mu_sel * sites["R_unit"]
    neff = torch.exp(2.0 * torch.logsumexp(log_wts, -1) - torch.logsumexp(2.0 * log_wts, -1))

    c = R.shape[0]
    grid = lambda name: torch.as_tensor(COORDS[name], dtype=log_wts.dtype,  # noqa: E731
                                        device=log_wts.device).expand(c, -1)
    m_grid, q_grid, z_grid = grid("m_grid"), grid("q_grid"), grid("z_grid")
    full = lambda v: torch.full_like(m_grid, v)  # noqa: E731
    R_col = R[:, None]

    def rate(m1, q, z):  # exp clamped at 80 nats, as the reference does
        return torch.exp(torch.clamp_max(log_dndmdqdv(pop, m1, q, z), 80.0))

    return {
        "kappa": pop.params.redshift.kappa,
        "neff_sel": neff_sel,
        # MC noise of the -nobs log mu_sel term in nats
        "selection_noise_nats": nobs / torch.sqrt(neff_sel),
        "neff": neff,
        "R": R,
        "mdNdmdVdt_fixed_qz": m_grid * R_col * rate(m_grid, full(QREF), full(ZREF)),
        "dNdqdVdt_fixed_mz": MREF * R_col * rate(full(MREF), q_grid, full(ZREF)),
        "dNdVdt_fixed_mq": MREF * R_col * rate(full(MREF), full(QREF), z_grid),
    }


def _bump_extras(pop):
    """The bump family's reparameterized sites (``_bump_extras``, ``likelihoods.py:549-551``)."""
    return {"mbhmax": pop.params.mass.mbhmax, "fpl": pop.params.mass.fpl}


def pop_cosmo_deterministics(sites: Dict[str, torch.Tensor], data: PopCosmoData,
                             n_grid: int = DEFAULT_N_GRID, n_z: int = 1024, dl_bounds=None,
                             qry=None, plain: bool = False) -> Dict[str, torch.Tensor]:
    """Every deterministic trace site of the joint model for sites of shape
    ``(C,)`` (``pop_cosmo_deterministics``, ``likelihoods.py:563-573``): the
    shared set, ``mbhmax``, ``fpl`` and ``hz = h E(z)`` on ``COORDS["z_grid"]``.
    The weights come from one kernel-B launch with the ``rows`` epilogue."""
    nobs = data.events.a.shape[0]
    pop, cosmo, log_w, log_sel_w = pop_cosmo_event_sel_logwts(sites, data, n_grid, n_z, dl_bounds, qry,
                                                              plain)
    out = _shared_deterministics(sites, pop, log_w, log_sel_w, data.selection.log_ndraw, nobs)
    out.update(_bump_extras(pop))
    z_grid = torch.as_tensor(COORDS["z_grid"], dtype=log_w.dtype, device=log_w.device)
    cp = CosmoParams(*(x[:, None] for x in cosmo.params))
    out["hz"] = cp.h * efunc(z_grid, cp)
    return out


def pop_rows(data: PopData) -> torch.Tensor:
    """(4, N) rows [m1, q, z, log pdraw]: every PE sample, then every injection."""
    ev, sel = data.events, data.selection
    return torch.stack([torch.cat([e.reshape(-1), x]) for e, x in
                        ((ev.a, sel.a), (ev.q, sel.q), (ev.c, sel.c), (ev.log_pdraw, sel.log_pdraw))])


def _pop_event_sel_logwts(sites: Dict[str, torch.Tensor], data: PopData, n_grid: int = DEFAULT_N_GRID,
                          rows=None, plain: bool = False):
    """``(pop, log_wts (C, nobs, nsamp), log_sel_wts (C, nsel))``: the
    population-only model's source-frame weights (``_pop_event_sel_logwts``,
    the JAX package's ``likelihoods.py:274-288``), every row of every chain in
    one :func:`log_dndmdqdv` call (m1 and m2 share one table lookup).

    ``rows`` is :func:`pop_rows` of ``data`` (computed if not given);
    ``plain=True`` builds the bump table with kernel A's plain twin."""
    nobs, nsamp = data.events.a.shape
    m1, q, z, log_pdraw = pop_rows(data) if rows is None else rows
    pop = build_population(population_from_sites(sites), n_grid, plain)
    c = pop.mass_table.log_bump.shape[0]
    log_w = (log_dndmdqdv(pop, m1.expand(c, -1), q.expand(c, -1), z.expand(c, -1))
             + data.planck.log_dvdz_dt(z) - log_pdraw)
    n_ev = nobs * nsamp
    return pop, log_w[:, :n_ev].reshape(c, nobs, nsamp), log_w[:, n_ev:]


def pop_loglike(sites: Dict[str, torch.Tensor], data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None,
                plain: bool = False) -> torch.Tensor:
    """Population-only log-likelihood for sites of shape ``(C,)``; returns
    ``(C,)`` (``pop_loglike``, the JAX package's ``likelihoods.py:292-305``)."""
    nobs, nsamp = data.events.a.shape
    _, log_w, log_sel_w = _pop_event_sel_logwts(sites, data, n_grid, rows, plain)
    log_like = torch.logsumexp(log_w, -1) - math.log(nsamp)
    log_mu_sel = torch.logsumexp(log_sel_w, -1) - data.selection.log_ndraw
    return log_like.sum(-1) - nobs * log_mu_sel


def pop_deterministics(sites: Dict[str, torch.Tensor], data: PopData, n_grid: int = DEFAULT_N_GRID,
                       rows=None, plain: bool = False) -> Dict[str, torch.Tensor]:
    """Every deterministic trace site of the population-only model for sites
    of shape ``(C,)`` (``pop_deterministics``, ``likelihoods.py:554-560``): the
    shared set, ``mbhmax`` and ``fpl``."""
    nobs = data.events.a.shape[0]
    pop, log_w, log_sel_w = _pop_event_sel_logwts(sites, data, n_grid, rows, plain)
    out = _shared_deterministics(sites, pop, log_w, log_sel_w, data.selection.log_ndraw, nobs)
    out.update(_bump_extras(pop))
    return out


_MASS_PRIORS = {
    "a": TruncatedNormal(2.35, 2.0, low=-1.65, high=6.35),
    "b": TruncatedNormal(1.9, 2.0, low=-2.1, high=5.9),
    "c": TruncatedNormal(4.0, 2.0, low=0.0, high=8.0),
    "mpisn": TruncatedNormal(35.0, 5.0, low=20.0, high=50.0),
    "dmbhmax": TruncatedNormal(5.0, 2.0, low=0.5, high=11.0),
    "sigma": TruncatedNormal(2.0, 2.0, low=1.0),
    "beta": Normal(0.0, 2.0),
    "log_fpl": Uniform(math.log(1e-3), math.log(0.5)),
}

_REDSHIFT_PRIORS = {
    "lam": TruncatedNormal(2.7, 2.0, low=-1.3, high=6.7),
    "dkappa": TruncatedNormal(5.6 - 2.7, 2.0, low=1.0, high=9.6 - 2.7),
    "zp": TruncatedNormal(1.9, 1.0, low=0.0, high=3.9),
}

_COSMO_PRIORS = {
    "h": TruncatedNormal(0.7, 0.2, low=0.35, high=1.4),
    "Om": TruncatedNormal(0.3, 0.15, low=0.0, high=1.0),
    "w": TruncatedNormal(-1.0, 0.25, low=-1.5, high=-0.5),
}

_RATE_PRIORS = {"R_unit": Normal(0.0, 1.0)}

POP_PRIORS = {**_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}
POP_COSMO_PRIORS = {**_COSMO_PRIORS, **_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}


def pop_model_spec(data: PopData, n_grid: int = DEFAULT_N_GRID, device=None, plain: bool = False) -> ModelSpec:
    """The population-only model as a :class:`ModelSpec` (12 sites) with
    ``data`` on ``device`` (``None`` means CUDA; raises without it).  The
    rows are stacked here, once; ``plain=True`` builds the bump table with
    kernel A's plain twin (the on-card comparison uses it)."""
    dev = resolve_device(device)
    data = data.to(dev)
    rows = pop_rows(data)
    return ModelSpec(
        priors=dict(POP_PRIORS),
        loglike=lambda sites: pop_loglike(sites, data, n_grid, rows, plain),
        device=dev,
    )


def pop_cosmo_model_spec(data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                         device=None, plain: bool = False) -> ModelSpec:
    """The joint model as a :class:`ModelSpec` (15 sites) with ``data`` on
    ``device`` (``None`` means CUDA; raises without it).

    The dL bounds and the query table are fixed here, once.  ``plain=True``
    builds the same potential on the kernels' plain twins (the on-card
    comparison uses it; the main path does not).
    """
    dev = resolve_device(device)
    data = data.to(dev)
    bounds = dl_bounds_of(data)
    qry = query_table(data)
    return ModelSpec(
        priors=dict(POP_COSMO_PRIORS),
        loglike=lambda sites: pop_cosmo_loglike(sites, data, n_grid, n_z, bounds, qry, plain),
        device=dev,
    )
