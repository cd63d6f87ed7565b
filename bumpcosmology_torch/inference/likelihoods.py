"""The population likelihoods of the four mass families (L2); counterpart
of the JAX package's ``inference/likelihoods.py``: the joint population +
flat-wCDM model and the population-only model at fixed Planck18, both
batched over chains, and the registry :data:`MASS_FAMILIES`.

    log L = Σ_events [ logsumexp_samples(log w) − log nsamp ]  −  nobs·log μ_sel
    log μ_sel = logsumexp_injections(log w_sel) − log Ndraw

**Routes by family.** ``build`` selects a family, ``None`` the PISN bump,
as in the JAX package; here it is a family object (:class:`_Family`, the
``build`` of :data:`MASS_FAMILIES`), and ``build(sites, n_grid)`` is the
family's intensity, as there.  Each family states its routes once: its
tables, what ``dl_bounds=None`` means for it, its joint route's per-row
weights and segment log-sum-exps, and its own deterministics.  Every
family's joint route takes the family's kernel for CUDA tensors with
``plain`` false and its plain twin otherwise (:meth:`_Family.takes_kernel`).

* The bump, joint model: the JAX package's fused/Pallas route
  (``_cosmo_frame_logwts_fused``, ``likelihoods.py:339-361``).  Every PE
  sample and injection is one row of a shared ``(N, 4)`` query table; one
  kernel-B launch weighs all of them for all chains against the log(dL)-keyed
  detector table, built at ``n_z`` points as ``likelihoods.py:472`` does, and
  reduces them to the per-event and selection log-sum-exps (the ``lse``
  epilogue).  Its deterministics take kernel B's ``rows`` epilogue
  (:func:`pop_cosmo_event_sel_logwts`), a choice of the port: the JAX
  package's take its non-fused route.
* POWER-LAW+PEAK, BROKEN POWER LAW and POWER LAW + SPLINE (a family the JAX
  package lacks, ``models/pspline.py``), joint model: kernel B hard-codes the
  bump's table layout, and the JAX package sends only the bump's intensity
  to its Pallas kernel (``likelihoods.py:351-356``).  On the card the
  potential takes kernel F (:func:`~bumpcosmology_torch.ops.cuda_families.family_lse`):
  the same query rows against the detector table at ``n_z`` points, each
  row's weight under the family (the q-norm table read at m1, the pivot
  computed in the kernel) and the segment log-sum-exps, one launch forward
  and one backward; only the q-norm table (and POWER LAW + SPLINE's table of
  cubic coefficients, F's second per-chain table) is built in PyTorch.  On
  the CPU, and with ``plain=True``, it takes F's twin,
  the XLA branch of ``_cosmo_frame_logwts_fused`` in plain PyTorch with
  autograd (one bracket per row shared by the chains).  The deterministics
  take the non-fused ``_cosmo_frame_logwts`` (``likelihoods.py:308-323``:
  ``z_at_dl`` and ``dvc_and_ddl_at_z`` on the cosmology table), as the JAX
  package's do.
* Population-only model, every family: the rows are source-frame (m1, q, z)
  weighed at a fixed cosmology (:class:`FixedCosmoGrid`) in plain PyTorch
  with autograd (:func:`pop_loglike`), as the JAX package computes them in
  XLA; kernel A builds the bump's table.

**The cosmology and detector tables.**  Every family's joint route reads
the detector table at ``n_z`` points; on the card (``plain`` false) kernel T
builds it from the sites ``h``, ``Om``, ``w``, one launch forward and one
backward (:func:`~bumpcosmology_torch.models.cosmology.kernel_detector_table`),
and no cosmology table is built.  The CPU, ``plain=True``, the
deterministics and the non-fused route build both tables in plain PyTorch
(``build_cosmology``, ``build_detector_table``).

**Fleets.**  The calibration suite fits S catalogs at once, one chain each
(the JAX package ``vmap``s its likelihood over the catalogs).  Here the data
carry a leading fleet axis instead (:func:`stack_fleet`): events ``(S, nobs,
nsamp)``, injections ``(S, nsel)``, ``log_ndraw`` ``(S,)``, and chain ``s``
reads catalog ``s``.  :func:`pop_rows` and :func:`query_table` then give
``(4, S, N)`` and ``(S, N, 4)`` rows, and the likelihoods take them as they
take one catalog's, with no loop over S: kernel B reads one query table per
chain.  :func:`take_fleet` picks the catalogs of a subset of the chains.

**Shards.**  Data split along the ``data`` axis of a mesh
(:func:`~bumpcosmology_torch.parallel.shard_pop_data`,
``shard_pop_cosmo_data``) fill the data's ``shard`` field (:class:`DataShard`:
the axis's process group and the catalog's global sizes; ``None`` for a
whole catalog).  :func:`pop_loglike` and
:func:`pop_cosmo_loglike` then weigh this rank's rows (through kernels A
and B, as for a whole catalog), combine the per-event and selection
log-sum-exps over the group (:func:`sharded_logsumexp`) and sum the sites'
gradient over it (:func:`~bumpcosmology_torch.ops.collectives.copy_to_group`);
the deterministics gather the rows' weights first.  So a spec built on a
shard gives every rank of the group the whole catalog's potential: the
counterpart of the JAX package's GSPMD placement.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.distributions import Normal, TruncatedNormal, Uniform
from bumpcosmology_torch.inference.model import ModelSpec
from bumpcosmology_torch.models.cosmology import (
    build_cosmology,
    build_detector_table,
    dvc_and_ddl_at_z,
    efunc,
    kernel_detector_table,
    planck18_log_dvdz_grid,
    z_at_dl,
)
from bumpcosmology_torch.models.brokenpl import (
    BrokenPLMassParams,
    BrokenPLPopulationParams,
    build_brokenpl_population,
)
from bumpcosmology_torch.models.mass import DEFAULT_N_GRID, MREF
from bumpcosmology_torch.models.parameters import (
    CosmoParams,
    MassParams,
    PopulationParams,
    RedshiftParams,
)
from bumpcosmology_torch.models.plpeak import PLPeakMassParams, PLPeakPopulationParams, build_plpeak_population
from bumpcosmology_torch.models.pspline import (
    N_HEIGHTS,
    PSplineMassParams,
    PSplinePopulationParams,
    build_pspline_population,
    spline_coefficients,
)
from bumpcosmology_torch.models.population import COORDS, QREF, build_population, log_dndmdqdv
from bumpcosmology_torch.models.redshift import ZREF
from bumpcosmology_torch.ops.collectives import all_gather_cat, copy_to_group
from bumpcosmology_torch.ops.cuda_families import family_lse, family_scalars
from bumpcosmology_torch.ops.cuda_logwts import cosmo_frame_logwts, cosmo_frame_logwts_lse, query_rows
from bumpcosmology_torch.ops.logsumexp import sharded_logsumexp
from bumpcosmology_torch.ops.interp import interp_unit_spaced, interp_unit_spaced_columns
from bumpcosmology_torch.utils.profiling import span

__all__ = [
    "EventData",
    "SelectionData",
    "FixedCosmoGrid",
    "DataShard",
    "PopData",
    "PopCosmoData",
    "make_pop_data",
    "make_pop_cosmo_data",
    "population_from_sites",
    "cosmo_from_sites",
    "dl_range",
    "dl_bounds_of",
    "query_table",
    "selection_neff_terms",
    "pop_cosmo_event_sel_logwts",
    "pop_cosmo_segment_lse",
    "pop_cosmo_loglike",
    "pop_cosmo_deterministics",
    "pop_rows",
    "pop_loglike",
    "pop_deterministics",
    "POP_PRIORS",
    "POP_COSMO_PRIORS",
    "pop_model_spec",
    "pop_cosmo_model_spec",
    "plpeak_from_sites",
    "plpeak_loglike",
    "plpeak_cosmo_loglike",
    "plpeak_deterministics",
    "plpeak_cosmo_deterministics",
    "PLPEAK_PRIORS",
    "PLPEAK_COSMO_PRIORS",
    "plpeak_model_spec",
    "plpeak_cosmo_model_spec",
    "brokenpl_from_sites",
    "brokenpl_loglike",
    "brokenpl_cosmo_loglike",
    "brokenpl_deterministics",
    "brokenpl_cosmo_deterministics",
    "BROKENPL_PRIORS",
    "BROKENPL_COSMO_PRIORS",
    "brokenpl_model_spec",
    "brokenpl_cosmo_model_spec",
    "SPLINE_SITES",
    "pspline_from_sites",
    "pspline_loglike",
    "pspline_cosmo_loglike",
    "pspline_deterministics",
    "pspline_cosmo_deterministics",
    "PSPLINE_PRIORS",
    "PSPLINE_COSMO_PRIORS",
    "pspline_model_spec",
    "pspline_cosmo_model_spec",
    "MassFamily",
    "MASS_FAMILIES",
    "stack_fleet",
    "take_fleet",
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


class DataShard(NamedTuple):
    """What a rank's slice of a catalog needs of the whole catalog."""

    group: object  # the process group along the mesh's ``data`` axis
    nsamp: int  # PE samples per event in the whole catalog (the ``- log nsamp`` term)
    dl_range: Optional[tuple]  # (smallest, largest) dL of the whole catalog (joint model)


class PopData(NamedTuple):
    events: EventData  # source frame (m1, q, z)
    selection: SelectionData
    planck: FixedCosmoGrid
    shard: Optional[DataShard] = None  # this rank's slice of a catalog split along ``data``

    def to(self, device) -> "PopData":
        return PopData(
            EventData(*(x.to(device) for x in self.events)),
            SelectionData(*(x.to(device) for x in self.selection)),
            self.planck._replace(log_dv=self.planck.log_dv.to(device)),
            self.shard,
        )


class PopCosmoData(NamedTuple):
    events: EventData
    selection: SelectionData
    shard: Optional[DataShard] = None

    def to(self, device) -> "PopCosmoData":
        return PopCosmoData(
            EventData(*(x.to(device) for x in self.events)),
            SelectionData(*(x.to(device) for x in self.selection)),
            self.shard,
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


def _redshift_from_sites(sites) -> RedshiftParams:
    return RedshiftParams(lam=sites["lam"], kappa=sites["lam"] + sites["dkappa"], zp=sites["zp"])


def population_from_sites(sites: Dict[str, torch.Tensor]) -> PopulationParams:
    """mbhmax = mpisn + dmbhmax,  fpl = exp(log_fpl),  kappa = lam + dkappa."""
    mass = MassParams(
        a=sites["a"], b=sites["b"], c=sites["c"], mpisn=sites["mpisn"],
        mbhmax=sites["mpisn"] + sites["dmbhmax"], sigma=sites["sigma"],
        fpl=torch.exp(sites["log_fpl"]), beta=sites["beta"],
    )
    return PopulationParams(mass=mass, redshift=_redshift_from_sites(sites))


def plpeak_from_sites(sites: Dict[str, torch.Tensor]) -> PLPeakPopulationParams:
    """Site dict → PLPeak parameters: every mass site direct, ``kappa = lam + dkappa``."""
    return PLPeakPopulationParams(mass=PLPeakMassParams(*(sites[k] for k in PLPeakMassParams._fields)),
                                  redshift=_redshift_from_sites(sites))


def brokenpl_from_sites(sites: Dict[str, torch.Tensor]) -> BrokenPLPopulationParams:
    """Site dict → BrokenPL parameters: every mass site direct, ``kappa = lam + dkappa``."""
    return BrokenPLPopulationParams(mass=BrokenPLMassParams(*(sites[k] for k in BrokenPLMassParams._fields)),
                                    redshift=_redshift_from_sites(sites))


SPLINE_SITES = tuple(f"f_{i}" for i in range(1, N_HEIGHTS + 1))  # the spline's interior heights


def pspline_from_sites(sites: Dict[str, torch.Tensor]) -> PSplinePopulationParams:
    """Site dict → PS parameters: the mass sites direct, the heights ``f_1`` …
    ``f_18`` stacked to ``(C, 18)``, ``kappa = lam + dkappa``."""
    mass = PSplineMassParams(*(sites[k] for k in PSplineMassParams._fields[:-1]),
                             heights=torch.stack([sites[k] for k in SPLINE_SITES], dim=1))
    return PSplinePopulationParams(mass=mass, redshift=_redshift_from_sites(sites))


def cosmo_from_sites(sites: Dict[str, torch.Tensor]) -> CosmoParams:
    return CosmoParams(h=sites["h"], Om=sites["Om"], w=sites["w"])


def dl_range(data: PopCosmoData):
    """(smallest, largest) event/selection dL of the data (of every catalog of a fleet)."""
    return (min(float(data.events.c.min()), float(data.selection.c.min())),
            max(float(data.events.c.max()), float(data.selection.c.max())))


def dl_bounds_of(data: PopCosmoData, margin: float = 0.05):
    """(dl_lo, dl_hi) floats bracketing every event/selection dL (of every
    catalog of a fleet; of the whole catalog for a shard, so that every rank
    builds the same detector table)."""
    lo, hi = dl_range(data) if data.shard is None else data.shard.dl_range
    return lo * (1.0 - margin), hi * (1.0 + margin)


def _combine_shards(lse_ev: torch.Tensor, lse_sel: torch.Tensor, group):
    """The per-event ``(C, nobs)`` and selection ``(C,)`` log-sum-exps of a
    shard's rows combined over the ranks of ``group``: one max and one sum
    all-reduce for both terms."""
    nobs = lse_ev.shape[-1]
    lse = sharded_logsumexp(torch.cat([lse_ev, lse_sel[:, None]], dim=1)[..., None], group, axis=-1)
    return lse[:, :nobs], lse[:, nobs]


def _whole_rows(log_w: torch.Tensor, log_sel_w: torch.Tensor, data):
    """A shard's event ``(C, nobs, nsamp/k)`` and selection ``(C, nsel/k)``
    weights gathered over its group, in the catalog's order (unchanged for
    data that are not a shard)."""
    if data.shard is None:
        return log_w, log_sel_w
    group = data.shard.group
    return all_gather_cat(log_w, group, dim=-1), all_gather_cat(log_sel_w, group, dim=-1)


def _flat_events(x: torch.Tensor) -> torch.Tensor:
    """(..., nobs, nsamp) → (..., nobs * nsamp)."""
    return x.reshape(*x.shape[:-2], -1)


def query_table(data: PopCosmoData) -> torch.Tensor:
    """(N, 4) rows [m1_det, q, log dL, log pdraw]: every PE sample, then every
    injection; ``(S, N, 4)``, one table a chain, for a fleet's data."""
    ev, sel = data.events, data.selection
    f = _flat_events
    return torch.cat([query_rows(f(ev.a), f(ev.q), f(ev.c), f(ev.log_pdraw)),
                      query_rows(sel.a, sel.q, sel.c, sel.log_pdraw)], dim=-2).contiguous()


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


def _cosmo_frame_logwts(pop, cosmo, rows) -> torch.Tensor:
    """``(C, N)`` detector-frame weights of the ``(4, N)`` rows [m1_det, q,
    dL, log pdraw] on the cosmology table: z = z(dL) by the table's inverse,
    m1 = m1_det/(1+z), times the full Jacobian (``_cosmo_frame_logwts``, the
    JAX package's ``likelihoods.py:308-323``)."""
    a, q, dl, log_pdraw = rows
    c = cosmo.dl.shape[0]
    z = z_at_dl(cosmo, dl.expand(c, -1))
    m1 = a / (1.0 + z)
    dvc, ddl = dvc_and_ddl_at_z(cosmo, z)
    return (log_dndmdqdv(pop, m1, q.expand(c, -1), z) - 2.0 * torch.log1p(z) + torch.log(dvc)
            - torch.log(ddl) - log_pdraw)


def _cosmo_frame_logwts_fused(pop, det, qry) -> torch.Tensor:
    """``(C, N)`` detector-frame weights of the query rows through the
    log(dL)-keyed detector table: the XLA branch of the JAX package's
    ``_cosmo_frame_logwts_fused`` (``likelihoods.py:358-361``), for the
    families kernel B does not take.  A shared ``(N, 4)`` table's positions
    are expanded to the chains; a ``(C, N, 4)`` table (a fleet) has one per
    chain and row.  Both read the ``(C, K, 2)`` table through
    :func:`interp_unit_spaced_columns`, whose backward on the card sums in a
    fixed order, so the value+grad repeats bit for bit there."""
    c = det.cols.shape[0]
    zj = interp_unit_spaced_columns(qry[..., 2].expand(c, -1), det.v0, det.dv, det.cols)  # (C, N, 2)
    z, log_jac = zj[..., 0], zj[..., 1]
    m1 = qry[..., 0] / (1.0 + z)
    return (log_dndmdqdv(pop, m1, qry[..., 1].expand(c, -1), z) - 2.0 * torch.log1p(z) + log_jac
            - qry[..., 3])


# ---------------------------------------------------------------------------
# Mass families: each family's routes, stated once
# ---------------------------------------------------------------------------


class _Family(NamedTuple):
    """A mass family as the likelihoods take it: the ``build`` of their
    signatures (``None`` is :data:`_BUMP`, see :func:`_family`).

    ``family(sites, n_grid)`` is its per-draw intensity: the bump's table
    by kernel A (its plain twin with ``plain=True``), or a q-normalised
    family's q-norm table and pivot in the span ``loglike.qnorm``
    (``pivot=False`` leaves the pivot at 0, for kernel F to compute).
    ``fills_bounds``: ``dl_bounds=None`` means the data's bounds (the bump),
    or else the non-fused route, as the JAX package's signatures have it.
    ``rows(pop, det, qry, kernel)`` and ``lse(pop, det, qry, nobs, nsamp,
    kernel)`` are the fused route's ``(C, N)`` weights and segment
    log-sum-exps, by the family's kernel or by its plain twin
    (:meth:`takes_kernel`).  ``extras`` names the family's own
    deterministic sites, read off its mass parameters (the JAX package's
    ``_bump_extras``, ``likelihoods.py:549-551``)."""

    name: str  # its key in MASS_FAMILIES; for a q-normalised family, also its code in kernel F
    intensity: Callable  # (sites, n_grid, plain, pivot) -> intensity
    fills_bounds: bool
    rows: Callable
    lse: Callable
    extras: tuple

    def __call__(self, sites, n_grid: int, plain: bool = False, pivot: bool = True):
        return self.intensity(sites, n_grid, plain, pivot)

    @staticmethod
    def takes_kernel(plain: bool, data) -> bool:
        """Every family's rule: the kernel for CUDA tensors with ``plain`` false, the plain twin otherwise."""
        return not plain and data.events.a.device.type == "cuda"

    def bounds(self, dl_bounds, data):
        """``dl_bounds``; for ``None``, the data's bounds if the family
        fills them, else ``None`` (the non-fused route)."""
        return dl_bounds_of(data) if dl_bounds is None and self.fills_bounds else dl_bounds

    def tables(self, sites, n_grid: int, n_z: int, dl_bounds, plain: bool = False, kernel: bool = False):
        """The intensity, the cosmology table and the detector table (``None``
        without ``dl_bounds``) of the sites, in the span ``loglike.tables``.
        On the joint route's kernels (``kernel``, :meth:`takes_kernel`) the
        intensity leaves the pivot at 0 for kernel F to compute, kernel T
        builds the detector table, and no cosmology table is built (``None``)."""
        with span("loglike.tables"):
            pop = self(sites, n_grid, plain, pivot=not kernel)
            if kernel:
                return pop, None, kernel_detector_table(cosmo_from_sites(sites), dl_bounds[0], dl_bounds[1], n=n_z)
            cosmo = build_cosmology(cosmo_from_sites(sites), n=n_z)
            det = None if dl_bounds is None else build_detector_table(cosmo, dl_bounds[0], dl_bounds[1], n=n_z)
            return pop, cosmo, det


def _bump_intensity(sites, n_grid: int, plain: bool, pivot: bool):
    """The bump's population, its table by kernel A; the bump has no pivot."""
    return build_population(population_from_sites(sites), n_grid, plain)


def _bump_rows(pop, det, qry, kernel: bool):
    """Kernel B's ``rows`` epilogue, or its twin."""
    return cosmo_frame_logwts(pop, det, qry, not kernel)


def _bump_lse(pop, det, qry, nobs: int, nsamp: int, kernel: bool):
    """Kernel B's ``lse`` epilogue, or its twin."""
    return cosmo_frame_logwts_lse(pop, det, qry, nobs, nsamp, not kernel)


def _qnorm_intensity(from_sites, build, sites, n_grid: int, plain: bool, pivot: bool):
    """A q-normalised family's intensity, by its own ``from_sites`` and ``build``."""
    with span("loglike.qnorm"):
        return build(from_sites(sites), n_m=n_grid, pivot=pivot)


def _qnorm_rows(pop, det, qry, kernel: bool):
    """Kernel F has no ``rows`` epilogue: the twin on every device."""
    return _cosmo_frame_logwts_fused(pop, det, qry)


def _qnorm_lse(name: str, pop, det, qry, nobs: int, nsamp: int, kernel: bool):
    """Kernel F on tables built without the pivot, or its twin: the fused
    route in plain PyTorch with autograd, then ``torch.logsumexp``."""
    if kernel:
        scal = family_scalars(name, pop.params.mass, pop.params.redshift)
        # POWER LAW + SPLINE's coefficient table is F's second per-chain table
        return family_lse(name, det, pop.log_nq, pop.dm, scal, qry, nobs, nsamp, spline=getattr(pop, "coef", None))
    log_w, log_sel_w = _segments(_cosmo_frame_logwts_fused(pop, det, qry), nobs, nsamp)
    return torch.logsumexp(log_w, -1), torch.logsumexp(log_sel_w, -1)


def _qnorm_family(name: str, from_sites, build) -> _Family:
    return _Family(name, partial(_qnorm_intensity, from_sites, build), False, _qnorm_rows, partial(_qnorm_lse, name),
                   ())


def _pspline_intensity(sites, n_grid: int, plain: bool, pivot: bool):
    """POWER LAW + SPLINE's intensity: the coefficient table in the span
    ``loglike.spline``, then the q-norm table and the pivot as the other
    q-normalised families build them."""
    params = pspline_from_sites(sites)
    with span("loglike.spline"):
        coef = spline_coefficients(params.mass.heights)
    with span("loglike.qnorm"):
        return build_pspline_population(params, n_m=n_grid, pivot=pivot, coef=coef)


_BUMP = _Family("bump", _bump_intensity, True, _bump_rows, _bump_lse, ("mbhmax", "fpl"))
_PLPEAK = _qnorm_family("plpeak", plpeak_from_sites, build_plpeak_population)
_BROKENPL = _qnorm_family("brokenpl", brokenpl_from_sites, build_brokenpl_population)
_PSPLINE = _Family("pspline", _pspline_intensity, False, _qnorm_rows, partial(_qnorm_lse, "pspline"), ())


def _family(build) -> _Family:
    """The family ``build`` selects: ``None`` is the bump, as in the JAX package's signatures."""
    return _BUMP if build is None else build


def _segments(log_w: torch.Tensor, nobs: int, nsamp: int):
    """``(C, N)`` weights as the events' ``(C, nobs, nsamp)`` and the injections' ``(C, nsel)``."""
    n_ev = nobs * nsamp
    return log_w[:, :n_ev].reshape(-1, nobs, nsamp), log_w[:, n_ev:]


def pop_cosmo_event_sel_logwts(sites: Dict[str, torch.Tensor], data: PopCosmoData,
                               n_grid: int = DEFAULT_N_GRID, n_z: int = 1024, dl_bounds=None,
                               qry=None, plain: bool = False, build=None):
    """``(pop, cosmo, log_wts (C, nobs, nsamp), log_sel_wts (C, nsel))``: the
    per-row detector-frame weights that the deterministics (``neff``,
    ``neff_sel``, ``selection_noise_nats``) consume.

    With detector bounds, the fused route through the family's ``rows``:
    for the bump one kernel-B launch with the ``rows`` epilogue, the fused
    branch of the JAX package's ``_pop_cosmo_event_sel_logwts``
    (``likelihoods.py:472-476``), ``dl_bounds`` defaulting to the data's;
    for another family plain PyTorch.  Another family without
    ``dl_bounds``: the non-fused route, as the JAX package's deterministics
    take it.  A fleet's data (leading axis S = C) give chain ``s`` catalog ``s``."""
    family = _family(build)
    pop, cosmo, det = family.tables(sites, n_grid, n_z, family.bounds(dl_bounds, data), plain)
    if det is None:
        log_w = _cosmo_frame_logwts(pop, cosmo, pop_rows(data))
    else:
        log_w = family.rows(pop, det, query_table(data) if qry is None else qry, family.takes_kernel(plain, data))
    return (pop, cosmo, *_segments(log_w, *data.events.a.shape[-2:]))


def pop_cosmo_segment_lse(sites: Dict[str, torch.Tensor], data: PopCosmoData,
                          n_grid: int = DEFAULT_N_GRID, n_z: int = 1024, dl_bounds=None,
                          qry=None, plain: bool = False, build=None):
    """``(C, nobs)`` per-event and ``(C,)`` selection log-sum-exps of the joint
    model's weights for sites of shape ``(C,)``: the two terms of the
    likelihood before their constants.

    ``qry`` is :func:`query_table` of ``data`` (computed if not given).  With
    detector bounds, the family's ``lse``: the bump's kernel B ``lse``
    epilogue (``dl_bounds`` defaulting to the data's), the q-normalised
    families' kernel F (:func:`~bumpcosmology_torch.ops.cuda_families.family_lse`),
    or, on the CPU and with ``plain=True``, their plain twins.  Another
    family without ``dl_bounds``: :func:`pop_cosmo_event_sel_logwts`'s
    non-fused route.  A fleet's data (leading axis S = C) give chain ``s``
    catalog ``s``.
    """
    family = _family(build)
    dl_bounds = family.bounds(dl_bounds, data)
    if dl_bounds is None:
        _, _, log_w, log_sel_w = pop_cosmo_event_sel_logwts(sites, data, n_grid, n_z, None, qry, plain, family)
        return torch.logsumexp(log_w, -1), torch.logsumexp(log_sel_w, -1)
    kernel = family.takes_kernel(plain, data)
    pop, _, det = family.tables(sites, n_grid, n_z, dl_bounds, plain, kernel)
    nobs, nsamp = data.events.a.shape[-2:]
    return family.lse(pop, det, query_table(data) if qry is None else qry, nobs, nsamp, kernel)


def pop_cosmo_loglike(sites: Dict[str, torch.Tensor], data: PopCosmoData,
                      n_grid: int = DEFAULT_N_GRID, n_z: int = 1024, dl_bounds=None,
                      qry=None, plain: bool = False, build=None, n_det=None) -> torch.Tensor:
    """Joint log-likelihood for sites of shape ``(C,)``; returns ``(C,)``:
    :func:`pop_cosmo_segment_lse`'s two terms with their constants.

    ``n_det`` is accepted for the JAX package's signature and changes
    nothing: the detector table is built at ``n_z`` points, as the JAX package's
    CPU and Pallas route builds it (``likelihoods.py:472``); its TPU bracket
    path alone read ``n_det``.  Data that are a shard give the whole
    catalog's log-likelihood on every rank of the shard's group."""
    nobs, nsamp = data.events.a.shape[-2:]
    shard = data.shard
    if shard is not None:
        sites, nsamp = copy_to_group(sites, shard.group), shard.nsamp
    lse_ev, lse_sel = pop_cosmo_segment_lse(sites, data, n_grid, n_z, dl_bounds, qry, plain, build)
    if shard is not None:
        lse_ev, lse_sel = _combine_shards(lse_ev, lse_sel, shard.group)
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


def pop_cosmo_deterministics(sites: Dict[str, torch.Tensor], data: PopCosmoData,
                             n_grid: int = DEFAULT_N_GRID, n_z: int = 1024, dl_bounds=None,
                             qry=None, plain: bool = False, build=None) -> Dict[str, torch.Tensor]:
    """Every deterministic trace site of the joint model for sites of shape
    ``(C,)`` (``pop_cosmo_deterministics``, ``likelihoods.py:563-573``, and
    the families' ``*_cosmo_deterministics``): the shared set, the family's
    own sites (the bump's ``mbhmax`` and ``fpl``) and ``hz = h E(z)`` on
    ``COORDS["z_grid"]``.  The weights are :func:`pop_cosmo_event_sel_logwts`'s:
    the bump's from one kernel-B launch with the ``rows`` epilogue, another
    family's on the non-fused route unless ``dl_bounds`` is given."""
    family = _family(build)
    nobs = data.events.a.shape[0]
    pop, cosmo, log_w, log_sel_w = pop_cosmo_event_sel_logwts(sites, data, n_grid, n_z, dl_bounds, qry,
                                                              plain, family)
    log_w, log_sel_w = _whole_rows(log_w, log_sel_w, data)
    out = _shared_deterministics(sites, pop, log_w, log_sel_w, data.selection.log_ndraw, nobs)
    out.update({k: getattr(pop.params.mass, k) for k in family.extras})
    out["hz"] = _hz(cosmo, log_w)
    return out


def _hz(cosmo, like: torch.Tensor) -> torch.Tensor:
    """h E(z) on ``COORDS["z_grid"]``, ``(C, 128)``."""
    z_grid = torch.as_tensor(COORDS["z_grid"], dtype=like.dtype, device=like.device)
    cp = CosmoParams(*(x[:, None] for x in cosmo.params))
    return cp.h * efunc(z_grid, cp)


def pop_rows(data: PopData) -> torch.Tensor:
    """(4, N) rows [m1, q, z, log pdraw]: every PE sample, then every
    injection; ``(4, S, N)`` for a fleet's data."""
    ev, sel = data.events, data.selection
    return torch.stack([torch.cat([_flat_events(e), x], dim=-1) for e, x in
                        ((ev.a, sel.a), (ev.q, sel.q), (ev.c, sel.c), (ev.log_pdraw, sel.log_pdraw))])


def _pop_event_sel_logwts(sites: Dict[str, torch.Tensor], data: PopData, n_grid: int = DEFAULT_N_GRID,
                          rows=None, plain: bool = False, build=None):
    """``(pop, log_wts (C, nobs, nsamp), log_sel_wts (C, nsel))``: the
    population-only model's source-frame weights (``_pop_event_sel_logwts``,
    the JAX package's ``likelihoods.py:274-288``), every row of every chain in
    one :func:`log_dndmdqdv` call.

    ``rows`` is :func:`pop_rows` of ``data`` (computed if not given);
    ``build`` selects the family (``None``: the bump, whose table kernel A
    builds, or its plain twin with ``plain=True``).  A fleet's data (leading
    axis S = C) give chain ``s`` catalog ``s``."""
    m1, q, z, log_pdraw = pop_rows(data) if rows is None else rows
    pop = _family(build)(sites, n_grid, plain)
    c = next(iter(sites.values())).shape[0]
    log_w = (log_dndmdqdv(pop, m1.expand(c, -1), q.expand(c, -1), z.expand(c, -1))
             + data.planck.log_dvdz_dt(z) - log_pdraw)
    return (pop, *_segments(log_w, *data.events.a.shape[-2:]))


def pop_loglike(sites: Dict[str, torch.Tensor], data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None,
                plain: bool = False, build=None) -> torch.Tensor:
    """Population-only log-likelihood for sites of shape ``(C,)``; returns
    ``(C,)`` (``pop_loglike``, the JAX package's ``likelihoods.py:292-305``).
    ``build`` selects the family (``None``: the bump); a fleet's data (leading
    axis S = C) give chain ``s`` catalog ``s``; data that are a shard give the
    whole catalog's log-likelihood on every rank of the shard's group."""
    nobs, nsamp = data.events.a.shape[-2:]
    shard = data.shard
    if shard is not None:
        sites, nsamp = copy_to_group(sites, shard.group), shard.nsamp
    _, log_w, log_sel_w = _pop_event_sel_logwts(sites, data, n_grid, rows, plain, build)
    lse_ev, lse_sel = torch.logsumexp(log_w, -1), torch.logsumexp(log_sel_w, -1)
    if shard is not None:
        lse_ev, lse_sel = _combine_shards(lse_ev, lse_sel, shard.group)
    log_like = lse_ev - math.log(nsamp)
    log_mu_sel = lse_sel - data.selection.log_ndraw
    return log_like.sum(-1) - nobs * log_mu_sel


def pop_deterministics(sites: Dict[str, torch.Tensor], data: PopData, n_grid: int = DEFAULT_N_GRID,
                       rows=None, plain: bool = False, build=None) -> Dict[str, torch.Tensor]:
    """Every deterministic trace site of the population-only model for sites
    of shape ``(C,)`` (``pop_deterministics``, ``likelihoods.py:554-560``, and
    the families' ``*_deterministics``): the shared set and the family's own
    sites (the bump's ``mbhmax`` and ``fpl``)."""
    family = _family(build)
    nobs = data.events.a.shape[0]
    pop, log_w, log_sel_w = _pop_event_sel_logwts(sites, data, n_grid, rows, plain, family)
    log_w, log_sel_w = _whole_rows(log_w, log_sel_w, data)
    out = _shared_deterministics(sites, pop, log_w, log_sel_w, data.selection.log_ndraw, nobs)
    out.update({k: getattr(pop.params.mass, k) for k in family.extras})
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


def _pop_spec(priors, data: PopData, n_grid: int, device, plain: bool = False, build=None) -> ModelSpec:
    dev = resolve_device(device)
    data = data.to(dev)
    rows = pop_rows(data)
    return ModelSpec(priors=dict(priors), loglike=lambda sites: pop_loglike(sites, data, n_grid, rows, plain, build),
                     device=dev)


def _cosmo_spec(priors, data: PopCosmoData, n_grid: int, n_z: int, device, plain: bool = False,
                build=None) -> ModelSpec:
    dev = resolve_device(device)
    data = data.to(dev)
    bounds = dl_bounds_of(data)
    qry = query_table(data)
    return ModelSpec(
        priors=dict(priors),
        loglike=lambda sites: pop_cosmo_loglike(sites, data, n_grid, n_z, bounds, qry, plain, build),
        device=dev,
    )


def pop_model_spec(data: PopData, n_grid: int = DEFAULT_N_GRID, device=None, plain: bool = False) -> ModelSpec:
    """The population-only model as a :class:`ModelSpec` (12 sites) with
    ``data`` on ``device`` (``None`` means CUDA; raises without it).  The
    rows are stacked here, once; ``plain=True`` builds the bump table with
    kernel A's plain twin (the on-card comparison uses it)."""
    return _pop_spec(POP_PRIORS, data, n_grid, device, plain)


def pop_cosmo_model_spec(data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                         device=None, plain: bool = False, n_det=None) -> ModelSpec:
    """The joint model as a :class:`ModelSpec` (15 sites) with ``data`` on
    ``device`` (``None`` means CUDA; raises without it).

    The dL bounds and the query table are fixed here, once.  ``plain=True``
    builds the same potential on the kernels' plain twins (the on-card
    comparison uses it; the main path does not).

    ``n_det`` is accepted for the JAX package's signature and changes
    nothing: the detector table is built at ``n_z`` points, as the JAX package's
    CPU and Pallas route builds it (``likelihoods.py:472``); its TPU bracket
    path alone read ``n_det``.
    """
    return _cosmo_spec(POP_COSMO_PRIORS, data, n_grid, n_z, device, plain)


# ---------------------------------------------------------------------------
# POWER-LAW+PEAK (models/plpeak.py) and BROKEN POWER LAW (models/brokenpl.py):
# the JAX package's names, each the shared function with the family's object.
# ---------------------------------------------------------------------------


def plpeak_loglike(sites, data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None) -> torch.Tensor:
    """Population-only log-likelihood under POWER-LAW+PEAK."""
    return pop_loglike(sites, data, n_grid, rows, build=_PLPEAK)


def plpeak_cosmo_loglike(sites, data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                         dl_bounds=None, qry=None, n_det=None) -> torch.Tensor:
    """Joint log-likelihood under POWER-LAW+PEAK (fused route with ``dl_bounds``);
    ``n_det`` as in :func:`pop_cosmo_loglike`, accepted and unused."""
    return pop_cosmo_loglike(sites, data, n_grid, n_z, dl_bounds, qry, build=_PLPEAK)


def plpeak_deterministics(sites, data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None):
    """Deterministic sites of the PLPeak population-only fit (the shared set)."""
    return pop_deterministics(sites, data, n_grid, rows, build=_PLPEAK)


def plpeak_cosmo_deterministics(sites, data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024):
    """Deterministic sites of the PLPeak joint fit (the shared set + ``hz``), on the non-fused route."""
    return pop_cosmo_deterministics(sites, data, n_grid, n_z, build=_PLPEAK)


def brokenpl_loglike(sites, data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None) -> torch.Tensor:
    """Population-only log-likelihood under BROKEN POWER LAW."""
    return pop_loglike(sites, data, n_grid, rows, build=_BROKENPL)


def brokenpl_cosmo_loglike(sites, data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                           dl_bounds=None, qry=None, n_det=None) -> torch.Tensor:
    """Joint log-likelihood under BROKEN POWER LAW (fused route with ``dl_bounds``);
    ``n_det`` as in :func:`pop_cosmo_loglike`, accepted and unused."""
    return pop_cosmo_loglike(sites, data, n_grid, n_z, dl_bounds, qry, build=_BROKENPL)


def brokenpl_deterministics(sites, data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None):
    """Deterministic sites of the BrokenPL population-only fit (the shared set)."""
    return pop_deterministics(sites, data, n_grid, rows, build=_BROKENPL)


def brokenpl_cosmo_deterministics(sites, data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024):
    """Deterministic sites of the BrokenPL joint fit (the shared set + ``hz``), on the non-fused route."""
    return pop_cosmo_deterministics(sites, data, n_grid, n_z, build=_BROKENPL)


# POWER-LAW+PEAK hyperpriors: the GWTC-3 fiducial analysis ranges.
_PLPEAK_MASS_PRIORS = {
    "alpha": Uniform(-4.0, 12.0),
    "beta_q": Uniform(-4.0, 12.0),
    "mmin": Uniform(2.0, 10.0),
    "mmax": Uniform(30.0, 100.0),
    "lam_peak": Uniform(0.0, 1.0),
    "mu_m": Uniform(20.0, 50.0),
    "sigma_m": Uniform(1.0, 10.0),
    "delta_m": Uniform(0.0, 10.0),
}

PLPEAK_PRIORS = {**_PLPEAK_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}
PLPEAK_COSMO_PRIORS = {**_COSMO_PRIORS, **_PLPEAK_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}

# BROKEN POWER LAW hyperpriors: the LVK appendix-B analysis ranges.
_BROKENPL_MASS_PRIORS = {
    "alpha1": Uniform(-4.0, 12.0),
    "alpha2": Uniform(-4.0, 12.0),
    "bfrac": Uniform(0.0, 1.0),
    "beta_q": Uniform(-4.0, 12.0),
    "mmin": Uniform(2.0, 10.0),
    "mmax": Uniform(50.0, 200.0),
    "delta_m": Uniform(0.0, 10.0),
}

BROKENPL_PRIORS = {**_BROKENPL_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}
BROKENPL_COSMO_PRIORS = {**_COSMO_PRIORS, **_BROKENPL_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}

# POWER LAW + SPLINE hyperpriors: POWER-LAW+PEAK's for the power law and the taper,
# a unit normal for each of the spline's 18 interior heights
_PSPLINE_MASS_PRIORS = {
    **{k: _PLPEAK_MASS_PRIORS[k] for k in ("alpha", "beta_q", "mmin", "mmax", "delta_m")},
    **{k: Normal(0.0, 1.0) for k in SPLINE_SITES},
}

PSPLINE_PRIORS = {**_PSPLINE_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}
PSPLINE_COSMO_PRIORS = {**_COSMO_PRIORS, **_PSPLINE_MASS_PRIORS, **_REDSHIFT_PRIORS, **_RATE_PRIORS}


def plpeak_model_spec(data: PopData, n_grid: int = DEFAULT_N_GRID, device=None) -> ModelSpec:
    """The POWER-LAW+PEAK population-only model (12 sites) on ``device`` (``None`` means CUDA)."""
    return _pop_spec(PLPEAK_PRIORS, data, n_grid, device, build=_PLPEAK)


def plpeak_cosmo_model_spec(data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                            device=None, n_det=None) -> ModelSpec:
    """The joint POWER-LAW+PEAK + flat-wCDM model (15 sites) on ``device`` (``None`` means CUDA).
    ``n_det``: as in :func:`pop_cosmo_model_spec`, accepted and unused."""
    return _cosmo_spec(PLPEAK_COSMO_PRIORS, data, n_grid, n_z, device, build=_PLPEAK)


def brokenpl_model_spec(data: PopData, n_grid: int = DEFAULT_N_GRID, device=None) -> ModelSpec:
    """The BROKEN POWER LAW population-only model (11 sites) on ``device`` (``None`` means CUDA)."""
    return _pop_spec(BROKENPL_PRIORS, data, n_grid, device, build=_BROKENPL)


def brokenpl_cosmo_model_spec(data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                              device=None, n_det=None) -> ModelSpec:
    """The joint BROKEN POWER LAW + flat-wCDM model (14 sites) on ``device`` (``None`` means CUDA).
    ``n_det``: as in :func:`pop_cosmo_model_spec`, accepted and unused."""
    return _cosmo_spec(BROKENPL_COSMO_PRIORS, data, n_grid, n_z, device, build=_BROKENPL)


def pspline_loglike(sites, data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None) -> torch.Tensor:
    """Population-only log-likelihood under POWER LAW + SPLINE."""
    return pop_loglike(sites, data, n_grid, rows, build=_PSPLINE)


def pspline_cosmo_loglike(sites, data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                          dl_bounds=None, qry=None, n_det=None) -> torch.Tensor:
    """Joint log-likelihood under POWER LAW + SPLINE (fused route with ``dl_bounds``);
    ``n_det`` as in :func:`pop_cosmo_loglike`, accepted and unused."""
    return pop_cosmo_loglike(sites, data, n_grid, n_z, dl_bounds, qry, build=_PSPLINE)


def pspline_deterministics(sites, data: PopData, n_grid: int = DEFAULT_N_GRID, rows=None):
    """Deterministic sites of the PS population-only fit (the shared set)."""
    return pop_deterministics(sites, data, n_grid, rows, build=_PSPLINE)


def pspline_cosmo_deterministics(sites, data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024):
    """Deterministic sites of the PS joint fit (the shared set + ``hz``), on the non-fused route."""
    return pop_cosmo_deterministics(sites, data, n_grid, n_z, build=_PSPLINE)


def pspline_model_spec(data: PopData, n_grid: int = DEFAULT_N_GRID, device=None) -> ModelSpec:
    """The POWER LAW + SPLINE population-only model (27 sites) on ``device`` (``None`` means CUDA)."""
    return _pop_spec(PSPLINE_PRIORS, data, n_grid, device, build=_PSPLINE)


def pspline_cosmo_model_spec(data: PopCosmoData, n_grid: int = DEFAULT_N_GRID, n_z: int = 1024,
                             device=None, n_det=None) -> ModelSpec:
    """The joint POWER LAW + SPLINE + flat-wCDM model (30 sites) on ``device`` (``None`` means CUDA).
    ``n_det``: as in :func:`pop_cosmo_model_spec`, accepted and unused."""
    return _cosmo_spec(PSPLINE_COSMO_PRIORS, data, n_grid, n_z, device, build=_PSPLINE)


# ---------------------------------------------------------------------------
# Mass-family registry: the fit stages dispatch here
# ---------------------------------------------------------------------------


class MassFamily(NamedTuple):
    """Everything a fit stage needs for one mass-model family (``MassFamily``,
    the JAX package's ``likelihoods.py:872-891``).  ``build`` is the per-draw
    intensity constructor (``None``: the bump, through kernels A and B); the
    traces are ``.npz`` stores, the bump keeping the unsuffixed names."""

    build: object  # Optional[(sites, n_grid) -> intensity]
    pop_priors: Dict[str, object]
    cosmo_priors: Dict[str, object]
    pop_spec: object  # (data, n_grid, device) -> ModelSpec
    cosmo_spec: object  # (data, n_grid, n_z, device) -> ModelSpec
    pop_det: object  # (sites, data, n_grid) -> deterministic sites
    cosmo_det: object  # (sites, data, n_grid, n_z) -> deterministic sites
    trace_name: str
    cosmo_trace_name: str


MASS_FAMILIES: Dict[str, MassFamily] = {
    "bump": MassFamily(
        build=None,
        pop_priors=POP_PRIORS,
        cosmo_priors=POP_COSMO_PRIORS,
        pop_spec=pop_model_spec,
        cosmo_spec=pop_cosmo_model_spec,
        pop_det=pop_deterministics,
        cosmo_det=pop_cosmo_deterministics,
        trace_name="trace.npz",
        cosmo_trace_name="trace_cosmo.npz",
    ),
    "plpeak": MassFamily(
        build=_PLPEAK,
        pop_priors=PLPEAK_PRIORS,
        cosmo_priors=PLPEAK_COSMO_PRIORS,
        pop_spec=plpeak_model_spec,
        cosmo_spec=plpeak_cosmo_model_spec,
        pop_det=plpeak_deterministics,
        cosmo_det=plpeak_cosmo_deterministics,
        trace_name="trace_plpeak.npz",
        cosmo_trace_name="trace_cosmo_plpeak.npz",
    ),
    "brokenpl": MassFamily(
        build=_BROKENPL,
        pop_priors=BROKENPL_PRIORS,
        cosmo_priors=BROKENPL_COSMO_PRIORS,
        pop_spec=brokenpl_model_spec,
        cosmo_spec=brokenpl_cosmo_model_spec,
        pop_det=brokenpl_deterministics,
        cosmo_det=brokenpl_cosmo_deterministics,
        trace_name="trace_brokenpl.npz",
        cosmo_trace_name="trace_cosmo_brokenpl.npz",
    ),
    "pspline": MassFamily(
        build=_PSPLINE,
        pop_priors=PSPLINE_PRIORS,
        cosmo_priors=PSPLINE_COSMO_PRIORS,
        pop_spec=pspline_model_spec,
        cosmo_spec=pspline_cosmo_model_spec,
        pop_det=pspline_deterministics,
        cosmo_det=pspline_cosmo_deterministics,
        trace_name="trace_pspline.npz",
        cosmo_trace_name="trace_cosmo_pspline.npz",
    ),
}


# ---------------------------------------------------------------------------
# Fleets: S catalogs of one shape on a leading axis, chain s reading catalog s
# ---------------------------------------------------------------------------


def stack_fleet(datas):
    """S catalogs of one shape and type, on one device, as one fleet: every
    tensor leaf (of a tensor or nested named tuples of tensors, such as
    :class:`PopCosmoData`) stacked on a new leading axis.  A :class:`PopData`
    fleet shares the first catalog's Planck18 grid (the same in every catalog)."""
    first = datas[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(list(datas))
    if isinstance(first, (PopData, PopCosmoData)):
        return first._replace(events=stack_fleet([d.events for d in datas]),
                              selection=stack_fleet([d.selection for d in datas]))
    return type(first)(*(stack_fleet(list(xs)) for xs in zip(*datas)))


def take_fleet(data, idx: torch.Tensor):
    """The catalogs ``idx`` of a fleet, in that order (a fleet again): every
    tensor leaf of ``data`` (a tensor or nested named tuples of tensors)
    indexed on its leading axis, but a :class:`PopData`'s shared grid."""
    if isinstance(data, torch.Tensor):
        return data.index_select(0, idx)
    if isinstance(data, (PopData, PopCosmoData)):
        return data._replace(events=take_fleet(data.events, idx), selection=take_fleet(data.selection, idx))
    return type(data)(*(take_fleet(x, idx) for x in data))
