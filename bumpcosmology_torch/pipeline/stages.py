"""Pipeline stages (L4); counterpart of the JAX package's
``pipeline/stages.py``: the two fits, population-only and joint population +
cosmology, PISN-bump family.

Tables are ``{column: numpy array}`` (:mod:`bumpcosmology_torch.utils.io`)
and traces ``.npz`` stores (:mod:`bumpcosmology_torch.utils.trace`), so the
artifacts are ``pe-samples.npz``, ``selection-samples.npz``, ``trace.npz``
and ``trace_cosmo.npz`` under the data directory.
"""
from __future__ import annotations

import numpy as np

from bumpcosmology_torch.pipeline.config import PipelineConfig
from bumpcosmology_torch.utils.io import read_table

__all__ = ["group_events", "pop_data_from_tables", "pop_cosmo_data_from_tables", "run_pop_fit",
           "run_pop_cosmo_fit"]

TRACE_NAME = "trace.npz"
COSMO_TRACE_NAME = "trace_cosmo.npz"


def group_events(table, cols=("m1", "q", "z", "wt")):
    """Stack per-event sample columns to (nobs, nsamp) arrays (cf.
    ``run_fit.py:22-33``); returns (sorted event labels, arrays).  Requires
    equal samples per event."""
    evt = np.asarray(table["evt"])
    events = sorted(np.unique(evt))
    return events, [np.stack([np.asarray(table[c])[evt == e] for e in events]) for c in cols]


def pop_data_from_tables(pe_table, sel_table, device=None):
    """The population-only model's source-frame :class:`PopData` on ``device``
    (``None`` means CUDA) from the tables (cf. ``run_fit.py:22-39``)."""
    from bumpcosmology_torch.inference.likelihoods import make_pop_data

    _, (m1s, qs, zs, wts) = group_events(pe_table)
    return make_pop_data(m1s, qs, zs, wts, *(np.asarray(sel_table[c]) for c in ("m1", "q", "z", "pdraw")),
                         ndraw=float(np.asarray(sel_table["ndraw"])[0]), device=device)


def _check_family(family: str) -> None:
    if family != "bump":
        raise NotImplementedError(f"mass_family {family!r} is not ported yet (ROADMAP.md, Queue 1 item 6)")


def _nuts_config(cfg: PipelineConfig):
    from bumpcosmology_torch.inference.nuts import NutsConfig

    return NutsConfig(max_depth=cfg.fit.max_depth, target_accept=cfg.fit.target_accept,
                      shared_mass=cfg.fit.shared_mass)


def run_pop_fit(cfg: PipelineConfig, pe_table=None, sel_table=None, trace_out=None, device=None):
    """Population-only fit (``run_fit.py``) → trace.

    ``pe_table`` (``m1 q z wt evt``) and ``sel_table`` (``m1 q z pdraw
    ndraw``) are source-frame column dicts, read from the data directory when
    not given.  The fit runs on ``device`` (``None`` means CUDA; it raises
    without it) with ``cfg.fit.sampler`` and seed ``cfg.fit.seed``.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.likelihoods import pop_deterministics, pop_model_spec, pop_rows
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.models.population import COORDS
    from bumpcosmology_torch.utils.trace import Trace, save_trace

    family = cfg.fit.mass_family
    _check_family(family)
    dev = resolve_device(device)
    pe = pe_table if pe_table is not None else read_table(cfg.paths.path("pe-samples.npz"))
    sel = sel_table if sel_table is not None else read_table(cfg.paths.path("selection-samples.npz"))

    data = pop_data_from_tables(pe, sel, dev)
    n_grid = cfg.fit.n_grid
    spec = pop_model_spec(data, n_grid=n_grid, device=dev)
    rows = pop_rows(data)
    det_fn = lambda s: pop_deterministics(s, data, n_grid, rows)  # noqa: E731
    res = fit(spec, cfg.fit.seed, num_warmup=cfg.fit.num_warmup, num_samples=cfg.fit.num_samples,
              num_chains=cfg.fit.num_chains, cfg=_nuts_config(cfg), sampler=cfg.fit.sampler,
              deterministics_fn=det_fn, device=dev)
    trace = Trace(res.posterior, res.sample_stats, coords=COORDS, attrs={"model": "pop", "family": family})
    save_trace(trace_out or cfg.paths.path(TRACE_NAME), trace)
    return res


def _detector_frame(table, wt_col: str):
    """(m1_det, q, dL, pdraw in the detector frame) at fixed Planck18:
    m1_det = m1 (1+z), dL = dL(z), pdraw · |d(m1, q, z)/d(m1_det, q, dL)|."""
    from bumpcosmology_torch.data.weights import dm1sqz_dm1ddqdl, planck18_dl_np

    m1, q, z = (np.asarray(table[c], dtype=np.float64) for c in ("m1", "q", "z"))
    return m1 * (1.0 + z), q, planck18_dl_np(z), np.asarray(table[wt_col]) * dm1sqz_dm1ddqdl(m1, q, z)


def pop_cosmo_data_from_tables(pe_table, sel_table, device=None):
    """The joint model's :class:`PopCosmoData` on ``device`` (``None`` means
    CUDA) from source-frame tables, converted to the detector frame on the
    host (``run_cosmo_fit.py:22-30``)."""
    from bumpcosmology_torch.inference.likelihoods import make_pop_cosmo_data

    ev = dict(zip(("m1d", "q", "dl", "pdraw_cosmo"), _detector_frame(pe_table, "wt")), evt=pe_table["evt"])
    _, (m1d, qs, dls, pdraws) = group_events(ev, cols=("m1d", "q", "dl", "pdraw_cosmo"))
    return make_pop_cosmo_data(m1d, qs, dls, pdraws, *_detector_frame(sel_table, "pdraw"),
                               ndraw=float(np.asarray(sel_table["ndraw"])[0]), device=device)


def run_pop_cosmo_fit(cfg: PipelineConfig, pe_table=None, sel_table=None, trace_out=None, device=None):
    """Joint population + cosmology fit (``run_cosmo_fit.py``) → trace.

    ``pe_table`` (``m1 q z wt evt``) and ``sel_table`` (``m1 q z pdraw
    ndraw``) are source-frame column dicts, read from the data directory when
    not given; they are converted to the detector frame on the host.  The fit
    runs on ``device`` (``None`` means CUDA; it raises without it) with
    ``cfg.fit.sampler`` and seed ``cfg.fit.cosmo_seed``.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.likelihoods import (
        dl_bounds_of,
        pop_cosmo_deterministics,
        pop_cosmo_model_spec,
        query_table,
    )
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.models.population import COORDS
    from bumpcosmology_torch.utils.trace import Trace, save_trace

    family = cfg.fit.mass_family
    _check_family(family)
    dev = resolve_device(device)
    pe = pe_table if pe_table is not None else read_table(cfg.paths.path("pe-samples.npz"))
    sel = sel_table if sel_table is not None else read_table(cfg.paths.path("selection-samples.npz"))

    data = pop_cosmo_data_from_tables(pe, sel, dev)
    n_grid, n_z = cfg.fit.n_grid, cfg.fit.n_z
    spec = pop_cosmo_model_spec(data, n_grid=n_grid, n_z=n_z, device=dev)
    bounds, qry = dl_bounds_of(data), query_table(data)
    det_fn = lambda s: pop_cosmo_deterministics(s, data, n_grid, n_z, bounds, qry)  # noqa: E731
    res = fit(spec, cfg.fit.cosmo_seed, num_warmup=cfg.fit.num_warmup, num_samples=cfg.fit.num_samples,
              num_chains=cfg.fit.num_chains, cfg=_nuts_config(cfg), sampler=cfg.fit.sampler,
              deterministics_fn=det_fn, device=dev)
    trace = Trace(res.posterior, res.sample_stats, coords=COORDS,
                  attrs={"model": "pop_cosmo", "family": family})
    save_trace(trace_out or cfg.paths.path(COSMO_TRACE_NAME), trace)
    return res
