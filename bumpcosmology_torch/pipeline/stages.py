"""Pipeline stages (L4); counterpart of the JAX package's
``pipeline/stages.py``: the two fits, population-only and joint population +
cosmology, for every mass family of ``likelihoods.MASS_FAMILIES``, and the
mock-universe stages that turn the injection campaign into fit inputs:

    _stage_mock_injections -> _stage_mock_observations -> _stage_mock_year_samples
                           -> _stage_mock_fit_inputs -> run_pop_fit / run_pop_cosmo_fit

Tables are ``{column: numpy array}`` (:mod:`bumpcosmology_torch.utils.io`)
and traces ``.npz`` stores (:mod:`bumpcosmology_torch.utils.trace`): the
artifacts are the JAX package's names with ``.npz`` (``mock_injections.npz``,
``mock_observations.npz``, ``mock_year_samples.npz``, ``pe-samples.npz``,
``selection-samples.npz``, the family's trace) under the data directory.
Every stage runs on ``device`` (``None`` means CUDA; it raises without it).
The DAG, the data, calibration and comparison stages are not ported yet.
"""
from __future__ import annotations

import numpy as np

from bumpcosmology_torch.pipeline.config import PipelineConfig
from bumpcosmology_torch.utils.io import read_table, write_table

__all__ = ["group_events", "pop_data_from_tables", "pop_cosmo_data_from_tables", "run_pop_fit",
           "run_pop_cosmo_fit", "mass_family"]


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


def mass_family(name: str):
    """The registry row of ``name``; an unknown family raises the JAX package's ``ValueError``."""
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES

    try:
        return MASS_FAMILIES[name]
    except KeyError:
        raise ValueError(f"unknown mass_family {name!r} (expected one of {sorted(MASS_FAMILIES)})") from None


def _nuts_config(cfg: PipelineConfig):
    from bumpcosmology_torch.inference.nuts import NutsConfig

    return NutsConfig(max_depth=cfg.fit.max_depth, target_accept=cfg.fit.target_accept,
                      shared_mass=cfg.fit.shared_mass)


def run_pop_fit(cfg: PipelineConfig, pe_table=None, sel_table=None, trace_out=None, device=None):
    """Population-only fit (``run_fit.py``) of ``cfg.fit.mass_family`` → the
    family's trace.

    ``pe_table`` (``m1 q z wt evt``) and ``sel_table`` (``m1 q z pdraw
    ndraw``) are source-frame column dicts, read from the data directory when
    not given.  The fit runs on ``device`` (``None`` means CUDA; it raises
    without it) with ``cfg.fit.sampler`` and seed ``cfg.fit.seed``.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.likelihoods import pop_rows
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.models.population import COORDS
    from bumpcosmology_torch.utils.trace import Trace, save_trace

    family = cfg.fit.mass_family
    fam = mass_family(family)
    dev = resolve_device(device)
    pe = pe_table if pe_table is not None else read_table(cfg.paths.path("pe-samples.npz"))
    sel = sel_table if sel_table is not None else read_table(cfg.paths.path("selection-samples.npz"))

    data = pop_data_from_tables(pe, sel, dev)
    n_grid = cfg.fit.n_grid
    spec = fam.pop_spec(data, n_grid=n_grid, device=dev)
    rows = pop_rows(data)
    det_fn = lambda s: fam.pop_det(s, data, n_grid, rows)  # noqa: E731
    res = fit(spec, cfg.fit.seed, num_warmup=cfg.fit.num_warmup, num_samples=cfg.fit.num_samples,
              num_chains=cfg.fit.num_chains, cfg=_nuts_config(cfg), sampler=cfg.fit.sampler,
              deterministics_fn=det_fn, device=dev)
    trace = Trace(res.posterior, res.sample_stats, coords=COORDS, attrs={"model": "pop", "family": family})
    save_trace(trace_out or cfg.paths.path(fam.trace_name), trace)
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
    """Joint population + cosmology fit (``run_cosmo_fit.py``) of
    ``cfg.fit.mass_family`` → the family's trace.

    ``pe_table`` (``m1 q z wt evt``) and ``sel_table`` (``m1 q z pdraw
    ndraw``) are source-frame column dicts, read from the data directory when
    not given; they are converted to the detector frame on the host.  The fit
    runs on ``device`` (``None`` means CUDA; it raises without it) with
    ``cfg.fit.sampler`` and seed ``cfg.fit.cosmo_seed``.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.sampler import fit
    from bumpcosmology_torch.models.population import COORDS
    from bumpcosmology_torch.utils.trace import Trace, save_trace

    family = cfg.fit.mass_family
    fam = mass_family(family)
    dev = resolve_device(device)
    pe = pe_table if pe_table is not None else read_table(cfg.paths.path("pe-samples.npz"))
    sel = sel_table if sel_table is not None else read_table(cfg.paths.path("selection-samples.npz"))

    data = pop_cosmo_data_from_tables(pe, sel, dev)
    n_grid, n_z = cfg.fit.n_grid, cfg.fit.n_z
    spec = fam.cosmo_spec(data, n_grid=n_grid, n_z=n_z, device=dev)
    det_fn = lambda s: fam.cosmo_det(s, data, n_grid, n_z)  # noqa: E731
    res = fit(spec, cfg.fit.cosmo_seed, num_warmup=cfg.fit.num_warmup, num_samples=cfg.fit.num_samples,
              num_chains=cfg.fit.num_chains, cfg=_nuts_config(cfg), sampler=cfg.fit.sampler,
              deterministics_fn=det_fn, device=dev)
    trace = Trace(res.posterior, res.sample_stats, coords=COORDS,
                  attrs={"model": "pop_cosmo", "family": family})
    save_trace(trace_out or cfg.paths.path(fam.cosmo_trace_name), trace)
    return res


# ----------------------------------------------------------------------- mock


def _load_psds(psd_files):
    """{det: path} of tabulated (f, S_n) curves -> {det: psd callable}
    (``.npz`` with arrays ``f`` and ``psd``, or two columns of text, comma-
    separated in a ``.csv``), read with numpy alone."""
    if not psd_files:
        return None
    from bumpcosmology_torch.mock.psd import tabulated_psd

    psds = {}
    for det, path in psd_files.items():
        if str(path).endswith(".npz"):
            with np.load(path) as d:
                f, v = np.asarray(d["f"]), np.asarray(d["psd"])
        else:
            arr = np.loadtxt(path, delimiter="," if str(path).endswith(".csv") else None)
            f, v = arr[:, 0], arr[:, 1]
        psds[det] = tabulated_psd(f, v)
    return psds


def _stage_mock_injections(cfg: PipelineConfig, device=None):
    """The injection campaign (SNRs through kernel C) → ``mock_injections.npz``."""
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.mock import campaign_summary, draw_injection_campaign

    dev = resolve_device(device)
    inj = draw_injection_campaign(
        ndraw=cfg.mock.ndraw,
        seed=cfg.mock.injection_seed,
        z_horizon=cfg.mock.z_horizon,
        chirp_dist_min=cfg.mock.chirp_dist_min,
        snr_chunk=cfg.mock.snr_chunk,
        psds=_load_psds(cfg.mock.psd_files),
        device=dev,
    )
    write_table(cfg.paths.path("mock_injections.npz"), inj, key="true_parameters")
    stats = campaign_summary(inj, threshold=cfg.mock.detection_snr, device=dev)
    print(
        "[mock_injections] {n_detected} detected (SNR>{thr}); "
        "{predicted_detections_per_year:.0f} det/yr predicted; "
        "Neff(default pop) = {neff_default_pop:.1f}; "
        "expected pop-model draws = {expected_pop_draws:.1f}".format(thr=cfg.mock.detection_snr, **stats)
    )


def _stage_mock_observations(cfg: PipelineConfig, device=None):
    """Observation noise on the campaign → ``mock_observations.npz`` (host numpy;
    ``device`` is resolved so that the stage, like the others, needs the card)."""
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.mock import add_observation_noise

    resolve_device(device)
    inj = read_table(cfg.paths.path("mock_injections.npz"), key="true_parameters")
    obs = add_observation_noise(inj, seed=cfg.mock.observation_seed, threshold=cfg.mock.detection_snr)
    write_table(cfg.paths.path("mock_observations.npz"), obs, key="observations")


def _stage_mock_year_samples(cfg: PipelineConfig, device=None):
    """The one-year catalog with mock PE samples → ``mock_year_samples.npz``
    (kernel A builds the fiducial bump table once)."""
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.mock import draw_one_year_catalog

    dev = resolve_device(device)
    inj = read_table(cfg.paths.path("mock_injections.npz"), key="true_parameters")
    obs = read_table(cfg.paths.path("mock_observations.npz"), key="observations")
    cat = draw_one_year_catalog(len(inj["m1"]), obs, nsamp=cfg.mock.nsamp, seed=cfg.mock.catalog_seed,
                                device=dev)
    write_table(cfg.paths.path("mock_year_samples.npz"), cat)


def _stage_mock_fit_inputs(cfg: PipelineConfig, device=None):
    """The mock universe's artifacts as fit inputs: the catalog becomes
    ``pe-samples.npz``; ``selection-samples.npz`` is ``cfg.ingest.nsamp_sel``
    rows drawn without replacement from the injections detected under an
    independent noise realization (seed ``observation_seed + 1``), with
    ``ndraw`` scaled by the share drawn (``_stage_mock_fit_inputs``, the JAX
    package's ``stages.py:305-357``)."""
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.mock import add_observation_noise

    resolve_device(device)
    rng = np.random.default_rng(cfg.ingest.sel_seed)
    inj = read_table(cfg.paths.path("mock_injections.npz"), key="true_parameters")
    cat = read_table(cfg.paths.path("mock_year_samples.npz"))
    write_table(cfg.paths.path("pe-samples.npz"), cat)

    det = add_observation_noise(inj, seed=cfg.mock.observation_seed + 1, threshold=cfg.mock.detection_snr)
    n_det = len(det["m1"])
    nsel = min(cfg.ingest.nsamp_sel, n_det)
    pick = rng.choice(n_det, size=nsel, replace=False)
    ndraw = float(len(inj["m1"])) * (nsel / n_det)
    sel = {"m1": det["m1"][pick], "q": det["q"][pick], "z": det["z"][pick], "pdraw": det["pdraw_mqz"][pick],
           "ndraw": np.full(nsel, ndraw)}
    write_table(cfg.paths.path("selection-samples.npz"), sel)
    print(f"[mock_fit_inputs] {len(np.unique(cat['evt']))} events, {nsel} selection samples")
