"""Pipeline stages (L4); counterpart of the JAX package's
``pipeline/stages.py``: ingestion of the GWTC releases and the O3 injection
file, the two fits, population-only and joint population + cosmology, for
every mass family of ``likelihoods.MASS_FAMILIES``, and the mock-universe
stages that turn the injection campaign into fit inputs:

    _stage_fetch -> _stage_draw_pe_samples, _stage_draw_selection_samples
                 -> run_pop_fit / run_pop_cosmo_fit
    _stage_mock_injections -> _stage_mock_observations -> _stage_mock_year_samples
                           -> _stage_mock_fit_inputs -> run_pop_fit / run_pop_cosmo_fit

The ingestion stages read and write HDF5 (the releases' format) and need
h5py; they write the fit inputs ``pe-samples.npz`` and
``selection-samples.npz``, which the other stages read on a host without it.

Tables are ``{column: numpy array}`` (:mod:`bumpcosmology_torch.utils.io`)
and traces ``.npz`` stores (:mod:`bumpcosmology_torch.utils.trace`): the
artifacts are the JAX package's names with ``.npz`` (``mock_injections.npz``,
``mock_observations.npz``, ``mock_year_samples.npz``, ``pe-samples.npz``,
``selection-samples.npz``, the family's trace) under the data directory.
The calibration stages, :func:`_stage_sbc` and :func:`_stage_score_check`,
draw their own campaigns and write ``sbc_ranks.npz`` and ``score_check.npz``.
The model-comparison stages read the fit inputs and the saved traces:
:func:`_stage_loo` (the leave-one-out fleet → ``influence.npz``),
:func:`_stage_compare` (PSIS-LOO, WAIC and bridge-sampling evidence →
``model_compare.npz``), :func:`_stage_ppc` (→ ``ppc.npz``) and
:func:`_stage_prior_sens` (→ ``prior_sensitivity.npz``).  Their artifacts
key the arrays by the JAX package's HDF5 paths, with attributes under
``attrs/<name>`` and ``<group>/attrs/<name>``.
:func:`_stage_figures` draws every figure whose artifact exists into
``<data_dir>/figures`` and :func:`_stage_report` compiles them with the
traces' summaries into ``<data_dir>/report`` (both need matplotlib and
seaborn, and raise an ``ImportError`` naming what is missing).
Every stage runs on ``device`` (``None`` means CUDA; it raises without it).
:func:`build_pipeline` assembles the stages into a :class:`~bumpcosmology_torch.pipeline.dag.Pipeline`.
"""
from __future__ import annotations

import re
import time
from glob import glob
from pathlib import Path

import numpy as np

from bumpcosmology_torch.pipeline.config import PipelineConfig
from bumpcosmology_torch.pipeline.dag import Pipeline, Stage
from bumpcosmology_torch.utils.io import read_table, write_table

__all__ = ["build_pipeline", "group_events", "pop_data_from_tables", "pop_cosmo_data_from_tables", "run_pop_fit",
           "run_pop_cosmo_fit", "mass_family", "write_sbc_artifact", "write_influence_artifact"]


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


# ------------------------------------------------------------------ ingestion


def _require_h5py(stage: str) -> None:
    """Raises the ``ImportError`` that tells where ingestion runs when h5py is absent."""
    try:
        import h5py  # noqa: F401
    except ImportError as err:
        raise ImportError(
            f"the {stage} stage reads and writes the releases' HDF5 files and needs h5py, which this host "
            "lacks.  Ingestion (fetch, draw_pe_samples, draw_selection_samples) runs on a host that has h5py; "
            "copy the input_manifest.json, pe-samples.npz and selection-samples.npz it writes into this "
            "host's data directory, and the stages here find ingestion up to date and read them.") from err


def _stage_fetch(cfg: PipelineConfig, device=None):
    """Download the 56 GWTC PE releases and the O3 injection file from Zenodo
    (``showyourwork.yml:27-94``), checking and resuming as needed.

    When no usable input is left: with ``ingest.rehearsal_fallback`` (CLI
    ``--rehearsal``), write rehearsal fixtures (their mock campaign's SNRs on
    ``device``), else stop with what to do.  Under the rehearsal no download
    is attempted (the JAX package tries one first): a rehearsal is for a
    host without network."""
    _require_h5py("fetch")
    from bumpcosmology_torch.data.fetch import fetch_inputs
    from bumpcosmology_torch.device import resolve_device

    dev = resolve_device(device)
    offline = cfg.ingest.rehearsal_fallback
    counts = fetch_inputs(cfg.paths.pe_raw_dir, cfg.paths.injection_file,
                          manifest_out=str(cfg.paths.path("input_manifest.json")), offline=offline)
    print("[fetch] {present} present, {downloaded} downloaded, {failed} failed".format(**counts)
          + (" (offline: no download attempted)" if offline else ""))
    have_pe = bool(glob(str(Path(cfg.paths.pe_raw_dir) / "*.h5")))
    have_inj = Path(cfg.paths.injection_file).exists()
    if have_pe and have_inj:
        return
    if not cfg.ingest.rehearsal_fallback:
        raise RuntimeError(
            f"fetch left no usable inputs (PE files: {have_pe}, injection file: {have_inj}).  Either (a) place "
            f"the GWTC-2.1/GWTC-3 releases under {cfg.paths.pe_raw_dir} and the endo3 injection file at "
            f"{cfg.paths.injection_file} by other means, or (b) rerun with --rehearsal (config: "
            "ingest.rehearsal_fallback=true) to write format-faithful rehearsal fixtures and complete the "
            "pipeline offline.")
    print(f"[fetch] no usable inputs and rehearsal fallback enabled — writing {cfg.ingest.rehearsal_events} "
          "rehearsal events + injection file (format-faithful mock inputs; see data/rehearsal.py)")
    from bumpcosmology_torch.data.rehearsal import write_rehearsal_catalog

    n = write_rehearsal_catalog(cfg.paths.pe_raw_dir, cfg.paths.injection_file,
                                n_events=cfg.ingest.rehearsal_events,
                                campaign_ndraw=cfg.ingest.rehearsal_campaign_ndraw,
                                seed=cfg.ingest.rehearsal_seed, device=dev)
    print(f"[fetch] rehearsal fallback wrote {n} PE files + injection file")


def _stage_draw_pe_samples(cfg: PipelineConfig, device=None):
    """``cfg.ingest.nsamp_pe`` samples of every accepted event, reweighted to
    the fiducial population (its intensity on ``device``) → ``pe-samples.npz``
    (columns ``m1 q z wt evt``); rejected events are skipped with a line."""
    _require_h5py("draw_pe_samples")
    from bumpcosmology_torch.data import RejectedEventError, default_pop_wt, extract_posterior_samples
    from bumpcosmology_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.ingest.pe_seed)
    files = sorted(glob(str(Path(cfg.paths.pe_raw_dir) / "*.h5")))
    if not files:
        raise FileNotFoundError(
            f"no GWTC posterior files in {cfg.paths.pe_raw_dir} — run the 'fetch' stage (or place the "
            "GWTC-2.1/GWTC-3 releases there by hand; offline, rerun with --rehearsal for format-faithful "
            "fixtures)")
    cols = {k: [] for k in ("m1", "q", "z", "wt", "evt")}
    for f in files:
        m = re.match(r"^.*(GW[0-9_]+[0-9]+).*\.h5$", f)
        name = m[1] if m else Path(f).stem
        try:
            drawn = extract_posterior_samples(f, cfg.ingest.nsamp_pe, rng=rng,
                                              desired_pop_wt=lambda m1, q, z: default_pop_wt(m1, q, z, device=dev))
        except (RejectedEventError, ValueError) as err:
            print(f"[draw_pe_samples] skipping {name}: {err}")
            continue
        for k, v in zip(("m1", "q", "z", "wt"), drawn):
            cols[k].append(v)
        cols["evt"].append(np.full(len(drawn[0]), name))
    if not cols["evt"]:
        raise ValueError(f"no event of the {len(files)} files in {cfg.paths.pe_raw_dir} passed ingestion")
    write_table(cfg.paths.path("pe-samples.npz"), {k: np.concatenate(v) for k, v in cols.items()})


def _stage_draw_selection_samples(cfg: PipelineConfig, device=None):
    """``cfg.ingest.nsamp_sel`` detected injections, reweighted to the
    fiducial population (on ``device``) → ``selection-samples.npz`` (columns
    ``m1 q z pdraw ndraw``)."""
    _require_h5py("draw_selection_samples")
    from bumpcosmology_torch.data import default_pop_wt, extract_selection_samples
    from bumpcosmology_torch.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(cfg.ingest.sel_seed)
    m1, q, z, pdraw, ndraw = extract_selection_samples(
        cfg.paths.injection_file, cfg.ingest.nsamp_sel,
        desired_pop_wt=lambda m1, q, z: default_pop_wt(m1, q, z, device=dev),
        far_threshold=cfg.ingest.far_threshold, rng=rng)
    write_table(cfg.paths.path("selection-samples.npz"),
                {"m1": m1, "q": q, "z": z, "pdraw": pdraw, "ndraw": np.full(len(m1), ndraw)})


# ----------------------------------------------------------------------- fits


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


# ---------------------------------------------------------------- calibration

_JOINT_FAMILY = {"pop_cosmo": "bump", "plpeak_cosmo": "plpeak", "brokenpl_cosmo": "brokenpl"}


def _stage_sbc(cfg: PipelineConfig, device=None, probe: int = 0, checkpoint_path=None,
               warmup_only: bool = False) -> dict:
    """Simulation-based calibration suite → ``sbc_ranks.npz`` (ranks and
    p-values; ``_stage_sbc``, the JAX package's ``stages.py:360-517``).

    ``cfg.sbc.model`` is ``"pop"`` (the shared-bank population-only
    simulator) or a joint model, ``"pop_cosmo"``, ``"plpeak_cosmo"`` or
    ``"brokenpl_cosmo"`` (the fresh-noise simulator; ``fresh_noise=False``
    takes the shared-bank joint simulator, the bump only).  The campaign's
    SNRs run through kernel C, the fleet fit through kernels A (and B on the
    bump's joint model) on ``device`` (``None`` means CUDA; it raises
    without it).  The joint models also check the rate reconstruction's
    coverage over prior draws of μ(θ) on this campaign.

    Returns a report: the host-clock seconds of the campaign, then of
    :func:`~bumpcosmology_torch.inference.calibration.run_sbc_fleet`'s parts
    (its ``stats``), of the rate check and of the artifact; the p-values,
    the failing sites, the rate check's p (``None`` where it did not run)
    and the artifact's path.  ``probe`` T > 0 stops after the campaign, the
    catalogs and T fleet transitions (``run_sbc_fleet``'s ``probe``) and
    returns the report so far, writing nothing; ``checkpoint_path`` and
    ``warmup_only`` split the fleet fit at the end of its warmup
    (``run_sbc_fleet``'s), and a warmup-only run also returns there.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference import calibration as cal
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.nuts import NutsConfig
    from bumpcosmology_torch.mock import add_observation_noise, draw_injection_campaign

    dev = resolve_device(device)
    c = cfg.sbc
    n_grid, n_z = cfg.fit.n_grid, cfg.fit.n_z
    t0 = time.perf_counter()
    inj = draw_injection_campaign(ndraw=c.campaign_ndraw, seed=c.seed, snr_chunk=cfg.mock.snr_chunk, device=dev)
    obs = add_observation_noise(inj, seed=c.seed + 1, threshold=c.threshold)
    n_total = float(len(inj["m1"]))
    n_obs = len(obs["m1"])
    if c.pool_max and n_obs > c.pool_max:
        # uniform thinning of the detected pool; Ndraw scales by the kept
        # fraction so the selection estimator stays unbiased
        frac = c.pool_max / n_obs
        keep = np.random.default_rng(c.seed + 5).choice(n_obs, size=c.pool_max, replace=False)
        obs = {k: np.asarray(v)[keep] for k, v in obs.items()}
        n_total = n_total * frac
        print(f"[sbc] detected pool thinned to {len(obs['m1'])} (Ndraw_eff {n_total:.0f})")
    family = _JOINT_FAMILY.get(c.model)
    if family is not None:
        # the joint model needs a larger selection set or its SBC ranks are
        # corrupted by selection-MC pseudo-modes
        if c.fresh_noise:
            if c.pool_max:
                print("[sbc] note: pool_max only applies to the shared-bank simulators")
            simulate = cal.make_mock_pop_cosmo_simulator_fresh(
                inj, nobs=c.nobs, nsamp=c.nsamp, nsel=max(c.nsel, 2048), pe_bank_size=c.pe_bank_size,
                threshold=c.threshold, family=family, device=dev,
            )
        else:
            if family != "bump":
                raise ValueError(f"{c.model} SBC requires fresh_noise=True")
            simulate = cal.make_mock_pop_cosmo_simulator(
                obs, n_total_injections=n_total, nobs=c.nobs, nsamp=c.nsamp, nsel=max(c.nsel, 2048),
                pe_bank_size=c.pe_bank_size, seed=c.seed + 2, device=dev,
            )
        proto = cal.COSMO_SBC_SPEC_BUILDERS[family](n_grid=n_grid, n_z=n_z, device=dev)(None)
        build = mass_family(family).build

        def make_loglike(datas):
            bounds = lk.dl_bounds_of(datas, margin=0.1)  # fleet-wide: every catalog's dL
            return lambda sites, d: lk.pop_cosmo_loglike(sites, d, n_grid, n_z, bounds, build=build)

    elif c.model == "pop":
        simulate = cal.make_mock_pop_simulator(
            obs, n_total_injections=n_total, nobs=c.nobs, nsamp=c.nsamp, nsel=c.nsel, seed=c.seed + 2,
            device=dev,
        )
        proto = cal.make_pop_sbc_spec_builder(n_grid=n_grid, device=dev)(None)

        def make_loglike(datas):
            return lambda sites, d: lk.pop_loglike(sites, d, n_grid)

    else:
        raise ValueError(
            f"unknown sbc model {c.model!r}; use 'pop', 'pop_cosmo', "
            "'plpeak_cosmo' or 'brokenpl_cosmo'"
        )

    report = {"campaign_s": time.perf_counter() - t0}
    ranks = cal.run_sbc_fleet(
        proto, make_loglike, simulate, n_sims=c.n_sims, generator=c.seed + 3, num_warmup=c.num_warmup,
        num_samples=c.num_samples, thin=c.thin, cfg=NutsConfig(max_depth=c.max_depth), chunk_size=c.fleet_chunk,
        device=dev, stats=report, probe=probe, checkpoint_path=checkpoint_path, warmup_only=warmup_only,
    )
    if probe or warmup_only:
        return report
    pvals = cal.sbc_uniformity_pvalues(ranks)
    t0 = time.perf_counter()

    # rate-reconstruction calibration: R is not a fitted site, so the fleet
    # gives it no rank; check the post-hoc reconstruction's frequentist
    # coverage with this suite's family and campaign driving the mu(theta)
    # mixing (rate_reconstruction_ranks)
    rate_ranks, rate_p = None, None
    if family is not None:
        try:
            from scipy.stats import kstest

            mu = cal.selection_mu_samples(inj, family, max(512, 4 * c.n_sims), generator=c.seed + 9,
                                          threshold=c.threshold, device=dev)
            rate_ranks = cal.rate_reconstruction_ranks(mu, r_true=2.3, rng=np.random.default_rng(c.seed + 10))
            rate_p = float(kstest(rate_ranks, "uniform").pvalue)
            print(f"[sbc] rate-reconstruction rank uniformity: p={rate_p:.3f} ({len(rate_ranks)} trials)")
        except Exception as err:  # the fleet certificate must not die on this
            print(f"[sbc] WARNING: rate-reconstruction check failed: {err!r}")
    report["rate_check_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    path = cfg.paths.path("sbc_ranks.npz")
    bad = write_sbc_artifact(path, c.model, c.n_sims, ranks, pvals, rate_ranks=rate_ranks, rate_p=rate_p)
    report.update(write_s=time.perf_counter() - t0, pvalues=pvals, bad=bad, rate_p=rate_p, artifact=path)
    print("[sbc] uniformity p-values:", {k: round(v, 3) for k, v in pvals.items()})
    if bad:
        print(f"[sbc] WARNING: sites failing uniformity at p<0.01: {bad}")
    else:
        print(f"[sbc] all {len(pvals)} sites pass uniformity at p>=0.01")
    return report


def write_sbc_artifact(out, model: str, n_sims: int, ranks: dict, pvals: dict, rate_ranks=None,
                       rate_p=None) -> list:
    """Persist SBC ranks and per-site verdicts as ``.npz``; returns the failing
    sites (``write_sbc_artifact``, the JAX package's ``stages.py:519-560``).

    The keys are the HDF5 layout's paths: ``ranks/<site>``, ``ranks/n_bins``,
    ``pvalues/site``, ``pvalues/p``, ``pvalues/passed`` (in matching order)
    and ``rate_check/ranks``; its attributes are 0-d arrays under
    ``attrs/<name>`` (root: ``model``, ``n_sims``, ``all_pass``) and
    ``<group>/attrs/<name>`` (``pvalues/attrs/<site>``; ``rate_check/attrs/``
    ``p``, ``passed``, ``method``).
    """
    bad = sorted(k for k, v in pvals.items() if v < 0.01)
    arrays = {"attrs/model": np.asarray(model), "attrs/n_sims": np.asarray(n_sims),
              "attrs/all_pass": np.asarray(not bad)}
    for k, v in ranks.items():
        arrays["ranks/" + (k.strip("_") if k == "__n_bins__" else k)] = np.asarray(v)
    sites = sorted(pvals)
    arrays["pvalues/site"] = np.array(sites, dtype=str)
    arrays["pvalues/p"] = np.array([pvals[s] for s in sites], dtype=np.float64)
    arrays["pvalues/passed"] = np.array([pvals[s] >= 0.01 for s in sites])
    for k, v in pvals.items():
        arrays["pvalues/attrs/" + k] = np.asarray(v)
    if rate_ranks is not None:
        arrays["rate_check/ranks"] = np.asarray(rate_ranks)
        arrays["rate_check/attrs/p"] = np.asarray(float(rate_p))
        arrays["rate_check/attrs/passed"] = np.asarray(bool(rate_p >= 0.01))
        arrays["rate_check/attrs/method"] = np.asarray(
            "frequentist rank coverage of the Gaussian R reconstruction "
            "(R = nobs/mu + sqrt(nobs)/mu * R_unit) with nobs ~ "
            "Poisson(2.3 * mu(theta)), mu from prior draws on this "
            "suite's campaign; see inference/calibration.py"
        )
    np.savez(out, **arrays)
    return bad


def _score_check_sites0(model: str) -> dict:
    """Default ("true") parameter sites for the score-identity check."""
    from bumpcosmology_torch.models.parameters import DEFAULT_POPULATION, PLANCK18

    sites = {"h": PLANCK18.h, "Om": PLANCK18.Om, "w": PLANCK18.w, "R_unit": 0.0}
    if model == "plpeak_cosmo":
        from bumpcosmology_torch.models.plpeak import DEFAULT_PLPEAK_POPULATION

        mp = DEFAULT_PLPEAK_POPULATION.mass
        sites.update(
            alpha=mp.alpha, beta_q=mp.beta_q, mmin=mp.mmin, mmax=mp.mmax,
            lam_peak=mp.lam_peak, mu_m=mp.mu_m, sigma_m=mp.sigma_m,
            delta_m=mp.delta_m,
        )
    elif model == "brokenpl_cosmo":
        from bumpcosmology_torch.models.brokenpl import DEFAULT_BROKENPL_POPULATION

        mp = DEFAULT_BROKENPL_POPULATION.mass
        # the campaign draws primaries on m1 >= 5, so the truth uses mmin=5
        # (the SBC spec builders' support slice)
        sites.update(
            alpha1=mp.alpha1, alpha2=mp.alpha2, bfrac=mp.bfrac, beta_q=mp.beta_q,
            mmin=max(float(mp.mmin), 5.0), mmax=mp.mmax, delta_m=mp.delta_m,
        )
    else:
        mp = DEFAULT_POPULATION.mass
        sites.update(
            a=mp.a, b=mp.b, c=mp.c, mpisn=mp.mpisn, dmbhmax=mp.mbhmax - mp.mpisn,
            sigma=mp.sigma, log_fpl=float(np.log(mp.fpl)), beta=mp.beta,
        )
    rp = DEFAULT_POPULATION.redshift
    sites.update(lam=rp.lam, dkappa=rp.kappa - rp.lam, zp=rp.zp)
    return sites


def _stage_score_check(cfg: PipelineConfig, device=None):
    """Score-identity diagnostic → ``score_check.npz`` (``_stage_score_check``,
    the JAX package's ``stages.py:598-669``): E_{data|θ₀}[∇ log L̂(θ₀)] per
    hyperparameter and likelihood term over fresh simulated catalogs.  Pass =
    every TOTAL |z| under ``score.z_bar``.  Keys: ``site``, ``mean``, ``se``,
    ``z`` and ``attrs/<name>`` (``model``, ``n_catalogs``, ``z_bar``,
    ``all_pass``).  Runs on ``device`` (``None`` means CUDA; it raises
    without it)."""
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.calibration import make_mock_pop_cosmo_simulator_fresh
    from bumpcosmology_torch.inference.score_check import joint_term_grads, score_identity_check
    from bumpcosmology_torch.mock import draw_injection_campaign

    dev = resolve_device(device)
    c = cfg.score
    if c.model not in _JOINT_FAMILY:
        raise ValueError(
            f"unknown score_check model {c.model!r}; use 'pop_cosmo', "
            "'plpeak_cosmo' or 'brokenpl_cosmo'"
        )
    family = _JOINT_FAMILY[c.model]
    inj = draw_injection_campaign(ndraw=c.campaign_ndraw, seed=c.seed, snr_chunk=cfg.mock.snr_chunk, device=dev)
    simulate = make_mock_pop_cosmo_simulator_fresh(
        inj, nobs=c.nobs, nsamp=c.nsamp, nsel=c.nsel, pe_bank_size=c.pe_bank_size, threshold=c.threshold,
        family=family, device=dev,
    )
    sites0 = _score_check_sites0(c.model)
    grad_sites = tuple(k for k in sites0 if k != "R_unit")
    term_grads = joint_term_grads(sites0, grad_sites, nobs=c.nobs, n_grid=c.n_grid, n_z=c.n_z,
                                  build=mass_family(family).build, device=dev)

    def progress(i, n):
        if i % 50 == 0 or i == n:
            print(f"[score_check] {i}/{n} catalogs", flush=True)

    res = score_identity_check(simulate, sites0, term_grads, grad_sites, n_catalogs=c.n_catalogs,
                               seed=c.seed + 1, progress=progress)
    print(res.table())
    ok = res.max_abs_z() < c.z_bar
    np.savez(cfg.paths.path("score_check.npz"), **{
        "attrs/model": np.asarray(c.model), "attrs/n_catalogs": np.asarray(res.n_catalogs),
        "attrs/z_bar": np.asarray(c.z_bar), "attrs/all_pass": np.asarray(ok),
        "site": np.array(res.sites, dtype=str), "mean": res.mean, "se": res.se, "z": res.z})
    verdict = "PASS" if ok else "FAIL"
    print(f"[score_check] max TOTAL |z| = {res.max_abs_z():.2f} (bar {c.z_bar}) -> {verdict}")
    if not ok:
        print(
            "[score_check] WARNING: nonzero expected score — the simulator and "
            "the fitted likelihood disagree; see the per-term table above"
        )


# ----------------------------------------------------------- model comparison


def _fit_inputs(cfg: PipelineConfig):
    """The fit inputs ``pe-samples.npz`` and ``selection-samples.npz``, and the sorted event labels."""
    pe = read_table(cfg.paths.path("pe-samples.npz"))
    sel = read_table(cfg.paths.path("selection-samples.npz"))
    return pe, sel, group_events(pe, cols=())[0]


def _stage_loo(cfg: PipelineConfig, device=None):
    """Leave-one-out event-influence diagnostics → ``influence.npz``
    (``_stage_loo``, the JAX package's ``stages.py:671-754``).

    Refits the catalog nobs times, each with one event removed, as one
    lockstep fleet (:mod:`~bumpcosmology_torch.inference.influence`; on the
    joint model kernel B reads a query table per catalog), and scores each
    event's influence on every scalar site against the full-catalog trace
    in posterior-sd units.  Runs on ``device`` (``None`` means CUDA; it
    raises without it).
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.influence import influence_summary, loo_fit
    from bumpcosmology_torch.inference.nuts import NutsConfig
    from bumpcosmology_torch.utils.trace import load_trace

    dev = resolve_device(device)
    c = cfg.loo
    n_grid, n_z = cfg.fit.n_grid, cfg.fit.n_z
    pe, sel, names = _fit_inputs(cfg)
    if c.model == "pop_cosmo":
        data = pop_cosmo_data_from_tables(pe, sel, dev)
        spec = lk.pop_cosmo_model_spec(data, n_grid=n_grid, n_z=n_z, device=dev)
        bounds = lk.dl_bounds_of(data, margin=0.1)
        loglike = lambda s, d: lk.pop_cosmo_loglike(s, d, n_grid, n_z, bounds)  # noqa: E731
        trace_path = cfg.paths.path("trace_cosmo.npz")
    else:
        data = pop_data_from_tables(pe, sel, dev)
        spec = lk.pop_model_spec(data, n_grid=n_grid, device=dev)
        loglike = lambda s, d: lk.pop_loglike(s, d, n_grid)  # noqa: E731
        trace_path = cfg.paths.path("trace.npz")

    loo = loo_fit(spec, loglike, data, c.seed, num_warmup=c.num_warmup, num_samples=c.num_samples,
                  cfg=NutsConfig(max_depth=c.max_depth), chunk_size=c.fleet_chunk, device=dev)
    full = load_trace(trace_path).posterior
    infl = influence_summary(loo, full)
    out = cfg.paths.path("influence.npz")
    write_influence_artifact(out, c.model, names, infl)
    worst = max(
        ((site, i, float(v["z"][i])) for site, v in infl.items() for i in range(len(v["z"]))),
        key=lambda t: abs(t[2]),
        default=None,
    )
    if worst is not None:
        print(
            f"[loo] most influential: event {names[worst[1]]} on site {worst[0]} "
            f"(z = {worst[2]:+.2f} posterior sds); artifact {out}"
        )


def _stage_compare(cfg: PipelineConfig, device=None):
    """Predictive model comparison → ``model_compare.npz`` (``_stage_compare``,
    the JAX package's ``stages.py:757-911``): PSIS-LOO and WAIC over the
    per-event likelihood decomposition of the pop and pop_cosmo traces on
    the same catalog, and of every other family's traces that exist, then
    bridge-sampling marginal likelihoods → log10 Bayes factors.  The
    pointwise matrices and the evidence's potentials run ``compare.batch``
    draws at a time on ``device`` (``None`` means CUDA; it raises without
    it); the joint bump's through kernel A and kernel B's ``lse`` epilogue,
    forward only.  Returns the ranking table.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.evidence import bayes_factor_table, log_evidence_bridge
    from bumpcosmology_torch.inference.model_compare import (
        compare,
        pointwise_matrix,
        pop_cosmo_pointwise_loglike,
        pop_pointwise_loglike,
        psis_loo,
        waic,
    )
    from bumpcosmology_torch.utils.trace import load_trace

    dev = resolve_device(device)
    c = cfg.compare
    n_grid, n_z = cfg.fit.n_grid, cfg.fit.n_z
    pe, sel, names = _fit_inputs(cfg)
    pop_data = pop_data_from_tables(pe, sel, dev)
    rows = lk.pop_rows(pop_data)
    cosmo_data = pop_cosmo_data_from_tables(pe, sel, dev)
    bounds = lk.dl_bounds_of(cosmo_data, margin=0.1)
    qry = lk.query_table(cosmo_data)

    def matrix(fn, post, priors):
        return pointwise_matrix(fn, post, list(priors), max_draws=c.max_draws, batch=c.batch, device=dev)

    # pop (source frame, fixed Planck18) and pop_cosmo (detector frame)
    posts = {"pop": load_trace(cfg.paths.path("trace.npz")).posterior,
             "pop_cosmo": load_trace(cfg.paths.path("trace_cosmo.npz")).posterior}
    specs = {"pop": lk.pop_model_spec(pop_data, n_grid=n_grid, device=dev),
             "pop_cosmo": lk.pop_cosmo_model_spec(cosmo_data, n_grid=n_grid, n_z=n_z, device=dev)}
    matrices = {
        "pop": matrix(lambda s: pop_pointwise_loglike(s, pop_data, n_grid, rows=rows), posts["pop"],
                      specs["pop"].priors),
        "pop_cosmo": matrix(lambda s: pop_cosmo_pointwise_loglike(s, cosmo_data, n_grid, n_z, bounds, qry=qry),
                            posts["pop_cosmo"], specs["pop_cosmo"].priors),
    }

    # the other families' traces on the same catalog, when present, so the
    # bump is ranked against the phenomenological fiducials head to head
    for famname, fam in lk.MASS_FAMILIES.items():
        if famname == "bump":
            continue
        candidates = (
            (f"pop_{famname}", fam.trace_name,
             lambda s, b=fam.build: pop_pointwise_loglike(s, pop_data, n_grid, build=b, rows=rows),
             fam.pop_priors, lambda fam=fam: fam.pop_spec(pop_data, n_grid=n_grid, device=dev)),
            (f"pop_cosmo_{famname}", fam.cosmo_trace_name,
             lambda s, b=fam.build: pop_cosmo_pointwise_loglike(s, cosmo_data, n_grid, n_z, bounds, build=b,
                                                                qry=qry),
             fam.cosmo_priors, lambda fam=fam: fam.cosmo_spec(cosmo_data, n_grid=n_grid, n_z=n_z, device=dev)),
        )
        for name, fname, fn, priors, make_spec in candidates:
            path = cfg.paths.path(fname)
            if path.exists():
                posts[name] = load_trace(path).posterior
                matrices[name] = matrix(fn, posts[name], priors)
                specs[name] = make_spec()

    loos = {k: psis_loo(v) for k, v in matrices.items()}
    waics = {k: waic(v) for k, v in matrices.items()}
    table = compare(loos)
    print("[compare]\n" + table)
    for name, r in loos.items():
        bad = [(names[i], float(r.khat[i])) for i in np.nonzero(r.khat > 0.7)[0]]
        if bad:
            print(f"[compare] {name}: Pareto k̂ > 0.7 (PSIS unreliable) for {bad}")

    # the event marginals are frame-invariant (pdraw carries the Jacobian), so
    # log Z is comparable across the source-frame and detector-frame models
    evidences = {}
    for name, spec in specs.items():
        try:
            evidences[name] = log_evidence_bridge(spec, posts[name], max_draws=c.max_draws, batch=c.batch)
        except (FloatingPointError, ValueError, np.linalg.LinAlgError) as exc:
            # as the JAX stage: a failed evidence is reported, after LOO/WAIC
            # have run, and the stage goes on (the proposal's Cholesky is
            # numpy's here too, hence numpy's LinAlgError)
            print(f"[compare] evidence for {name} failed: {exc}")
    bf_table = bayes_factor_table(evidences) if evidences else ""
    if bf_table:
        print("[compare] marginal likelihoods (bridge sampling)\n" + bf_table)

    arrays = {"attrs/table": np.asarray(table), "attrs/bf_table": np.asarray(bf_table),
              "attrs/best_model": np.asarray(max(loos, key=lambda k: loos[k].elpd)),
              "event": np.array([str(n) for n in names], dtype=str)}
    for name in matrices:
        r, w = loos[name], waics[name]
        arrays.update({f"{name}/elpd_i": r.elpd_i, f"{name}/khat": r.khat, f"{name}/pointwise": matrices[name]})
        attrs = dict(elpd=r.elpd, se=r.se, p_loo=r.p_loo, waic_elpd=w.elpd, waic_se=w.se, p_waic=w.p_waic,
                     n_draws=matrices[name].shape[0])
        if name in evidences:
            e = evidences[name]
            attrs.update(log_z=e.log_z, log_z_se=e.se)
            arrays[f"{name}/log_z_blocks"] = e.log_z_blocks
        arrays.update({f"{name}/attrs/{k}": np.asarray(v) for k, v in attrs.items()})
    np.savez(cfg.paths.path("model_compare.npz"), **arrays)
    return table


def _stage_ppc(cfg: PipelineConfig, device=None):
    """Posterior predictive checks of every saved trace → ``ppc.npz``
    (``_stage_ppc``, the JAX package's ``stages.py:914-1013``): a
    per-observable posterior-predictive p-value (KS against the weighted
    predicted CDF, calibrated by replication; :mod:`~bumpcosmology_torch.inference.ppc`)
    for pop, pop_cosmo and their other-family variants.  The weights run
    ``ppc.batch`` draws at a time on ``device`` (``None`` means CUDA; it
    raises without it): the joint bump's through kernel B's ``rows``
    epilogue on the data's own dL range.  Returns the artifact's path.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES
    from bumpcosmology_torch.inference.ppc import posterior_predictive_check
    from bumpcosmology_torch.utils.trace import load_trace

    dev = resolve_device(device)
    c = cfg.ppc
    pe, sel, _ = _fit_inputs(cfg)
    pop_data = pop_data_from_tables(pe, sel, dev)
    cosmo_data = pop_cosmo_data_from_tables(pe, sel, dev)

    candidates = []
    for famname, fam in MASS_FAMILIES.items():
        suffix = "" if famname == "bump" else f"_{famname}"
        candidates.append((f"pop{suffix}", fam.trace_name, pop_data, fam.build, fam.pop_priors))
        candidates.append((f"pop_cosmo{suffix}", fam.cosmo_trace_name, cosmo_data, fam.build, fam.cosmo_priors))
    arrays = {"attrs/n_draws": np.asarray(c.n_draws)}
    n_done = 0
    for name, fname, data, build, priors in candidates:
        path = cfg.paths.path(fname)
        if not path.exists():
            continue
        post = load_trace(path).posterior
        res = posterior_predictive_check(
            post, list(priors), data, build=build, n_grid=cfg.fit.n_grid, n_z=cfg.fit.n_z,
            n_draws=c.n_draws, seed=c.seed, batch=c.batch, model="pop_cosmo" if "cosmo" in name else "pop",
            device=dev,
        )
        arrays[f"{name}/attrs/n_draws"] = np.asarray(res.n_draws)
        msg = []
        for col in res.p_values:
            g = f"{name}/{col}/"
            arrays.update({g + "attrs/p_value": np.asarray(res.p_values[col]),
                           g + "attrs/label": np.asarray(res.labels[col]), g + "grid": res.grid[col],
                           g + "pred_cdf_q": res.pred_cdf_q[col], g + "obs_cdf_q": res.obs_cdf_q[col],
                           g + "ks_obs": res.ks_obs[col], g + "ks_rep": res.ks_rep[col]})
            msg.append(f"{res.labels[col]}: p = {res.p_values[col]:.3f}")
            if res.p_values[col] < 0.01:
                print(
                    f"[ppc] WARNING {name}/{res.labels[col]}: p = "
                    f"{res.p_values[col]:.4f} — the fit does not reproduce "
                    "the observed distribution of this observable"
                )
        print(f"[ppc] {name}: " + "; ".join(msg))
        n_done += 1
    if n_done == 0:
        raise FileNotFoundError("ppc: no trace found (run `pipeline sample` / `sample_cosmo` first)")
    out = cfg.paths.path("ppc.npz")
    np.savez(out, **arrays)
    return out


def _stage_prior_sens(cfg: PipelineConfig, device=None):
    """Prior-sensitivity battery on the saved traces → ``prior_sensitivity.npz``
    (``_stage_prior_sens``, the JAX package's ``stages.py:1016-1095``):
    each site's prior rescaled (x0.5, x2) and the trace importance-reweighted
    (:mod:`~bumpcosmology_torch.inference.prior_sens`); the artifact records
    the posterior-mean shift (in posterior sds) and sd ratio of every site
    under every perturbation, and the reweighting's ESS fraction.  Host
    numpy; ``device`` is resolved so that the stage, like the others, needs
    the card unless the caller names the CPU.  Returns the artifact's path.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.prior_sens import prior_sensitivity_suite
    from bumpcosmology_torch.utils.trace import load_trace

    resolve_device(device)
    # the bump and PLPeak traces only, not BrokenPL's, as the JAX stage visits them
    candidates = (
        ("pop", lk.MASS_FAMILIES["bump"].trace_name, lk.POP_PRIORS),
        ("pop_cosmo", lk.MASS_FAMILIES["bump"].cosmo_trace_name, lk.POP_COSMO_PRIORS),
        ("pop_plpeak", lk.MASS_FAMILIES["plpeak"].trace_name, lk.PLPEAK_PRIORS),
        ("pop_cosmo_plpeak", lk.MASS_FAMILIES["plpeak"].cosmo_trace_name, lk.PLPEAK_COSMO_PRIORS),
    )
    arrays = {}
    n_done = 0
    for name, fname, priors in candidates:
        path = cfg.paths.path(fname)
        if not path.exists():
            continue
        post = load_trace(path).posterior
        results = prior_sensitivity_suite(post, priors)
        if not results:
            continue
        site_names = [s for s in priors if s in post]
        arrays.update({
            f"{name}/perturbation": np.array([r.name for r in results], dtype=str),
            f"{name}/site": np.array(site_names, dtype=str),
            f"{name}/shift_sd": np.array([[r.shift_sd[s] for s in site_names] for r in results]),
            f"{name}/sd_ratio": np.array([[r.sd_ratio[s] for s in site_names] for r in results]),
            f"{name}/ess_frac": np.array([r.ess_frac for r in results]),
        })
        worst = max(
            ((r.name, s, r.shift_sd[s]) for r in results for s in site_names if r.ess_frac > 0.05),
            key=lambda t: abs(t[2]), default=None,
        )
        if worst is not None:
            print(
                f"[prior-sens] {name}: largest reliable shift {worst[2]:+.2f} "
                f"posterior sds on '{worst[1]}' under {worst[0]}"
            )
        for r in results:
            if r.ess_frac < 0.05:
                print(
                    f"[prior-sens] {name}: {r.name} reweighting ESS fraction "
                    f"{r.ess_frac:.3f} < 0.05 — shift unreliable, refit to confirm"
                )
        n_done += 1
    if n_done == 0:
        raise FileNotFoundError("prior_sens: no trace found (run `pipeline sample` / `sample_cosmo` first)")
    out = cfg.paths.path("prior_sensitivity.npz")
    np.savez(out, **arrays)
    return out


def write_influence_artifact(out, model: str, names, infl: dict) -> None:
    """Persist the per-event influence summary (sites × events) as ``.npz``
    (``write_influence_artifact``, the JAX package's ``stages.py:1098-1108``):
    ``attrs/model``, ``event`` and ``<site>/mean_loo``, ``<site>/delta_mean``,
    ``<site>/z``."""
    arrays = {"attrs/model": np.asarray(model), "event": np.array([str(n) for n in names], dtype=str)}
    for site, v in infl.items():
        for k in ("mean_loo", "delta_mean", "z"):
            arrays[f"{site}/{k}"] = np.asarray(v[k])
    np.savez(out, **arrays)


# -------------------------------------------------------- figures and report


def _require_plotting(stage: str) -> None:
    """Raises the ``ImportError`` that names the plotting libraries this host lacks."""
    import importlib

    from bumpcosmology_torch.figures.plots import PLOTTING_LIBRARIES

    missing = []
    for name in PLOTTING_LIBRARIES:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    if missing:
        raise ImportError(
            f"the {stage} stage draws with matplotlib, seaborn and pandas; this host lacks {', '.join(missing)}.  "
            "Copy the data directory's artifacts (traces and stage outputs) to a host that has them and run "
            "`python -m bumpcosmology_torch.pipeline figures report --device cpu` there.")


def _stage_figures(cfg: PipelineConfig, device=None):
    """Draw every figure whose artifact exists into ``<data_dir>/figures``
    (``_stage_figures``, the JAX package's ``stages.py:1112-1118``); the bump
    curves are built on ``device`` (``None`` means CUDA)."""
    from bumpcosmology_torch.figures.plots import render_all

    _require_plotting("figures")
    made = render_all(cfg, out_dir=Path(cfg.paths.data_dir) / "figures", device=device)
    print(f"[figures] wrote {len(made)} figure(s)")


def _stage_report(cfg: PipelineConfig, device=None):
    """Compile ``ms.tex``, ``ms.md`` and ``report.pdf`` into ``<data_dir>/report``
    (``_stage_report``, the JAX package's ``stages.py:1121-1130``)."""
    from bumpcosmology_torch.figures.report import generate_report

    _require_plotting("report")
    out = generate_report(cfg, out_dir=Path(cfg.paths.data_dir) / "report", device=device)
    print(f"[report] wrote {', '.join(str(v) for v in out.values())}")


# ------------------------------------------------------------------- assembly


def build_pipeline(cfg: PipelineConfig, device=None) -> Pipeline:
    """Every stage of the port with its inputs and ``.npz`` outputs under
    ``cfg.paths.data_dir``, each run on ``device`` (``None`` means CUDA; a
    stage raises without it when it runs).  ``figures`` and ``report`` have
    no outputs, so they run whenever they are asked for."""
    p = cfg.paths.path
    loo_trace, loo_after = (("trace_cosmo.npz", "sample_cosmo") if cfg.loo.model == "pop_cosmo"
                            else ("trace.npz", "sample"))
    fit_inputs = [p("pe-samples.npz"), p("selection-samples.npz")]
    return Pipeline([
        Stage("fetch", lambda: _stage_fetch(cfg, device), outputs=[p("input_manifest.json")]),
        Stage("draw_pe_samples", lambda: _stage_draw_pe_samples(cfg, device), outputs=[p("pe-samples.npz")],
              after=["fetch"]),
        Stage("draw_selection_samples", lambda: _stage_draw_selection_samples(cfg, device),
              inputs=[Path(cfg.paths.injection_file)], outputs=[p("selection-samples.npz")], after=["fetch"]),
        Stage("sample", lambda: run_pop_fit(cfg, device=device), inputs=fit_inputs, outputs=[p("trace.npz")],
              after=["draw_pe_samples", "draw_selection_samples"]),
        Stage("sample_cosmo", lambda: run_pop_cosmo_fit(cfg, device=device), inputs=fit_inputs,
              outputs=[p("trace_cosmo.npz")], after=["draw_pe_samples", "draw_selection_samples"]),
        Stage("mock_injections", lambda: _stage_mock_injections(cfg, device), outputs=[p("mock_injections.npz")]),
        Stage("mock_observations", lambda: _stage_mock_observations(cfg, device),
              inputs=[p("mock_injections.npz")], outputs=[p("mock_observations.npz")], after=["mock_injections"]),
        Stage("mock_fit_inputs", lambda: _stage_mock_fit_inputs(cfg, device),
              inputs=[p("mock_injections.npz"), p("mock_year_samples.npz")], outputs=fit_inputs,
              after=["mock_year_samples"]),
        Stage("sbc", lambda: _stage_sbc(cfg, device), outputs=[p("sbc_ranks.npz")]),
        Stage("score_check", lambda: _stage_score_check(cfg, device), outputs=[p("score_check.npz")]),
        Stage("loo", lambda: _stage_loo(cfg, device), inputs=fit_inputs + [p(loo_trace)],
              outputs=[p("influence.npz")], after=[loo_after]),
        Stage("compare", lambda: _stage_compare(cfg, device),
              inputs=fit_inputs + [p("trace.npz"), p("trace_cosmo.npz")], outputs=[p("model_compare.npz")],
              after=["sample", "sample_cosmo"]),
        Stage("ppc", lambda: _stage_ppc(cfg, device), inputs=fit_inputs + [p("trace.npz")], outputs=[p("ppc.npz")],
              after=["sample"]),
        Stage("prior_sens", lambda: _stage_prior_sens(cfg, device), inputs=[p("trace.npz")],
              outputs=[p("prior_sensitivity.npz")], after=["sample"]),
        Stage("mock_year_samples", lambda: _stage_mock_year_samples(cfg, device),
              inputs=[p("mock_injections.npz"), p("mock_observations.npz")], outputs=[p("mock_year_samples.npz")],
              after=["mock_observations"]),
        Stage("figures", lambda: _stage_figures(cfg, device), inputs=[p("trace.npz"), p("trace_cosmo.npz")],
              outputs=[]),
        Stage("report", lambda: _stage_report(cfg, device), inputs=[p("trace.npz"), p("trace_cosmo.npz")],
              outputs=[], after=["figures"]),
    ])
