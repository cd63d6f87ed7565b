"""Rehearsal fixtures: GWTC and endo3 input files in the real releases'
layout, drawn from the mock universe; counterpart of the JAX package's
``data/rehearsal.py``.

With no network the real inputs (:mod:`bumpcosmology_torch.data.fetch`)
cannot be downloaded.  The files written here have the real releases'
on-disk layout — the same HDF5 group names, structured dtypes, FAR columns
and Ndraw attributes that :func:`~bumpcosmology_torch.data.gwtc.extract_posterior_samples`
and :func:`~bumpcosmology_torch.data.gwtc.extract_selection_samples` probe —
so the ingestion code runs end to end on them (group detection, prior
reweighting, the m2 and Neff cuts, the FAR cut, the Ndraw bookkeeping):

* O3a (GWTC-2.1) PE files: a ``PublicationSamples/posterior_samples``
  structured dataset beside per-waveform analyses (``C01:IMRPhenomPv2``);
* O3b (GWTC-3) PE files: ``C01:Mixed/posterior_samples`` and no
  ``PublicationSamples`` group;
* the injection file: an ``injections`` group with ``mass1_source``,
  ``mass2_source``, ``redshift``, the two sampling-pdf columns whose product
  (x m1) is the per-draw pdraw, the four search FAR columns, and the
  ``n_accepted``/``n_rejected``/``total_generated`` and analysis-time
  attributes.

Stored posterior samples are distributed as likelihood x LALInference
prior: mock PE draws from the Gaussian measurement law are importance-
resampled by ``li_prior_wt / jacobian_wt``, an exact change of target.
Candidate events whose weights are heavy-tailed, or which would fail
ingestion, are skipped.  The campaign's SNRs run through kernel C on
``device``; every other draw is host numpy from one seeded generator, in the
JAX package's order, so both packages write the same files from one seed up
to the float32 rounding of the SNRs.  h5py is imported by the writers.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from bumpcosmology_torch.data.weights import default_pop_wt, li_prior_wt, planck18_dl_np
from bumpcosmology_torch.models.mass import MBH_MIN

__all__ = ["write_rehearsal_catalog"]

_SECONDS_PER_YEAR = 3600.0 * 24.0 * 365.25

_PE_DTYPE = np.dtype([
    ("mass_1_source", "<f8"),
    ("mass_2_source", "<f8"),
    ("mass_ratio", "<f8"),
    ("chirp_mass_source", "<f8"),
    ("total_mass_source", "<f8"),
    ("redshift", "<f8"),
    ("luminosity_distance", "<f8"),
    ("log_likelihood", "<f8"),
])


def _pe_record_array(m1, q, z, rng) -> np.ndarray:
    """(m1, q, z) posterior draws packed into the GWTC structured dtype."""
    arr = np.zeros(len(m1), dtype=_PE_DTYPE)
    arr["mass_1_source"] = m1
    arr["mass_2_source"] = q * m1
    arr["mass_ratio"] = q
    arr["chirp_mass_source"] = m1 * q**0.6 / (1.0 + q) ** 0.2
    arr["total_mass_source"] = m1 * (1.0 + q)
    arr["redshift"] = z
    # the releases store dL in Mpc; ingestion reads z, not dL
    arr["luminosity_distance"] = planck18_dl_np(z) * 1e3
    arr["log_likelihood"] = rng.normal(50.0, 3.0, size=len(m1))
    return arr


def _write_o3a_file(path: Path, samples: np.ndarray, rng) -> None:
    """GWTC-2.1 layout: PublicationSamples beside per-waveform analyses."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_group("PublicationSamples").create_dataset("posterior_samples", data=samples)
        # a thinned shuffle stands in for each per-waveform rerun
        for ana in ("C01:IMRPhenomPv2", "C01:SEOBNRv4PHM"):
            sub = samples[rng.permutation(len(samples))[: max(len(samples) // 2, 4)]]
            f.create_group(ana).create_dataset("posterior_samples", data=sub)
        f.attrs["catalog"] = "GWTC-2.1 (rehearsal)"


def _write_o3b_file(path: Path, samples: np.ndarray, rng) -> None:
    """GWTC-3 layout: the C01:Mixed analysis, no PublicationSamples."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_group("C01:Mixed").create_dataset("posterior_samples", data=samples)
        sub = samples[rng.permutation(len(samples))[: max(len(samples) // 2, 4)]]
        f.create_group("C01:IMRPhenomXPHM").create_dataset("posterior_samples", data=sub)
        f.attrs["catalog"] = "GWTC-3 (rehearsal)"


def _write_injection_file(path: Path, campaign: dict, rng, detection_snr: float = 10.0) -> None:
    """endo3-layout injection file from a mock campaign's columns.

    pdraw(m1, q, z) = [p(m1, m2) m1] p(z), so the file's
    ``mass1_source_mass2_source_sampling_pdf`` is ``pdraw_mqz / (m1 p(z))``
    and ingestion's product pdf_m1m2 pdf_z m1 gives pdraw back.  The rows
    whose SNR was computed (past the z / chirp-distance precut) are the
    accepted draws, the rest ``n_rejected``.  Each search's FAR is a smooth
    map of the SNR (decades per unit SNR, jittered per pipeline) whose
    FAR < 1/yr contour lies at ``detection_snr``.
    """
    import h5py

    from bumpcosmology_torch.mock.catalog import Z_HORIZON
    from bumpcosmology_torch.mock.sampling import MadauZPDF

    snr = np.asarray(campaign["SNR"])
    acc = snr > 0.0
    n_total = len(snr)
    n_acc = int(np.count_nonzero(acc))
    m1, q, z, pdraw = (np.asarray(campaign[k])[acc] for k in ("m1", "q", "z", "pdraw_mqz"))
    snr = snr[acc]
    pdf_z = MadauZPDF(zmax=Z_HORIZON)(z)
    pdf_m1m2 = pdraw / (m1 * pdf_z)
    fars = {}
    for i, name in enumerate(("far_pycbc_hyperbank", "far_pycbc_bbh", "far_gstlal", "far_mbta")):
        jitter = rng.normal(0.0, 0.3, size=n_acc) + 0.15 * i
        fars[name] = 10.0 ** (1.2 * (detection_snr - snr) + jitter)

    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        g = f.create_group("injections")
        g.create_dataset("mass1_source", data=m1)
        g.create_dataset("mass2_source", data=q * m1)
        g.create_dataset("redshift", data=z)
        g.create_dataset("mass1_source_mass2_source_sampling_pdf", data=pdf_m1m2)
        g.create_dataset("redshift_sampling_pdf", data=pdf_z)
        g.create_dataset("optimal_snr_net", data=snr)
        for name, v in fars.items():
            g.create_dataset(name, data=v)
        f.attrs["n_accepted"] = n_acc
        f.attrs["n_rejected"] = n_total - n_acc
        f.attrs["total_generated"] = n_total
        f.attrs["start_time_s"] = 0.0
        f.attrs["end_time_s"] = _SECONDS_PER_YEAR  # one year of analysis time
        f.attrs["name"] = "rehearsal o3 bbhpop"


def write_rehearsal_catalog(pe_dir, injection_path, n_events: int = 6, nsamp_store: int = 2048,
                            campaign_ndraw: int = 120_000, threshold: float = 20.0, seed: int = 11,
                            snr_chunk: int = 16384, use_real_inventory: bool = False, device=None) -> int:
    """Write a rehearsal input set; returns the number of PE files.

    ``pe_dir`` receives the per-event GWTC-layout ``.h5`` files (alternating
    the GWTC-2.1 and GWTC-3 layouts), ``injection_path`` the endo3-layout
    injection file.  ``n_events`` PE files are written (candidates that fail
    the heavy-tail or ingestion screens are replaced by the next), each with
    ``nsamp_store`` posterior samples, from a ``campaign_ndraw``-draw mock
    campaign whose SNRs run on ``device`` (``None`` means CUDA).  The PE
    events are the campaign's detections at observed SNR above
    ``threshold``; the injection file's FAR map stays at SNR 10.  With
    ``use_real_inventory`` the files take the 56 release filenames of
    :data:`~bumpcosmology_torch.data.fetch.ZENODO_FILES`, with each
    catalog's layout, and ``n_events`` is 56.
    """
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.mock.catalog import add_observation_noise, draw_injection_campaign, draw_mock_pe_samples

    dev = resolve_device(device)
    pe_dir = Path(pe_dir)
    injection_path = Path(injection_path)
    pe_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)

    inventory = None
    if use_real_inventory:
        from bumpcosmology_torch.data.fetch import ZENODO_FILES

        inventory = [name for _, name in ZENODO_FILES]
        n_events = len(inventory)

    campaign = draw_injection_campaign(ndraw=campaign_ndraw, seed=seed + 1000, snr_chunk=snr_chunk, device=dev)
    _write_injection_file(injection_path, campaign, rng)

    obs = add_observation_noise(campaign, seed=seed + 2000, threshold=threshold)
    n_obs = len(obs["m1"])
    if n_obs == 0:
        raise ValueError(f"no detections at threshold {threshold} in a {campaign_ndraw}-draw campaign")

    # candidates in proportion to the population weight, as a real catalog's event mix
    wt = default_pop_wt(obs["m1"], obs["q"], obs["z"], device=dev) / obs["pdraw_mqz"]
    order = rng.choice(n_obs, size=n_obs, p=wt / wt.sum(), replace=False)

    pe_cols = ("log_mc_obs", "sigma_log_mc", "q_obs", "sigma_q", "log_dl_obs", "sigma_log_dl")
    written = 0
    for cand in order:
        if written >= n_events:
            break
        row = [obs[k][cand] for k in pe_cols]
        size = 16 * nsamp_store
        stored = None
        while size <= 256 * nsamp_store:
            m1s, qs, zs, w_mock = draw_mock_pe_samples(*row, size=size, output_source_frame=True, rng=rng)
            # exact retarget: draws ~ L w_mock, resampled by li_prior / w_mock to ~ L li_prior
            r = li_prior_wt(m1s, qs, zs) / w_mock
            neff = np.sum(r) ** 2 / np.sum(r * r)
            if neff >= 4 * nsamp_store:
                pick = rng.choice(size, size=nsamp_store, p=r / r.sum())
                stored = (m1s[pick], qs[pick], zs[pick])
                break
            size *= 4
        if stored is None:
            continue  # heavy-tailed retarget weights: skipped, as ingestion would reject it

        m1s, qs, zs = stored
        # the file must pass the real m2 and Neff cuts with a margin (2 nsamp = 256 at nsamp 128)
        if np.median(qs * m1s) < MBH_MIN + 0.25:
            continue
        w_ing = default_pop_wt(m1s, qs, zs, device=dev) / li_prior_wt(m1s, qs, zs)
        w_ing = w_ing / w_ing.sum()
        if 1.0 / np.sum(w_ing * w_ing) < 320.0:
            continue

        samples = _pe_record_array(m1s, qs, zs, rng)
        if inventory is not None:
            # the release filename; its catalog picks the layout
            name = inventory[written]
            (_write_o3a_file if "GWTC2p1" in name else _write_o3b_file)(pe_dir / name, samples, rng)
        elif written % 2 == 0:
            evt = f"GW{190400 + written:06d}_{int(rng.integers(0, 235959)):06d}"
            _write_o3a_file(pe_dir / f"IGWN-GWTC2p1-v2-{evt}_PEDataRelease_mixed_nocosmo.h5", samples, rng)
        else:
            evt = f"GW{190400 + written:06d}_{int(rng.integers(0, 235959)):06d}"
            _write_o3b_file(pe_dir / f"IGWN-GWTC3p0-v1-{evt}_PEDataRelease_mixed_nocosmo.h5", samples, rng)
        written += 1

    if written < min(n_events, 3):
        raise ValueError(f"only {written} viable rehearsal events from {n_obs} detections; "
                         "increase campaign_ndraw or lower threshold")
    return written
