"""Mock-universe pipeline: injection campaign -> observations -> PE catalog;
counterpart of the JAX package's ``mock/catalog.py``.

Host draws are numpy float64 with the JAX package's seeds and call order, so
the port draws the same injections, noise and events; the SNRs run on
``device`` (``None`` means CUDA) through kernel C.

**Tables** are plain ``dict[str, np.ndarray]`` with the JAX package's column
names, in its order (no pandas: the GPU host has none).  Row filters are
boolean masks.  Every function that reads a table takes anything indexable
by column name, so a JAX-package DataFrame works too
(:func:`bumpcosmology_torch.convert.columns` turns one into a dict).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from bumpcosmology_torch.data.weights import (
    DH,
    default_pop_wt,
    planck18_dc_np,
    planck18_dl_np,
    planck18_efunc_np,
    planck18_z_of_dl_np,
)
from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.mock.sampling import MadauZPDF, PowerLawPDF
from bumpcosmology_torch.mock.snr import network_snr_batched
from bumpcosmology_torch.models.parameters import DEFAULT_RATE

__all__ = [
    "Z_HORIZON",
    "CHIRP_DIST_MIN",
    "DETECTION_SNR",
    "draw_injection_campaign",
    "campaign_summary",
    "add_observation_noise",
    "Uncertainties",
    "draw_mock_pe_samples",
    "draw_one_year_catalog",
]

Z_HORIZON = 3.5
CHIRP_DIST_MIN = 1.5
DETECTION_SNR = 10.0
CATALOG_COLUMNS = ("m1", "q", "z", "wt", "evt")


def _col(table, name) -> np.ndarray:
    return np.asarray(table[name])


def draw_injection_campaign(
    ndraw: int = 10_000_000,
    seed: int = 333_165_393,
    z_horizon: float = Z_HORIZON,
    chirp_dist_min: float = CHIRP_DIST_MIN,
    snr_chunk: int = 65536,
    psds=None,
    device=None,
) -> dict:
    """Draw the synthetic injection campaign and compute network SNRs.

    Source distribution: p(m1) ~ m1^-2.35 on [5, 500]; p(mtot|m1) ~ mtot^-2
    on [m1+5, 2 m1]; p(z) Madau(2.7, 5.6, 1.9) x comoving measure to
    ``z_horizon``; isotropic angles; Gaussian spin components of sigma
    0.2/sqrt(3) (carried for catalog parity; the amplitude is non-spinning).

    The z / chirp-distance precut zeroes SNRs outside the detectable region
    without sending those rows to the device.  ``snr_chunk`` bounds the plain
    twin's intermediate on the CPU; the kernel takes all rows in one launch.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    zpdf = MadauZPDF(zmax=z_horizon)
    z = zpdf.icdf(rng.uniform(size=ndraw))

    mpdf = PowerLawPDF(2.35, 5.0, 500.0)
    m1 = mpdf.icdf(rng.uniform(size=ndraw))

    mtpdf = PowerLawPDF(2.0, m1 + 5.0, 2.0 * m1)
    mt = mtpdf.icdf(rng.uniform(size=ndraw))
    m2 = mt - m1
    q = m2 / m1

    # pdraw over (m1, q, z): p(m1) p(mt|m1) |dmt/dq| p(z), |dmt/dq| = m1
    pdraw = mpdf(m1) * (mtpdf(mt) * m1) * zpdf(z)

    iota = np.arccos(rng.uniform(-1.0, 1.0, size=ndraw))
    ra = rng.uniform(0.0, 2.0 * np.pi, size=ndraw)
    dec = np.arcsin(rng.uniform(-1.0, 1.0, size=ndraw))
    psi = rng.uniform(0.0, np.pi, size=ndraw)
    gmst = rng.uniform(0.0, 2.0 * np.pi, size=ndraw)
    s1 = rng.normal(0.0, 0.2 / math.sqrt(3.0), size=(3, ndraw))
    s2 = rng.normal(0.0, 0.2 / math.sqrt(3.0), size=(3, ndraw))

    dl = planck18_dl_np(z)
    mc_det = m1 * (1.0 + z) * q ** 0.6 / (1.0 + q) ** 0.2
    chirp_dist = mc_det ** (5.0 / 6.0) / dl
    compute = (z < z_horizon) & (chirp_dist > chirp_dist_min)

    snr_cols = {k: np.zeros(ndraw) for k in ("SNR_H1", "SNR_L1", "SNR_V1", "SNR")}
    idx = np.flatnonzero(compute)
    if idx.size:
        snrs = network_snr_batched(
            m1[idx] * (1.0 + z[idx]),
            m2[idx] * (1.0 + z[idx]),
            dl[idx],
            iota[idx],
            ra[idx],
            dec[idx],
            psi[idx],
            gmst[idx],
            chunk=snr_chunk,
            psds=psds,
            device=dev,
        )
        snr_cols["SNR_H1"][idx] = snrs["H1"]
        snr_cols["SNR_L1"][idx] = snrs["L1"]
        snr_cols["SNR_V1"][idx] = snrs["V1"]
        snr_cols["SNR"][idx] = snrs["net"]

    return {
        "m1": m1,
        "q": q,
        "z": z,
        "iota": iota,
        "ra": ra,
        "dec": dec,
        "psi": psi,
        "gmst": gmst,
        "s1x": s1[0],
        "s1y": s1[1],
        "s1z": s1[2],
        "s2x": s2[0],
        "s2y": s2[1],
        "s2z": s2[2],
        "pdraw_mqz": pdraw,
        **snr_cols,
    }


def campaign_summary(df, threshold: float = DETECTION_SNR, device=None) -> dict:
    """Detection-rate diagnostics of a campaign table."""
    snr = _col(df, "SNR")
    det = snr > threshold
    m1, q, z, pdraw = (_col(df, k)[det] for k in ("m1", "q", "z", "pdraw_mqz"))
    wt = default_pop_wt(m1, q, z, device=device) / pdraw
    nex = DEFAULT_RATE * np.sum(wt) / len(snr)
    n_det = int(np.count_nonzero(det))
    neff = np.sum(wt) ** 2 / np.sum(wt**2) if n_det else 0.0
    return {
        "n_detected": n_det,
        "predicted_detections_per_year": float(nex),
        "neff_default_pop": float(neff),
        "expected_pop_draws": float(np.sum(wt) / np.max(wt)) if n_det else 0.0,
    }


@dataclass
class Uncertainties:
    """GWTC-3-calibrated measurement uncertainties."""

    sigma_log_mc: np.ndarray
    sigma_q: np.ndarray
    sigma_log_dl: np.ndarray

    @classmethod
    def from_snr(cls, snr):
        snr = np.asarray(snr, dtype=np.float64)
        return cls(0.05 * 20.0 / snr, 0.07 * 20.0 / snr, 0.2 * 20.0 / snr)


def add_observation_noise(inj, seed: int = 181_286_134, threshold: float = DETECTION_SNR) -> dict:
    """Observed SNRs and point estimates for detected injections: SNR_OBS =
    SNR + N(0, sqrt(3)); detection at SNR_OBS > threshold; noisy (log Mc_det,
    q, log dL) point estimates.  Returns the detected rows with the new columns."""
    rng = np.random.default_rng(seed)
    snr_obs = _col(inj, "SNR") + rng.normal(0.0, math.sqrt(3.0), size=len(_col(inj, "SNR")))
    keep = snr_obs > threshold
    det = {k: _col(inj, k)[keep] for k in inj.keys()}
    det["SNR_OBS"] = snr_obs[keep]

    det["mc"] = det["m1"] * det["q"] ** 0.6 / (1.0 + det["q"]) ** 0.2
    det["dl"] = planck18_dl_np(det["z"])
    det["mc_det"] = det["mc"] * (1.0 + det["z"])

    unc = Uncertainties.from_snr(det["SNR_OBS"])
    det["sigma_log_mc"] = unc.sigma_log_mc
    det["log_mc_obs"] = rng.normal(np.log(det["mc_det"]), unc.sigma_log_mc)
    det["sigma_q"] = unc.sigma_q
    det["q_obs"] = rng.normal(det["q"], unc.sigma_q)
    det["sigma_log_dl"] = unc.sigma_log_dl
    det["log_dl_obs"] = rng.normal(np.log(det["dl"]), unc.sigma_log_dl)
    return det


def draw_mock_pe_samples(
    log_mc_obs,
    sigma_log_mc,
    q_obs,
    sigma_q,
    log_dl_obs,
    sigma_log_dl,
    size=1,
    output_source_frame=False,
    rng=None,
):
    """Gaussian mock PE samples in (log Mc_det, q, log dL), q truncated to
    [0, 1] and drawn by inverse CDF (the truncated normal, with no rejection
    loop).  With ``output_source_frame``: (m1_src, q, z) and the analytic PE
    prior weight 1/m1 * 1/dL (dC + (1+z) dH/E)."""
    from scipy.special import ndtr, ndtri

    if rng is None:
        rng = np.random.default_rng()
    log_mcs = rng.normal(log_mc_obs, sigma_log_mc, size=size)
    c_lo = ndtr((0.0 - q_obs) / sigma_q)
    c_hi = ndtr((1.0 - q_obs) / sigma_q)
    u = rng.uniform(c_lo, c_hi, size=size)
    # clip away exact 0/1 quantiles (ndtri(-inf/inf)) from extreme q_obs
    u = np.clip(u, 1e-12, 1.0 - 1e-12)
    qs = np.clip(q_obs + sigma_q * ndtri(u), 0.0, 1.0)
    log_dls = rng.normal(log_dl_obs, sigma_log_dl, size=size)

    mcs = np.exp(log_mcs)
    m1s = mcs / (qs**0.6 / (1.0 + qs) ** 0.2)
    dls = np.exp(log_dls)

    if not output_source_frame:
        return m1s, qs, dls, 1.0 / m1s / dls

    z = planck18_z_of_dl_np(dls)
    m1_src = m1s / (1.0 + z)
    prior_wt = 1.0 / m1_src / dls * (planck18_dc_np(z) + (1.0 + z) * DH / planck18_efunc_np(z))
    return m1_src, qs, z, prior_wt


def draw_one_year_catalog(
    n_total_injections: int,
    obs,
    nsamp: int = 128,
    seed: int = 177_043_409,
    rate: float = DEFAULT_RATE,
    device=None,
) -> dict:
    """Poisson-draw a one-year catalog with mock PE samples.

    Expected count nex = R sum(wt) / N_total over detected injections; events
    drawn ~ wt without replacement; per event, PE samples importance-drawn
    with size doubling until Neff >= 2 nsamp.  Returns the columns
    ``m1, q, z, wt, evt`` (``evt`` is the event's row in ``obs``).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pop_wt = default_pop_wt(_col(obs, "m1"), _col(obs, "q"), _col(obs, "z"), device=dev)
    wt = pop_wt / _col(obs, "pdraw_mqz")
    nex = rate * np.sum(wt) / n_total_injections
    n = rng.poisson(nex)
    n = min(n, len(wt))
    ne = np.sum(wt) ** 2 / np.sum(wt**2)
    print(f"[mock] catalog Neff={ne:.1f}, drawing {n} events (nex={nex:.1f})")
    inds = rng.choice(len(wt), size=n, p=wt / np.sum(wt), replace=False)

    pe_cols = ("log_mc_obs", "sigma_log_mc", "q_obs", "sigma_q", "log_dl_obs", "sigma_log_dl")
    pe = {k: _col(obs, k) for k in pe_cols}
    parts = []
    for i in range(n):
        row = [pe[k][inds[i]] for k in pe_cols]
        size = 32 * nsamp
        while True:
            m, q, z, w = draw_mock_pe_samples(*row, size=size, output_source_frame=True, rng=rng)
            pw = default_pop_wt(m, q, z, device=dev)
            rw = pw / w
            neff = np.sum(rw) ** 2 / np.sum(rw**2)
            if neff < 2 * nsamp:
                size *= 2
                continue
            pick = rng.choice(len(rw), size=nsamp, p=rw / np.sum(rw))
            parts.append((m[pick], q[pick], z[pick], pw[pick], np.full(nsamp, inds[i])))
            break
    if not parts:
        return {k: np.zeros(0, dtype=np.int64 if k == "evt" else np.float64) for k in CATALOG_COLUMNS}
    return {k: np.concatenate(col) for k, col in zip(CATALOG_COLUMNS, zip(*parts))}
