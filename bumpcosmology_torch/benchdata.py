"""Benchmark catalogs for the port; counterpart of the JAX package's ``benchdata.py``.

:func:`load_pop_cosmo_data` reads the committed flagship catalog
(``benchmarks/flagship_catalog.npz``: 56 events x 256 PE samples in float32
and 24,576 injections in float64, with ``sel_ln`` the log of the number
drawn), cast to float32 as the JAX loader does implicitly.
:func:`mock_pop_data` and :func:`mock_pop_cosmo_data` build self-consistent
catalogs from the fiducial population through the port's mock universe (the
campaign's SNRs through kernel C on ``device``), in the source and the
detector frame; :func:`flagship_pop_cosmo_data` and
:func:`save_pop_cosmo_data` round-trip a catalog through the same ``.npz``
layout.  The mock tables are column dicts; no pandas is needed.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.likelihoods import (
    EventData,
    PopCosmoData,
    PopData,
    SelectionData,
    make_pop_cosmo_data,
    make_pop_data,
)

__all__ = ["mock_pop_data", "mock_pop_cosmo_data", "flagship_pop_cosmo_data", "save_pop_cosmo_data",
           "load_pop_cosmo_data"]


def _first_seen(labels: np.ndarray) -> np.ndarray:
    """The distinct labels in the order they first appear (``pandas.unique``)."""
    _, first = np.unique(labels, return_index=True)
    return labels[np.sort(first)]


def _catalog(nobs, nsamp, nsel, ndraw_campaign, threshold, seed, device):
    """(per-event stacks (m1, q, z, wt), selection rows, ndraw), as the JAX
    package's ``benchdata._catalog`` draws them from the same seeds."""
    from bumpcosmology_torch.mock import add_observation_noise, draw_injection_campaign, draw_one_year_catalog
    from bumpcosmology_torch.models.parameters import DEFAULT_RATE

    rng = np.random.default_rng(seed)
    inj = draw_injection_campaign(ndraw=ndraw_campaign, seed=seed + 1, snr_chunk=32768, device=device)
    n_inj = len(inj["m1"])
    obs = add_observation_noise(inj, seed=seed + 2, threshold=threshold)

    # pick the rate so the Poisson catalog lands near nobs, then trim
    cat = None
    rate = DEFAULT_RATE
    for _ in range(6):
        cat = draw_one_year_catalog(n_inj, obs, nsamp=nsamp, seed=seed + 3, rate=rate, device=device)
        n = len(np.unique(cat["evt"]))
        if n >= nobs:
            break
        rate *= max(2.0, (nobs + 1) / max(n, 1))
    events = _first_seen(cat["evt"])[:nobs]
    stacks = [np.stack([cat[c][cat["evt"] == e] for e in events]) for c in ("m1", "q", "z", "wt")]

    det = add_observation_noise(inj, seed=seed + 4, threshold=threshold)
    n_det = len(det["m1"])
    nsel_eff = min(nsel, n_det)
    pick = rng.choice(n_det, size=nsel_eff, replace=False)
    sel = {k: v[pick] for k, v in det.items()}
    if nsel_eff < nsel:
        # pad by resampling with replacement: the shapes stay, but the
        # selection's Monte-Carlo resolution is the count of unique rows
        print(f"[benchdata] WARNING: requested nsel={nsel} but the campaign yields only {nsel_eff} unique "
              "detections — padding with replacement; selection-MC noise is set by the unique count. "
              "Grow ndraw_campaign to actually get nsel.")
        extra = rng.choice(n_det, size=nsel - nsel_eff)
        sel = {k: np.concatenate([v, det[k][extra]]) for k, v in sel.items()}
        ndraw = float(n_inj) * (nsel / n_det)
    else:
        ndraw = float(n_inj) * (nsel_eff / n_det)
    return stacks, sel, ndraw


def mock_pop_data(nobs=56, nsamp=128, nsel=1024, ndraw_campaign=300_000, threshold=20.0, seed=7000,
                  dtype=None, device=None) -> PopData:
    """A source-frame catalog from the fiducial population on ``device``
    (``None`` means CUDA); ``dtype`` overrides float32 (the host-side
    construction is float64 either way)."""
    dev = resolve_device(device)
    (m1, q, z, wt), sel, ndraw = _catalog(nobs, nsamp, nsel, ndraw_campaign, threshold, seed, dev)
    kw = {} if dtype is None else {"dtype": dtype}
    return make_pop_data(m1, q, z, wt, sel["m1"], sel["q"], sel["z"], sel["pdraw_mqz"], ndraw=ndraw,
                         device=dev, **kw)


def mock_pop_cosmo_data(nobs=56, nsamp=128, nsel=1024, ndraw_campaign=300_000, threshold=20.0, seed=7000,
                        dtype=None, device=None) -> PopCosmoData:
    """The same catalog in the detector frame (m1_det, q, dL) with the pdraw
    Jacobian of ``run_cosmo_fit.py:22-30``, on ``device`` (``None`` means CUDA)."""
    from bumpcosmology_torch.data.weights import dm1sqz_dm1ddqdl, planck18_dl_np

    dev = resolve_device(device)
    (m1, q, z, wt), sel, ndraw = _catalog(nobs, nsamp, nsel, ndraw_campaign, threshold, seed, dev)
    sm1, sq, sz, spd = (sel[k] for k in ("m1", "q", "z", "pdraw_mqz"))
    kw = {} if dtype is None else {"dtype": dtype}
    return make_pop_cosmo_data(
        m1 * (1.0 + z), q, planck18_dl_np(z), wt * dm1sqz_dm1ddqdl(m1, q, z),
        sm1 * (1.0 + sz), sq, planck18_dl_np(sz), spd * dm1sqz_dm1ddqdl(sm1, sq, sz),
        ndraw=ndraw, device=dev, **kw)


def flagship_pop_cosmo_data(path=None, device=None) -> PopCosmoData:
    """The flagship catalog: read from ``path`` when it exists (the committed
    ``benchmarks/flagship_catalog.npz``), else a smaller-campaign stand-in
    (56 events x 256 samples, 8,192 selection rows from 2.4e6 draws), written
    to ``path`` when one is given."""
    if path is not None and os.path.exists(path):
        return load_pop_cosmo_data(path, device=device)
    data = mock_pop_cosmo_data(nobs=56, nsamp=256, nsel=8192, ndraw_campaign=2_400_000, device=device)
    if path is not None:
        save_pop_cosmo_data(path, data)
    return data


def save_pop_cosmo_data(path, data: PopCosmoData) -> None:
    """Write ``data`` in the flagship catalog's ``.npz`` layout."""
    ev, sel = data.events, data.selection
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    np.savez(path, ev_a=host(ev.a), ev_q=host(ev.q), ev_c=host(ev.c), ev_lp=host(ev.log_pdraw),
             sel_a=host(sel.a), sel_q=host(sel.q), sel_c=host(sel.c), sel_lp=host(sel.log_pdraw),
             sel_ln=host(sel.log_ndraw))


def load_pop_cosmo_data(path, device=None, dtype=torch.float32) -> PopCosmoData:
    """:class:`PopCosmoData` from a catalog ``.npz`` on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    with np.load(path) as d:
        t = {k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=dev) for k in d.files}
    ev = EventData(a=t["ev_a"], q=t["ev_q"], c=t["ev_c"], log_pdraw=t["ev_lp"])
    sel = SelectionData(a=t["sel_a"], q=t["sel_q"], c=t["sel_c"], log_pdraw=t["sel_lp"],
                        log_ndraw=t["sel_ln"])
    return PopCosmoData(events=ev, selection=sel)
