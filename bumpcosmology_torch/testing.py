"""Synthetic inputs for the tests and the on-card check.

* :func:`synthetic_pop_data`: source-frame catalogs, the same numpy draws
  as the JAX package's ``testing.py::synthetic_pop_data``.
* :func:`synthetic_pop_cosmo_data`: detector-frame catalogs; counterpart of
  the JAX package's ``testing.py::synthetic_pop_cosmo_data``.  Same numpy
  draws from the seed; dL comes from this package's fixed Planck18 table, so
  the values agree with the JAX helper's to float32 rounding.  Tests that
  compare the two packages carry the JAX data across with
  :mod:`bumpcosmology_torch.convert` instead, so both see identical inputs.
* :func:`synthetic_source_tables`: the same kind of source-frame catalog as
  the column tables the fit stages read (``pe-samples``: m1 q z wt evt;
  ``selection-samples``: m1 q z pdraw ndraw), for any mass family.
* :func:`snr_knot_rows`: injections whose transition frequencies sit on the
  stored knots of kernel C's grid, where a count off by one moves a term.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bumpcosmology_torch.inference.likelihoods import PopCosmoData, PopData, make_pop_cosmo_data, make_pop_data
from bumpcosmology_torch.models.cosmology import dl_at_z, planck18_table

__all__ = ["synthetic_pop_data", "synthetic_pop_cosmo_data", "synthetic_source_tables", "snr_knot_rows"]


def _source_frame(nobs, nsamp, nsel, seed):
    rng = np.random.default_rng(seed)
    m1 = rng.uniform(8.0, 70.0, size=(nobs, nsamp))
    q = rng.uniform(0.3, 1.0, size=(nobs, nsamp))
    z = rng.uniform(0.02, 1.5, size=(nobs, nsamp))
    pdraw = rng.uniform(0.5, 2.0, size=(nobs, nsamp))
    m1_s = rng.uniform(8.0, 70.0, size=nsel)
    q_s = rng.uniform(0.3, 1.0, size=nsel)
    z_s = rng.uniform(0.02, 1.5, size=nsel)
    pd_s = rng.uniform(0.5, 2.0, size=nsel)
    return m1, q, z, pdraw, m1_s, q_s, z_s, pd_s


def synthetic_pop_data(nobs=56, nsamp=128, nsel=1024, seed=0, device=None) -> PopData:
    """A source-frame catalog (m1, q, z) on ``device`` (``None`` means CUDA)."""
    return make_pop_data(*_source_frame(nobs, nsamp, nsel, seed), ndraw=float(nsel * 100), device=device)


def synthetic_pop_cosmo_data(nobs=56, nsamp=128, nsel=1024, seed=0, device=None) -> PopCosmoData:
    """A detector-frame catalog (m1_det, q, dL) on ``device`` (``None`` means CUDA)."""
    m1, q, z, pd, m1s, qs, zs, pds = _source_frame(nobs, nsamp, nsel, seed)
    table = planck18_table(device)

    def dl(zz):
        zt = torch.as_tensor(zz, dtype=torch.float32, device=table.dl.device).reshape(1, -1)
        return dl_at_z(table, zt).reshape(np.shape(zz)).cpu().numpy()

    return make_pop_cosmo_data(m1 * (1 + z), q, dl(z), pd, m1s * (1 + zs), qs, dl(zs), pds,
                               ndraw=float(nsel * 100), device=device)


def synthetic_source_tables(nobs=8, nsamp=32, nsel=128, seed=0):
    """``(pe, sel)`` column dicts for ``run_pop_fit`` / ``run_pop_cosmo_fit``:
    uniform draws (m1 in [8, 70], q in [0.3, 1], z in [0.02, 1.5], weights in
    [0.5, 2]), events labelled ``GW00``, ``GW01``, ..., ``ndraw`` 100 x nsel."""
    rng = np.random.default_rng(seed)
    n = nobs * nsamp
    pe = {"m1": rng.uniform(8.0, 70.0, n), "q": rng.uniform(0.3, 1.0, n), "z": rng.uniform(0.02, 1.5, n),
          "wt": rng.uniform(0.5, 2.0, n), "evt": np.repeat([f"GW{i:02d}" for i in range(nobs)], nsamp)}
    sel = {"m1": rng.uniform(8.0, 70.0, nsel), "q": rng.uniform(0.3, 1.0, nsel), "z": rng.uniform(0.02, 1.5, nsel),
           "pdraw": rng.uniform(0.5, 2.0, nsel), "ndraw": np.full(nsel, 100.0 * nsel)}
    return pe, sel


def snr_knot_rows(f_grid: torch.Tensor, knots=None, ratios=(0.1, 0.45, 1.0), span: int = 12, seed: int = 0):
    """``(m1, m2, dl)`` float32 injections on ``f_grid``'s device whose
    ``f_merg``, ``f_ring`` or ``f_cut`` (as :func:`~bumpcosmology_torch.mock.cuda_snr.row_scalars`
    rounds them) equals a stored knot of ``f_grid``, or the float32 one ulp
    below or above it.

    For each transition, knot (index in ``knots``, default every knot) and
    mass ratio, the total mass that puts the transition on the knot is solved
    in float64; then ``m1`` is stepped by up to ``span`` ulps either way, and
    the first step that lands each of the three targets gives a row.  ``dl``
    is drawn from ``seed``, log-uniform over [0.1, 10] Gpc.
    """
    from bumpcosmology_torch.mock.cuda_snr import row_scalars
    from bumpcosmology_torch.mock.waveform import FCUT, FMERG, FRING, MSUN_S

    dev = f_grid.device
    idx = torch.arange(f_grid.shape[0], device=dev) if knots is None else torch.as_tensor(knots, device=dev)
    f_k = f_grid[idx]
    targets = torch.stack([torch.nextafter(f_k, f_k.new_tensor(-math.inf)), f_k,
                           torch.nextafter(f_k, f_k.new_tensor(math.inf))])  # (3, K)
    steps = torch.arange(-span, span + 1, device=dev, dtype=torch.int32)
    m1s, m2s = [], []
    for which, (a, b, c) in enumerate((FMERG, FRING, FCUT)):
        for q in ratios:
            eta = q / (1.0 + q) ** 2
            m_total = (a * eta * eta + b * eta + c) / (math.pi * MSUN_S * f_k.double())
            m1 = (m_total / (1.0 + q)).float()
            m1c = (m1.view(torch.int32)[:, None] + steps).view(torch.float32)  # (K, 2 span + 1)
            m2c = (m1.double() * q).float()[:, None].expand_as(m1c)
            fx = row_scalars(m1c.reshape(-1), m2c.reshape(-1))[(0, 1, 3)[which]].reshape(m1c.shape)
            for target in targets:
                hit = fx == target[:, None]
                found = hit.any(1)
                first = hit.int().argmax(1)
                rows = torch.nonzero(found).squeeze(1)
                m1s.append(m1c[rows, first[rows]])
                m2s.append(m2c[rows, first[rows]])
    m1, m2 = torch.cat(m1s), torch.cat(m2s)
    rng = np.random.default_rng(seed)
    dl = torch.as_tensor(np.exp(rng.uniform(np.log(0.1), np.log(10.0), m1.shape[0])).astype(np.float32), device=dev)
    return m1, m2, dl
