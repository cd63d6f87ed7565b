"""Synthetic detector-frame catalogs; counterpart of
the JAX package's ``testing.py::synthetic_pop_cosmo_data``.

Same numpy draws from the seed; dL comes from this package's fixed Planck18
table, so the values agree with the JAX helper's to float32 rounding.  Tests
that compare the two packages carry the JAX data across with
:mod:`bumpcosmology_torch.convert` instead, so both see identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from bumpcosmology_torch.inference.likelihoods import PopCosmoData, make_pop_cosmo_data
from bumpcosmology_torch.models.cosmology import dl_at_z, planck18_table

__all__ = ["synthetic_pop_cosmo_data"]


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


def synthetic_pop_cosmo_data(nobs=56, nsamp=128, nsel=1024, seed=0, device=None) -> PopCosmoData:
    """A detector-frame catalog (m1_det, q, dL) on ``device`` (``None`` means CUDA)."""
    m1, q, z, pd, m1s, qs, zs, pds = _source_frame(nobs, nsamp, nsel, seed)
    table = planck18_table(device)

    def dl(zz):
        zt = torch.as_tensor(zz, dtype=torch.float32, device=table.dl.device).reshape(1, -1)
        return dl_at_z(table, zt).reshape(np.shape(zz)).cpu().numpy()

    return make_pop_cosmo_data(m1 * (1 + z), q, dl(z), pd, m1s * (1 + zs), qs, dl(zs), pds,
                               ndraw=float(nsel * 100), device=device)
