"""The committed flagship catalog (``benchmarks/flagship_catalog.npz``) for the
port; counterpart of the JAX package's ``benchdata.py::load_pop_cosmo_data``.

The file holds 56 events x 256 PE samples (float32) and 24,576 injections
(float64, with ``sel_ln`` the log of the number drawn).  Every array is cast
to float32, as the JAX loader does implicitly.
"""
from __future__ import annotations

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.likelihoods import EventData, PopCosmoData, SelectionData

__all__ = ["load_pop_cosmo_data"]


def load_pop_cosmo_data(path, device=None, dtype=torch.float32) -> PopCosmoData:
    """:class:`PopCosmoData` from a catalog ``.npz`` on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    with np.load(path) as d:
        t = {k: torch.as_tensor(np.asarray(d[k]), dtype=dtype, device=dev) for k in d.files}
    ev = EventData(a=t["ev_a"], q=t["ev_q"], c=t["ev_c"], log_pdraw=t["ev_lp"])
    sel = SelectionData(a=t["sel_a"], q=t["sel_q"], c=t["sel_c"], log_pdraw=t["sel_lp"],
                        log_ndraw=t["sel_ln"])
    return PopCosmoData(events=ev, selection=sel)
