"""Posterior trace container (L4/L5); counterpart of the JAX package's
``utils/trace.py``, stored as one ``.npz`` (the GPU host has no h5py) with
the same logical layout:

    posterior/<site>      (chains, draws[, k])
    sample_stats/<stat>   (chains, draws)
    coords/<axis>         grid coordinates for vector sites
    attrs                 a JSON object of strings

The arviz/netCDF export is not ported.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

__all__ = ["Trace", "save_trace", "load_trace", "SITE_DIMS"]

_GROUPS = ("posterior", "sample_stats", "coords")


class Trace:
    """In-memory trace: posterior + sample_stats dicts of numpy arrays."""

    def __init__(
        self,
        posterior: Dict[str, np.ndarray],
        sample_stats: Optional[Dict[str, np.ndarray]] = None,
        coords: Optional[Dict[str, np.ndarray]] = None,
        attrs: Optional[Dict[str, str]] = None,
    ):
        self.posterior = dict(posterior)
        self.sample_stats = dict(sample_stats or {})
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, name: str) -> np.ndarray:
        return self.posterior[name]

    def stacked(self, name: str) -> np.ndarray:
        """Site flattened over (chains, draws)."""
        x = self.posterior[name]
        return x.reshape((-1,) + x.shape[2:])

    def summary(self):
        from bumpcosmology_torch.inference.diagnostics import summary as _summary

        return _summary({k: v for k, v in self.posterior.items() if v.ndim == 2})


def save_trace(path, trace: Trace) -> None:
    """Write ``trace`` to ``path`` exactly (no suffix is added)."""
    arrays = {f"{group}/{k}": np.asarray(v) for group in _GROUPS for k, v in getattr(trace, group).items()}
    arrays["attrs"] = np.asarray(json.dumps({k: str(v) for k, v in trace.attrs.items()}))
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_trace(path) -> Trace:
    groups = {g: {} for g in _GROUPS}
    with np.load(path) as d:
        for key in d.files:
            group, _, name = key.partition("/")
            if group in groups:
                groups[group][name] = d[key]
        attrs = json.loads(str(d["attrs"])) if "attrs" in d.files else {}
    return Trace(groups["posterior"], groups["sample_stats"], groups["coords"], attrs)


#: dims metadata for vector sites (the axes are the posterior-predictive
#: COORDS grids of ``models/population.py``)
SITE_DIMS = {
    "mdNdmdVdt_fixed_qz": ["m_grid"],
    "dNdqdVdt_fixed_mz": ["q_grid"],
    "dNdVdt_fixed_mq": ["z_grid"],
    "hz": ["z_grid"],
    "neff": ["event"],
}

