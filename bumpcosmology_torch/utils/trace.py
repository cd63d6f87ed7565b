"""Posterior trace container (L4/L5); counterpart of the JAX package's
``utils/trace.py``, stored as one ``.npz`` (the GPU host has no h5py) with
the same logical layout:

    posterior/<site>      (chains, draws[, k])
    sample_stats/<stat>   (chains, draws)
    coords/<axis>         grid coordinates for vector sites
    attrs                 a JSON object of strings

:func:`export_netcdf` writes the arviz InferenceData layout as NetCDF-4
with h5py, imported when it is called; :func:`to_arviz` needs arviz.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

__all__ = ["Trace", "save_trace", "load_trace", "SITE_DIMS", "site_dims", "to_arviz", "export_netcdf"]

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



def site_dims(trace: Trace) -> Dict[str, list]:
    """Per-site trailing-dimension names for the vector sites of ``trace``."""
    return {name: SITE_DIMS.get(name, [f"{name}_dim0"]) for name, v in trace.posterior.items() if np.ndim(v) > 2}


def _coords(trace: Trace) -> Dict[str, np.ndarray]:
    coords = {k: np.asarray(v) for k, v in trace.coords.items()}
    if "neff" in trace.posterior and np.ndim(trace.posterior["neff"]) == 3:
        coords.setdefault("event", np.arange(trace.posterior["neff"].shape[-1]))
    return coords


def to_arviz(trace: Trace):
    """An ``arviz.InferenceData`` of ``trace``; raises ``ImportError`` without arviz,
    which the port does not need."""
    try:
        import arviz as az
    except ImportError as err:
        raise ImportError("arviz is not installed. The native trace format is an .npz store "
                          "(save_trace/load_trace; layout documented in utils/trace.py), and "
                          "export_netcdf writes NetCDF-4 without arviz.") from err
    return az.from_dict(posterior=trace.posterior, sample_stats=trace.sample_stats or None,
                        coords=_coords(trace), dims=site_dims(trace))


def _nc_group(f, name: str, variables: Dict[str, np.ndarray], coords, dims_map) -> None:
    """One InferenceData group as NetCDF-4: each named dimension a dataset
    marked as an HDF5 dimension scale, attached to the variables that use it."""
    g = f.create_group(name)
    first = next(iter(variables.values()))
    dim_sizes = {"chain": first.shape[0], "draw": first.shape[1]}
    for vname, v in variables.items():
        for ax, dim in enumerate(dims_map.get(vname, [])):
            dim_sizes[dim] = v.shape[2 + ax]
    scales = {}
    for dim, size in dim_sizes.items():
        ds = g.create_dataset(dim, data=np.asarray(coords[dim]) if dim in coords else np.arange(size))
        ds.make_scale(dim)
        scales[dim] = ds
    for vname, v in variables.items():
        ds = g.create_dataset(vname, data=np.asarray(v))
        for ax, dim in enumerate(["chain", "draw"] + list(dims_map.get(vname, []))):
            ds.dims[ax].attach_scale(scales[dim])


def export_netcdf(path, trace: Trace) -> None:
    """Write the arviz InferenceData layout (``posterior`` and ``sample_stats``
    groups, the dims of :data:`SITE_DIMS`) as a NetCDF-4 file with h5py, which
    is imported here: ``arviz.from_netcdf`` and xarray's h5netcdf engine read it."""
    import h5py

    coords = _coords(trace)
    with h5py.File(path, "w") as f:
        f.attrs["inference_library"] = "bumpcosmology_torch"
        _nc_group(f, "posterior", trace.posterior, coords, site_dims(trace))
        if trace.sample_stats:
            _nc_group(f, "sample_stats", trace.sample_stats, coords, {})
