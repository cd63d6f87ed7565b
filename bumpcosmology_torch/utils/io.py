"""Column tables on disk (L4); counterpart of the JAX package's
``utils/io.py``.  A table is ``{column: numpy array}``, stored as one
``.npz`` array per column under ``<key>/`` (the GPU host has neither pandas
nor h5py); text columns are stored as fixed-width unicode, so reading needs
no pickle.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["write_table", "read_table"]


def write_table(path, table: Dict[str, np.ndarray], key: str = "samples") -> None:
    """Write ``table`` to ``path`` exactly (no suffix is added), columns in their order."""
    arrays = {}
    for col, vals in table.items():
        vals = np.asarray(vals)
        arrays[f"{key}/{col}"] = vals.astype(str) if vals.dtype == object else vals
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def read_table(path, key: str = "samples") -> Dict[str, np.ndarray]:
    prefix = key + "/"
    with np.load(path) as d:
        return {k[len(prefix):]: d[k] for k in d.files if k.startswith(prefix)}
