"""Saving and loading an adapted sampler state (L4); counterpart of the JAX
package's ``utils/checkpoint.py``.

The ``.npz`` holds ``theta u grad eps cov chol_cov`` with a leading chain
axis, the layout the JAX package writes and reads: a file written by either
package loads in the other.  A fleet fit split at the end of its warmup
(``fleet_fit(checkpoint_path=)``) also keeps its ``torch.Generator``'s
state under ``generator_state``, which the JAX package's loader ignores.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device

if TYPE_CHECKING:
    from bumpcosmology_torch.inference.nuts import WarmupResult

__all__ = ["checkpoint_file", "save_warmup", "load_warmup", "load_generator_state"]


def checkpoint_file(path) -> str:
    """``np.savez`` appends ``.npz`` to a path without it; readers must agree."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_warmup(path, warm: WarmupResult, generator=None) -> None:
    """Write ``warm`` (and ``generator``'s state, when given) to ``path``."""
    arrays = dict(zip(("theta", "u", "grad"), warm.state))
    arrays.update(eps=warm.eps, cov=warm.cov, chol_cov=warm.chol_cov)
    if generator is not None:
        arrays["generator_state"] = generator.get_state()
    np.savez(checkpoint_file(path), **{k: v.detach().cpu().numpy() for k, v in arrays.items()})


def load_generator_state(path):
    """The ``torch.Generator`` state kept in ``path`` (``None`` if there is none)."""
    with np.load(checkpoint_file(path)) as d:
        return torch.as_tensor(d["generator_state"]) if "generator_state" in d.files else None


def load_warmup(path, device=None, dtype=torch.float32) -> WarmupResult:
    """The adapted state in ``path`` on ``device`` (``None`` means CUDA)."""
    from bumpcosmology_torch.inference.nuts import ChainState, WarmupResult  # nuts imports utils.profiling

    dev = resolve_device(device)
    with np.load(checkpoint_file(path)) as d:
        t = {k: torch.as_tensor(d[k], dtype=dtype, device=dev)
             for k in ("theta", "u", "grad", "eps", "cov", "chol_cov")}
    return WarmupResult(ChainState(t["theta"], t["u"], t["grad"]), t["eps"], t["cov"], t["chol_cov"])
