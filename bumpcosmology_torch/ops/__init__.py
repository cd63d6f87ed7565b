"""L0 numerics and the hand-written CUDA kernels; see the JAX package's ``ops``.

The package exports the JAX package's public ``ops`` helpers that the port
has, except the two whose names are those of their modules (``interp`` and
``logsumexp``: take them from ``ops.interp`` and ``ops.logsumexp``), so that
``ops.interp`` stays the module.  The TPU interpolation-method switch has no
counterpart.  ``sharded_logsumexp`` takes a ``torch.distributed`` process
group (``ops.collectives`` holds the collectives under it).  ``cuda_bump`` (kernel A)
and ``cuda_logwts`` (kernel B) replace the Pallas kernels
``ops/pallas_bump.py`` and ``ops/pallas_logwts.py`` of the JAX package;
``cuda_priors`` (kernel P) computes the models' priors and transforms on the
card, which the JAX package leaves to XLA.
"""
from bumpcosmology_torch.ops.integrate import cumtrapz, log_cumtrapz, log_trapz, trapz
from bumpcosmology_torch.ops.interp import interp_unit_spaced, inverse_interp
from bumpcosmology_torch.ops.logsumexp import log_neff, logmeanexp, neff, sharded_logsumexp

__all__ = [
    "cumtrapz",
    "trapz",
    "log_trapz",
    "log_cumtrapz",
    "interp_unit_spaced",
    "inverse_interp",
    "logmeanexp",
    "sharded_logsumexp",
    "log_neff",
    "neff",
]
