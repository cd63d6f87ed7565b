"""bumpcosmology_torch — the PyTorch/CUDA port of the JAX package beside it.

The JAX package beside this one stays the reference; this package mirrors
its layout so each module's counterpart is easy to find:

- :mod:`bumpcosmology_torch.ops`        — L0 numerics (integrate, interp) and
  the two hand-written Hopper kernels (``cuda_bump``, ``cuda_logwts``)
- :mod:`bumpcosmology_torch.models`     — L1 population & cosmology models
- :mod:`bumpcosmology_torch.inference`  — L2 priors, potential, likelihood, NUTS
- :mod:`bumpcosmology_torch.utils`      — traces, tables and checkpoints
- :mod:`bumpcosmology_torch.data`       — importance weights at fixed Planck18, the
  GWTC and O3 injection-file ingestion, rehearsal fixtures and the input fetch
- :mod:`bumpcosmology_torch.mock`       — the mock universe's injection campaign,
  observations and one-year catalog, with the SNR-integral kernel (``cuda_snr``)
- :mod:`bumpcosmology_torch.pipeline`   — the stages, their DAG and the CLI
  ``python -m bumpcosmology_torch.pipeline``

Everything is batched over a leading chain axis: the potential takes
``theta`` of shape ``(C, dim)`` and one value+grad serves all ``C`` chains.

Devices: entry points take ``device=None``, which means CUDA, and raise when
CUDA is absent; the CPU runs only when the caller passes ``device="cpu"``.
Each kernel wrapper dispatches on the device of the tensors it is given: a
CPU tensor takes the kernel's plain PyTorch twin, a CUDA tensor launches the
kernel or raises.

The main path mirrors the JAX package's fused/Pallas detector-frame route
(``inference/likelihoods.py::_cosmo_frame_logwts_fused``), which builds the
log(dL)-keyed detector table at ``n_z`` points (``likelihoods.py:472``),
not at the bracket path's ``n_det``.
"""

__version__ = "0.1.0"
