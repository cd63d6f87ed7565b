"""Utilities: trace I/O, checkpointing, profiling and the kernels' build
cache; see the JAX package's ``utils``.

``enable_compilation_cache`` moves the directory where the hand-written CUDA
kernels are built and kept (the JAX package's moves XLA's compilation cache).
"""
from bumpcosmology_torch.utils.trace import Trace, save_trace, load_trace
from bumpcosmology_torch.utils.checkpoint import save_warmup, load_warmup
from bumpcosmology_torch.utils.compile_cache import enable_compilation_cache
