"""Utilities: trace I/O and checkpointing; see the JAX package's ``utils``.

The JAX package's ``enable_compilation_cache`` has no counterpart yet: the
port compiles nothing with XLA, and its nvcc builds are kept in
``bumpcosmology_torch/_build/`` on their own.
"""
from bumpcosmology_torch.utils.trace import Trace, save_trace, load_trace
from bumpcosmology_torch.utils.checkpoint import save_warmup, load_warmup
