"""The kernels' build cache (L4); counterpart of the JAX package's
``utils/compile_cache.py``.

The JAX package points XLA's persistent compilation cache at a directory.
The port compiles nothing with XLA; what it builds are its hand-written
CUDA kernels (``ops/_build.py``: one ``nvcc`` per ``csrc/*.cu``, a few
seconds each).  The shared libraries are named by a hash of their source and
the ``nvcc`` flags, so one directory can hold the builds of several
checkouts, and an edited source is rebuilt.  By default they stay in the
package's git-ignored ``_build/``; :func:`enable_compilation_cache` moves
them, for example to a directory kept between jobs.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

__all__ = ["enable_compilation_cache"]


def enable_compilation_cache(cache_dir: Optional[str] = None, min_compile_time_secs: float = 1.0) -> Path:
    """Point the kernels' build directory (``ops._build.BUILD_DIR``) at a
    directory and return it.

    The directory is, in this order: ``cache_dir``, the environment variable
    ``BUMPCOSMOLOGY_CACHE_DIR``, or the package's ``_build/`` (the default,
    which this restores).  ``min_compile_time_secs`` is accepted for the JAX
    package's signature and unused: every build is kept."""
    from bumpcosmology_torch.ops import _build

    path = Path(cache_dir or os.environ.get("BUMPCOSMOLOGY_CACHE_DIR") or _build.DEFAULT_BUILD_DIR)
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    return path
