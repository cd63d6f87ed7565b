"""Build-on-first-use for the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, which is loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes).
Libraries land in ``BUILD_DIR``, by default ``bumpcosmology_torch/_build/``
(git-ignored; ``utils.enable_compilation_cache`` moves it), under a name
that carries a hash of the source, the ``csrc/*.cuh`` headers it includes
and the flags, so an edited source or header is rebuilt and an unchanged
one is reused.  :func:`build_kernels` starts one ``nvcc`` per source, all
at once.  ``csrc/families.cu`` (kernel F) and ``csrc/tables.cu`` (kernel T)
add ``-fmad=false``: they keep the eager twin's roundings, no multiply and
add fused into one.

Nothing here runs at import time: the CPU test host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["KERNEL_SOURCES", "DEFAULT_BUILD_DIR", "BUILD_DIR", "build_kernels", "load_kernel", "kernel_function",
           "check_cuda", "cuda_stream", "raise_on"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR
KERNEL_SOURCES = ("bump", "logwts", "snr", "floor", "priors", "families", "tables")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCTIONS: Dict[tuple, object] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin): "
                       "the CUDA kernels are built from source on first use")


# flags a source adds to NVCC_FLAGS
EXTRA_FLAGS = {"families": ("-fmad=false",), "tables": ("-fmad=false",)}


def _flags(name: str) -> tuple:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def _sources(name: str) -> bytes:
    """``csrc/<name>.cu`` and the ``csrc`` headers it includes, each once, in the order first included."""
    seen, out, todo = set(), [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.add(f)
        text = (CSRC / f).read_bytes()
        out.append(text)
        todo += [h.decode() for h in re.findall(rb'#include "([\w.]+)"', text)]
    return b"".join(out)


def _target(name: str) -> Path:
    digest = hashlib.sha256(_sources(name) + " ".join(_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_kernels(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every (or the named) kernel source that has no up-to-date
    library yet, one ``nvcc`` process per source, all started together.

    Returns ``{name: ptxas report}`` for the sources compiled by this call.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = tuple(names or KERNEL_SOURCES)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
        reports[name] = text
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return reports


def check_cuda(t, shape, name: str) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous float32 CUDA tensor, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def cuda_stream(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, as a ctypes pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code (a refused launch never runs)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def load_kernel(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed.

    ``signatures`` maps each exported C function to ``(argtypes, restype)``;
    they are set once, when the library is first loaded (ctypes would
    otherwise pass every pointer as a 32-bit int).
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_kernels([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = lib
        return lib


def kernel_function(name: str, fn: str, signatures: Dict[str, tuple]):
    """The bound C function ``fn`` of ``csrc/<name>.cu``, cached after its
    first use so that a hot wrapper pays one dictionary lookup per call."""
    f = _FUNCTIONS.get((name, fn))
    if f is None:
        f = _FUNCTIONS[(name, fn)] = getattr(load_kernel(name, signatures), fn)
    return f
