"""ctypes binding to the native C++ library of the repository's ``native/``
(L0, host); counterpart of the JAX package's ``native.py``.

``native/csrc/bumpnative.cpp`` gives an OpenMP network SNR over a batch of
injections and an alias sampler.  The library is built on first use with
``make -C native`` into the git-ignored ``native/build/``, under a lock so
that two processes do not write it at once (the card's host has make and
g++).  A build or load that fails
raises with the compiler's output: nothing falls back to another path
(the JAX package's binding swallows the failure and reports the library as
unavailable).  :func:`available` says whether the library loads; no path of
the port gates on it.  The port's own SNR (``mock/snr.py``, kernel C on the
card) is the reference the native SNR is held against.
"""
from __future__ import annotations

import ctypes
import fcntl
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "network_snr_native", "alias_sample"]

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
ABI_VERSION = 1
_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    return NATIVE_DIR / "build" / "libbumpnative.so"


def _build() -> None:
    """``make -C native``, which rebuilds only a stale library; raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    (NATIVE_DIR / "build").mkdir(parents=True, exist_ok=True)
    cmd = ["make", "-C", str(NATIVE_DIR)]
    with open(NATIVE_DIR / "build" / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as err:
            raise RuntimeError(f"bumpnative: cannot build {_lib_path()}: {err}") from err
    if proc.returncode != 0:
        raise RuntimeError(f"bumpnative: {' '.join(cmd)} failed (rc {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")


def _load() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        _build()
        lib = ctypes.CDLL(str(_lib_path()))
        lib.bumpnative_abi_version.restype = ctypes.c_int
        if lib.bumpnative_abi_version() != ABI_VERSION:
            raise RuntimeError(f"bumpnative: ABI version {lib.bumpnative_abi_version()}, expected {ABI_VERSION}")
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.bumpnative_network_snr.argtypes = [f64] * 8 + [ctypes.c_int64, ctypes.c_double, ctypes.c_double,
                                                           ctypes.c_int, f64]
        lib.bumpnative_network_snr.restype = None
        lib.bumpnative_alias_sample.argtypes = [f64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64,
                                                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        lib.bumpnative_alias_sample.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def network_snr_native(m1_det, m2_det, dl_gpc, iota, ra, dec, psi, gmst,
                       f_min: float = 10.0, f_max: float = 2048.0, n_f: int = 512):
    """Network SNR on the host in float64 (H1, L1, V1, net), OpenMP over the batch."""
    lib = _load()
    args = [np.ascontiguousarray(np.asarray(a, dtype=np.float64)) for a in
            (m1_det, m2_det, dl_gpc, iota, ra, dec, psi, gmst)]
    n = len(args[0])
    out = np.empty((n, 4), dtype=np.float64)
    lib.bumpnative_network_snr(*args, n, f_min, f_max, n_f, out)
    return {"H1": out[:, 0], "L1": out[:, 1], "V1": out[:, 2], "net": out[:, 3]}


def alias_sample(weights, k: int, seed: int) -> np.ndarray:
    """``k`` indices drawn ∝ ``weights`` by the alias method (O(1) a draw)."""
    lib = _load()
    w = np.ascontiguousarray(np.asarray(weights, dtype=np.float64))
    out = np.empty(k, dtype=np.int64)
    lib.bumpnative_alias_sample(w, len(w), k, seed, out)
    return out
