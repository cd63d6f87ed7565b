"""The card's launch floor: empty kernels launched through the same ctypes
path as the port's kernels (``csrc/floor.cu``).

A kernel's time is read against these: :func:`launch_floor` is one block of 32
threads that does nothing; :func:`launch_floor_grid` is a plain grid of
``(blocks, chains)`` blocks (kernel A's forward); :func:`launch_floor_cluster`
has the launch geometry of kernel B and of kernel A's backward (one cluster of
8 blocks per chain, one ``cluster.sync()``) and does nothing else.  Nothing on the main path calls them; the on-card check times them.
"""
from __future__ import annotations

import ctypes

import torch

from bumpcosmology_torch.ops._build import kernel_function, raise_on

__all__ = ["launch_floor", "launch_floor_grid", "launch_floor_cluster"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"launch_floor": ([_P], _I), "launch_floor_grid": ([_I, _I, _I, _P], _I),
               "launch_floor_cluster": ([_I, _I, _P], _I)}


def _stream(device) -> ctypes.c_void_p:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch floor: expected a CUDA device, got {device}")
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch_floor(device="cuda") -> None:
    """Queue one empty kernel (1 block x 32 threads) on ``device``'s current stream."""
    raise_on(kernel_function("floor", "launch_floor", _SIGNATURES)(_stream(device)), "launch_floor")


def launch_floor_grid(blocks: int, chains: int, threads: int, device="cuda") -> None:
    """Queue one empty kernel of grid (``blocks``, ``chains``) x ``threads``, no clusters."""
    rc = kernel_function("floor", "launch_floor_grid", _SIGNATURES)(blocks, chains, threads, _stream(device))
    raise_on(rc, "launch_floor_grid")


def launch_floor_cluster(chains: int, threads: int, device="cuda") -> None:
    """Queue one empty kernel of grid (8, ``chains``) x ``threads`` in clusters of 8 blocks."""
    rc = kernel_function("floor", "launch_floor_cluster", _SIGNATURES)(chains, threads, _stream(device))
    raise_on(rc, "launch_floor_cluster")
