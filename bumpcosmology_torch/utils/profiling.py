"""Profiling and phase timing (L4); counterpart of the JAX package's
``utils/profiling.py``.

* :func:`trace` — a ``torch.profiler`` context (host and, on a card, CUDA
  activity) that writes a Chrome trace under ``log_dir``;
* :class:`PhaseTimer` — wall-clock phases (warmup, sampling, ...) with a
  readable report; a phase waits for the card when told what to wait on.

The JAX package's ``xla_cost`` (XLA's static flops and bytes of a jitted
function) has no counterpart: the port compiles nothing with XLA.  The
nearest thing is the bound that ``tools/kernel_times.py`` and
``chip_smoke.py`` compute for each hand-written kernel (the bytes it must
move and the operations it must do, over the card's peak rates).
"""
from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict

import torch

__all__ = ["trace", "PhaseTimer"]


@contextlib.contextmanager
def trace(log_dir):
    """``with trace("prof"): ...`` — profile the block; on leaving it, write
    ``<log_dir>/trace-<pid>-<n>.json`` (Chrome trace format, readable by
    Perfetto or ``chrome://tracing``).  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    n = len(list(log_dir.glob(f"trace-{os.getpid()}-*.json")))
    prof.export_chrome_trace(str(log_dir / f"trace-{os.getpid()}-{n}.json"))


def _wait_for(x) -> None:
    """Synchronise the card of every CUDA tensor in ``x`` (a tensor or nested containers of them)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _wait_for(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _wait_for(v)


class PhaseTimer:
    """Accumulate named wall-clock phases; print a one-line-per-phase report."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; ``block_on`` (a tensor, or containers of tensors)
        is waited for on its card before the clock stops, as the JAX
        package's ``block_until_ready`` waits."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{k:24s} {v:9.2f}s ({100 * v / total:5.1f}%)" for k, v in self.phases.items()]
        lines.append(f"{'total':24s} {total:9.2f}s")
        return "\n".join(lines)
