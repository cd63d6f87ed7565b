"""Profiling, the program's spans and counters, and phase timing (L4);
counterpart of the JAX package's ``utils/profiling.py``.

* :func:`trace` — a ``torch.profiler`` context (host and, on a card, CUDA
  activity) that writes a Chrome trace under ``log_dir``;
* :func:`span` — a span of the program, recorded only while the torch
  profiler records; :func:`spans` returns what was recorded;
* :func:`counters` — the program's counters, always on;
* :class:`PhaseTimer` — wall-clock phases (warmup, sampling, ...) with a
  readable report; a phase waits for the card when told what to wait on.

**A trace with the program's spans.**  ``with trace("prof"): fit(...)``
writes ``prof/trace-<pid>-<n>.json``; open it in Perfetto
(``ui.perfetto.dev``) or ``chrome://tracing``.  The profiler being on is
the one switch: while it records, each span below is a ``user_annotation``
range in that trace, on the same clock as the card's kernels, and is kept
in memory as ``(name, parent, start_ns, end_ns)`` on
``time.perf_counter_ns()``.  Nothing else turns them on, and while the
profiler is off a span costs one check.  The spans, each inside its parent:

* ``nuts.transition``: one NUTS draw of every chain (``nuts.nuts_transition``);
* ``potential.value_and_grad``: one batched value+grad, forward and backward
  (``model.value_and_grad``), inside ``nuts.transition``;
* ``potential.loglike``: the forward of the spec's log-likelihood
  (``model.make_potential``), inside ``potential.value_and_grad``;
* ``loglike.tables``: the bump table (kernel A), the cosmology and the
  detector tables, forward (``likelihoods._frame_tables``), inside
  ``potential.loglike``;
* ``loglike.backward``: the backward from the log-likelihood's output to
  its sites, recorded on autograd's thread, inside ``potential.value_and_grad``.

What a value+grad spends outside ``potential.loglike`` and
``loglike.backward`` is the priors and the transforms, forward and
backward; what a leapfrog spends between value+grads is NUTS's own work.
While tracing, the log-likelihood's sites and output pass through two
identity autograd functions that open and close ``loglike.backward``; the
autograd graph holds them only then.

The counters (:func:`counters`) are plain integers: ``model.value_and_grads``
(batched value+grads), ``nuts.host_syncs`` (reads of the device by NUTS's
transitions and its step-size search: a leapfrog's active-chain check and
its ``nonzero``, one check a subtree) and the hand-written kernels'
launches, ``cuda_bump.*``, ``cuda_logwts.*``, ``cuda_priors.*`` and ``cuda_snr.*``.

The JAX package's ``xla_cost`` (XLA's static flops and bytes of a jitted
function) has no counterpart: the port compiles nothing with XLA.  The
nearest thing is the bound that ``tools/kernel_times.py`` and
``chip_smoke.py`` compute for each hand-written kernel (the bytes it must
move and the operations it must do, over the card's peak rates).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["trace", "span", "spans", "backward_span", "counters", "PhaseTimer"]

_profiler_enabled = torch._C._autograd._profiler_enabled  # the one switch of the spans

_NULL = contextlib.nullcontext()


class _Record:
    """The spans recorded in the current profile (appended from any thread),
    whether one has been recorded in it yet, and each thread's open spans."""

    def __init__(self):
        self.spans: List[Tuple[str, Optional[str], int, int]] = []
        self.live = False
        self.local = threading.local()

    def begin(self) -> None:
        """A span opens while the profiler records: the first of a new
        profile starts the record anew."""
        if not self.live:
            self.spans = []
            self.live = True

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_RECORD = _Record()


class _Span:
    """A span opened while the profiler records; closed whatever its state
    then.  Its parent is the innermost open span of the thread unless given."""

    __slots__ = ("name", "parent", "rf", "t0")

    def __init__(self, name: str, parent: Optional[str]):
        self.name, self.parent = name, parent

    def __enter__(self):
        _RECORD.begin()
        stack = _RECORD.stack()
        if self.parent is None and stack:
            self.parent = stack[-1]
        stack.append(self.name)
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _RECORD.stack().pop()
        _RECORD.spans.append((self.name, self.parent, self.t0, t1))
        return False


def span(name: str, parent: Optional[str] = None):
    """``with span("layer.part"): ...`` — a span of the program while the
    torch profiler records (a ``record_function`` range in its trace and an
    entry of :func:`spans`); otherwise a shared context that does nothing."""
    if not _profiler_enabled():
        _RECORD.live = False
        return _NULL
    return _Span(name, parent)


def spans() -> List[Tuple[str, Optional[str], int, int]]:
    """The spans of the current (or last) profile, as ``(name, parent,
    start_ns, end_ns)`` on ``time.perf_counter_ns()``, in the order they closed."""
    return list(_RECORD.spans)


class _BackwardSpan:
    """A span that the backward pass opens in one autograd function and
    closes in another, on autograd's thread: its parent is given."""

    def __init__(self, name: str, parent: str):
        self.name, self.parent, self.rf, self.t0 = name, parent, None, 0

    def open(self) -> None:
        if _profiler_enabled():
            _RECORD.begin()
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
            self.t0 = time.perf_counter_ns()

    def close(self) -> None:
        if self.rf is not None:
            t1 = time.perf_counter_ns()
            self.rf.__exit__(None, None, None)
            self.rf = None
            _RECORD.spans.append((self.name, self.parent, self.t0, t1))


class _OpenOnBackward(torch.autograd.Function):
    """Identity on the output; its backward opens the span."""

    @staticmethod
    def forward(ctx, box, y):
        ctx.box = box
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        ctx.box.open()
        return None, grad


class _CloseOnBackward(torch.autograd.Function):
    """Identity on the inputs; its backward, once every input's gradient is
    in, closes the span.  The profiler names its forward's op after the
    class, and the benchmark's ``idle_in_sampler_pct`` moves the spans onto
    the trace's clock by that op (``cardbench/program_record.py``)."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.box.close()
        return (None,) + grads


def backward_span(name: str, parent: str, fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
                  inputs: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``fn(inputs)``.  While the profiler records, the backward from its
    output to ``inputs`` is the span ``name`` (child of ``parent``), timed by
    two identity autograd functions; otherwise the graph is ``fn``'s alone."""
    if not _profiler_enabled():
        return fn(inputs)
    box = _BackwardSpan(name, parent)
    names = list(inputs)
    marked = _CloseOnBackward.apply(box, *(inputs[k] for k in names))
    return _OpenOnBackward.apply(box, fn(dict(zip(names, marked))))


def counters() -> Dict[str, int]:
    """Every counter of the program by qualified name: the batched
    value+grads, NUTS's reads of the device and the kernels' launches."""
    from bumpcosmology_torch.inference import model, nuts
    from bumpcosmology_torch.mock import cuda_snr
    from bumpcosmology_torch.ops import cuda_bump, cuda_logwts, cuda_priors

    out = {}
    for prefix, counts in (("model", model.COUNTS), ("nuts", nuts.COUNTS), ("cuda_bump", cuda_bump.LAUNCHES),
                           ("cuda_logwts", cuda_logwts.LAUNCHES), ("cuda_priors", cuda_priors.LAUNCHES),
                           ("cuda_snr", cuda_snr.LAUNCHES)):
        out.update((f"{prefix}.{k}", v) for k, v in counts.items())
    return out


@contextlib.contextmanager
def trace(log_dir):
    """``with trace("prof"): ...`` — profile the block, the program's spans
    included; on leaving it, write ``<log_dir>/trace-<pid>-<n>.json`` (Chrome
    trace format, readable by Perfetto or ``chrome://tracing``).  Yields the
    profiler; :func:`spans` then holds the block's spans."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    _RECORD.live = False
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
