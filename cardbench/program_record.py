"""What the port records of itself, for the per-layer metrics of its layers.

The port keeps its spans in memory while the torch profiler records
(``bumpcosmology_torch.utils.profiling.spans``: ``(name, parent, start_ns,
end_ns)`` on ``time.perf_counter_ns``, the clock of the harness's
:class:`~cardbench.harness.Window`) and its counters always
(``profiling.counters``).  The traced run's profiler covers the stretch, so
the spans are the stretch's.  A value+grad is *complete* where its
``potential.value_and_grad`` span holds one ``potential.loglike`` and one
``loglike.backward`` span and the next value+grad's span starts after it; its
*interval* runs from its start to the next's.  Every function returns
``None`` where the program recorded nothing: a program without these spans
or counters.
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional

VALUE_AND_GRAD = "potential.value_and_grad"
LOGLIKE = "potential.loglike"
BACKWARD = "loglike.backward"
TABLES = "loglike.tables"
MARKER = "_CloseOnBackward"  # the profiler's name of the port's marker at the log-likelihood's sites
MATCH_US = 2000.0  # how far from the harness's pairing a marker is looked for


def program_spans() -> Optional[list]:
    """The port's spans, or ``None`` where it records none."""
    try:
        from bumpcosmology_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans() or None


def program_counters() -> Optional[Dict[str, int]]:
    """The port's counters by qualified name, or ``None`` where it has none."""
    try:
        from bumpcosmology_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def value_and_grads(spans: Optional[list] = None) -> Optional[List[dict]]:
    """The complete value+grads, in order: each its ``start``, ``end`` and
    ``next`` (the next value+grad's start) and the summed nanoseconds of
    its ``loglike``, ``backward`` and ``tables`` spans."""
    spans = program_spans() if spans is None else spans
    if not spans:
        return None
    vgs = sorted((s, e) for name, _, s, e in spans if name == VALUE_AND_GRAD)
    starts = [s for s, _ in vgs]
    inside: List[Dict[str, list]] = [{LOGLIKE: [], BACKWARD: [], TABLES: []} for _ in vgs]
    for name, _, s, e in spans:
        if name not in (LOGLIKE, BACKWARD, TABLES):
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= vgs[i][1]:
            inside[i][name].append(e - s)
    out = []
    for i, ((s, e), kids) in enumerate(zip(vgs[:-1], inside)):
        if len(kids[LOGLIKE]) == 1 and len(kids[BACKWARD]) == 1:
            out.append(dict(start=s, end=e, next=starts[i + 1], loglike=kids[LOGLIKE][0],
                            backward=kids[BACKWARD][0], tables=sum(kids[TABLES]), n_tables=len(kids[TABLES])))
    return out or None


def mean_ms(parts) -> Optional[float]:
    """The mean of nanosecond readings, in milliseconds (``None`` for none)."""
    parts = list(parts)
    return 1e-6 * sum(parts) / len(parts) if parts else None


def trace_offset_us(run, spans: Optional[list] = None) -> Optional[tuple]:
    """(offset, residuals) that move a ``perf_counter`` time onto the
    profiler's clock, in microseconds.

    The offset is the median, over the stretch's value+grads, of the trace's
    start of the port's ``_CloseOnBackward`` op (its marker at the
    log-likelihood's sites, applied first thing inside ``potential.loglike``)
    minus that ``potential.loglike`` span's start; the residuals are each
    value+grad's difference from it.  Each marker is found near the span's
    start moved by :func:`harness_offset_us`, whose pairs are a quarter to
    half a millisecond of the harness's own host work apart."""
    coarse = harness_offset_us(run)
    spans = program_spans() if spans is None else spans
    if coarse is None or not spans:
        return None
    marks = sorted(s for s, _, name in run.trace.get("host_ops", ()) if name == MARKER)
    diffs = []
    for t in sorted(1e-3 * s for name, _, s, _ in spans if name == LOGLIKE):
        j = bisect.bisect_left(marks, t + coarse[0] - MATCH_US)
        near = [m for m in marks[j:j + 2] if abs(m - t - coarse[0]) <= MATCH_US]
        if near:
            diffs.append(min(near, key=lambda m: abs(m - t - coarse[0])) - t)
    if not diffs:
        return None
    offset = statistics.median(diffs)
    return offset, [d - offset for d in diffs]


def harness_offset_us(run) -> Optional[tuple]:
    """(offset, residuals) as :func:`trace_offset_us` gives them, from the
    harness's pairs: each value+grad's ``cardbench.loglike`` span start on
    the trace minus its :class:`Window` entry time."""
    w, tr = run.window, run.trace
    if not tr or not tr.get("spans") or w.stretch_first is None:
        return None
    entries = w.entries[w.stretch_first:w.stretch_stop]
    diffs = [start - 1e6 * t for (start, _), t in zip(tr["spans"], entries)]
    if not diffs:
        return None
    offset = statistics.median(diffs)
    return offset, [d - offset for d in diffs]


def idle_outside_value_and_grads_pct(vgs: List[dict], device: list, offset_us: float) -> Optional[float]:
    """The share of the device's idle time, from the first complete
    value+grad's start to the last one's ``next``, that falls outside every
    value+grad's span; the spans moved onto the trace by ``offset_us``, the
    device's ``(start_us, end_us, name)`` intervals as the trace gives them."""
    on_trace = [(1e-3 * v["start"] + offset_us, 1e-3 * v["end"] + offset_us) for v in vgs]
    lo, hi = on_trace[0][0], 1e-3 * vgs[-1]["next"] + offset_us
    idle, end = [], lo
    for s, e, _ in sorted(device):
        if e <= end or s >= hi:
            continue
        if s > end:
            idle.append((end, s))
        end = e
    if hi > end:
        idle.append((end, hi))
    total = sum(b - a for a, b in idle)
    if total <= 0.0:
        return None
    inside = sum(max(0.0, min(b, ve) - max(a, vs)) for a, b in idle for vs, ve in on_trace if vs < b and ve > a)
    return 100.0 * (total - inside) / total
