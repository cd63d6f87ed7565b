"""The readers of the port's own spans and counters (``program_record.py``
and the six metrics on it), on a synthetic run with known spans, counters
and device intervals; and ``None`` from each where the program records
nothing, as a program without spans (the parent of this benchmark's
readers) records nothing."""
import sys
import types

import pytest

from cardbench import harness

READERS = ("sampler_self_ms", "priors_ms", "loglike_ms", "tables_ms", "host_syncs_per_leapfrog",
           "idle_in_sampler_pct")
T = 1000.0  # seconds on the host's perf_counter
SHIFT_US = 5e6  # the trace's clock runs this far ahead of it
MS = 1_000_000  # nanoseconds


def at(ms):
    """A time ``ms`` milliseconds after T, in perf_counter nanoseconds."""
    return int(T * 1e9) + int(ms * MS)


# value+grads at 0, 12 and 25 ms: the first two complete (a log-likelihood
# and its backward inside, a next value+grad), the third without a next
SPANS = [
    ("loglike.backward", "potential.value_and_grad", at(-5), at(-4)),  # of a value+grad the record missed
    ("loglike.tables", "potential.loglike", at(3), at(4)),
    ("potential.loglike", "potential.value_and_grad", at(2), at(6)),
    ("loglike.backward", "potential.value_and_grad", at(7), at(9)),
    ("potential.value_and_grad", "nuts.transition", at(0), at(10)),
    ("loglike.tables", "potential.loglike", at(15), at(16.5)),
    ("potential.loglike", "potential.value_and_grad", at(14), at(18)),
    ("loglike.backward", "potential.value_and_grad", at(19), at(21)),
    ("potential.value_and_grad", "nuts.transition", at(12), at(22)),
    ("potential.loglike", "potential.value_and_grad", at(27), at(31)),
    ("potential.value_and_grad", "nuts.transition", at(25), at(35)),
]
COUNTERS = {"model.value_and_grads": 100, "nuts.host_syncs": 215, "cuda_bump.bump_fwd": 100}


def trace_us(ms):
    return T * 1e6 + SHIFT_US + 1e3 * ms


def synthetic_run():
    """The harness's window entered each value+grad as its log-likelihood
    started, and its ``cardbench.loglike`` spans start 350, 500 and 300 us
    after on the shifted clock (the harness's own host work); the port's
    marker ops start 0, +10 and −10 us off its ``potential.loglike`` spans;
    the card busy 0–1, 11–11.5 and 20–24 ms."""
    entries = [T + 0.002, T + 0.014, T + 0.027]
    window = types.SimpleNamespace(entries=entries, stretch_first=0, stretch_stop=3)
    spans = [(1e6 * t + SHIFT_US + d, 1e6 * t + SHIFT_US + d + 500.0) for t, d in zip(entries, (350.0, 500.0, 300.0))]
    marks = [(trace_us(ms) + d, trace_us(ms) + d + 20.0, name) for ms, d in ((2, 0.0), (14, 10.0), (27, -10.0))
             for name in ("_CloseOnBackward", "aten::view")]
    device = [(trace_us(0), trace_us(1), "k"), (trace_us(11), trace_us(11.5), "k"), (trace_us(20), trace_us(24), "k")]
    return types.SimpleNamespace(window=window, trace={"spans": spans, "host_ops": sorted(marks), "device": device})


def program(spans, counters):
    module = types.ModuleType("bumpcosmology_torch.utils.profiling")
    module.spans, module.counters = (lambda: list(spans)), (lambda: dict(counters))
    return module


def read_all(run):
    return {name: harness.load_reader(name)(run) for name in READERS}


def test_each_reader_returns_the_known_number(monkeypatch):
    monkeypatch.setitem(sys.modules, "bumpcosmology_torch.utils.profiling", program(SPANS, COUNTERS))
    got = read_all(synthetic_run())
    assert got["sampler_self_ms"] == pytest.approx(2.5)  # 12 − 10 and 25 − 22
    assert got["priors_ms"] == pytest.approx(4.0)  # 10 − 4 − 2 twice
    assert got["loglike_ms"] == pytest.approx(6.0)
    assert got["tables_ms"] == pytest.approx(1.25)
    assert got["sampler_self_ms"] + got["priors_ms"] + got["loglike_ms"] == pytest.approx(12.5)  # (12 + 13) / 2
    assert got["host_syncs_per_leapfrog"] == pytest.approx(2.15)
    # idle 1–11, 11.5–20 and 24–25 ms (19.5 ms), of it outside the value+grads 10–11, 11.5–12 and 24–25 ms
    assert got["idle_in_sampler_pct"] == pytest.approx(100.0 * 2.5 / 19.5)


def test_the_offset_is_the_markers_median_and_its_residuals_are_kept(monkeypatch):
    """The marker ops give the offset to within their own spread; the
    harness's pairs, which the markers are looked for by, are 350 us off."""
    from cardbench import program_record

    monkeypatch.setitem(sys.modules, "bumpcosmology_torch.utils.profiling", program(SPANS, COUNTERS))
    offset, residuals = program_record.trace_offset_us(synthetic_run())
    assert offset == pytest.approx(SHIFT_US) and residuals == pytest.approx([0.0, 10.0, -10.0])
    offset, residuals = program_record.harness_offset_us(synthetic_run())
    assert offset == pytest.approx(SHIFT_US + 350.0) and residuals == pytest.approx([0.0, 150.0, -50.0])


@pytest.mark.parametrize("case", ["no_profiling_api", "nothing_recorded"])
def test_every_reader_returns_none_where_the_program_records_nothing(monkeypatch, case):
    """A program without ``spans``/``counters`` (the parent), and one whose
    profile recorded no span and which made no value+grad."""
    module = types.ModuleType("bumpcosmology_torch.utils.profiling")
    if case == "nothing_recorded":
        module = program([], {"model.value_and_grads": 0, "nuts.host_syncs": 0})
    monkeypatch.setitem(sys.modules, "bumpcosmology_torch.utils.profiling", module)
    assert read_all(synthetic_run()) == dict.fromkeys(READERS)
