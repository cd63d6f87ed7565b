"""The port's spans and counters (``utils/profiling.py``) on a tiny joint fit
on the CPU: nothing is recorded and the autograd graph is the plain one
while the profiler is off; the draws do not depend on it; under
``profiling.trace`` the spans nest as documented, split each leapfrog's
interval exactly into sampler, priors and log-likelihood, and land in the
Chrome trace; ``model.value_and_grads`` counts every value+grad."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
from bumpcosmology_torch.inference.model import make_potential
from bumpcosmology_torch.inference.nuts import NutsConfig
from bumpcosmology_torch.inference.sampler import fit
from bumpcosmology_torch.testing import synthetic_pop_cosmo_data
from bumpcosmology_torch.utils import load_warmup, profiling

WARM = Path(__file__).resolve().parents[1] / "benchmarks" / "flagship_warmup16.npz"
SPANS = ("nuts.transition", "potential.value_and_grad", "potential.loglike", "loglike.tables", "loglike.backward")
PARENT = {"potential.value_and_grad": "nuts.transition", "potential.loglike": "potential.value_and_grad",
          "loglike.tables": "potential.loglike", "loglike.backward": "potential.value_and_grad"}
NUM_WARMUP, NUM_SAMPLES = 6, 3


def _spec():
    return pop_cosmo_model_spec(synthetic_pop_cosmo_data(4, 16, 64, seed=0, device="cpu"), n_grid=32, n_z=64,
                                device="cpu")


def _fit(spec):
    theta0 = load_warmup(WARM, device="cpu").state.theta[:2]
    return fit(spec, seed=3, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES, num_chains=2, init_theta=theta0,
               cfg=NutsConfig(max_depth=3), device="cpu", verbose=False)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    """The same fit untraced and under ``profiling.trace``: each its result,
    the spans recorded, the counters' deltas and the log-likelihood's calls."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    base = _spec()
    out = {}
    for traced in (False, True):
        calls = [0]

        def loglike(sites):
            calls[0] += 1
            return base.loglike(sites)

        spec = base._replace(loglike=loglike)
        before_spans, before = profiling.spans(), profiling.counters()
        if traced:
            log_dir = tmp_path_factory.mktemp("prof")
            with profiling.trace(log_dir):
                res = _fit(spec)
            trace_file = next(log_dir.glob("trace-*.json"))
        else:
            res, trace_file = _fit(spec), None
        after = profiling.counters()
        out[traced] = dict(res=res, spans=profiling.spans(), before_spans=before_spans, calls=calls[0],
                           counts={k: after[k] - before[k] for k in after}, trace_file=trace_file)
    yield out
    torch.set_num_threads(threads)


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


def test_with_the_profiler_off_nothing_is_recorded_and_the_graph_has_no_marker(fits):
    off = fits[False]
    assert off["spans"] == off["before_spans"]
    potential = make_potential(_spec())
    theta = load_warmup(WARM, device="cpu").state.theta[:2].clone().requires_grad_(True)
    plain = _graph_names(potential(theta))
    assert not any("OnBackward" in name for name in plain)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        marked = _graph_names(potential(theta))
    assert {"_OpenOnBackwardBackward", "_CloseOnBackwardBackward"} <= marked


def test_the_draws_are_bit_identical_with_the_profiler_on_and_off(fits):
    off, on = fits[False]["res"], fits[True]["res"]
    assert set(off.posterior) == set(on.posterior) and set(off.sample_stats) == set(on.sample_stats)
    for k in off.posterior:
        np.testing.assert_array_equal(off.posterior[k], on.posterior[k], err_msg=k)
    for k in off.sample_stats:
        np.testing.assert_array_equal(off.sample_stats[k], on.sample_stats[k], err_msg=k)


@pytest.mark.parametrize("child", sorted(PARENT))
def test_under_trace_the_spans_nest_as_documented(fits, child):
    """Each span names its documented parent and lies inside a span of that
    name; a value+grad made outside a transition (the state's recomputation,
    the warmup's first one) names none and lies inside none."""
    spans = fits[True]["spans"]
    by_name = {n: [(s, e) for m, _, s, e in spans if m == n] for n in SPANS}
    assert len(by_name["nuts.transition"]) == NUM_WARMUP + NUM_SAMPLES
    parent = PARENT[child]
    kids = [(p, s, e) for n, p, s, e in spans if n == child]
    assert kids
    for p, s, e in kids:
        inside = [ps <= s and e <= pe for ps, pe in by_name[parent]]
        if p is None:
            assert child == "potential.value_and_grad" and not any(inside)
        else:
            assert p == parent and sum(inside) == 1


def test_the_readers_split_each_interval_exactly(fits, monkeypatch):
    """sampler_self_ms + priors_ms + loglike_ms is the mean interval from one
    value+grad's start to the next's, and each part is positive."""
    from cardbench import harness, program_record

    vgs = program_record.value_and_grads(fits[True]["spans"])
    assert vgs and len(vgs) >= NUM_SAMPLES
    monkeypatch.setattr(program_record, "program_spans", lambda: fits[True]["spans"])
    parts = {name: harness.load_reader(name)(None) for name in ("sampler_self_ms", "priors_ms", "loglike_ms",
                                                                 "tables_ms")}
    assert all(v > 0.0 for v in parts.values())
    interval = 1e-6 * sum(v["next"] - v["start"] for v in vgs) / len(vgs)
    total = parts["sampler_self_ms"] + parts["priors_ms"] + parts["loglike_ms"]
    assert total == pytest.approx(interval, rel=1e-12)
    assert parts["tables_ms"] < parts["loglike_ms"]


def test_the_chrome_trace_holds_every_span_as_a_user_annotation(fits):
    """Every span lands in the trace; the program names none as the benchmark's (``cardbench.*``)."""
    events = json.loads(Path(fits[True]["trace_file"]).read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert set(SPANS) <= names
    assert {n for n, _, _, _ in fits[True]["spans"]} == set(SPANS)


@pytest.mark.parametrize("traced", [False, True])
def test_the_value_and_grads_counter_counts_every_log_likelihood_call(fits, traced):
    f = fits[traced]
    assert f["calls"] > NUM_WARMUP + NUM_SAMPLES
    assert f["counts"]["model.value_and_grads"] == f["calls"]
    # a leapfrog reads the device twice; the warmup's first value+grad and the
    # state's recomputation read it not at all, the step-size search's first once
    assert f["counts"]["nuts.host_syncs"] >= 2 * (f["calls"] - 2) - 1


# ---------------------------------------------------------------------------
# The families' joint route: ``loglike.tables`` around the family's intensity
# and the cosmology and detector tables, ``loglike.qnorm`` around the q-norm
# table and pivot inside it
# ---------------------------------------------------------------------------

FAMILY_PARENT = {"loglike.qnorm": "loglike.tables", "loglike.tables": "potential.loglike"}


def _family_fit(spec):
    return fit(spec, seed=5, num_warmup=NUM_WARMUP, num_samples=NUM_SAMPLES, num_chains=2,
               cfg=NutsConfig(max_depth=3), device="cpu", verbose=False)


@pytest.fixture(scope="module", params=["plpeak", "brokenpl"])
def family_fits(request):
    """A tiny joint fit of a power-law-in-q family, untraced and under the
    torch profiler: each its result and the spans recorded."""
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    spec = MASS_FAMILIES[request.param].cosmo_spec(synthetic_pop_cosmo_data(4, 16, 64, seed=1, device="cpu"),
                                                   n_grid=32, n_z=64, device="cpu")
    out = {}
    for traced in (False, True):
        before = profiling.spans()
        if traced:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                res = _family_fit(spec)
        else:
            res = _family_fit(spec)
        out[traced] = dict(res=res, spans=profiling.spans(), before_spans=before)
    yield out
    torch.set_num_threads(threads)


def test_family_route_records_nothing_with_the_profiler_off(family_fits):
    off = family_fits[False]
    assert off["spans"] == off["before_spans"]


def test_family_route_draws_are_bit_identical_with_the_profiler_on_and_off(family_fits):
    off, on = family_fits[False]["res"], family_fits[True]["res"]
    assert set(off.posterior) == set(on.posterior)
    for k in off.posterior:
        np.testing.assert_array_equal(off.posterior[k], on.posterior[k], err_msg=k)
    for k in off.sample_stats:
        np.testing.assert_array_equal(off.sample_stats[k], on.sample_stats[k], err_msg=k)


@pytest.mark.parametrize("child", sorted(FAMILY_PARENT))
def test_family_route_spans_nest_qnorm_in_tables_in_the_loglike(family_fits, child):
    """Every ``loglike.qnorm`` lies in one ``loglike.tables``, every
    ``loglike.tables`` in one ``potential.loglike``, each naming it, and
    each forward of the log-likelihood builds the tables once."""
    spans = family_fits[True]["spans"]
    parent = FAMILY_PARENT[child]
    outer = [(s, e) for n, _, s, e in spans if n == parent]
    kids = [(p, s, e) for n, p, s, e in spans if n == child]
    assert kids and len(kids) == len([n for n, _, _, _ in spans if n == "potential.loglike"])
    for p, s, e in kids:
        assert p == parent and sum(ps <= s and e <= pe for ps, pe in outer) == 1


def test_family_route_readers_split_each_interval(family_fits, monkeypatch):
    """sampler_self_ms + priors_ms + loglike_ms is the mean interval of the
    complete value+grads, as on the bump, and the q-norm table is a part of
    the tables, which are a part of the log-likelihood."""
    from cardbench import harness, program_record

    spans = family_fits[True]["spans"]
    vgs = program_record.value_and_grads(spans)
    assert vgs and len(vgs) >= NUM_SAMPLES
    monkeypatch.setattr(program_record, "program_spans", lambda: spans)
    parts = {name: harness.load_reader(name)(None) for name in ("sampler_self_ms", "priors_ms", "loglike_ms",
                                                                 "tables_ms", "qnorm_ms")}
    assert all(v > 0.0 for v in parts.values())
    interval = 1e-6 * sum(v["next"] - v["start"] for v in vgs) / len(vgs)
    assert parts["sampler_self_ms"] + parts["priors_ms"] + parts["loglike_ms"] == pytest.approx(interval, rel=1e-12)
    assert parts["qnorm_ms"] <= parts["tables_ms"] < parts["loglike_ms"]


def test_the_q_norm_reader_reads_nothing_on_the_bump(fits, monkeypatch):
    """The bump's route has no q-norm table: ``qnorm_ms`` is ``None`` there,
    as on a program that records no such span."""
    from cardbench import harness, program_record

    monkeypatch.setattr(program_record, "program_spans", lambda: fits[True]["spans"])
    assert harness.load_reader("qnorm_ms")(None) is None
    monkeypatch.setattr(program_record, "program_spans", lambda: None)
    assert harness.load_reader("qnorm_ms")(None) is None
