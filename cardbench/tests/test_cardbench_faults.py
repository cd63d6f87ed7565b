"""``correct`` comes out false when the timed path is broken underneath, and
for the lower-precision control; true for the program as it is.  Runs the
whole of a run but the look for a card, at a tiny size on the CPU, with the
cell's own limits and its own 4 chains.

The faults a cell of this benchmark can have: a value+grad that returns a
state unchanged (the first one's), half of the batch left out with the mean
taken over the rest (half of each event's PE samples and of the
injections), an answer altered where it is produced (one event's
log-sum-exp moved by 0.01 nats, in every chain or in one chain only), and
an integrator that is wrong (the mass matrix dropped, or the momentum's
second half-step left out).  No cell runs across chips, so there is no
exchange between chips to leave out."""
import math
import time

import pytest
import torch

from cardbench import harness
from conftest import CELL


def run(tiny_bench, seconds=2.0, trace=False, seed=2**31 + 12345):
    manifest, bench = tiny_bench
    rc, result, lines = harness.run_benchmark(manifest, CELL, seed, seconds, trace, "cpu", time.perf_counter(),
                                              bench_dir=bench, root=bench, log=lambda msg: None)
    assert rc == 0 and result is not None
    assert [line.split()[1] for line in lines] == list(harness.NUMBERS)
    assert list(result)[-1] == "checks"
    return result


def failing(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


def stale(monkeypatch):
    from bumpcosmology_torch.inference import likelihoods as lk

    real, seen = lk.cosmo_frame_logwts_lse, {}

    def lse(*args, **kwargs):
        out = real(*args, **kwargs)
        return seen.setdefault(tuple(out[0].shape), tuple(x.detach() for x in out))

    monkeypatch.setattr(lk, "cosmo_frame_logwts_lse", lse)


def half_batch(monkeypatch):
    from bumpcosmology_torch.inference import likelihoods as lk

    def lse(pop, det, qry, nobs, nsamp, plain=False):
        lw = lk.cosmo_frame_logwts(pop, det, qry, plain)
        c, n_ev = lw.shape[0], nobs * nsamp
        ev = lw[:, :n_ev].reshape(c, nobs, nsamp)[..., : nsamp // 2]
        sel = lw[:, n_ev:]
        h = sel.shape[1] // 2
        return (torch.logsumexp(ev, -1) + math.log(nsamp / (nsamp // 2)),
                torch.logsumexp(sel[:, :h], -1) + math.log(sel.shape[1] / h))

    monkeypatch.setattr(lk, "cosmo_frame_logwts_lse", lse)


def altered(monkeypatch, chains=slice(None)):
    from bumpcosmology_torch.inference import likelihoods as lk

    real = lk.cosmo_frame_logwts_lse

    def lse(*args, **kwargs):
        lse_ev, lse_sel = real(*args, **kwargs)
        shift = torch.zeros_like(lse_ev)
        shift[chains, 0] = 0.01
        return lse_ev + shift, lse_sel

    monkeypatch.setattr(lk, "cosmo_frame_logwts_lse", lse)


def one_chain(monkeypatch):
    altered(monkeypatch, chains=slice(0, 1))


def no_mass_matrix(monkeypatch):
    from bumpcosmology_torch.inference import nuts

    monkeypatch.setattr(nuts, "_matvec", lambda cov, p: p)


def no_second_half_step(monkeypatch):
    from bumpcosmology_torch.inference import nuts

    def leapfrog(vg, theta, p, grad, eps, cov):
        e = eps[:, None]
        p_half = p - 0.5 * e * grad
        theta_new = theta + e * nuts._matvec(cov, p_half)
        u_new, grad_new = vg(theta_new)
        return theta_new, p_half, u_new, grad_new

    monkeypatch.setattr(nuts, "_leapfrog", leapfrog)


def test_the_program_as_it_is_is_correct(tiny_bench):
    result = run(tiny_bench)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "leapfrog_ms_p95"}


@pytest.mark.parametrize("fault, numbers", [
    (stale, {"value_gap", "grad_gap"}), (half_batch, {"value_gap"}), (altered, {"value_gap"}),
    (one_chain, {"value_gap"}), (no_mass_matrix, {"leapfrog_gap"}), (no_second_half_step, {"leapfrog_gap"})])
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, fault, numbers):
    fault(monkeypatch)
    result = run(tiny_bench)
    assert result["correct"] is False and result["failed"] > 0
    assert numbers <= failing(result)


def test_the_lower_precision_control_is_not_correct(tiny_bench):
    """The reference in the program's place, in float32 with every stage
    rounded to TF32 (and the leapfrog run in TF32): its numbers break the
    cell's limits; the program's keep them."""
    from cardbench import limits

    manifest, bench = tiny_bench
    cell_entry, config_entry = harness.cell_of(manifest, CELL)
    cell = harness.Cell(harness.load_config(config_entry, bench),
                        harness.load_traffic(cell_entry["traffic"], bench), "cpu", bench)
    lim = harness.limits_of(CELL, bench)
    (row,) = limits.readings(cell, [2**31 + 99], 1.5, "cpu", lambda: None, lim)
    assert all(row["program"][k] <= lim[k] for k in harness.NUMBERS)
    assert all(row["control"][k] > lim[k] for k in harness.NUMBERS)


def test_a_traced_run_reads_the_per_layer_metrics(tiny_bench):
    result = run(tiny_bench, seconds=1.5, trace=True, seed=7)
    assert result["correct"] is True
    # the CPU records no device activity: the device readers find nothing, or nothing but idle time
    assert {"leapfrog_ms_mean", "outside_loglike_ms", "mfu.leapfrog"} <= set(result["metrics"])
    assert "setup_s" not in result["metrics"] and "breakdown" in result
    assert 0.0 < result["metrics"]["mfu.leapfrog"]["value"] < 100.0
