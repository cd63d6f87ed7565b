"""The POWER LAW + PEAK cell, ``flagship_plpeak.nuts``, on the CPU: its plain
reference (``reference/plpeak_joint.py``) against the port's
``plpeak_cosmo_model_spec`` in float64 at a tiny cut of the committed
catalog; the configuration at a tiny size, from a state that the port's own
warmup makes here, through ``harness.measure`` and ``judge`` with the cell's
limits; and ``correct`` false for a broken family route and for the
lower-precision control."""
import json
import math
import shutil
import time

import numpy as np
import pytest
import torch

from cardbench import harness
from cardbench.reference import plpeak_joint as ref
from conftest import BENCH, REPO
from test_cardbench_families import adapted_state

CELL = "flagship_plpeak.nuts"
CONFIG = "flagship_plpeak"
TINY = dict(events=4, pe_samples=32, injections=512, n_grid=32, n_z=64)

# Sites placed at the model's edges, one chain each: a narrow taper (most
# secondaries q m1 in the taper's foot below log S = -8) and mmax at its
# lowest (most primaries on the power law's soft wall); a wide taper holding
# most primaries inside it and the steepest slopes; alpha within 1e-13 of 1
# (the power law's norm on its series branch); a narrow, dominant peak.
EDGES = {
    "h": (0.7, 0.36, 1.39, 0.68), "Om": (0.3, 0.02, 0.95, 0.31), "w": (-1.0, -1.45, -0.55, -0.9),
    "alpha": (2.5, 11.9, 1.0 - 1e-13, -3.9), "beta_q": (1.0, -3.9, 0.0, 11.9),
    "mmin": (8.0, 9.5, 2.1, 5.0), "mmax": (30.05, 99.9, 60.0, 45.0), "lam_peak": (0.3, 0.001, 0.5, 0.99),
    "mu_m": (45.0, 21.0, 35.0, 20.2), "sigma_m": (8.0, 9.9, 3.0, 1.01), "delta_m": (0.05, 9.95, 4.0, 0.001),
    "lam": (2.7, -1.2, 6.6, 0.0), "dkappa": (3.0, 1.1, 6.8, 2.0), "zp": (1.9, 0.05, 3.8, 1.0),
    "R_unit": (0.0, 1.0, -1.0, 0.5),
}


def tiny_raw():
    config = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    return harness.cut_catalog(harness.read_catalog(harness.data_path(config, "catalog")), TINY["events"],
                               TINY["pe_samples"], TINY["injections"])


def port_spec(raw):
    from bumpcosmology_torch.inference import likelihoods as lk

    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in raw.items()}
    data = lk.PopCosmoData(events=lk.EventData(t["ev_a"], t["ev_q"], t["ev_c"], t["ev_lp"]),
                           selection=lk.SelectionData(t["sel_a"], t["sel_q"], t["sel_c"], t["sel_lp"], t["sel_ln"]))
    return lk.MASS_FAMILIES["plpeak"].cosmo_spec(data, n_grid=TINY["n_grid"], n_z=TINY["n_z"], device="cpu")


def reference_inputs(raw):
    ev = {k: raw["ev_" + k][None] for k in ("a", "q", "c", "lp")}
    sel = {k: raw["sel_" + k][None] for k in ("a", "q", "c", "lp")}
    cat = ref.catalogs(ev, sel, np.asarray([float(raw["sel_ln"])]), torch.float64, "cpu")
    return cat, ref.dl_bounds(raw["ev_c"], raw["sel_c"], 0.05)


@pytest.mark.parametrize("draw", ["prior", "edges"])
def test_the_reference_is_the_ports_potential_in_float64(draw):
    """In float64 the reference's log-likelihood and its gradient by the
    sites equal the port's (the same equations computed in another order),
    at 4 chains of seeded prior draws and at sites on the model's edges;
    so does the whole potential and its gradient by the positions.

    Tolerances, each of |port - reference| / (1 + |reference|): 1e-12 for
    the log-likelihood (float64's rounding, 1e-16, over some thousand terms
    summed in another order; read 4e-16); 1e-9 for its gradient by the
    sites and for the potential's by the positions (the log-sum-exps'
    backward cancels terms of a hundred or so; read 7e-15); 1e-9 for the
    potential (the port's priors keep their constants in float32; read
    9e-11)."""
    from bumpcosmology_torch.inference.model import constrain, make_potential, prior_sample, unconstrain
    from bumpcosmology_torch.inference.model import value_and_grad as port_value_and_grad

    raw = tiny_raw()
    spec = port_spec(raw)
    assert list(spec.priors) == list(ref.NAMES)
    if draw == "prior":
        theta = prior_sample(spec, torch.Generator().manual_seed(2**31 + 5), (4,)).double()
    else:
        theta = unconstrain(spec, {k: torch.tensor(v, dtype=torch.float64) for k, v in EDGES.items()})
    sites = constrain(spec, theta)
    cat, bounds = reference_inputs(raw)
    with torch.enable_grad():
        leaves = {k: sites[k].detach().requires_grad_(True) for k in ref.NAMES}
        ll = spec.loglike(leaves)
        grads = torch.autograd.grad(ll.sum(), [leaves[k] for k in ref.NAMES], allow_unused=True)
    g = torch.stack([torch.zeros_like(ll) if x is None else x for x in grads], dim=1)
    ll_r, g_r = ref.loglike_and_site_grad({k: v.detach() for k, v in sites.items()}, cat, TINY["n_grid"],
                                          TINY["n_z"], bounds)
    assert bool(torch.isfinite(ll_r).all() and torch.isfinite(g_r).all())
    assert float(((ll.detach() - ll_r).abs() / (1 + ll_r.abs())).max()) < 1e-12
    assert float(((g - g_r).abs() / (1 + g_r.abs())).max()) < 1e-9

    u, gu = port_value_and_grad(make_potential(spec), theta)
    u_r, gu_r = ref.value_and_grad(theta, cat, TINY["n_grid"], TINY["n_z"], bounds)
    assert float(((u - u_r).abs() / (1 + u_r.abs())).max()) < 1e-9
    assert float(((gu - gu_r).abs() / (1 + gu_r.abs())).max()) < 1e-9


def test_the_pivot_cancels_from_the_log_likelihood():
    """The pivot, log_norm, is one number a chain added to every row's
    weight: it enters the events' term nobs times and the injections' term
    nobs times with the opposite sign, so the log-likelihood and its
    gradient do not depend on it (it moves only the rate).  Left out of the
    reference, they move by float64's rounding alone."""
    raw = tiny_raw()
    cat, bounds = reference_inputs(raw)
    sites = {k: torch.tensor(v, dtype=torch.float64) for k, v in EDGES.items()}
    ll, g = ref.loglike_and_site_grad(sites, cat, TINY["n_grid"], TINY["n_z"], bounds)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref, "pivot", lambda s, dm, log_nq: torch.zeros_like(s["h"]))
        ll0, g0 = ref.loglike_and_site_grad(sites, cat, TINY["n_grid"], TINY["n_z"], bounds)
    assert float(((ll0 - ll).abs() / (1 + ll.abs())).max()) < 1e-12
    assert float(((g0 - g).abs() / (1 + g.abs())).max()) < 1e-9


# ---------------------------------------------------------------------------
# The cell at a tiny size, judged
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def plpeak_bench(tmp_path_factory):
    """(manifest, bench_dir) of ``flagship_plpeak.nuts`` at a tiny size with
    the benchmark's own traffic mix (cut as ``tiny_bench`` cuts it), readers
    and limits, its 4 chains and a state that the port's warmup makes here
    on the cut catalog."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bench = tmp_path_factory.mktemp("plpeak") / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for f in (BENCH / "limits").glob("*.json"):
        shutil.copy(f, bench / "limits" / f.name)
    config = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    config.update(catalog=str(BENCH / "data" / "flagship_catalog.npz"), **TINY)
    state, digest = adapted_state("plpeak", config, bench, bench / "plpeak_warmup.npz")
    config.update(warmup_state=state, warmup_state_sha256=digest)
    (bench / "configs" / f"{CONFIG}.json").write_text(json.dumps(config))
    t = json.loads((BENCH / "traffic" / "nuts.json").read_text())
    t.update(max_depth=7, leapfrog_sample=32, trace_stretch={"after_share": 0.3, "value_and_grads": 5})
    (bench / "traffic" / "nuts.json").write_text(json.dumps(t))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        c["file"] = f"configs/{c['name']}.json"
    yield manifest, bench
    torch.set_num_threads(threads)


def run(plpeak_bench, seconds=2.0, trace=False, seed=2**31 + 20020):
    manifest, bench = plpeak_bench
    rc, result, lines = harness.run_benchmark(manifest, CELL, seed, seconds, trace, "cpu", time.perf_counter(),
                                              bench_dir=bench, root=bench, log=lambda msg: None)
    assert rc == 0 and result is not None
    assert [line.split()[1] for line in lines] == list(harness.NUMBERS)
    return result


def failing(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


def test_the_program_as_it_is_is_correct(plpeak_bench):
    result = run(plpeak_bench)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "leapfrog_ms_p95"}
    assert result["checks"]["value_gap"]["value"] <= result["checks"]["value_gap"]["limit"] / 3


def test_a_traced_run_reads_the_family_routes_spans(plpeak_bench):
    """The traced run reads ``qnorm_ms`` and ``tables_ms`` on this route,
    the one inside the other, and no kernel's roofline (none runs)."""
    result = run(plpeak_bench, seconds=1.5, trace=True, seed=2**31 + 20021)
    metrics = result["metrics"]
    assert result["correct"] is True
    assert {"qnorm_ms", "tables_ms", "loglike_ms", "priors_ms", "sampler_self_ms", "leapfrog_ms_mean",
            "outside_loglike_ms", "mfu.leapfrog", "host_syncs_per_leapfrog"} <= set(metrics)
    assert 0.0 < metrics["qnorm_ms"]["value"] <= metrics["tables_ms"]["value"] < metrics["loglike_ms"]["value"]
    assert not {"a_bump_roofline", "b_lse_bwd_roofline"} & set(metrics)


def no_qnorm(monkeypatch):
    """N_q ≡ 1: the q-norm table left out of the pairing."""
    from bumpcosmology_torch.models import plpeak

    real = plpeak._log_nq_grid

    def table(*args, **kwargs):
        dm, log_nq = real(*args, **kwargs)
        return dm, torch.zeros_like(log_nq)

    monkeypatch.setattr(plpeak, "_log_nq_grid", table)


def one_chain(monkeypatch):
    """One event's log-sum-exp moved 0.01 nats, in the first chain only."""
    from bumpcosmology_torch.inference import likelihoods as lk

    real = lk.pop_cosmo_segment_lse

    def lse(*args, **kwargs):
        lse_ev, lse_sel = real(*args, **kwargs)
        shift = torch.zeros_like(lse_ev)
        shift[0, 0] = 0.01
        return lse_ev + shift, lse_sel

    monkeypatch.setattr(lk, "pop_cosmo_segment_lse", lse)


@pytest.mark.parametrize("fault, numbers", [(no_qnorm, {"value_gap", "grad_gap"}), (one_chain, {"value_gap"})])
def test_a_broken_family_route_is_not_correct(plpeak_bench, monkeypatch, fault, numbers):
    fault(monkeypatch)
    result = run(plpeak_bench)
    assert result["correct"] is False and result["failed"] > 0
    assert numbers <= failing(result)


def test_the_pivot_left_out_is_no_fault_of_the_log_likelihood(plpeak_bench, monkeypatch):
    """With the port's pivot left out (log_norm ≡ 0) the cell's numbers stay
    within the limits: the pivot cancels from the log-likelihood
    (:func:`test_the_pivot_cancels_from_the_log_likelihood`), so no check of
    the log-likelihood or the sampler can see it."""
    from bumpcosmology_torch.models import plpeak

    monkeypatch.setattr(plpeak, "_pivot_log_norm", lambda intensity: torch.zeros_like(intensity.log_norm))
    result = run(plpeak_bench)
    assert result["correct"] is True


def test_the_lower_precision_control_is_not_correct(plpeak_bench):
    """The reference in the program's place, in float32 with every stage
    rounded to TF32 (and the leapfrog run in TF32): it breaks at least one
    of the cell's limits; the program keeps every one."""
    from cardbench import limits

    manifest, bench = plpeak_bench
    cell_entry, config_entry = harness.cell_of(manifest, CELL)
    cell = harness.Cell(harness.load_config(config_entry, bench),
                        harness.load_traffic(cell_entry["traffic"], bench), "cpu", bench)
    lim = harness.limits_of(CELL, bench)
    (row,) = limits.readings(cell, [2**31 + 20099], 1.5, "cpu", lambda: None, lim)
    assert all(row["program"][k] <= lim[k] for k in harness.NUMBERS)
    assert any(row["control"][k] > lim[k] for k in harness.NUMBERS)
    assert row["control"]["leapfrog_gap"] > lim["leapfrog_gap"]
    assert math.isfinite(row["control"]["value_gap"])
