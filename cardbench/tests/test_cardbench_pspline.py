"""The POWER LAW + SPLINE cell, ``gwtc3_pspline.nuts``, on the CPU: its plain
reference (``reference/pspline_joint.py``) against the port in float64 at a
tiny cut of the committed catalog; the configuration at a tiny size, from a
state that the port's own warmup makes here, through ``harness`` with the
cell's limits; ``correct`` false for one spline height's cotangent dropped,
for one row's interval shifted by one knot and for the lower-precision
control; and ``counts_pspline``'s bound by hand at the cell's shape."""
import json
import math
import shutil
import time

import numpy as np
import pytest
import torch

from cardbench import counts, counts_pspline, harness
from cardbench.reference import pspline_joint as ref
from conftest import BENCH, REPO
from test_cardbench_families import adapted_state

CELL = "gwtc3_pspline.nuts"
CONFIG = "gwtc3_pspline"
TINY = dict(events=4, pe_samples=32, injections=512, n_grid=32, n_z=64)


def tiny_raw():
    config = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    return harness.cut_catalog(harness.read_catalog(harness.data_path(config, "catalog")), TINY["events"],
                               TINY["pe_samples"], TINY["injections"])


def test_the_reference_is_the_ports_potential_in_float64():
    """In float64 the reference's log-likelihood and its gradient by the 30
    sites equal the port's at 4 chains of seeded prior draws: 1e-12 and
    1e-10 of 1 + |reference| (the same equations in another order, the
    spline by another formula; read 3e-16 and 8e-15)."""
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import constrain, prior_sample

    raw = tiny_raw()
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in raw.items()}
    data = lk.PopCosmoData(events=lk.EventData(t["ev_a"], t["ev_q"], t["ev_c"], t["ev_lp"]),
                           selection=lk.SelectionData(t["sel_a"], t["sel_q"], t["sel_c"], t["sel_lp"], t["sel_ln"]))
    spec = lk.MASS_FAMILIES["pspline"].cosmo_spec(data, n_grid=TINY["n_grid"], n_z=TINY["n_z"], device="cpu")
    assert list(spec.priors) == list(ref.NAMES)
    sites = constrain(spec, prior_sample(spec, torch.Generator().manual_seed(2**31 + 2501), (4,)).double())
    ev = {k: raw["ev_" + k][None] for k in ("a", "q", "c", "lp")}
    sel = {k: raw["sel_" + k][None] for k in ("a", "q", "c", "lp")}
    cat = ref.catalogs(ev, sel, np.asarray([float(raw["sel_ln"])]), torch.float64, "cpu")
    bounds = ref.dl_bounds(raw["ev_c"], raw["sel_c"], 0.05)
    leaves = {k: sites[k].detach().requires_grad_(True) for k in ref.NAMES}
    ll = spec.loglike(leaves)
    grads = torch.autograd.grad(ll.sum(), [leaves[k] for k in ref.NAMES], allow_unused=True)
    g = torch.stack([torch.zeros_like(ll) if x is None else x for x in grads], dim=1)
    ll_r, g_r = ref.loglike_and_site_grad({k: v.detach() for k, v in sites.items()}, cat, TINY["n_grid"],
                                          TINY["n_z"], bounds)
    assert float(((ll.detach() - ll_r).abs() / (1 + ll_r.abs())).max()) < 1e-12
    assert float(((g - g_r).abs() / (1 + g_r.abs())).max()) < 1e-10


# ---------------------------------------------------------------------------
# The cell at a tiny size, judged
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pspline_bench(tmp_path_factory):
    """(manifest, bench_dir) of ``gwtc3_pspline.nuts`` at a tiny size with
    the benchmark's own traffic mix (cut as ``tiny_bench`` cuts it), readers
    and limits, its 4 chains and a state that the port's warmup makes here
    on the cut catalog."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bench = tmp_path_factory.mktemp("pspline") / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for f in (BENCH / "limits").glob("*.json"):
        shutil.copy(f, bench / "limits" / f.name)
    config = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
    config.update(catalog=str(BENCH / "data" / "flagship_catalog.npz"), **TINY)
    state, digest = adapted_state("pspline", config, bench, bench / "pspline_warmup.npz")
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


def run(pspline_bench, seconds=2.0, trace=False, seed=2**31 + 25020):
    manifest, bench = pspline_bench
    rc, result, lines = harness.run_benchmark(manifest, CELL, seed, seconds, trace, "cpu", time.perf_counter(),
                                              bench_dir=bench, root=bench, log=lambda msg: None)
    assert rc == 0 and result is not None
    assert [line.split()[1] for line in lines] == list(harness.NUMBERS)
    return result


def failing(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


def test_the_program_as_it_is_is_correct(pspline_bench):
    result = run(pspline_bench)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "leapfrog_ms_p95"}
    assert all(c["value"] <= c["limit"] / 3 for c in result["checks"].values()), result["checks"]


def test_a_traced_run_reads_the_spline_span(pspline_bench):
    """The traced run reads ``spline_ms`` inside ``tables_ms`` beside
    ``qnorm_ms``; kernel F's roofline reads nothing where F did not run
    (the CPU takes the eager twin)."""
    result = run(pspline_bench, seconds=1.5, trace=True, seed=2**31 + 25021)
    metrics = result["metrics"]
    assert result["correct"] is True
    assert {"spline_ms", "qnorm_ms", "tables_ms", "loglike_ms", "priors_ms", "sampler_self_ms",
            "leapfrog_ms_mean", "host_syncs_per_leapfrog"} <= set(metrics)
    assert 0.0 < metrics["spline_ms"]["value"] < metrics["tables_ms"]["value"]
    assert metrics["spline_ms"]["value"] + metrics["qnorm_ms"]["value"] <= metrics["tables_ms"]["value"]
    assert "f_pspline_bwd_roofline" not in metrics and "mfu.leapfrog" not in metrics


def no_height_cotangent(monkeypatch):
    """The cotangent of the spline's twelfth height (its knot at 23.5 Msun, among the events' masses)
    dropped, its value kept."""
    from bumpcosmology_torch.inference import likelihoods as lk

    real = lk.pspline_from_sites

    def from_sites(sites):
        return real({**sites, "f_12": sites["f_12"].detach()})

    monkeypatch.setattr(lk, "pspline_from_sites", from_sites)


def shifted_interval(monkeypatch):
    """The first PE sample of the first event reads the cubic of the
    interval next to its own (one knot up, or down from the last)."""
    from bumpcosmology_torch.models import pspline

    def log_spline(coef, m1, log_m1):
        lo, t = pspline.unit_bracket(log_m1, pspline.X0, pspline.H, pspline.N_KNOTS)
        if m1.shape[-1] > 1:  # a query table's rows, not the pivot's one
            lo = lo.clone()
            lo[..., 0] = torch.where(lo[..., 0] < pspline.N_KNOTS - 2, lo[..., 0] + 1, lo[..., 0] - 1)
        c0, c1, c2, c3 = pspline.take_rows(coef, lo).unbind(-1)
        f = c0 + t * (c1 + t * (c2 + t * c3))
        return torch.where((m1 >= pspline.M_KNOT_LO) & (m1 <= pspline.M_KNOT_HI), f, 0.0)

    monkeypatch.setattr(pspline, "log_spline", log_spline)


@pytest.mark.parametrize("fault, numbers", [(no_height_cotangent, {"grad_gap"}),
                                            (shifted_interval, {"value_gap"})])
def test_a_broken_spline_is_not_correct(pspline_bench, monkeypatch, fault, numbers):
    fault(monkeypatch)
    result = run(pspline_bench)
    assert result["correct"] is False and result["failed"] > 0
    assert numbers <= failing(result)


def test_the_lower_precision_control_is_not_correct(pspline_bench):
    """The reference in the program's place, in float32 with every stage
    rounded to TF32 (and the leapfrog run in TF32): it breaks every one of
    the cell's limits; the program keeps every one."""
    from cardbench import limits

    manifest, bench = pspline_bench
    cell_entry, config_entry = harness.cell_of(manifest, CELL)
    cell = harness.Cell(harness.load_config(config_entry, bench),
                        harness.load_traffic(cell_entry["traffic"], bench), "cpu", bench)
    lim = harness.limits_of(CELL, bench)
    (row,) = limits.readings(cell, [2**31 + 25099], 1.5, "cpu", lambda: None, lim)
    assert all(row["program"][k] <= lim[k] for k in harness.NUMBERS)
    assert all(row["control"][k] > lim[k] for k in harness.NUMBERS), row["control"]
    assert math.isfinite(row["control"]["value_gap"])


def test_the_bound_by_hand_at_the_cells_shape():
    """The backward's bound at the cell's shape: 4 chains x 38,912 rows of
    144 + 4 + 290 FP32 operations (the forward recomputed, the row's
    cotangent, its chain rule), 68,173,824 in all, at 67 TFLOP/s: 1.01752 us;
    the bytes, 38,912 x 16 of rows and 4 x 4 x (2 (2,048 + 256 + 76 + 11) +
    2 x 57) of tables, cotangents and segments, 700,928 at 3.35 TB/s, take
    0.209 us, so the operations bound it."""
    assert sum(n for _, _, n in counts_pspline.ROW_FWD) == 144
    assert sum(n for _, _, n in counts_pspline.ROW_BWD) == 290
    assert counts_pspline.row_bwd_ops() == 438
    ops, n_bytes = 4 * 38912 * 438, 38912 * 16 + 4 * 4 * (2 * (2048 + 256 + 76 + 11) + 2 * 57)
    assert (ops, n_bytes) == (68173824, 700928)
    got = counts_pspline.f_pspline_bwd_bound_s(4, 38912, 1024, 256, 56, per_chain=False)
    assert got == pytest.approx(ops / counts.FP32_OPS_PER_S, rel=1e-12) == pytest.approx(1.01752e-6, rel=1e-5)
    assert n_bytes / counts.HBM_BYTES_PER_S < got


def test_the_roofline_reads_the_pspline_backward_by_its_name():
    """``f_pspline_bwd_roofline`` sums the device time of F's backward with
    the family code 2 alone (not POWER-LAW+PEAK's, code 0), pairs each launch
    with its value+grad's chains, and reads nothing without such a launch."""
    w = harness.Window(1.0)
    w.entries, w.chains, w.stretch_first, w.stretch_stop = [0.0, 0.1, 0.2], [4, 4, 2], 0, 3
    name = "void (anonymous namespace)::families_bwd_kernel<float, 2, false, false>(float const*, float const*)"
    other = name.replace("<float, 2,", "<float, 0,")
    trace = {"device": [(0.0, 100.0, name), (200.0, 300.0, name), (400.0, 450.0, name), (500.0, 900.0, other)]}
    shapes = dict(family="pspline", n_grid=256, n_z=1024, queries=38912, nobs=56, per_chain=False)
    read = harness.load_reader("f_pspline_bwd_roofline")
    got = read(harness.Run(w, trace, shapes, counts.H100_MAX_SM_CLOCK_HZ))
    bound = sum(counts_pspline.f_pspline_bwd_bound_s(c, 38912, 1024, 256, 56, False) for c in (4, 4, 2))
    assert got == pytest.approx(100.0 * bound / 250e-6, rel=1e-12)
    assert read(harness.Run(w, {"device": trace["device"][3:]}, shapes, counts.H100_MAX_SM_CLOCK_HZ)) is None
