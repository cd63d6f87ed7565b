#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bumpcosmology_torch``).

Run from the root of a checkout on a host with one NVIDIA GPU:

    python3 chip_smoke.py

It drives the port's main path — the flagship joint population + flat-wCDM
fit on ``benchmarks/flagship_catalog.npz`` (56 events x 256 PE samples plus
24,576 injections: 38,912 queries per chain), ``n_grid=256``, ``n_z=1024``,
16 chains sampled with dense-mass NUTS from ``benchmarks/flagship_warmup16.npz``
— and holds every CUDA kernel against its plain PyTorch twin:

1. build every kernel from ``bumpcosmology_torch/csrc`` (one nvcc per source),
   and time the card's launch floor: an empty kernel through the same ctypes
   path, alone and in kernel B's cluster geometry;
2. kernel A (bump table) against its twin at C=16, G=256 on the warm thetas:
   forward rtol 1e-4 / atol 5e-5, VJP to the 5 scalars rtol 2e-4 / atol 1e-5;
   the same limits, against the twin run in float64, at C=1 (the mock campaign's
   launch), at G=48 and G=100 (not multiples of a warp), at G=2100 (nine passes
   of 256 columns, more than 32 rows a warp) and at C=64; two backward launches on the same inputs
   must agree bit for bit (the reduction runs in a fixed order);
3. kernel B (detector-frame log-weights) at full size, N=38,912, K=1024,
   G=256, C=16, both epilogues, forward and backward.  ``rows``: values rtol
   2e-5 / atol 2e-5 (the same -inf rows), every cotangent rtol 5e-4 with atol
   5e-4 x the largest reference entry (float32 atomics sum in another order).
   ``lse`` (56 per-event and one selection log-sum-exp per chain, and the
   cotangents from a random (C, nobs) + (C,) cotangent): the same limits;
4. the 16-chain potential value+grad (through the ``lse`` epilogue), kernels
   against twins: |dU|/(1+|U|) < 2e-4 and |dgrad|/(1+|grad|) < 5e-3, timed with
   CUDA events;
5. ``run_sampling`` for a few NUTS draws, then the effective-sample-size
   diagnostics (``pop_cosmo_event_sel_logwts`` and ``selection_neff_terms``, the
   ``rows`` epilogue) on the last draw of every chain, with every launch count
   set to 0 just before and read just after; kernel A and the ``lse`` kernels
   must have launched once per value+grad and the ``rows`` forward at least once;
6. the mock injection campaign at the reference's size: 10^7 draws
   (seed 333,165,393) through ``draw_injection_campaign`` with the SNR
   integral on kernel C, then ``campaign_summary`` (predicted detections/yr
   in the JAX package's calibrated band, 250-2200), ``add_observation_noise``
   and ``draw_one_year_catalog(nsamp=128)``, with every launch count set to 0
   just before and read just after (kernel C and kernel A's forward must have
   launched); then kernel C against its plain twin on exactly the rows the
   campaign computed: rtol 2e-5 / atol 1e-6, the same exact zeros.

Every kernel is timed twice: ``ms`` is its device time (20 launches captured
in one CUDA graph and replayed, so the host's queueing rate is out of the
figure), ``call_ms`` the time of one call of its Python wrapper as the main
path pays it (CUDA events around 20 eager calls).

Any failure raises and exits non-zero.  The last two lines of stdout are
the ``kernels`` JSON object and ``{"ok": true, "device": {...}}``; the line
before them is the card's name and power limit from nvidia-smi.  Exits
non-zero, printing no result, when CUDA is absent or the package is not
beside this script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CATALOG = ROOT / "benchmarks" / "flagship_catalog.npz"
WARMUP16 = ROOT / "benchmarks" / "flagship_warmup16.npz"
SEED = 20261016
N_GRID, N_Z = 256, 1024
N_DRAWS = 5
MAX_DEPTH = 10

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# FP32 operations per unit of work, tallied from the kernel sources (each
# exp/log/log1p counted as one operation; the special-function unit runs
# those at a quarter of the FMA rate, so B's bounds are optimistic; A's and
# C's bounds also count special-function results, one exp per cell for A):
#   A-fwd per cell: r (2), K (2), max (1), exp(K - max): subtract, scale, ex2 (3), add (1) -> 9
#   A-bwd per cell: r (2), K - L (3), exp: scale, ex2 (2), w r (1), three moments of w (3),
#          five table-weighted sums (5) -> 16
#   B-fwd per chain-query: bracket + two lerps (14), masses (3), two mass terms (2 x 26),
#          rate and frame terms (16), sum (12) -> 97
#   B-bwd per chain-query: the forward's 97 again + two mass-term VJPs (2 x 24),
#          z/kappa/zp terms (26), 4 table scatters and the slope terms (14) -> 185
#   B lse epilogue per chain-query: forward max, exp, add, merge -> + 4;
#          backward exp(out - lse), multiply, compare -> + 3
OPS_A_FWD_PER_CELL = 9
OPS_A_BWD_PER_CELL = 16
SFU_A_PER_CELL = 1
OPS_B_FWD_PER_QUERY = 97
OPS_B_BWD_PER_QUERY = 185
OPS_B_LSE_FWD_EXTRA = 4
OPS_B_LSE_BWD_EXTRA = 3
GRAPH_LAUNCHES = 20

# Kernel C (csrc/snr.cu) does data-dependent work: a row's loop ends at the
# first grid point at or above f_cut, and each live point runs one branch.
# FP32 operations per live point (compares, the ratio, powf or the Lorentzian,
# amp, amp^2 w inv_psd, the sum): inspiral 8, merger 9, ringdown 12; per row
# 60 (masses, 4 transition frequencies, 5 powf, the amplitude, the final
# compare); per block and grid point 3 (staging f_k and w_k inv_psd_k).
# Special-function results (MUFU: powf needs at least one ex2, an IEEE
# division one rcp): 2 per inspiral/merger point (powf, division), 1 per
# ringdown point (division), 10 per row; the SFU issues 16 results per clock
# per SM.
OPS_C_INSP, OPS_C_MERG, OPS_C_RING, OPS_C_ROW, OPS_C_STAGE = 8, 9, 12, 60, 3
SFU_C_POWER_POINT, SFU_C_RING_POINT, SFU_C_ROW = 2, 1, 10
SFU_PER_CLOCK_PER_SM, H100_SMS = 16, 132
MOCK_NDRAW = 10_000_000
MOCK_SEED = 333_165_393
MOCK_NSAMP = 128
PLAIN_CHUNK = 65536


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time of one eager call of ``fn()`` over ``reps`` calls, by CUDA events
    on the stream: the wrapper call as the main path pays it (``call_ms``)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, launches: int = GRAPH_LAUNCHES, replays: int = 5, warmup: int = 3) -> float:
    """Device time of one ``fn()``: ``launches`` calls captured in one CUDA
    graph, replayed ``replays`` times between two CUDA events.  The host queues
    nothing while the graph runs, so this is the kernel's own time plus the
    card's gap between two dependent graph nodes (``ms``)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (launches * replays)


def both_ms(fn, **graph_kwargs):
    """(device ms, call ms) of ``fn``."""
    return graph_ms(fn, **graph_kwargs), cuda_ms(fn)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def bound_a(n_bytes: float, cells: int, ops_per_cell: int, clock_hz: float):
    """Kernel A's bound: bytes, FP32 operations, or one special-function result
    (the exp) per cell at 16 per clock per SM.  Returns (ms, by, the three times in ms)."""
    t = dict(bytes=n_bytes / HBM_BYTES_PER_S * 1e3, fp32=cells * ops_per_cell / FP32_OPS_PER_S * 1e3,
             sfu=cells * SFU_A_PER_CELL / (SFU_PER_CLOCK_PER_SM * H100_SMS * clock_hz) * 1e3)
    ms = max(t.values())
    return ms, ("bytes" if ms == t["bytes"] else "operations"), t


def check_close(name: str, got, ref, rtol: float, atol: float) -> float:
    """Raise unless |got - ref| <= atol + rtol |ref| with the same non-finite entries."""
    import torch

    if not torch.equal(torch.isfinite(got), torch.isfinite(ref)) or not torch.equal(
            torch.isneginf(got), torch.isneginf(ref)):
        raise AssertionError(f"{name}: non-finite entries differ between kernel and plain twin")
    fin = torch.isfinite(ref)
    err = (got[fin] - ref[fin]).abs()
    lim = atol + rtol * ref[fin].abs()
    if bool((err > lim).any()):
        worst = int((err - lim).argmax())
        raise AssertionError(f"{name}: |kernel - plain| {float(err[worst]):.3e} exceeds "
                             f"{float(lim[worst]):.3e} (rtol {rtol}, atol {atol:.3e})")
    return float(err.max()) if err.numel() else 0.0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import bumpcosmology_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port package is not beside this script ({err})", file=sys.stderr)
        return 2

    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.likelihoods import (
        cosmo_from_sites,
        dl_bounds_of,
        pop_cosmo_event_sel_logwts,
        pop_cosmo_model_spec,
        population_from_sites,
        query_table,
        selection_neff_terms,
    )
    from bumpcosmology_torch.inference.model import constrain, make_potential, value_and_grad
    from bumpcosmology_torch.inference.nuts import NutsConfig, run_sampling
    from bumpcosmology_torch.models.cosmology import build_cosmology, build_detector_table
    from bumpcosmology_torch.models.population import build_population
    from bumpcosmology_torch.ops import _build, cuda_bump, cuda_logwts, launch_floor
    from bumpcosmology_torch.utils.checkpoint import load_warmup

    card = card_line()
    tag = f"[{card}]"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = round(now - t_phase, 3)
        t_phase = now

    # ---- phase 1: build -------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_kernels()
    log(f"phase 1 build: {len(reports)} kernel source(s) compiled in "
        f"{time.perf_counter() - t0:.2f} s (host wall clock)")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # the launch floor: kernels that compute nothing, through the same ctypes path
    b_threads = 32 * 19  # kernel B's forward block at the flagship size (38 pieces a block in 2 rounds of 19 warps)
    floor_ms, floor_call_ms = both_ms(lambda: launch_floor.launch_floor(dev))
    floor_cl_ms, floor_cl_call_ms = both_ms(lambda: launch_floor.launch_floor_cluster(16, b_threads, dev))
    log(f"{tag} launch floor (empty kernel; device ms from {GRAPH_LAUNCHES} launches in one replayed CUDA graph, "
        f"call ms from CUDA events around 20 eager calls): 1 block x 32 threads: device {floor_ms:.5f} ms, "
        f"call {floor_call_ms:.5f} ms; kernel B's geometry (16 clusters of 8 blocks x {b_threads} threads, one "
        f"cluster.sync): device {floor_cl_ms:.5f} ms, call {floor_cl_call_ms:.5f} ms")
    phase_done("1_build")

    data = load_pop_cosmo_data(CATALOG)
    warm = load_warmup(WARMUP16)
    spec = pop_cosmo_model_spec(data, N_GRID, N_Z)
    spec_data, spec_bounds = data.to(spec.device), dl_bounds_of(data)
    spec_plain = pop_cosmo_model_spec(data, N_GRID, N_Z, plain=True)
    theta = warm.state.theta
    c = theta.shape[0]
    with torch.no_grad():
        sites = constrain(spec, theta)
        pop_params = population_from_sites(sites)
    mp = pop_params.mass
    p5 = torch.stack([mp.a, mp.b, mp.mpisn, mp.mbhmax, mp.sigma], dim=1).contiguous()
    rows = {}

    # ---- phase 2: kernel A ----------------------------------------------
    def twin_vjp(p, n_grid, g, dtype):
        leaf = p.detach().to(dtype).clone().requires_grad_(True)
        out = cuda_bump.bump_log_dn_plain(leaf, n_grid)
        (out * g.to(dtype)).sum().backward()
        return out.detach().float(), leaf.grad.float()

    def kernel_a_errors(label, p, n_grid, g, twin_dtype=torch.float32):
        """(forward, VJP) max |kernel - twin| on ``p`` (C, 5), inside phase 2's
        limits, then the kernel's table and VJP.  The twin runs in ``twin_dtype``."""
        leaf = p.detach().clone().requires_grad_(True)
        out = cuda_bump.bump_log_dn(leaf, n_grid)
        (out * g).sum().backward()
        ref, ref_grad = twin_vjp(p, n_grid, g, twin_dtype)
        torch.cuda.synchronize()
        return (check_close(f"A-fwd {label}", out.detach(), ref, rtol=1e-4, atol=5e-5),
                check_close(f"A-bwd {label}", leaf.grad, ref_grad, rtol=2e-4, atol=1e-5), out.detach(), leaf.grad)

    def share_of_vjp_limit(got, ref):
        return round(float(((got - ref).abs() / (1e-5 + 2e-4 * ref.abs())).max()), 3)

    g_a = torch.randn((c, N_GRID), generator=gen, device=dev)
    err_af, err_ab, logdn, _ = kernel_a_errors(f"C={c} G={N_GRID}", p5, N_GRID, g_a)
    # the shapes the geometry could break: one chain, grids that are no multiple of a warp, a grid of many
    # passes, four times the chains.  Here the twin runs in float64: with a random cotangent some of the 5 C
    # sums nearly cancel, and on such an entry the float32 twin's own rounding uses up the VJP limit (the
    # shares of the limit are printed for C=64: kernel and float32 twin against float64, and against each other)
    p64 = p5.repeat(4, 1)
    p64[:, [0, 1, 4]] *= 1.0 + 0.04 * (torch.rand((4 * c, 3), generator=gen, device=dev) - 0.5)
    p64[:, 3] += torch.rand((4 * c,), generator=gen, device=dev)
    shape_errs = {}
    for p, n_grid in ((p5[:1], N_GRID), (p5, 48), (p5, 100), (p5[:2], 2100), (p64, N_GRID)):
        label = f"C={p.shape[0]} G={n_grid}"
        g_s = torch.randn((p.shape[0], n_grid), generator=gen, device=dev)
        e_f, e_b, _, grad_k = kernel_a_errors(label, p, n_grid, g_s, torch.float64)
        shape_errs[label] = [float(f"{e_f:.3e}"), float(f"{e_b:.3e}")]
    # g_s and grad_k are those of the loop's last shape, C=64
    grad_32, grad_64 = twin_vjp(p64, N_GRID, g_s, torch.float32)[1], twin_vjp(p64, N_GRID, g_s, torch.float64)[1]
    shares64 = {"kernel vs float64 twin": share_of_vjp_limit(grad_k, grad_64),
                "float32 twin vs float64 twin": share_of_vjp_limit(grad_32, grad_64),
                "kernel vs float32 twin": share_of_vjp_limit(grad_k, grad_32)}
    # the backward's reduction runs in a fixed order: two launches agree bit for bit
    for p, ld, g_s in ((p5, logdn, g_a), (p64, cuda_bump._bump_fwd_cuda(p64, N_GRID),
                                          torch.randn((4 * c, N_GRID), generator=gen, device=dev))):
        d1 = cuda_bump._bump_bwd_cuda(p, ld, g_s, N_GRID)
        d2 = cuda_bump._bump_bwd_cuda(p, ld, g_s, N_GRID)
        torch.cuda.synchronize()
        if not torch.equal(d1, d2):
            raise AssertionError(f"A-bwd C={p.shape[0]}: two launches on the same inputs differ")
    a_fwd, a_fwd_call = both_ms(lambda: cuda_bump._bump_fwd_cuda(p5, N_GRID))
    a_fwd_plain = cuda_ms(lambda: cuda_bump._bump_fwd_plain(p5, N_GRID))
    a_bwd, a_bwd_call = both_ms(lambda: cuda_bump._bump_bwd_cuda(p5, logdn, g_a, N_GRID))
    a_bwd_plain = cuda_ms(lambda: cuda_bump._bump_bwd_plain(p5, logdn, g_a, N_GRID))
    by_chains = {c: (a_fwd, a_bwd)}
    for p in (p5[:1], p64):
        ld = cuda_bump._bump_fwd_cuda(p, N_GRID)
        g_s = torch.randn((p.shape[0], N_GRID), generator=gen, device=dev)
        by_chains[p.shape[0]] = (graph_ms(lambda: cuda_bump._bump_fwd_cuda(p, N_GRID)),
                                 graph_ms(lambda: cuda_bump._bump_bwd_cuda(p, ld, g_s, N_GRID)))
    # the launch floor in kernel A's geometries at the flagship size
    geo = cuda_bump.LAUNCH_GEOMETRY
    floor_af = graph_ms(lambda: launch_floor.launch_floor_grid(geo["blocks"], c, geo["fwd_threads"], dev))
    floor_ab = graph_ms(lambda: launch_floor.launch_floor_cluster(c, geo["bwd_threads"], dev))
    cells = c * N_GRID * N_GRID
    clock = max_sm_clock_hz()
    bound_af = bound_a(c * 5 * 4 + c * N_GRID * 4, cells, OPS_A_FWD_PER_CELL, clock)
    bound_ab = bound_a(c * 5 * 4 * 2 + 2 * c * N_GRID * 4, cells, OPS_A_BWD_PER_CELL, clock)
    rows["bump_fwd"] = dict(ms=a_fwd, call_ms=a_fwd_call, plain_ms=a_fwd_plain, max_abs_err=err_af, bound=bound_af[:2])
    rows["bump_bwd"] = dict(ms=a_bwd, call_ms=a_bwd_call, plain_ms=a_bwd_plain, max_abs_err=err_ab, bound=bound_ab[:2])
    log(f"{tag} phase 2 kernel A (C={c}, G={N_GRID}): forward max|err| {err_af:.3e}, "
        f"VJP max|err| {err_ab:.3e}; fwd device {a_fwd:.5f} ms, call {a_fwd_call:.4f} ms (plain {a_fwd_plain:.4f}), "
        f"bwd device {a_bwd:.5f} ms, call {a_bwd_call:.4f} ms (plain {a_bwd_plain:.4f}); launch floor in its "
        f"geometries: forward grid ({geo['blocks']}, {c}) x {geo['fwd_threads']} threads {floor_af:.5f} ms, backward {c} "
        f"clusters of 8 blocks x {geo['bwd_threads']} threads {floor_ab:.5f} ms")
    log(f"{tag} phase 2 kernel A by shape: [forward, VJP] max|err| against the twin in float64, inside the same limits "
        f"{json.dumps(shape_errs)}; largest share of the VJP limit at C={4 * c}: {json.dumps(shares64)}; "
        f"two backward launches bit-identical at C={c} and C={4 * c}; device ms at G={N_GRID} [fwd, bwd]: "
        + json.dumps({f"C={k}": [round(f, 6), round(b, 6)] for k, (f, b) in sorted(by_chains.items())}))
    log(f"{tag} phase 2 kernel A bounds at {clock / 1e6:.0f} MHz x {H100_SMS} SMs (ms; bytes, FP32 operations, "
        f"special-function unit): forward {json.dumps({k: round(v, 7) for k, v in bound_af[2].items()})}, "
        f"backward {json.dumps({k: round(v, 7) for k, v in bound_ab[2].items()})}")
    phase_done("2_kernel_a")

    # ---- phase 3: kernel B at full size ---------------------------------
    with torch.no_grad():
        pop = build_population(pop_params, N_GRID)
        det = build_detector_table(build_cosmology(cosmo_from_sites(sites), n=N_Z),
                                   *dl_bounds_of(data), n=N_Z)
        tables = (det.cols.contiguous(), pop.mass_table.log_bump.contiguous(),
                  cuda_logwts.pack_scalars(pop, det).contiguous())
    qry = query_table(data)
    n = qry.shape[0]
    nobs, nsamp = data.events.a.shape
    g_b = torch.randn((c, n), generator=gen, device=dev)
    res = []
    for fn in (cuda_logwts.logwts, cuda_logwts.logwts_plain):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        out = fn(*leaves, qry)
        (out.nan_to_num(neginf=0.0) * g_b).sum().backward()
        res.append((out.detach(), *(x.grad for x in leaves)))
    torch.cuda.synchronize()
    err_bf = check_close("B-fwd", res[0][0], res[1][0], rtol=2e-5, atol=2e-5)

    def check_cotangents(label, got3, ref3):
        worst = 0.0
        for name, got, ref in zip(("d_det", "d_bump", "d_scal"), got3, ref3):
            scale = float(ref.abs().max())
            worst = max(worst, check_close(f"{label} {name}", got, ref, rtol=5e-4, atol=5e-4 * scale))
        return worst

    err_bb = check_cotangents("B-bwd", res[0][1:], res[1][1:])
    n_dead = int(torch.isneginf(res[0][0]).sum())
    g_live = g_b * torch.isfinite(res[0][0])

    # the lse epilogue: per-event and selection log-sum-exps, and the cotangents back
    g_ev = torch.randn((c, nobs), generator=gen, device=dev)
    g_sel = torch.randn((c,), generator=gen, device=dev)
    res_l = []
    for fn in (cuda_logwts.logwts_lse, cuda_logwts.logwts_lse_plain):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        lse_ev, lse_sel = fn(*leaves, qry, nobs, nsamp)
        torch.autograd.backward([lse_ev, lse_sel], [g_ev, g_sel])
        res_l.append((lse_ev.detach(), lse_sel.detach(), *(x.grad for x in leaves)))
    torch.cuda.synchronize()
    err_lf = max(check_close("B-lse-fwd events", res_l[0][0], res_l[1][0], rtol=2e-5, atol=2e-5),
                 check_close("B-lse-fwd selection", res_l[0][1], res_l[1][1], rtol=2e-5, atol=2e-5))
    err_lb = check_cotangents("B-lse-bwd", res_l[0][2:], res_l[1][2:])
    lse_ev, lse_sel = res_l[0][:2]

    b_fwd, b_fwd_call = both_ms(lambda: cuda_logwts._logwts_fwd_cuda(*tables, qry))
    b_fwd_plain = cuda_ms(lambda: cuda_logwts._evaluate(*tables, qry)["out"])
    b_bwd, b_bwd_call = both_ms(lambda: cuda_logwts._logwts_bwd_cuda(*tables, qry, g_live))
    b_bwd_plain = cuda_ms(lambda: cuda_logwts._logwts_bwd_plain(*tables, qry, g_live))
    l_fwd, l_fwd_call = both_ms(lambda: cuda_logwts._logwts_lse_fwd_cuda(*tables, qry, nobs, nsamp))
    l_bwd, l_bwd_call = both_ms(lambda: cuda_logwts._logwts_lse_bwd_cuda(*tables, qry, lse_ev, lse_sel, g_ev, g_sel,
                                                                         nobs, nsamp))
    l_fwd_plain = cuda_ms(lambda: cuda_logwts._segment_lse(cuda_logwts._evaluate(*tables, qry)["out"], nobs, nsamp))

    def lse_bwd_plain():
        r = cuda_logwts._evaluate(*tables, qry)
        g = cuda_logwts._lse_row_cotangent(r["out"], lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp)
        return cuda_logwts._bwd_of_rows(r, *tables, g)

    l_bwd_plain = cuda_ms(lse_bwd_plain)
    # how many detector bins a warp's 32 consecutive rows fall into (the backward's shared-memory atomics)
    with torch.no_grad():
        k_det = tables[0].shape[1]
        bins = torch.floor((qry[:, 2] - tables[2][0, 0]) / tables[2][0, 1]).clamp(0, k_det - 2)
        warps = bins[: n // 32 * 32].reshape(-1, 32).sort(dim=1).values
        distinct = 1 + (warps[:, 1:] != warps[:, :-1]).sum(1).float()
        n_ev_warps = nobs * nsamp // 32
    table_bytes = c * (k_det * 8 + N_GRID * 4 + 15 * 4)
    seg_bytes = c * (nobs + 1) * 4
    rows["logwts_fwd"] = dict(ms=b_fwd, call_ms=b_fwd_call, plain_ms=b_fwd_plain, max_abs_err=err_bf,
                              bound=bound_ms(n * 16 + table_bytes + c * n * 4, c * n * OPS_B_FWD_PER_QUERY))
    rows["logwts_bwd"] = dict(ms=b_bwd, call_ms=b_bwd_call, plain_ms=b_bwd_plain, max_abs_err=err_bb,
                              bound=bound_ms(n * 16 + table_bytes + c * n * 4 + table_bytes,
                                             c * n * OPS_B_BWD_PER_QUERY))
    rows["logwts_lse_fwd"] = dict(ms=l_fwd, call_ms=l_fwd_call, plain_ms=l_fwd_plain, max_abs_err=err_lf,
                                  bound=bound_ms(n * 16 + table_bytes + seg_bytes,
                                                 c * n * (OPS_B_FWD_PER_QUERY + OPS_B_LSE_FWD_EXTRA)))
    rows["logwts_lse_bwd"] = dict(ms=l_bwd, call_ms=l_bwd_call, plain_ms=l_bwd_plain, max_abs_err=err_lb,
                                  bound=bound_ms(n * 16 + table_bytes + table_bytes + 2 * seg_bytes,
                                                 c * n * (OPS_B_BWD_PER_QUERY + OPS_B_LSE_BWD_EXTRA)))
    log(f"{tag} phase 3 kernel B (C={c}, N={n}, K={k_det}, G={N_GRID}; {n_dead} -inf chain-queries): rows "
        f"values max|err| {err_bf:.3e}, cotangents max|err| {err_bb:.3e}; fwd device {b_fwd:.5f} ms, call "
        f"{b_fwd_call:.4f} ms (plain {b_fwd_plain:.4f}), bwd device {b_bwd:.5f} ms, call {b_bwd_call:.4f} ms "
        f"(plain {b_bwd_plain:.4f})")
    log(f"{tag} phase 3 kernel B lse epilogue ({nobs} events x {nsamp} samples + {n - nobs * nsamp} injections): "
        f"values max|err| {err_lf:.3e}, cotangents max|err| {err_lb:.3e}; fwd device {l_fwd:.5f} ms, call "
        f"{l_fwd_call:.4f} ms (plain {l_fwd_plain:.4f}), bwd device {l_bwd:.5f} ms, call {l_bwd_call:.4f} ms "
        f"(plain {l_bwd_plain:.4f})")
    log(f"{tag} phase 3 kernel B backward: distinct detector bins among 32 consecutive rows: events mean "
        f"{float(distinct[:n_ev_warps].mean()):.2f} (min {int(distinct[:n_ev_warps].min())}), injections mean "
        f"{float(distinct[n_ev_warps:].mean()):.2f} (min {int(distinct[n_ev_warps:].min())})")
    phase_done("3_kernel_b")

    # ---- phase 4: potential value+grad ----------------------------------
    pot, pot_plain = make_potential(spec), make_potential(spec_plain)
    u_k, g_k = value_and_grad(pot, theta)
    u_p, g_p = value_and_grad(pot_plain, theta)
    torch.cuda.synchronize()
    if not (torch.isfinite(u_k).all() and torch.isfinite(g_k).all()):
        raise AssertionError("potential: non-finite value or gradient at the warm thetas")
    du = float(((u_k - u_p).abs() / (1.0 + u_p.abs())).max())
    dg = float(((g_k - g_p).abs() / (1.0 + g_p.abs())).max())
    if du >= 2e-4 or dg >= 5e-3:
        raise AssertionError(f"potential: kernels vs plain |dU|/(1+|U|) {du:.3e}, "
                             f"|dgrad|/(1+|grad|) {dg:.3e}")
    vg_ms = cuda_ms(lambda: value_and_grad(pot, theta), reps=10)
    vg_plain_ms = cuda_ms(lambda: value_and_grad(pot_plain, theta), reps=10)
    log(f"{tag} phase 4 potential (C={c}, 15 sites): |dU|/(1+|U|) {du:.3e}, "
        f"|dgrad|/(1+|grad|) {dg:.3e}; batched value+grad {vg_ms:.3f} ms with the kernels, "
        f"{vg_plain_ms:.3f} ms with the plain twins (CUDA events, mean of 10)")
    phase_done("4_potential")

    # ---- phase 5: NUTS sampling through the kernels ----------------------
    counters = (cuda_bump.LAUNCHES, cuda_logwts.LAUNCHES)
    for cnt in counters:
        for k in cnt:
            cnt[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_sampling(pot, warm, N_DRAWS, NutsConfig(max_depth=MAX_DEPTH), seed=SEED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sampled = {k: v for cnt in counters for k, v in cnt.items()}
    # the effective-sample-size diagnostics on the last draw of every chain (the rows epilogue)
    with torch.no_grad():
        last_sites = constrain(spec, out.thetas[:, -1])
        _, _, log_w, log_sel_w = pop_cosmo_event_sel_logwts(last_sites, spec_data, N_GRID, N_Z, spec_bounds, qry)
        _, neff_sel = selection_neff_terms(log_sel_w, spec_data.selection.log_ndraw)
        neff = torch.exp(2.0 * torch.logsumexp(log_w, -1) - torch.logsumexp(2.0 * log_w, -1))
    torch.cuda.synchronize()
    launches = {k: v for cnt in counters for k, v in cnt.items()}
    if out.thetas.shape != (c, N_DRAWS, theta.shape[1]) or not bool(torch.isfinite(out.thetas).all()):
        raise AssertionError(f"sampling: draws of shape {tuple(out.thetas.shape)} are not all finite")
    on_path = ("bump_fwd", "bump_bwd", "logwts_lse_fwd", "logwts_lse_bwd", "logwts_fwd")
    missing = [k for k in on_path if launches[k] == 0]
    if missing:
        raise AssertionError(f"sampling: kernels never launched on the main path: {missing}")
    n_vg = sampled["logwts_lse_fwd"]
    if not (sampled["logwts_lse_bwd"] == sampled["bump_fwd"] == sampled["bump_bwd"] == n_vg) or sampled["logwts_fwd"]:
        raise AssertionError(f"sampling: not one kernel-B forward and backward per value+grad: {sampled}")
    if out.max_abs_du >= 0.05:
        raise AssertionError(f"sampling: recomputed u differs from the stored state by "
                             f"{out.max_abs_du:.4f} nats (limit 0.05)")
    if (neff_sel.shape != (c,) or neff.shape != (c, nobs) or not bool(torch.isfinite(neff_sel).all())
            or not bool(torch.isfinite(neff).all()) or float(neff_sel.min()) < 1.0 or float(neff.min()) < 1.0
            or float(neff.max()) > nsamp * (1 + 1e-4)):
        raise AssertionError("diagnostics: neff_sel or per-event neff outside [1, number of rows]")
    st = out.stats
    n_lf = int(st.n_leapfrog.sum())
    log(f"{tag} phase 5 run_sampling ({N_DRAWS} draws x {c} chains, max_depth {MAX_DEPTH}): "
        f"{wall:.2f} s wall, {c * N_DRAWS / wall:.3f} draws/s, {n_lf / wall:.1f} chain-leapfrogs/s "
        f"({n_lf} chain-leapfrogs in {n_vg} batched value+grads, {n_vg / wall:.1f}/s), "
        f"mean accept {float(st.accept_prob.mean()):.3f}, divergences {int(st.diverging.sum())}, "
        f"mean tree depth {float(st.tree_depth.float().mean()):.2f}, "
        f"max |du| vs stored state {out.max_abs_du:.5f}; launches {launches}")
    log(f"{tag} phase 5 diagnostics on the last draw of {c} chains (rows epilogue): neff_sel min "
        f"{float(neff_sel.min()):.1f}, median {float(neff_sel.median()):.1f}; per-event neff min "
        f"{float(neff.min()):.2f}, median {float(neff.median()):.2f} of {nsamp} samples")
    phase_done("5_sampling")
    log(f"{tag} phase 5 profile: " + device_busy_share(pot, out.warm))
    phase_done("5_profile")

    # ---- phase 6: the mock injection campaign through kernel C ------------
    rows["snr_integral"], mock_launches = mock_campaign_phase(dev, tag)
    launches["snr_integral"] = mock_launches["snr_integral"]
    phase_done("6_mock_campaign")
    log(f"phase wall times (host clock, s): {json.dumps(phase_s)}")

    sources = {"bump": "bumpcosmology_torch/csrc/bump.cu", "logwts": "bumpcosmology_torch/csrc/logwts.cu",
               "snr": "bumpcosmology_torch/csrc/snr.cu"}
    replaces = {
        "bump_fwd": "bumpcosmology_tpu/ops/pallas_bump.py:177",
        "bump_bwd": "bumpcosmology_tpu/ops/pallas_bump.py:199",
        "logwts_fwd": "bumpcosmology_tpu/ops/pallas_logwts.py:184",
        "logwts_bwd": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "logwts_lse_fwd": "bumpcosmology_tpu/ops/pallas_logwts.py:184",
        "logwts_lse_bwd": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "snr_integral": "bumpcosmology_tpu/mock/pallas_snr.py:116",
    }
    kernels = []
    for name, row in rows.items():
        b_ms, b_by = row["bound"]
        status = "ok: built, matches its plain twin, launched on the main path"
        if name == "logwts_bwd":
            status = ("ok: built, matches its plain twin; launched in the phase-3 comparison only "
                      "(the main path's gradient takes the lse epilogue)")
        kernels.append(dict(name=name, route="cuda", source=sources[name.split("_")[0]],
                            replaces=replaces[name], launches=launches[name],
                            max_abs_err=row["max_abs_err"], ms=row["ms"], call_ms=row["call_ms"],
                            plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            status=status))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def device_busy_share(potential, warm, max_depth: int = 4) -> str:
    """Share of the wall time of one short NUTS draw (``max_depth`` 4: at
    most 15 batched value+grads) in which the card runs a kernel, from a
    ``torch.profiler`` trace (CUDA activity).  A full-depth draw makes some
    10^6 device activities, which take the profiler minutes to collect."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bumpcosmology_torch.inference.nuts import NutsConfig, run_sampling
    from bumpcosmology_torch.ops import cuda_logwts

    torch.cuda.synchronize()
    vg0 = cuda_logwts.LAUNCHES["logwts_lse_fwd"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_sampling(potential, warm, 1, NutsConfig(max_depth=max_depth), seed=SEED + 1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_vg = cuda_logwts.LAUNCHES["logwts_lse_fwd"] - vg0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return "device busy share not measured (the profiler recorded no device activity)"
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):  # union of intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return (f"one draw at max_depth {max_depth} under the profiler: {n_vg} batched value+grads, "
            f"{len(events)} device activities ({len(events) / max(n_vg, 1):.0f} per value+grad), "
            f"device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.1f} ms wall "
            f"(busy share {busy / wall_us:.4f}, idle share {1 - busy / wall_us:.4f}); top device time: "
            + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms" for n, t in top))


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def snr_work(m1, m2, f_grid):
    """(FP32 operations, special-function results) that kernel C does on these
    rows, counted per live point and branch as the kernel runs them."""
    import torch

    from bumpcosmology_torch.mock import cuda_snr

    f_merg, f_ring, _, f_cut = cuda_snr.row_scalars(m1, m2)
    n_f = f_grid.shape[0]
    below = lambda x: torch.searchsorted(f_grid, x.contiguous())  # noqa: E731  (number of f_k < x)
    n_cut = below(f_cut)
    n_insp = torch.minimum(below(f_merg), n_cut)
    n_pre_ring = torch.minimum(below(f_ring), n_cut)
    insp, merg, ring = (int(x.sum()) for x in (n_insp, n_pre_ring - n_insp, n_cut - n_pre_ring))
    n, blocks = m1.shape[0], -(-m1.shape[0] // 256)
    ops = (insp * OPS_C_INSP + merg * OPS_C_MERG + ring * OPS_C_RING + n * OPS_C_ROW
           + blocks * n_f * OPS_C_STAGE)
    sfu = (insp + merg) * SFU_C_POWER_POINT + ring * SFU_C_RING_POINT + n * SFU_C_ROW
    return ops, sfu, dict(inspiral=insp, merger=merg, ringdown=ring, all=n * n_f)


def mock_campaign_phase(dev, tag: str):
    """Phase 6: the 10^7-draw injection campaign and the catalog after it,
    through the port's entry points, then kernel C against its plain twin on
    the campaign's own SNR rows.  Returns (kernel row, launch counts)."""
    import numpy as np
    import torch

    from bumpcosmology_torch.mock import catalog, cuda_snr, psd, snr
    from bumpcosmology_torch.ops import cuda_bump, cuda_logwts

    counters = (cuda_bump.LAUNCHES, cuda_logwts.LAUNCHES, cuda_snr.LAUNCHES)
    # host-clock split of the campaign: wrap the two SNR calls to mark when the
    # host draws end, when the rows are on the card, when the SNRs are done
    marks, seen = {}, {}
    batched, network = catalog.network_snr_batched, snr.network_snr

    def timed_batched(*args, **kwargs):
        marks["batched_in"] = time.perf_counter()
        out = batched(*args, **kwargs)
        marks["batched_out"] = time.perf_counter()
        return out

    def timed_network(m1, m2, dl, *args, **kwargs):
        torch.cuda.synchronize()
        marks["network_in"] = time.perf_counter()
        out = network(m1, m2, dl, *args, **kwargs)
        torch.cuda.synchronize()
        marks["network_out"] = time.perf_counter()
        seen["rows"] = (m1, m2, dl)
        return out

    for cnt in counters:
        for k in cnt:
            cnt[k] = 0
    catalog.network_snr_batched, snr.network_snr = timed_batched, timed_network
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inj = catalog.draw_injection_campaign(ndraw=MOCK_NDRAW, seed=MOCK_SEED, device=dev)
        t_campaign = time.perf_counter()
        summary = catalog.campaign_summary(inj, device=dev)
        obs = catalog.add_observation_noise(inj)
        t_obs = time.perf_counter()
        cat = catalog.draw_one_year_catalog(len(inj["m1"]), obs, nsamp=MOCK_NSAMP, device=dev)
        torch.cuda.synchronize()
        t_cat = time.perf_counter()
    finally:
        catalog.network_snr_batched, snr.network_snr = batched, network
    launches = {k: v for cnt in counters for k, v in cnt.items()}

    m1, m2, dl = seen["rows"]
    n = m1.shape[0]
    split = dict(host_draws=marks["batched_in"] - t0, host_to_device=marks["network_in"] - marks["batched_in"],
                 device_snr=marks["network_out"] - marks["network_in"],
                 device_to_host=marks["batched_out"] - marks["network_out"],
                 host_assembly=t_campaign - marks["batched_out"])
    log(f"{tag} phase 6 campaign: {MOCK_NDRAW} draws, {n} rows computed on the card "
        f"({n / MOCK_NDRAW:.4f} pass the z / chirp-distance precut); wall {t_campaign - t0:.3f} s "
        f"(host clock, s: {json.dumps({k: round(v, 4) for k, v in split.items()})}); "
        f"device SNR {n / split['device_snr']:.4g} injections/s")
    snr_net = inj["SNR"]
    if snr_net.shape != (MOCK_NDRAW,) or not np.isfinite(snr_net).all() or (snr_net < 0).any():
        raise AssertionError("campaign: SNR column is not finite and non-negative at full length")
    nex = summary["predicted_detections_per_year"]
    n_events = len(np.unique(cat["evt"]))
    log(f"{tag} phase 6 campaign_summary {json.dumps(summary)} in {t_obs - t_campaign:.3f} s with the "
        f"observation noise; one-year catalog: {len(obs['SNR_OBS'])} observed detections, {n_events} events "
        f"x {MOCK_NSAMP} PE samples in {t_cat - t_obs:.3f} s (host clock); launches {launches}")
    if not 250.0 < nex < 2200.0:
        raise AssertionError(f"campaign: {nex:.1f} predicted detections/yr outside the calibrated band 250-2200")
    counts = np.bincount(cat["evt"])[np.unique(cat["evt"])] if n_events else np.zeros(0)
    if n_events == 0 or (counts != MOCK_NSAMP).any() or not all(np.isfinite(cat[k]).all() for k in cat):
        raise AssertionError(f"catalog: {n_events} events, samples per event {set(counts.tolist())}")
    if not ((cat["q"] >= 0) & (cat["q"] <= 1) & (cat["m1"] > 0) & (cat["z"] > 0)).all():
        raise AssertionError("catalog: PE samples outside their support")
    missing = [k for k in ("snr_integral", "bump_fwd") if launches[k] == 0]
    if missing:
        raise AssertionError(f"campaign: kernels never launched on the mock path: {missing}")

    # kernel C against its plain twin on the campaign's rows, then timed
    f_grid = snr.frequency_grid(device=dev)
    inv_psd = 1.0 / psd.PSDS["H1"](f_grid)
    grid = dict(f_min=float(f_grid[0]), f_max=float(f_grid[-1]), n_f=f_grid.shape[0], amp_scale=cuda_snr.AMP_SCALE)
    got = cuda_snr._snr_integral_cuda(m1, m2, dl, inv_psd, **grid)
    ref = cuda_snr.snr_integral_plain(m1, m2, dl, inv_psd, **grid, chunk=PLAIN_CHUNK)
    torch.cuda.synchronize()
    if not torch.equal(got == 0, ref == 0):
        raise AssertionError("C: the exact zeros (f_cut below f_min) differ between kernel and plain twin")
    err = check_close("C", got, ref, rtol=2e-5, atol=1e-6)
    ms, call_ms = both_ms(lambda: cuda_snr._snr_integral_cuda(m1, m2, dl, inv_psd, **grid), launches=5, replays=2)
    plain_ms = cuda_ms(lambda: cuda_snr.snr_integral_plain(m1, m2, dl, inv_psd, **grid, chunk=PLAIN_CHUNK),
                       reps=3, warmup=1)
    n_f = grid["n_f"]
    ops, sfu, points = snr_work(m1, m2, cuda_snr.log_grid(grid["f_min"], grid["f_max"], n_f, dev))
    clock = max_sm_clock_hz()
    t_bytes = (n * 16 + 2 * n_f * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_sfu = sfu / (SFU_PER_CLOCK_PER_SM * H100_SMS * clock) * 1e3
    bound = max(t_bytes, t_ops, t_sfu)
    by = "bytes" if bound == t_bytes else "operations"
    log(f"{tag} phase 6 kernel C (N={n}, n_f={n_f}; {int((ref == 0).sum())} exact zeros): max|err| {err:.3e} "
        f"vs the plain twin; device {ms:.4f} ms (5 launches in one replayed CUDA graph, the wrapper's four small "
        f"grid kernels included), call {call_ms:.4f} ms (plain {plain_ms:.4f} ms, chunks of {PLAIN_CHUNK}); live points "
        f"{json.dumps(points)}; bound {bound:.5f} ms by {by} (bytes {t_bytes:.5f}, FP32 operations "
        f"{t_ops:.5f}, special-function unit {t_sfu:.5f} at {clock / 1e6:.0f} MHz x {H100_SMS} SMs)")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=err, bound=(bound, by)), launches


if __name__ == "__main__":
    sys.exit(main())
