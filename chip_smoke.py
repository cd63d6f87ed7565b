#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``bumpcosmology_torch``).

Run from the root of a checkout on a host with one NVIDIA GPU:

    python3 chip_smoke.py

It drives the port's main path — the flagship joint population + flat-wCDM
fit on ``benchmarks/flagship_catalog.npz`` (56 events x 256 PE samples plus
24,576 injections: 38,912 queries per chain), ``n_grid=256``, ``n_z=1024``,
16 chains sampled with dense-mass NUTS from ``benchmarks/flagship_warmup16.npz``
(phase 5) and fitted from prior draws to a trace (phase 7) — and the paths
beside it: the mock stages (phase 6), the population-only fit (phase 8), the
ChEES samplers (phase 9), the other two mass families in both fits (phase
10), the calibration suite (phase 11), model comparison (phase 12), the
pipeline's command line (phase 13), the scale-out layer with the host
utilities (phase 14) and the SBC certificates' paths (phase 15); and it
holds every CUDA kernel against its plain PyTorch twin:

1. build every kernel from ``bumpcosmology_torch/csrc`` (one nvcc per source),
   and time the card's launch floor: an empty kernel through the same ctypes
   path, alone and in kernel B's cluster geometry;
2. kernel A (bump table) against its twin at C=16, G=256 on the warm thetas:
   forward rtol 1e-4 / atol 5e-5, VJP to the 5 scalars rtol 2e-4 / atol 1e-5;
   the same limits, against the twin run in float64, at C=1 (the mock campaign's
   launch), at G=48 and G=100 (not multiples of a warp), at G=2100 (nine passes
   of 256 columns, more than 32 rows a warp), at C=128 G=128 (the SBC certificate's fleet, phase 15b)
   and at C=64; two backward launches on the same inputs
   must agree bit for bit (the reduction runs in a fixed order);
3. kernel B (detector-frame log-weights) at full size, N=38,912, K=1024,
   G=256, C=16, both epilogues, forward and backward.  ``rows``: values rtol
   2e-5 / atol 2e-5 (the same -inf rows), every cotangent rtol 5e-4 with atol
   5e-4 x the largest reference entry (the twin's float32 scatter sums in
   another order than the kernel's fixed-point bins).
   ``lse`` (56 per-event and one selection log-sum-exp per chain, and the
   cotangents from a random (C, nobs) + (C,) cotangent): the same limits.
   Then B's query table per chain: the shared table copied once per chain
   (16 x 38,912 x 4) must give bit-identical forward values, and it and 20
   distinct per-chain tables of 2,816 rows (the SBC fleet's shape) are held
   against the twin at the same limits, both epilogues, both ways; and so
   are phase 12's shapes: the shared table at C = 64 (compare's batch) and
   the leave-one-out fleet's 56 per-chain tables of 38,656 rows (the
   flagship without one event each, 34.6 MB), and the SBC certificate's
   (phase 15b): 128 per-chain tables of 7,680 rows at K = 256, G = 128.  At the shared C = 16 shape
   and both per-chain shapes, two backward launches on the same inputs must
   agree bit for bit, both epilogues (the table cotangents are summed in
   fixed point).  Last, detector tables whose backward bins do not fit in
   shared memory, where the backward takes its second route (the bins in
   device memory): K = 8,192 and the largest K the forward takes (about
   28,900) on the shared C = 16 table, and K = 8,192 on 20 per-chain tables
   of 2,816 rows: both epilogues both ways against the twin, the backward
   twice bit for bit, every backward launch on the second route; the
   route's backwards at K = 8,192 are timed and bounded;
3p. kernel P (the priors and transforms, ``csrc/priors.cu``) on the joint
   model's 15 priors at C = 4 (the flagship benchmark's chains) and C = 128
   (an SBC fleet), forward and backward, against the per-site code within
   ``testing.priors_gaps``' limits, timed beside the per-site code's eager
   call on the card and bounded by the bytes it moves
   (``tools/kernel_times.kernel_p_times``).  Kernel P runs under every
   potential on the card, so every phase below that counts launches also
   holds P's: once forward a potential on the card, once backward a
   value+grad;
4. the 16-chain potential value+grad (through the ``lse`` epilogue), kernels
   against twins: |dU|/(1+|U|) < 2e-4 and |dgrad|/(1+|grad|) < 5e-3, timed with
   CUDA events; two value+grads at the same thetas must agree bit for bit;
   (4b) the same potential at ``n_z`` = 8,192: with every launch count set to
   0 just before one value+grad and read just after, one launch of kernel A,
   of B's ``lse`` epilogue (the backward on its second route) and of P each
   way, and nothing else; against the plain twins at the same limits, twice bit
   for bit, and |U(8,192) - U(1,024)| printed;
5. ``run_sampling`` for a few NUTS draws, then the effective-sample-size
   diagnostics (``pop_cosmo_event_sel_logwts`` and ``selection_neff_terms``, the
   ``rows`` epilogue) on the last draw of every chain, with every launch count
   set to 0 just before and read just after; kernel A and the ``lse`` kernels
   must have launched once per value+grad and the ``rows`` forward at least once;
6. the mock stages at the reference's size, into a temporary data
   directory: ``_stage_mock_injections`` (10^7 draws, seed 333,165,393, the
   SNR integral on kernel C, ``campaign_summary``'s predicted detections/yr
   in the JAX package's calibrated band, 250-2200), ``_stage_mock_observations``,
   ``_stage_mock_year_samples`` (``nsamp=128``) and ``_stage_mock_fit_inputs``
   (``pe-samples.npz``: the catalog; ``selection-samples.npz``: 1,024 rows),
   with every launch count set to 0 just before and read just after (kernel
   C and kernel A's forward must have launched); then kernel C against its
   plain twin on exactly the rows the
   campaign computed, and on some 3,000 rows whose f_merg, f_ring or f_cut
   sits on a stored knot of the grid or one ulp beside it: rtol 2e-5 / atol
   1e-6, the same exact zeros.  Kernel and twin are also measured (not held)
   against the same sum in float64 on the campaign's rows.  C's bound is the
   least work of its function on the campaign's rows (bytes, FP32 operations,
   special-function results; the constants' comment has the tally);
7. the fit from prior draws: ``run_pop_cosmo_fit`` at the flagship's width
   (the catalog's columns taken back to the source frame on the host, 16
   chains, ``n_grid=256``, ``n_z=1024``), cut in depth to 30 warmup steps —
   windows of 15, 5 (ending in one mass-matrix update) and 10 — and 10 draws
   at ``max_depth`` 6, with every launch count set to 0 just before and read
   just after: kernels A and B's ``lse`` epilogue must have launched once per
   batched value+grad (forward alone for the prior draws' potentials), B's
   ``rows`` forward once per chunk of the deterministics.  The adapted step
   sizes must be finite and positive, each covariance symmetric with a
   Cholesky factor, every posterior site and statistic finite at (16, 10[,
   k]), the trace must read back equal, and the deterministics through the
   kernels must match the plain path on the same draws within
   |d|/(1+|ref|) < 2e-4;
8. the population-only fit from prior draws: ``run_pop_fit`` on the same
   catalog taken back to the source frame (56 x 256 PE samples and 24,576
   injections, ``n_grid=256``), 16 chains, the same 30 warmup steps and 10
   draws at ``max_depth`` 5, with the checks of phase 7: kernel A forward
   and backward once per batched value+grad (the forward alone for the prior
   draws' potentials and each chunk of deterministics), kernel B never (the
   source-frame weights are plain torch); the potential through kernel A
   against its plain twin at the adapted state (phase 4's limits), and its
   value+grad timed with CUDA events;
9. the ChEES samplers, every launch count set to 0 just before and read
   just after each: (a) ``fit(sampler="nuts+chees")`` on the joint model from
   the committed adapted state, 10 iterations adapting T and 10 draws, kernel
   A and B's ``lse`` once per batched value+grad (the recompute of the stored
   state and every leapfrog), B's ``rows`` once per chunk of deterministics,
   then one ChEES iteration under the profiler and one trajectory under
   ``torch.cuda.set_sync_debug_mode("warn")`` (its synchronizations are
   printed, not held); (b) ``run_chees`` on the population-only potential
   from phase 8's prior draws (``warmup_schedule(30)``, 10 draws, at most 64
   leapfrogs a trajectory), kernel A once per batched value+grad;
10. the other mass families, with phase 8's cut: (a) ``run_pop_fit`` with
   ``mass_family="brokenpl"`` on phase 6's mock fit inputs at their full
   width (every catalog event x 128 samples and 1,024 selection rows), and
   (b) ``run_pop_cosmo_fit`` with ``mass_family="plpeak"`` on the flagship
   catalog, with the checks of phases 7-8: every launch count (A, B, C)
   0 (these families run no kernel, in either package); the trace reads
   back with the family's file name and attrs; the potential and gradient at
   the adapted state, and the deterministics of the run's draws, against
   the same built on the CPU from the same tables (phase 4's limits, 2e-4);
   ms per batched value+grad by CUDA events, and a profile of three;
11. the calibration suite through its stages, at the configs' defaults cut in
   fit depth (30 warmup steps, 32 draws, ``max_depth`` 5) and catalog count:
   (a) ``_stage_sbc(model="pop")``, 20 simulations fit as one fleet of 20
   chains (kernel A); (b) ``_stage_sbc(model="pop_cosmo")`` with the fresh-noise
   simulator on a 4·10⁶-draw campaign (the default 2·10⁵ detect too few
   injections for its 2,048-row pool), the fleet reading 20 per-chain query
   tables of 2,816 rows through kernel B, its potential for 3 simulations
   held card against CPU at phase 4's limits; (c) ``_stage_score_check`` at
   its defaults, 50 of 200 catalogs.  Every launch count is set to 0 before
   each stage and read after it, and at the edges of its windows: one launch
   of each kernel each way per batched value+grad (per catalog in (c)).  The
   artifacts must carry the JAX layout's keys, every rank lie in [0,
   n_bins), the rate check give numbers; the p-values are printed, not held;
12. model comparison through its stages on the traces that phases 7, 8 and
   10b wrote beside the flagship's fit inputs (16 chains x 10 draws each),
   every launch count set to 0 before each stage and read after it: (a)
   ``_stage_compare`` at ``CompareConfig``'s defaults (batches of 64 draws:
   kernel A's forward and B's ``lse`` forward once a joint batch of the
   pointwise matrix and of the evidence, no backward), each pointwise row
   summing to the model's log-likelihood within 2e-4, the joint matrix card
   against CPU within 2e-4; (b) ``_stage_ppc`` at ``PpcConfig``'s defaults
   (B's ``rows`` forward once a joint batch of 32), on the first batch B
   against its twin at its value limits and the weights card against CPU
   within 2e-4, every p-value in [0, 1]; (c) ``_stage_prior_sens``
   (host only: no launch, the JAX layout's keys); (d) ``_stage_loo`` on the
   joint model cut as phase 11 cuts (30 warmup steps, 32 draws, ``max_depth``
   5): 56 chains through B's per-chain tables, one launch of each kernel each
   way per batched value+grad, the fleet potential of 3 catalogs card
   against CPU at phase 4's limits, every influence z finite.  elpd, p_loo,
   k̂, log Z and the p-values are printed, not held (short traces);
13. the command line, ``bumpcosmology_torch.pipeline.__main__.main``, into a
   fresh data directory holding copies of phase 6's ``pe-samples.npz`` and
   ``selection-samples.npz`` and the record of an ingestion made elsewhere
   (``fetch_inputs(offline=True)``: no download is attempted): ``list``
   (ingestion fresh, ``sample_cosmo`` stale), then ``sample_cosmo`` at the
   catalog's full width cut in depth only (4 chains, 20 warmup steps, 8
   draws, ``max_depth`` 4), every launch count set to 0 just before and
   read just after: kernel A and B's ``lse`` epilogue once per batched
   value+grad (the forwards also for the prior draws' potentials), B's
   ``rows`` forward once for the deterministics; the trace must load with
   every site finite at (4, 8[, k]); then ``sample_cosmo`` again, which must
   report ``up to date`` and launch nothing.  At that path's shape (the
   catalog's 102,912 rows under the trace's last draw of each chain, C = 4)
   kernel B, both epilogues both ways, is held against its twin at phase
   3's limits and its backward twice bit for bit, kernel A against its
   float64 twin at phase 2's limits, and the potential's
   value+grad against the plain twins at phase 4's limits and twice bit for
   bit;
14. the scale-out layer and the host utilities: (a) two ranks on the one
   card (this script started again with ``--scale-out-rank``, joined by gloo
   through a ``file://`` store: NCCL refuses two ranks on one device, so the
   CUDA tensors of the collectives are staged through the host), the
   flagship split along the mesh's ``data`` axis (56 events x 128 PE samples
   + 12,288 injections: 19,456 rows a rank): the 16 committed chains' joint
   value+grad through a spec built on the shard, with every launch count set
   to 0 just before one value+grad and read just after (kernels A and B's
   ``lse`` once each way on each rank, nothing else), held against the dense
   value+grad on the card at phase 4's limits; ``make_sharded_pop_cosmo_loglike``
   must give the same bits; the sharded and dense ms a value+grad; and at
   this shape kernel B (both epilogues both ways) against its twin and twice
   bit for bit, kernel A against its float64 twin, the potential against the
   plain twins and twice bit for bit (``kernels_against_plain``); (b)
   ``fit(mesh=)`` cut in depth only (4 chains, 5 draws, ``max_depth`` 4):
   on two chain rows (a 2 x 1 mesh, 10 warmup steps from prior draws; every
   site finite at (4, 5), the rows drawing differently) and on one row over
   the data split (a 1 x 2 mesh), from prior draws with 10 warmup steps and
   from the committed adapted state with none: there each rank returns the
   draws it computed itself, and the two must be identical; the second
   within 1e-3 (|d|/(1+|ref|)) of a dense fit from the same state and seed;
   after the first two, ``kernels_against_plain`` at the fit's shape (C = 2
   on the whole catalog, C = 4 on the shard); (c)
   ``native.network_snr_native`` (the repository's ``native/`` C++ library,
   built with make) against kernel C on 4,096 rows at rtol 5e-3 / atol 1e-3,
   and whether make and g++ are on the host; (d) the five
   ``dNdm_PISN_effects`` curves (one launch of kernel A) against the CPU's
   at A's forward limits; (e) ``utils.profiling.trace`` around one joint
   value+grad writes a non-empty trace; (f) which of matplotlib, seaborn
   and pandas import here, and with all three the figures of phases 7-12's
   artifacts are drawn;
15. the SBC certificates' paths: (a) the PLPEAK and BROKENPL joint
   potentials (plain PyTorch: the fused detector-table route through
   ``ops/interp.py``'s lookup) at 16 prior draws, on the flagship shared by
   the chains and on 16 leave-one-out catalogs one a chain: two value+grads
   bit-identical, the first 4 chains card against CPU at phase 4's limits,
   no launch but P's, once each way a value+grad on the card; (b) the
   certificate's kernel shapes, run in phases 2 and 3: kernel A at C = 128, G = 128 and kernel B's both epilogues on 128
   per-chain tables of 7,680 rows at K = 256, G = 128, against their twins;
   (c) ``tools/sbc_certificate.py --family plpeak`` at the reference
   configuration cut to 8 simulations and 5 + 4 transitions at ``max_depth``
   4, every launch count set to 0 before and read after (the campaign's:
   kernel C, and A's forward at most once; and the fleet's priors: P once
   backward a value+grad, once forward besides for each of the 16 start
   candidates):
   the artifact's keys and ranks, the rate check; the verdict is printed,
   not held.

The ``kernels`` line's ``launches`` are phase 7's (the joint fit, C: phase
6's stages, B's per-chain rows: phase 11b's, and at the LOO fleet's shape
phase 12d's); ``launches_by_path`` gives every path, phases 4b and 6-15 (phase
14's on each rank: the sharded value+grad and the three mesh fits; and
the launches of 14c and 14d).  Every kernel is
timed twice: ``ms`` is its device time (20 launches captured
in one CUDA graph and replayed, so the host's queueing rate is out of the
figure), ``call_ms`` the time of one call of its Python wrapper as the main
path pays it (CUDA events around 20 eager calls).

Every kernel's device time must lie above its bound (the least time the
card could take for the same work), or the bound is miscounted.  Any failure
raises and exits non-zero.  The last two lines of stdout are
the ``kernels`` JSON object and ``{"ok": true, "device": {...}}``; the line
before them is the card's name and power limit from nvidia-smi.  Exits
non-zero, printing no result, when CUDA is absent or the package is not
beside this script.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CATALOG = ROOT / "benchmarks" / "flagship_catalog.npz"
WARMUP16 = ROOT / "benchmarks" / "flagship_warmup16.npz"
SEED = 20261016
N_GRID, N_Z = 256, 1024
# a detector table beyond the 4,347 rows whose backward bins fit in shared memory: kernel B's second backward route
LARGE_N_Z = 8192
N_DRAWS = 3
MAX_DEPTH = 10
# phases 7 and 8: the fits from prior draws, cut in depth (warmup_schedule(30): 15, 5 with a mass update, 10)
FIT_CHAINS, FIT_WARMUP, FIT_SAMPLES, FIT_DEPTH, POP_FIT_DEPTH = 16, 30, 10, 6, 5
# phase 9: ChEES; 9a the hybrid from the committed adapted state, 9b run_chees from phase 8's prior draws
CHEES_ADAPT, CHEES_SAMPLES, CHEES_WARMUP, CHEES_MAX_LEAPFROGS = 10, 10, 30, 64

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

# Kernel C's bound is the least work of its function on the campaign's own
# rows, whatever implements it.  Bytes: m1, m2, dl in and the integral out (16
# a row), the grid and inv_psd once.  A row needs, in FP32 operations: M, eta
# and M_s (5); the four transition frequencies, (a eta + b) eta + c times one
# shared reciprocal of pi M_s (3 each, and pi M_s: 13); a^2, which is a
# constant times m1 m2 M^(-1/3) / dl^2 (4); three counts on the sorted grid,
# each a binary search of 9 compare-and-select steps (54); the sum of the
# three segments' terms from the prefix tables (6) -> 82.  Special-function
# results (MUFU, 16 per clock per SM): the reciprocals of pi M_s, M^2, dl and
# f_merg (4) and the powers M^(-1/3) and f_ring^(-4/3) (a log2 and an exp2
# each: 4) -> 8 a row; a binary search needs none.  Inspiral and merger
# points add nothing (their sums come from the two prefix tables, built once
# per call over n_f points).  A live ringdown point needs the Lorentzian: d,
# d^2 + hw^2, hw^2 times the reciprocal, its square times g_k into the sum (5
# operations) and one reciprocal.
OPS_C_ROW, SFU_C_ROW, OPS_C_RING_POINT, SFU_C_RING_POINT = 82, 8, 5, 1
SFU_PER_CLOCK_PER_SM, H100_SMS = 16, 132
MOCK_NDRAW = 10_000_000
MOCK_SEED = 333_165_393
MOCK_NSAMP = 128
PLAIN_CHUNK = 65536
# phase 11: the calibration suite at SBCConfig's and ScoreCheckConfig's defaults, cut in fit depth and catalog count;
# the fleet's shape (SBCConfig: 20 simulations of 12 events x 64 samples; the joint model's 2,048 injections)
SBC_SIMS, SBC_NOBS, SBC_NSAMP, SBC_NSEL = 20, 12, 64, 2048
SBC_WARMUP, SBC_SAMPLES, SBC_DEPTH = 30, 32, 5
SBC_COSMO_CAMPAIGN = 4_000_000
SCORE_CATALOGS = 50
FLEET_CPU_SIMS = 3
# phase 15: the SBC certificates' fleet (the reference drivers' configuration: 128 simulations of 16 events x 256
# samples + 3,584 injections, n_grid 128, n_z 256), and the certificate tool at a cut size
CERT_SIMS, CERT_NOBS, CERT_NSAMP, CERT_NSEL, CERT_GRID, CERT_N_Z = 128, 16, 256, 3584, 128, 256
CERT_SMOKE_SIMS, CERT_SMOKE_WARMUP, CERT_SMOKE_SAMPLES, CERT_SMOKE_DEPTH = 8, 5, 4, 4
FAMILY_CHAINS, FAMILY_CPU_CHAINS = 16, 4
# phase 12: model comparison at CompareConfig's and PpcConfig's defaults over the traces of phases 7, 8 and 10b;
# the leave-one-out fleet (56 chains, each the flagship without one event) cut as phase 11 cuts the SBC fleet
COMPARE_BATCH = 64
# phase 13: the command line's sample_cosmo on phase 6's fit inputs, cut in depth only
CLI_CHAINS, CLI_WARMUP, CLI_SAMPLES, CLI_DEPTH = 4, 20, 8, 4
LOO_WARMUP, LOO_SAMPLES, LOO_DEPTH = 30, 32, 5
COMPARE_CPU_DRAWS = 64
# phase 14: two ranks on the one card (the flagship split along data), fit(mesh=) on two chain rows cut in depth
# only, the native SNR on a few thousand rows
SCALE_RANKS, SCALE_TIMEOUT_S = 2, 400
MESH_FIT_CHAINS, MESH_FIT_WARMUP, MESH_FIT_SAMPLES, MESH_FIT_DEPTH = 4, 10, 5, 4
MESH_FIT_DENSE_TOL = 1e-3
NATIVE_ROWS = 4096


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


def b_tables(sites, data, n_z: int = N_Z, n_grid: int = N_GRID):
    """Kernel B's per-chain inputs (detector table, bump table, 15 scalars) of
    the constrained ``sites`` (C,) on ``data``'s dL range, at ``n_grid``, ``n_z``."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import cosmo_from_sites, dl_bounds_of, population_from_sites
    from bumpcosmology_torch.models.cosmology import build_cosmology, build_detector_table
    from bumpcosmology_torch.models.population import build_population
    from bumpcosmology_torch.ops import cuda_logwts

    with torch.no_grad():
        pop = build_population(population_from_sites(sites), n_grid)
        det = build_detector_table(build_cosmology(cosmo_from_sites(sites), n=n_z), *dl_bounds_of(data), n=n_z)
        return (det.cols.contiguous(), pop.mass_table.log_bump.contiguous(),
                cuda_logwts.pack_scalars(pop, det).contiguous())


def check_cotangents(label, got3, ref3) -> float:
    """Kernel B's three cotangents against the twin's: rtol 5e-4, atol 5e-4 x max |ref|."""
    worst = 0.0
    for name, got, ref in zip(("d_det", "d_bump", "d_scal"), got3, ref3):
        scale = float(ref.abs().max())
        worst = max(worst, check_close(f"{label} {name}", got, ref, rtol=5e-4, atol=5e-4 * scale))
    return worst


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
    if len(sys.argv) > 1:  # one rank of phase 14, started by the script itself
        import argparse

        parser = argparse.ArgumentParser(description="one rank of phase 14 (started by chip_smoke.py)")
        parser.add_argument("--scale-out-rank", type=int, required=True)
        parser.add_argument("--store", type=Path, required=True)
        args = parser.parse_args()
        scale_out_rank(args.scale_out_rank, args.store)
        return 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run(Path(tmp))


def run(mock_dir: Path) -> int:
    """Every phase, then the kernels line and the result line; ``mock_dir``
    keeps phase 6's fit inputs for phase 10a, and in ``mock_dir / "compare"``
    the flagship's fit inputs and the traces of phases 7, 8 and 10b for
    phase 12."""
    import torch

    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.likelihoods import (
        dl_bounds_of,
        pop_cosmo_deterministics,
        pop_cosmo_event_sel_logwts,
        pop_cosmo_model_spec,
        population_from_sites,
        query_table,
        selection_neff_terms,
    )
    from bumpcosmology_torch.inference.model import constrain, make_potential, value_and_grad
    from bumpcosmology_torch.inference.nuts import NutsConfig, run_sampling
    from bumpcosmology_torch.ops import _build, cuda_bump, cuda_logwts, cuda_priors, launch_floor
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
            if "registers" in line or "spill" in line or "Function properties" in line:
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
    # the SBC certificate's fleet (phase 15b): 128 chains at G = 128
    p128 = p64.repeat(2, 1)
    p128[:, [0, 1, 4]] *= 1.0 + 0.04 * (torch.rand((2 * p64.shape[0], 3), generator=gen, device=dev) - 0.5)
    shape_errs = {}
    for p, n_grid in ((p5[:1], N_GRID), (p5, 48), (p5, 100), (p5[:2], 2100), (p128, CERT_GRID), (p64, N_GRID)):
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
    tables = b_tables(sites, data)
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
    rows.update(kernel_b_layouts(tag, data, sites, tables, qry, gen))
    kernel_b_certificate_shape(tag, data, sites, gen)
    rows.update(kernel_b_comparison_shapes(tag, data, sites, qry, gen))
    kernel_b_repeats(tag, data, sites, tables, qry, gen)
    rows.update(kernel_b_large_tables(tag, data, sites, qry, gen))
    phase_done("3_kernel_b")

    # ---- phase 3p: kernel P --------------------------------------------
    rows.update(kernel_p_phase(tag))
    phase_done("3p_kernel_p")

    # ---- phase 4: potential value+grad ----------------------------------
    pot, pot_plain = make_potential(spec), make_potential(spec_plain)
    _zero_counters()
    u_k, g_k = value_and_grad(pot, theta)
    u_p, g_p = value_and_grad(pot_plain, theta)  # plain twins of A and B; the priors are kernel P's on the card
    u_k2, g_k2 = value_and_grad(pot, theta)
    torch.cuda.synchronize()
    check_priors("potential", _read_counters(), 3)
    if not (torch.isfinite(u_k).all() and torch.isfinite(g_k).all()):
        raise AssertionError("potential: non-finite value or gradient at the warm thetas")
    if not (torch.equal(u_k, u_k2) and torch.equal(g_k, g_k2)):
        raise AssertionError("potential: two value+grads at the same thetas differ")
    du = float(((u_k - u_p).abs() / (1.0 + u_p.abs())).max())
    dg = float(((g_k - g_p).abs() / (1.0 + g_p.abs())).max())
    if du >= 2e-4 or dg >= 5e-3:
        raise AssertionError(f"potential: kernels vs plain |dU|/(1+|U|) {du:.3e}, "
                             f"|dgrad|/(1+|grad|) {dg:.3e}")
    vg_ms = cuda_ms(lambda: value_and_grad(pot, theta), reps=10)
    vg_plain_ms = cuda_ms(lambda: value_and_grad(pot_plain, theta), reps=10)
    log(f"{tag} phase 4 potential (C={c}, 15 sites): |dU|/(1+|U|) {du:.3e}, "
        f"|dgrad|/(1+|grad|) {dg:.3e}; two value+grads bit-identical (value and gradient); batched value+grad "
        f"{vg_ms:.3f} ms with the kernels, "
        f"{vg_plain_ms:.3f} ms with the plain twins (CUDA events, mean of 10)")
    phase_done("4_potential")
    large_table_launches = potential_large_table_phase(tag, data, theta, u_k)
    phase_done("4b_potential_n_z_8192")

    # ---- phase 5: NUTS sampling through the kernels ----------------------
    counters = (cuda_bump.LAUNCHES, cuda_logwts.LAUNCHES, cuda_priors.LAUNCHES)
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
    on_path = ("bump_fwd", "bump_bwd", "logwts_lse_fwd", "logwts_lse_bwd", "logwts_fwd", "priors_fwd", "priors_bwd")
    missing = [k for k in on_path if launches[k] == 0]
    if missing:
        raise AssertionError(f"sampling: kernels never launched on the main path: {missing}")
    n_vg = sampled["logwts_lse_fwd"]
    if not (sampled["logwts_lse_bwd"] == sampled["bump_fwd"] == sampled["bump_bwd"] == n_vg) or sampled["logwts_fwd"]:
        raise AssertionError(f"sampling: not one kernel-B forward and backward per value+grad: {sampled}")
    check_priors("sampling", sampled, n_vg)
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
    vg_per_s_nuts = n_vg / wall
    phase_done("5_sampling")
    log(f"{tag} phase 5 profile: " + device_busy_share(
        lambda: run_sampling(pot, out.warm, 1, NutsConfig(max_depth=4), seed=SEED + 1), "one draw at max_depth 4"))
    phase_done("5_profile")

    # ---- phase 6: the mock stages, the campaign through kernel C ---------
    rows["snr_integral"], mock_launches = mock_campaign_phase(dev, tag, mock_dir)
    phase_done("6_mock_stages")

    # ---- phase 7: the joint fit from prior draws to a trace --------------
    from bumpcosmology_torch.utils.io import write_table

    compare_dir = mock_dir / "compare"  # the flagship's fit inputs and the traces of phases 7, 8, 10b for phase 12
    compare_dir.mkdir()
    for name, table in zip(("pe-samples.npz", "selection-samples.npz"), flagship_source_tables()):
        write_table(compare_dir / name, table)
    joint_launches = fit_phase(dev, tag, "joint", trace_dir=compare_dir)[0]
    launches = dict(joint_launches, snr_integral=mock_launches["snr_integral"])  # the main path's; C's is phase 6's
    phase_done("7_fit")

    # ---- phase 8: the population-only fit from prior draws to a trace ----
    pop_launches, pop_spec, pop_theta0 = fit_phase(dev, tag, "pop", trace_dir=compare_dir)
    phase_done("8_pop_fit")

    # ---- phase 9: the ChEES samplers -----------------------------------
    hybrid_launches = chees_hybrid_phase(
        dev, tag, spec, warm, lambda s: pop_cosmo_deterministics(s, spec_data, N_GRID, N_Z, spec_bounds, qry),
        vg_per_s_nuts)
    phase_done("9a_nuts_chees")
    chees_launches = chees_pop_phase(dev, tag, pop_spec, pop_theta0)
    phase_done("9b_chees_pop")

    # ---- phase 10: the other mass families, no kernel on their path ------
    brokenpl_launches = fit_phase(dev, tag, "pop", family="brokenpl", data_dir=mock_dir)[0]
    phase_done("10a_brokenpl_pop_fit")
    plpeak_launches = fit_phase(dev, tag, "joint", family="plpeak", trace_dir=compare_dir)[0]
    phase_done("10b_plpeak_joint_fit")

    # ---- phase 11: the calibration suite ----------------------------------
    sbc_pop_launches = sbc_phase(dev, tag, "pop")
    phase_done("11a_sbc_pop")
    sbc_cosmo_launches = sbc_phase(dev, tag, "pop_cosmo")
    phase_done("11b_sbc_pop_cosmo")
    score_launches = score_check_phase(dev, tag)
    phase_done("11c_score_check")
    for k in ("logwts_lse_fwd_per_chain", "logwts_lse_bwd_per_chain"):  # the per-chain layout's path is 11b
        launches[k] = sbc_cosmo_launches[k]

    # ---- phase 12: model comparison ----------------------------------------
    comparison_launches = model_comparison_phase(dev, tag, compare_dir)
    phase_done("12_model_comparison")
    for k in ("logwts_lse_fwd_per_chain", "logwts_lse_bwd_per_chain"):  # at the LOO fleet's shape: 12d
        launches[k + "_loo"] = comparison_launches["12d_loo"][k]

    # ---- phase 13: the pipeline's command line ------------------------------
    cli_launches = cli_phase(tag, mock_dir)
    phase_done("13_cli")

    # ---- phase 14: the scale-out layer and the host utilities ---------------
    scale_launches = scale_out_phase(dev, tag, spec, theta, compare_dir)
    phase_done("14_scale_out")

    # ---- phase 15: the SBC certificates' paths ------------------------------
    family_launches = family_repeats_phase(dev, tag)
    phase_done("15a_family_repeats")
    certificate_launches = certificate_tool_phase(dev, tag)
    phase_done("15c_certificate_tool")
    log(f"phase wall times (host clock, s): {json.dumps(phase_s)}")

    sources = {"bump": "bumpcosmology_torch/csrc/bump.cu", "logwts": "bumpcosmology_torch/csrc/logwts.cu",
               "snr": "bumpcosmology_torch/csrc/snr.cu", "priors": "bumpcosmology_torch/csrc/priors.cu"}
    replaces = {
        "bump_fwd": "bumpcosmology_tpu/ops/pallas_bump.py:177",
        "bump_bwd": "bumpcosmology_tpu/ops/pallas_bump.py:199",
        "logwts_fwd": "bumpcosmology_tpu/ops/pallas_logwts.py:184",
        "logwts_bwd": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "logwts_lse_fwd": "bumpcosmology_tpu/ops/pallas_logwts.py:184",
        "logwts_lse_bwd": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "logwts_lse_fwd_per_chain": "bumpcosmology_tpu/ops/pallas_logwts.py:184",
        "logwts_lse_bwd_per_chain": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "logwts_lse_fwd_per_chain_loo": "bumpcosmology_tpu/ops/pallas_logwts.py:184",
        "logwts_lse_bwd_per_chain_loo": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "logwts_bwd_global": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "logwts_lse_bwd_global": "bumpcosmology_tpu/ops/pallas_logwts.py:217",
        "snr_integral": "bumpcosmology_tpu/mock/pallas_snr.py:116",
        "priors_fwd": "none: the priors of bumpcosmology_tpu/inference/model.py, which XLA fuses",
        "priors_bwd": "none: the priors of bumpcosmology_tpu/inference/model.py, which XLA fuses",
    }
    kernels = []
    for name, row in rows.items():
        b_ms, b_by = row["bound"]
        if row["ms"] < b_ms:
            raise AssertionError(f"{name}: {row['ms']:.6f} ms on the device is below its bound {b_ms:.6f} ms, "
                                 "so the bound does not count the least work")
        status = "ok: built, matches its plain twin, launched on the main path"
        if name == "logwts_fwd":
            status = ("ok: built, matches its plain twin; launched on the main path by the fit's deterministics "
                      "(one launch per chunk of 128 draws)")
        elif name == "logwts_bwd":
            status = ("ok: built, matches its plain twin; launched in the phase-3 comparison only "
                      "(the main path's gradient takes the lse epilogue)")
        elif name.endswith("_per_chain"):
            status = ("ok: built, matches its plain twin; a query table per chain (phase 3: 20 x 2,816 rows); "
                      "launched on the SBC fleet of the joint model (phase 11b) and the LOO fleet (12d)")
        elif name == "logwts_bwd_global":
            status = (f"ok: built, matches its plain twin; the backward's route for a detector table beyond its "
                      f"bins' shared memory (phase 3: K = {LARGE_N_Z} and the forward's largest K), launched in the "
                      "phase-3 comparison only")
        elif name == "logwts_lse_bwd_global":
            status = (f"ok: built, matches its plain twin; the backward's route for a detector table beyond its "
                      f"bins' shared memory (phase 3: K = {LARGE_N_Z} and the forward's largest K); launched on "
                      f"the joint potential at n_z = {LARGE_N_Z} (phase 4b)")
        elif name in PRIORS:
            status = ("ok: built, matches the per-site code; launched on every potential on the card (phase 3p: "
                      "C = 4 and C = 128; the kernels line's row C = 4)")
        elif name.endswith("_per_chain_loo"):
            status = ("ok: built, matches its plain twin; a query table per chain at the LOO fleet's shape (phase 3: "
                      "56 x 38,656 rows); launched on the LOO fleet of the joint model (phase 12d)")
        counter = name[: -len("_loo")] if name.endswith("_loo") else name
        by_path = {path: counts[counter] for path, counts in (
            ("4b_potential_n_z_8192", large_table_launches), ("6_mock_stages", mock_launches),
            ("7_joint_fit", joint_launches), ("8_pop_fit", pop_launches),
            ("9a_nuts_chees", hybrid_launches), ("9b_chees_pop", chees_launches),
            ("10a_brokenpl_pop_fit", brokenpl_launches), ("10b_plpeak_joint_fit", plpeak_launches),
            ("11a_sbc_pop", sbc_pop_launches), ("11b_sbc_pop_cosmo", sbc_cosmo_launches),
            ("11c_score_check", score_launches), *comparison_launches.items(), ("13_cli_sample_cosmo", cli_launches),
            *scale_launches.items(), ("15a_family_repeats", family_launches),
            ("15c_certificate_tool", certificate_launches))}
        kernels.append(dict(name=name, route="cuda", source=sources[name.split("_")[0]],
                            replaces=replaces[name], launches=launches[name], launches_by_path=by_path,
                            max_abs_err=row["max_abs_err"], ms=row["ms"], call_ms=row["call_ms"],
                            plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=b_by, library_ms=None,
                            status=status))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def cli_phase(tag: str, inputs_dir: Path) -> dict:
    """Phase 13: ``python -m bumpcosmology_torch.pipeline`` through its
    ``main``, on the card (its default device), into a fresh data directory
    with copies of the fit inputs in ``inputs_dir`` (phase 6's) and an
    ingestion record written offline; see the module docstring.  Returns the
    launch counts of the ``sample_cosmo`` run."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from bumpcosmology_torch.data.fetch import fetch_inputs
    from bumpcosmology_torch.inference import sampler
    from bumpcosmology_torch.pipeline.__main__ import main
    from bumpcosmology_torch.utils.trace import load_trace

    def cli(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        torch.cuda.synchronize()
        if rc != 0:
            raise AssertionError(f"cli {argv[0]}: exit code {rc}")
        return out.getvalue()

    calls = {"value_grad": 0, "value": 0}
    real_fit = sampler.fit

    def fit(spec, *args, **kwargs):
        def counted(sites):  # one call per batched potential: with gradients on, a value+grad
            calls["value_grad" if torch.is_grad_enabled() else "value"] += 1
            return spec.loglike(sites)

        return real_fit(spec._replace(loglike=counted), *args, **kwargs)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        data = Path(tmp) / "run"
        data.mkdir()
        for name in ("pe-samples.npz", "selection-samples.npz"):
            shutil.copy(inputs_dir / name, data / name)
        # the record of an ingestion made on another host; offline: no download is attempted
        fetch_inputs(data / "pe-samples-raw", data / "endo3_bbhpop-LIGO-T2100113-v12.hdf5",
                     manifest_out=str(data / "input_manifest.json"), offline=True)
        # --rehearsal keeps the fetch stage offline should it ever run here
        raw = [f"paths.pe_raw_dir={data / 'pe-samples-raw'}",
               f"paths.injection_file={data / 'endo3_bbhpop-LIGO-T2100113-v12.hdf5'}"]
        argv = ["sample_cosmo", "--data-dir", str(data), "--rehearsal", f"fit.num_chains={CLI_CHAINS}",
                f"fit.num_warmup={CLI_WARMUP}", f"fit.num_samples={CLI_SAMPLES}", f"fit.max_depth={CLI_DEPTH}", *raw]
        listing = {line.split()[0]: line.split()[1]
                   for line in cli(["list", "--data-dir", str(data), *raw]).splitlines()}
        want = {"fetch": "[fresh]", "draw_pe_samples": "[fresh]", "draw_selection_samples": "[fresh]",
                "sample_cosmo": "[stale]"}
        if any(listing.get(k) != v for k, v in want.items()):
            raise AssertionError(f"cli list: {listing}")
        sampler.fit = fit
        try:
            _zero_counters()
            t0 = time.perf_counter()
            first = cli(argv)
            wall = time.perf_counter() - t0
            launches = _read_counters()
        finally:
            sampler.fit = real_fit
        _zero_counters()
        t0 = time.perf_counter()
        second = cli(argv)
        wall2 = time.perf_counter() - t0
        again = _read_counters()
        trace = load_trace(data / "trace_cosmo.npz")
        shape_checks = cli_shape_checks(data, trace)
        pe = np.load(data / "pe-samples.npz")
        n_events = len(np.unique(pe["samples/evt"]))
        n_rows = int(pe["samples/m1"].shape[0]) + int(np.load(data / "selection-samples.npz")["samples/m1"].shape[0])

    chains, draws = CLI_CHAINS, CLI_SAMPLES
    n_vg, n_prior = calls["value_grad"], calls["value"]
    n_chunks = -(-chains * draws // 128)
    ok = (launches["bump_bwd"] == launches["logwts_lse_bwd"] == n_vg > 0 and launches["logwts_fwd"] == n_chunks
          and launches["bump_fwd"] == launches["logwts_lse_fwd"] + n_chunks == n_vg + n_prior + n_chunks
          and launches["logwts_bwd"] == 0 and 1 <= n_prior <= 50)
    if not ok:
        raise AssertionError(f"cli sample_cosmo: not one launch of A and B each way per value+grad ({n_vg}), "
                             f"{n_chunks} forwards for the deterministics: {launches}")
    check_priors("cli sample_cosmo", launches, n_vg, n_vg + n_prior)
    if "[pipeline] sample_cosmo: running..." not in first or "[pipeline] sample_cosmo: up to date" not in second:
        raise AssertionError(f"cli sample_cosmo: the first run did not run the fit or the second did not report "
                             f"it up to date:\n{first[-2000:]}\n{second[-2000:]}")
    if any(again.values()) or "running" in second:
        raise AssertionError(f"cli sample_cosmo: the up-to-date run launched {again}")
    bad = [k for k, v in trace.posterior.items() if v.shape[:2] != (chains, draws) or not np.isfinite(v).all()]
    if bad or trace.attrs.get("model") != "pop_cosmo":
        raise AssertionError(f"cli sample_cosmo: trace sites not finite at ({chains}, {draws}): {bad}; "
                             f"attrs {trace.attrs}")
    log(f"{tag} phase 13 cli: list, then sample_cosmo ({n_events} events, {n_rows} rows, {chains} chains, "
        f"{CLI_WARMUP} warmup steps, {draws} draws, max_depth {CLI_DEPTH}) in {wall:.2f} s wall: {n_vg} batched "
        f"value+grads, {n_prior} prior "
        f"potentials, launches {launches}; the trace reads back finite at ({chains}, {draws}); again: up to "
        f"date in {wall2:.2f} s, launches {sum(again.values())}")
    log(f"{tag} phase 13 at the CLI's shape: {shape_checks}")
    return launches


def cli_shape_checks(data_dir: Path, trace, dev=None) -> str:
    """Phase 13's shape held against the plain versions: the joint data of
    the CLI's fit inputs in ``data_dir`` (phase 6's mock catalog, 796 events
    x 128 samples + 1,024 selection rows) under the ``trace``'s last draw of
    each chain, through :func:`kernels_against_plain`.  Runs on the card
    unless ``dev`` says otherwise.  Returns a line of the results."""
    import numpy as np
    import torch

    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import unconstrain
    from bumpcosmology_torch.pipeline.stages import pop_cosmo_data_from_tables
    from bumpcosmology_torch.utils.io import read_table

    dev = torch.device("cuda") if dev is None else dev
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    jd = pop_cosmo_data_from_tables(read_table(data_dir / "pe-samples.npz"),
                                    read_table(data_dir / "selection-samples.npz"), dev)
    spec = pop_cosmo_model_spec(jd, N_GRID, N_Z, device=dev)
    last = {k: torch.as_tensor(np.asarray(trace.posterior[k])[:, -1], dtype=torch.float32, device=dev)
            for k in spec.names}
    theta = unconstrain(spec, last)
    if not bool(torch.isfinite(theta).all()):
        raise AssertionError("cli shape: the trace's last draws do not map to finite unconstrained thetas")
    return kernels_against_plain("cli", jd, theta, gen)


def a_against_twin(label: str, sites, gen) -> tuple:
    """Kernel A on the mass scalars of ``sites`` (C,) at ``N_GRID``, forward
    and VJP (a random cotangent), against its plain twin in float64 at phase
    2's limits, and its backward launched twice, bit for bit.  Returns the
    (forward, VJP) max |err|."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import population_from_sites
    from bumpcosmology_torch.ops import cuda_bump

    mp = population_from_sites(sites).mass
    p5 = torch.stack([mp.a, mp.b, mp.mpisn, mp.mbhmax, mp.sigma], dim=1).detach().contiguous()
    g = torch.randn((p5.shape[0], N_GRID), generator=gen, device=p5.device)
    leaf, ref_leaf = p5.clone().requires_grad_(True), p5.double().requires_grad_(True)
    out = cuda_bump.bump_log_dn(leaf, N_GRID)
    (out * g).sum().backward()
    ref = cuda_bump.bump_log_dn_plain(ref_leaf, N_GRID)
    (ref * g.double()).sum().backward()
    d1 = cuda_bump._bump_bwd_cuda(p5, out.detach(), g, N_GRID)
    d2 = cuda_bump._bump_bwd_cuda(p5, out.detach(), g, N_GRID)
    torch.cuda.synchronize()
    if not torch.equal(d1, d2):
        raise AssertionError(f"A-bwd {label} C={p5.shape[0]}: two launches on the same inputs differ")
    return (check_close(f"A-fwd {label}", out.detach(), ref.detach().float(), rtol=1e-4, atol=5e-5),
            check_close(f"A-bwd {label}", leaf.grad, ref_leaf.grad.float(), rtol=2e-4, atol=1e-5))


def kernels_against_plain(label: str, data, theta, gen) -> str:
    """Kernels A and B at the shape that the joint ``data`` and the
    unconstrained ``theta`` (C, d) give them, held against the plain
    versions: kernel B, both epilogues both ways, against its twin at phase
    3's limits (:func:`b_against_twin`) and its backward twice bit for bit
    (:func:`b_backward_repeats`); kernel A against its float64 twin at phase
    2's limits (:func:`a_against_twin`); the potential's value+grad with the
    kernels against the plain twins at phase 4's limits, and twice, bit for
    bit.  ``data`` may be a shard: B then weighs the rank's own rows, the
    value+grads are the whole catalog's (collectives of the shard's group),
    and every rank of the group must make the same call.  Returns a line of
    the results."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec, query_table
    from bumpcosmology_torch.inference.model import constrain, make_potential, value_and_grad

    spec, spec_plain = (pop_cosmo_model_spec(data, N_GRID, N_Z, device=theta.device, plain=plain)
                        for plain in (False, True))
    with torch.no_grad():
        sites = constrain(spec, theta)
        tables = b_tables(sites, data)
    qry = query_table(data)
    nobs, nsamp = data.events.a.shape
    errs = b_against_twin(f"B {label}", tables, qry, nobs, nsamp, gen)[0]
    shape = b_backward_repeats(f"B {label}", tables, qry, nobs, nsamp, gen)
    a_fwd, a_bwd = a_against_twin(label, sites, gen)
    pot, pot_plain = make_potential(spec), make_potential(spec_plain)
    u_k, g_k = value_and_grad(pot, theta)
    u_p, g_p = value_and_grad(pot_plain, theta)
    u_k2, g_k2 = value_and_grad(pot, theta)
    torch.cuda.synchronize()
    if not (torch.isfinite(u_k).all() and torch.isfinite(g_k).all()):
        raise AssertionError(f"{label}: non-finite potential or gradient")
    if not (torch.equal(u_k, u_k2) and torch.equal(g_k, g_k2)):
        raise AssertionError(f"{label}: two value+grads at the same thetas differ")
    du = float(((u_k - u_p).abs() / (1.0 + u_p.abs())).max())
    dg = float(((g_k - g_p).abs() / (1.0 + g_p.abs())).max())
    if du >= 2e-4 or dg >= 5e-3:
        raise AssertionError(f"{label}: potential kernels vs plain |dU|/(1+|U|) {du:.3e}, "
                             f"|dgrad|/(1+|grad|) {dg:.3e}")
    fmt = json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
    return (f"kernel B ({shape}, {nobs} events x {nsamp} samples, K={tables[0].shape[1]}) max|err| against the "
            f"twin {fmt}, two backward launches bit-identical; kernel A (C={theta.shape[0]}, G={N_GRID}) against "
            f"its float64 twin fwd {a_fwd:.3e}, VJP {a_bwd:.3e}, two backward launches bit-identical; potential "
            f"|dU|/(1+|U|) {du:.3e}, |dgrad|/(1+|grad|) {dg:.3e} against the plain twins, two value+grads "
            "bit-identical")


def device_busy_share(run, label: str, n_vg=None) -> str:
    """Share of the wall time of ``run()`` in which the card runs a kernel,
    from a ``torch.profiler`` trace (CUDA activity).  ``run`` is kept short
    (at most some 15 batched value+grads): a full-depth NUTS draw makes some
    10^6 device activities, which take the profiler minutes to collect.
    ``n_vg`` is the number of batched value+grads ``run`` makes; by default
    kernel A's backward launches count them (one per value+grad of the bump)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bumpcosmology_torch.ops import cuda_bump

    torch.cuda.synchronize()
    vg0 = cuda_bump.LAUNCHES["bump_bwd"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_vg = cuda_bump.LAUNCHES["bump_bwd"] - vg0 if n_vg is None else n_vg
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
    return (f"{label} under the profiler: {n_vg} batched value+grads, "
            f"{len(events)} device activities ({len(events) / max(n_vg, 1):.0f} per value+grad), "
            f"device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.1f} ms wall "
            f"(busy share {busy / wall_us:.4f}, idle share {1 - busy / wall_us:.4f}); top device time: "
            + "; ".join(f"{n[:60]} {t / 1e3:.2f} ms" for n, t in top))


def _counting_hmc_steps(steps: list):
    """Wrap ``chees._hmc_step`` to record each trajectory's leapfrog count;
    returns the function that restores it."""
    from bumpcosmology_torch.inference import chees

    real = chees._hmc_step

    def counted(vg, state, eps, n_steps, *args):
        steps.append(n_steps)
        return real(vg, state, eps, n_steps, *args)

    chees._hmc_step = counted
    return lambda: setattr(chees, "_hmc_step", real)


def _counters():
    from bumpcosmology_torch.mock import cuda_snr
    from bumpcosmology_torch.ops import cuda_bump, cuda_logwts, cuda_priors

    return cuda_bump.LAUNCHES, cuda_logwts.LAUNCHES, cuda_snr.LAUNCHES, cuda_priors.LAUNCHES


def _zero_counters():
    """Every kernel's launch count, and the batched value+grads
    (``model.COUNTS``), set to 0."""
    import torch

    from bumpcosmology_torch.inference import model

    for cnt in (*_counters(), model.COUNTS):
        for k in cnt:
            cnt[k] = 0
    torch.cuda.synchronize()


PRIORS = ("priors_fwd", "priors_bwd")


def _but_priors(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if k not in PRIORS}


def check_priors(label: str, launches: dict, n_vg: int, n_pot=None) -> None:
    """Kernel P launched once forward for each of ``n_pot`` potentials on the
    card (by default the ``n_vg`` value+grads alone) and once backward for
    each of the ``n_vg`` value+grads."""
    n_pot = n_vg if n_pot is None else n_pot
    if (launches["priors_fwd"], launches["priors_bwd"]) != (n_pot, n_vg):
        raise AssertionError(f"{label}: kernel P launched {launches['priors_fwd']} forward and "
                             f"{launches['priors_bwd']} backward, not {n_pot} (one a potential) and {n_vg} (one a "
                             f"value+grad)")


def _read_counters():
    return {k: v for cnt in _counters() for k, v in cnt.items()}


def chees_hybrid_phase(dev, tag: str, spec, warm, det_fn, vg_per_s_nuts: float):
    """Phase 9a: ``fit(sampler="nuts+chees")`` on the joint model at full
    width from the committed adapted state (``CHEES_ADAPT`` iterations of
    trajectory-length adaptation, ``CHEES_SAMPLES`` draws), with every launch
    count set to 0 just before and read just after: kernel A and kernel B's
    ``lse`` epilogue once per batched value+grad (the state's recompute and
    every leapfrog), B's ``rows`` forward once per chunk of the
    deterministics.  Then one ChEES iteration under the profiler, and one
    trajectory under ``torch.cuda.set_sync_debug_mode("warn")`` (the
    synchronizations are counted, not held).  Returns the launch counts."""
    import traceback
    import warnings

    import numpy as np
    import torch

    from bumpcosmology_torch.inference import chees, sampler
    from bumpcosmology_torch.inference.model import make_potential
    from bumpcosmology_torch.inference.nuts import ChainState

    seen, steps = {}, []
    real_run = sampler.run_chees_from_warmup

    def run(*args, **kwargs):
        seen["res"] = real_run(*args, **kwargs)
        return seen["res"]

    restore = _counting_hmc_steps(steps)
    sampler.run_chees_from_warmup = run
    try:
        _zero_counters()
        t0 = time.perf_counter()
        res = sampler.fit(spec, SEED, num_samples=CHEES_SAMPLES, num_chains=FIT_CHAINS, deterministics_fn=det_fn,
                          warmup_state=warm, sampler="nuts+chees", chees_num_adapt=CHEES_ADAPT, verbose=False,
                          device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters()
    finally:
        restore()
        sampler.run_chees_from_warmup = real_run
    ch = seen["res"]
    c, n_chunks = FIT_CHAINS, -(-FIT_CHAINS * CHEES_SAMPLES // 128)
    n_vg = 1 + sum(steps)  # the warm state's recompute, then one per leapfrog
    if not (launches["bump_bwd"] == launches["logwts_lse_bwd"] == launches["logwts_lse_fwd"] == n_vg
            and launches["bump_fwd"] == n_vg + n_chunks and launches["logwts_fwd"] == n_chunks
            and launches["logwts_bwd"] == 0):
        raise AssertionError(f"nuts+chees: launches are not one of each kernel per value+grad ({n_vg}) and one "
                             f"rows forward per chunk ({n_chunks}): {launches}")
    check_priors("nuts+chees", launches, n_vg)
    if len(steps) != CHEES_ADAPT + CHEES_SAMPLES:
        raise AssertionError(f"nuts+chees: {len(steps)} trajectories, not {CHEES_ADAPT} + {CHEES_SAMPLES}")
    for group, arrays in (("posterior", res.posterior), ("sample_stats", res.sample_stats)):
        for k, v in arrays.items():
            if v.shape[:2] != (c, CHEES_SAMPLES) or not np.isfinite(v).all():
                raise AssertionError(f"nuts+chees: {group} {k} of shape {v.shape} is not finite at "
                                     f"({c}, {CHEES_SAMPLES})")
    acc = res.sample_stats["accept_prob"]
    if not (math.isfinite(ch.trajectory_length) and ch.trajectory_length > 0 and ch.eps > 0
            and ((acc >= 0) & (acc <= 1)).all()):
        raise AssertionError(f"nuts+chees: T {ch.trajectory_length}, eps {ch.eps}, accept {acc.min()}-{acc.max()}")
    if ch.max_abs_du >= 0.05:
        raise AssertionError(f"nuts+chees: recomputed u differs from the stored state by {ch.max_abs_du:.4f} nats")
    t = res.timings
    log(f"{tag} phase 9a fit(sampler='nuts+chees') on the joint model ({c} chains from the committed adapted "
        f"state, {CHEES_ADAPT} adaptation iterations, {CHEES_SAMPLES} draws, n_grid {N_GRID}, n_z {N_Z}): "
        f"{wall:.2f} s wall (host clock), sampling {t['sampling_s']:.2f} s, deterministics "
        f"{t['deterministics_s']:.2f} s; T {ch.trajectory_length:.4g}, eps {ch.eps:.4g}, n_leapfrog (mean count) "
        f"{ch.n_leapfrog}, leapfrogs by trajectory: adaptation {steps[:CHEES_ADAPT]}, sampling {steps[CHEES_ADAPT:]}; "
        f"mean accept {float(acc.mean()):.3f}, divergences {int(res.sample_stats['diverging'].sum())}, "
        f"max |du| of the recompute {ch.max_abs_du:.5f}; {n_vg} batched value+grads, "
        f"{1e3 * t['sampling_s'] / n_vg:.2f} ms each, {n_vg / t['sampling_s']:.1f}/s (NUTS in phase 5: "
        f"{vg_per_s_nuts:.1f}/s); {c * CHEES_SAMPLES / t['sampling_s']:.3f} draws/s with the adaptation; "
        f"launches {launches}")

    # one adaptation iteration under the profiler, then one trajectory under the sync debug mode
    pot = make_potential(spec)
    final = res.final_state
    state = ChainState(*final.state)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    n = min(ch.n_leapfrog, 12)
    adam = chees._adam_init(ch.trajectory_length, state.theta)
    args = (final.eps, n, final.cov, final.chol_cov)
    log(f"{tag} phase 9a profile: " + device_busy_share(
        lambda: chees._t_adapt_iteration(pot, state, *args, adam, *chees._draws(gen, state.theta),
                                         chees.CheesConfig()), f"one ChEES iteration of {n} leapfrogs"))
    xi, uniform = chees._draws(gen, state.theta)
    chees._hmc_step(chees._vg(pot), state, *args, xi, uniform)  # once outside the count
    torch.cuda.synchronize()
    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1] if Path(f.filename).name != "warnings.py"]
        # the trajectory's own (enabling the mode warns once from the setter itself), innermost frame first
        if "synchroniz" in str(message) and any(f.name == "_hmc_step" for f in frames):
            syncs.append(" <- ".join(f"{Path(f.filename).parent.name}/{Path(f.filename).name}:{f.lineno} {f.name}"
                                     for f in reversed(frames[-6:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            chees._hmc_step(chees._vg(pot), state, *args, xi, uniform)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sites = sorted(set(syncs))
    log(f"{tag} phase 9a synchronizations in one trajectory of {n} leapfrogs under "
        f"torch.cuda.set_sync_debug_mode('warn'): {len(syncs)}" + (f", from {sites}" if sites else ""))
    return launches


def chees_pop_phase(dev, tag: str, spec, theta0):
    """Phase 9b: ``run_chees`` on the population-only potential from phase 8's
    prior draws (``CHEES_WARMUP`` steps of Stan's windows, ``CHEES_SAMPLES``
    draws, at most ``CHEES_MAX_LEAPFROGS`` a trajectory, which bounds the
    phase's time while the step size still adapts), with every launch count
    set to 0 just before and read just after: kernel A forward and backward
    once per batched value+grad, kernel B never.  Returns the launch counts."""
    import torch

    from bumpcosmology_torch.inference import chees
    from bumpcosmology_torch.inference.model import make_potential

    steps = []
    restore = _counting_hmc_steps(steps)
    try:
        _zero_counters()
        t0 = time.perf_counter()
        res = chees.run_chees(make_potential(spec), theta0, num_warmup=CHEES_WARMUP, num_samples=CHEES_SAMPLES,
                              cfg=chees.CheesConfig(max_leapfrogs=CHEES_MAX_LEAPFROGS), seed=SEED, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters()
    finally:
        restore()
    n_vg = 1 + sum(steps)  # the start's value+grad, then one per leapfrog
    if not (launches["bump_fwd"] == launches["bump_bwd"] == n_vg
            and not any(v for k, v in launches.items() if k.startswith("logwts"))):
        raise AssertionError(f"chees: kernel A not once per value+grad ({n_vg}), or kernel B launched: {launches}")
    check_priors("chees", launches, n_vg)
    c, dim = theta0.shape
    if (res.thetas.shape != (c, CHEES_SAMPLES, dim) or not bool(torch.isfinite(res.thetas).all())
            or not math.isfinite(res.trajectory_length) or not res.eps > 0):
        raise AssertionError(f"chees: draws of shape {tuple(res.thetas.shape)} finite "
                             f"{bool(torch.isfinite(res.thetas).all())}, T {res.trajectory_length}, eps {res.eps}")
    log(f"{tag} phase 9b run_chees on the pop potential ({c} chains from phase 8's prior draws, "
        f"warmup_schedule({CHEES_WARMUP}), {CHEES_SAMPLES} draws, max_leapfrogs {CHEES_MAX_LEAPFROGS}): {wall:.2f} s "
        f"wall (host clock), {n_vg} batched value+grads, {1e3 * wall / n_vg:.2f} ms each; adapted eps "
        f"{res.eps:.4g}, T {res.trajectory_length:.4g}, n_leapfrog (mean count) {res.n_leapfrog}; leapfrogs by "
        f"trajectory: warmup {steps[:CHEES_WARMUP]}, sampling {steps[CHEES_WARMUP:]}; sampling mean accept "
        f"{float(res.accept.mean()):.3f}, divergences {int(res.diverging.sum())}; launches {launches}")
    return launches


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def snr_work(m1, m2, f_grid, clock_hz: float):
    """Kernel C's least work on these rows: (bound ms, bound by, {bytes, fp32,
    sfu} in ms, live points by segment)."""
    import torch

    from bumpcosmology_torch.mock import cuda_snr

    f_merg, f_ring, _, f_cut = cuda_snr.row_scalars(m1, m2)
    below = lambda x: torch.searchsorted(f_grid, x.contiguous())  # noqa: E731  (number of f_k < x)
    n_cut = below(f_cut)
    n_insp = torch.minimum(below(f_merg), n_cut)
    n_pre_ring = torch.minimum(below(f_ring), n_cut)
    points = {k: int(x.sum()) for k, x in (("inspiral", n_insp), ("merger", n_pre_ring - n_insp),
                                           ("ringdown", n_cut - n_pre_ring))}
    n, n_f = m1.shape[0], f_grid.shape[0]
    sfu_per_ms = SFU_PER_CLOCK_PER_SM * H100_SMS * clock_hz / 1e3

    t = dict(bytes=(n * 16 + 2 * n_f * 4) / HBM_BYTES_PER_S * 1e3,
             fp32=(n * OPS_C_ROW + points["ringdown"] * OPS_C_RING_POINT) / FP32_OPS_PER_S * 1e3,
             sfu=(n * SFU_C_ROW + points["ringdown"] * SFU_C_RING_POINT) / sfu_per_ms)
    ms = max(t.values())
    return ms, ("bytes" if ms == t["bytes"] else "operations"), t, points


def run_campaign(dev, cfg):
    """``_stage_mock_injections`` at the reference's size (``MOCK_NDRAW``
    draws from ``MOCK_SEED``) with the SNRs on the card: the campaign, its
    table written to ``cfg``'s data directory, its summary.  Returns (injection
    table, summary, the (m1, m2, dl) rows that kernel C computed, the
    host-clock split in s).  ``tools/kernel_times.py --kernel c`` times C on
    the same rows."""
    import torch

    import bumpcosmology_torch.mock as mock
    from bumpcosmology_torch.mock import catalog, snr
    from bumpcosmology_torch.pipeline import stages

    # wrap the calls inside the stage to mark when the host draws end, when the
    # rows are on the card, when the SNRs are done, when the table is written,
    # and to keep the table and its summary
    marks, seen = {}, {}
    batched, network = catalog.network_snr_batched, snr.network_snr
    draw, summarize = mock.draw_injection_campaign, mock.campaign_summary

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

    def timed_draw(*args, **kwargs):
        seen["inj"] = draw(*args, **kwargs)
        marks["drawn"] = time.perf_counter()
        return seen["inj"]

    def timed_summary(*args, **kwargs):
        marks["summary_in"] = time.perf_counter()
        seen["summary"] = summarize(*args, **kwargs)
        return seen["summary"]

    catalog.network_snr_batched, snr.network_snr = timed_batched, timed_network
    mock.draw_injection_campaign, mock.campaign_summary = timed_draw, timed_summary
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stages._stage_mock_injections(cfg, device=dev)
        t_end = time.perf_counter()
    finally:
        catalog.network_snr_batched, snr.network_snr = batched, network
        mock.draw_injection_campaign, mock.campaign_summary = draw, summarize
    split = dict(host_draws=marks["batched_in"] - t0, host_to_device=marks["network_in"] - marks["batched_in"],
                 device_snr=marks["network_out"] - marks["network_in"],
                 device_to_host=marks["batched_out"] - marks["network_out"],
                 host_assembly=marks["drawn"] - marks["batched_out"],
                 table_write=marks["summary_in"] - marks["drawn"], summary=t_end - marks["summary_in"])
    return seen["inj"], seen["summary"], seen["rows"], split


def snr_against_twin(label: str, m1, m2, dl, inv_psd, grid):
    """(max |kernel - twin|, exact zeros, kernel, twin) of kernel C on these
    rows, inside rtol 2e-5 / atol 1e-6 with the same exact zeros, or raise."""
    import torch

    from bumpcosmology_torch.mock import cuda_snr

    got = cuda_snr._snr_integral_cuda(m1, m2, dl, inv_psd, **grid)
    ref = cuda_snr.snr_integral_plain(m1, m2, dl, inv_psd, **grid, chunk=PLAIN_CHUNK)
    torch.cuda.synchronize()
    if not torch.equal(got == 0, ref == 0):
        raise AssertionError(f"{label}: the exact zeros (f_cut at or below f_min) differ between kernel and twin")
    return check_close(label, got, ref, rtol=2e-5, atol=1e-6), int((ref == 0).sum()), got, ref


def snr_float64(m1, m2, dl, inv_psd, grid):
    """Kernel C's function with every operation in float64, on the stored
    float32 grid and with the float32 row scalars that kernel and twin cut at
    (``cuda_snr.row_scalars``): the sum that both are measured against."""
    import torch

    from bumpcosmology_torch.mock import cuda_snr
    from bumpcosmology_torch.mock.waveform import C_SI, GPC_M, MSUN_S

    f_min, f_max, n_f = grid["f_min"], grid["f_max"], grid["n_f"]
    f = cuda_snr.log_grid(f_min, f_max, n_f, m1.device).double()
    c_first, c_mid, c_last = cuda_snr.trapezoid_coefficients(f_min, f_max, n_f)
    w = c_mid * f
    w[0], w[-1] = c_first * f[0], c_last * f[-1]
    g = w * inv_psd.double()
    out = torch.empty(m1.shape[0], dtype=torch.float64, device=m1.device)
    for lo in range(0, m1.shape[0], PLAIN_CHUNK):
        sl = slice(lo, lo + PLAIN_CHUNK)
        f_merg, f_ring, sigma, f_cut = (x.double()[:, None] for x in cuda_snr.row_scalars(m1[sl], m2[sl]))
        a, b = m1[sl].double(), m2[sl].double()
        mc_s = (a * b) ** 0.6 / (a + b) ** 0.2 * MSUN_S
        a_newt = (math.sqrt(5.0 / 24.0) * math.pi ** (-2.0 / 3.0) * mc_s ** (5.0 / 6.0)
                  * (C_SI / (dl[sl].double() * GPC_M)) * grid["amp_scale"])[:, None]
        hw2 = (0.5 * sigma) ** 2
        ring = (f_ring / f_merg) ** (-2.0 / 3.0) * hw2 / ((f - f_ring) ** 2 + hw2)
        shape = torch.where(f < f_merg, (f / f_merg) ** (-7.0 / 6.0),
                            torch.where(f < f_ring, (f / f_merg) ** (-2.0 / 3.0), ring))
        amp = a_newt * f_merg ** (-7.0 / 6.0) * torch.where(f >= f_cut, 0.0, shape)
        out[sl] = (amp * amp * g).sum(dim=1)
    return out


def distance_to(exact, x):
    """(max |x - exact|, max |x - exact| / exact over the rows with exact > 0)."""
    d = (x.double() - exact).abs()
    live = exact > 0
    return float(d.max()), float((d[live] / exact[live]).max())


def mock_campaign_phase(dev, tag: str, data_dir):
    """Phase 6: the 10^7-draw injection campaign and the catalog after it,
    through the pipeline's four mock stages into ``data_dir``, which keeps
    the fit inputs (``pe-samples.npz``, ``selection-samples.npz``) for phase
    10a; then kernel C against its plain twin on the campaign's own SNR rows
    and on knot rows.  Returns (kernel row, launch counts)."""
    import numpy as np
    import torch

    from bumpcosmology_torch.mock import cuda_snr, psd, snr
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.pipeline.config import MockConfig, PathsConfig, PipelineConfig
    from bumpcosmology_torch.testing import snr_knot_rows
    from bumpcosmology_torch.utils.io import read_table

    cfg = PipelineConfig(paths=PathsConfig(data_dir=str(data_dir)),
                         mock=MockConfig(ndraw=MOCK_NDRAW, injection_seed=MOCK_SEED, nsamp=MOCK_NSAMP))
    _zero_counters()
    t0 = time.perf_counter()
    inj, summary, (m1, m2, dl), split = run_campaign(dev, cfg)
    t_campaign = time.perf_counter()
    stages._stage_mock_observations(cfg, device=dev)
    t_obs = time.perf_counter()
    stages._stage_mock_year_samples(cfg, device=dev)
    torch.cuda.synchronize()
    t_cat = time.perf_counter()
    stages._stage_mock_fit_inputs(cfg, device=dev)
    t_inputs = time.perf_counter()
    launches = _read_counters()
    obs = read_table(cfg.paths.path("mock_observations.npz"), key="observations")
    cat = read_table(cfg.paths.path("mock_year_samples.npz"))
    pe, sel = read_table(cfg.paths.path("pe-samples.npz")), read_table(cfg.paths.path("selection-samples.npz"))
    cfg.paths.path("mock_injections.npz").unlink()  # 1.5 GB; phase 10a reads only the fit inputs

    n = m1.shape[0]
    log(f"{tag} phase 6 _stage_mock_injections: {MOCK_NDRAW} draws, {n} rows computed on the card "
        f"({n / MOCK_NDRAW:.4f} pass the z / chirp-distance precut); wall {t_campaign - t0:.3f} s "
        f"(host clock, s: {json.dumps({k: round(v, 4) for k, v in split.items()})}); "
        f"device SNR {n / split['device_snr']:.4g} injections/s")
    snr_net = inj["SNR"]
    if snr_net.shape != (MOCK_NDRAW,) or not np.isfinite(snr_net).all() or (snr_net < 0).any():
        raise AssertionError("campaign: SNR column is not finite and non-negative at full length")
    nex = summary["predicted_detections_per_year"]
    n_events = len(np.unique(cat["evt"]))
    log(f"{tag} phase 6 campaign_summary {json.dumps(summary)}; _stage_mock_observations "
        f"{t_obs - t_campaign:.3f} s ({len(obs['SNR_OBS'])} observed detections), _stage_mock_year_samples "
        f"{t_cat - t_obs:.3f} s ({n_events} events x {MOCK_NSAMP} PE samples), _stage_mock_fit_inputs "
        f"{t_inputs - t_cat:.3f} s ({len(np.unique(pe['evt']))} events, {len(pe['m1'])} PE rows, "
        f"{len(sel['m1'])} selection rows, ndraw {float(sel['ndraw'][0]):.6g}) (host clock); launches {launches}")
    if not 250.0 < nex < 2200.0:
        raise AssertionError(f"campaign: {nex:.1f} predicted detections/yr outside the calibrated band 250-2200")
    counts = np.bincount(cat["evt"])[np.unique(cat["evt"])] if n_events else np.zeros(0)
    if n_events == 0 or (counts != MOCK_NSAMP).any() or not all(np.isfinite(cat[k]).all() for k in cat):
        raise AssertionError(f"catalog: {n_events} events, samples per event {set(counts.tolist())}")
    if not ((cat["q"] >= 0) & (cat["q"] <= 1) & (cat["m1"] > 0) & (cat["z"] > 0)).all():
        raise AssertionError("catalog: PE samples outside their support")
    if not (all(np.array_equal(pe[k], cat[k]) for k in cat) and len(sel["m1"]) == cfg.ingest.nsamp_sel
            and all(np.isfinite(v).all() for v in sel.values())):
        raise AssertionError("fit inputs: pe-samples is not the catalog, or the selection rows are not "
                             f"{cfg.ingest.nsamp_sel} finite rows")
    missing = [k for k in ("snr_integral", "bump_fwd") if launches[k] == 0]
    if missing:
        raise AssertionError(f"campaign: kernels never launched on the mock path: {missing}")

    # kernel C against its plain twin on the campaign's rows and on rows whose
    # transition frequencies sit on the stored knots or one ulp beside them, then timed
    f_grid = snr.frequency_grid(device=dev)
    inv_psd = 1.0 / psd.PSDS["H1"](f_grid)
    grid = dict(f_min=float(f_grid[0]), f_max=float(f_grid[-1]), n_f=f_grid.shape[0], amp_scale=cuda_snr.AMP_SCALE)
    n_f = grid["n_f"]
    stored = cuda_snr.log_grid(grid["f_min"], grid["f_max"], n_f, dev)  # the grid the kernel counts on
    err, n_zeros, got, ref = snr_against_twin("C", m1, m2, dl, inv_psd, grid)
    exact = snr_float64(m1, m2, dl, inv_psd, grid)
    (kernel_abs, kernel_rel), (twin_abs, twin_rel) = distance_to(exact, got), distance_to(exact, ref)
    del got, ref, exact
    knot_rows = snr_knot_rows(stored, knots=range(0, n_f, 2), ratios=(0.2, 1.0))
    err_knots, zeros_knots, _, _ = snr_against_twin("C knot rows", *knot_rows, inv_psd, grid)
    ms, call_ms = both_ms(lambda: cuda_snr._snr_integral_cuda(m1, m2, dl, inv_psd, **grid), launches=5, replays=2)
    plain_ms = cuda_ms(lambda: cuda_snr.snr_integral_plain(m1, m2, dl, inv_psd, **grid, chunk=PLAIN_CHUNK),
                       reps=3, warmup=1)
    clock = max_sm_clock_hz()
    bound, by, terms, points = snr_work(m1, m2, stored, clock)
    log(f"{tag} phase 6 kernel C (N={n}, n_f={n_f}; {n_zeros} exact zeros): max|err| {err:.3e} vs the plain twin; "
        f"against the float64 sum (same grid and cuts): kernel max abs {kernel_abs:.4e}, max rel {kernel_rel:.4e}; "
        f"twin max abs {twin_abs:.4e}, max rel {twin_rel:.4e}; "
        f"{knot_rows[0].shape[0]} knot rows ({zeros_knots} exact zeros): max|err| {err_knots:.3e}; device "
        f"{ms:.5f} ms (5 calls in one replayed CUDA graph: the table and row launches of each, grid cached), call "
        f"{call_ms:.4f} ms (plain {plain_ms:.4f} ms, chunks of {PLAIN_CHUNK}); live points by segment "
        f"{json.dumps(points)} of {n * n_f}, ringdown {points['ringdown'] / n:.2f} a row")
    log(f"{tag} phase 6 kernel C bound {bound:.6f} ms by {by}, the least work of these rows (ms: "
        f"{json.dumps({k: round(v, 7) for k, v in terms.items()})}; special-function unit at {clock / 1e6:.0f} MHz "
        f"x {H100_SMS} SMs)")
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, max_abs_err=max(err, err_knots),
                bound=(bound, by)), launches


def flagship_source_tables():
    """The flagship catalog as ``run_pop_cosmo_fit``'s input: source-frame
    columns recovered on the host, the inverse of the stage's own conversion
    (z from dL at Planck18, m1 = m1_det / (1 + z), the weight divided by the
    Jacobian the stage multiplies in)."""
    import numpy as np

    from bumpcosmology_torch.data.weights import dm1sqz_dm1ddqdl, planck18_z_of_dl_np

    with np.load(CATALOG) as d:
        cat = {k: np.asarray(d[k], dtype=np.float64) for k in d.files}

    def source(m1d, q, dl, log_pdraw):
        z = planck18_z_of_dl_np(dl)
        m1 = m1d / (1.0 + z)
        return m1, q, z, np.exp(log_pdraw) / dm1sqz_dm1ddqdl(m1, q, z)

    nobs, nsamp = cat["ev_a"].shape
    m1, q, z, wt = source(*(cat[k].ravel() for k in ("ev_a", "ev_q", "ev_c", "ev_lp")))
    pe = dict(m1=m1, q=q, z=z, wt=wt, evt=np.repeat(np.arange(nobs), nsamp))
    m1, q, z, pdraw = source(*(cat[k] for k in ("sel_a", "sel_q", "sel_c", "sel_lp")))
    sel = dict(m1=m1, q=q, z=z, pdraw=pdraw, ndraw=np.full(m1.shape, math.exp(float(cat["sel_ln"]))))
    return pe, sel


def fit_phase(dev, tag: str, model: str, family: str = "bump", data_dir=None, trace_dir=None):
    """The fit from prior draws to a trace, cut in depth: phase 7 (``model=
    "joint"``: ``run_pop_cosmo_fit``) and phase 8 (``model="pop"``:
    ``run_pop_fit``) of the bump at the flagship's width; phase 10a
    (``run_pop_fit``, ``family="brokenpl"``, on the fit inputs that phase 6's
    stages wrote to ``data_dir``) and phase 10b (``run_pop_cosmo_fit``,
    ``family="plpeak"``, on the flagship).  The samplers are wrapped only to
    observe: the prior draws, the step-size search's and each warmup
    transition's batched value+grads (the spec's log-likelihood called with
    gradients on), the warmup statistics and the draws.  The trace is written
    to ``data_dir`` or, for the flagship, to ``trace_dir`` (phase 12 reads it
    there) or a temporary directory.  Returns (the launch counts of the run,
    the spec, the prior draws)."""
    import tempfile

    import numpy as np
    import torch

    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference import nuts, sampler
    from bumpcosmology_torch.inference.diagnostics import summary
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.pipeline.config import FitConfig, PathsConfig, PipelineConfig
    from bumpcosmology_torch.utils.io import read_table
    from bumpcosmology_torch.utils.trace import load_trace

    joint, bump = model == "joint", family == "bump"
    phase = (7 if joint else 8) if bump else ("10b" if joint else "10a")
    depth = FIT_DEPTH if joint and bump else POP_FIT_DEPTH
    fam = lk.MASS_FAMILIES[family]
    run_stage, trace_name = ((stages.run_pop_cosmo_fit, fam.cosmo_trace_name) if joint
                             else (stages.run_pop_fit, fam.trace_name))
    if data_dir is None:
        pe, sel = flagship_source_tables()
    else:  # the stage reads them; they are read here too for the comparison on the host
        pe, sel = read_table(Path(data_dir) / "pe-samples.npz"), read_table(Path(data_dir) / "selection-samples.npz")
    calls = {"value_grad": 0, "value": 0}
    n_vg = lambda: calls["value_grad"]  # noqa: E731
    seen, marks = {}, []
    real = {"eps": nuts._find_reasonable_eps, "warmup": sampler.run_warmup, "sampling": sampler.run_sampling,
            "fit": sampler.fit, "init": sampler._finite_prior_init}

    def eps_search(*args, **kwargs):
        before = n_vg()
        eps = real["eps"](*args, **kwargs)
        seen.update(eps_search_vg=n_vg() - before, eps0=eps.clone())
        marks.append((0, n_vg(), time.perf_counter()))
        return eps

    def warmup(*args, progress=None, **kwargs):
        def mark(step, total, accept):
            marks.append((step, n_vg(), time.perf_counter()))
            if progress is not None:
                progress(step, total, accept)
        seen["warmup_vg0"] = n_vg()
        warm, stats = real["warmup"](*args, progress=mark, **kwargs)
        seen["warm_stats"] = stats
        return warm, stats

    def sampling(*args, **kwargs):
        before = n_vg()
        out = real["sampling"](*args, **kwargs)
        seen.update(thetas=out.thetas, sampling_vg=n_vg() - before)
        return out

    def fit(spec, *args, **kwargs):
        seen["spec"] = spec

        def counted(sites):  # one call per batched potential: with gradients on, a value+grad
            calls["value_grad" if torch.is_grad_enabled() else "value"] += 1
            return spec.loglike(sites)

        return real["fit"](spec._replace(loglike=counted), *args, **kwargs)

    def init(*args, **kwargs):
        seen["prior_theta"] = real["init"](*args, **kwargs)
        return seen["prior_theta"]

    cfg_fit = FitConfig(num_warmup=FIT_WARMUP, num_samples=FIT_SAMPLES, num_chains=FIT_CHAINS, max_depth=depth,
                        n_grid=N_GRID, n_z=N_Z, mass_family=family)
    nuts._find_reasonable_eps, sampler.run_warmup, sampler.run_sampling, sampler.fit, sampler._finite_prior_init = (
        eps_search, warmup, sampling, fit, init)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out_dir = Path(data_dir or trace_dir or tmp)
            cfg = PipelineConfig(paths=PathsConfig(data_dir=str(out_dir)), fit=cfg_fit)
            _zero_counters()
            t0 = time.perf_counter()
            res = (run_stage(cfg, device=dev) if data_dir is not None else run_stage(cfg, pe, sel, device=dev))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _read_counters()
            trace = load_trace(out_dir / trace_name)
    finally:
        nuts._find_reasonable_eps, sampler.run_warmup, sampler.run_sampling, sampler.fit, sampler._finite_prior_init = (
            real["eps"], real["warmup"], real["sampling"], real["fit"], real["init"])

    # the kernels on the path: the bump's once per batched value+grad, the forward alone for the prior draws'
    # potentials and for each chunk of the deterministics (kernel B's rows forward on the joint model); the
    # other families' none
    c, n_draws = FIT_CHAINS, FIT_CHAINS * FIT_SAMPLES
    n_chunks = -(-n_draws // 128)
    n_prior = calls["value"]
    if not bump:
        ok = not any(_but_priors(launches).values())
    elif joint:
        ok = (launches["bump_bwd"] == launches["logwts_lse_bwd"] == n_vg() and launches["logwts_fwd"] == n_chunks
              and launches["bump_fwd"] == launches["logwts_lse_fwd"] + n_chunks == n_vg() + n_prior + n_chunks
              and launches["logwts_bwd"] == 0)
    else:  # no kernel B: the population-only weights are plain torch
        ok = (launches["bump_bwd"] == n_vg() and launches["bump_fwd"] == n_vg() + n_prior + n_chunks
              and not any(v for k, v in launches.items() if k.startswith("logwts")))
    if not (ok and n_vg() > 0 and 1 <= n_prior <= 50):
        raise AssertionError(f"fit ({family}, {model}): launches are not " + (
            "zero on every kernel but P" if not bump else f"one of each kernel per value+grad ({n_vg()}), {n_chunks} "
            "forwards for the deterministics") + f": {launches}")
    check_priors(f"fit ({family}, {model})", launches, n_vg(), n_vg() + n_prior)
    warm = res.warmup_state
    if warm.eps.shape != (c,) or not bool(torch.isfinite(warm.eps).all()) or not bool((warm.eps > 0).all()):
        raise AssertionError(f"fit ({family}, {model}): adapted step sizes {warm.eps.tolist()}")
    asym = float(((warm.cov - warm.cov.mT).abs().amax((1, 2)) / warm.cov.abs().amax((1, 2))).max())
    info = torch.linalg.cholesky_ex(warm.cov).info
    if asym > 1e-5 or bool((info != 0).any()):
        raise AssertionError(f"fit ({family}, {model}): adapted covariances asymmetric by {asym:.2e} or without a "
                             f"Cholesky factor (info {info.tolist()})")
    for group, arrays in (("posterior", res.posterior), ("sample_stats", res.sample_stats)):
        for k, v in arrays.items():
            if v.shape[:2] != (c, FIT_SAMPLES) or not np.isfinite(v).all():
                raise AssertionError(f"fit ({family}, {model}): {group} {k} of shape {v.shape} is not finite at "
                                     f"({c}, {FIT_SAMPLES})")
    for group in ("posterior", "sample_stats"):
        stored, made = getattr(trace, group), getattr(res, group)
        if sorted(stored) != sorted(made) or not all(np.array_equal(stored[k], made[k]) for k in made):
            raise AssertionError(f"fit ({family}, {model}): the trace's {group} does not read back equal")
    attrs = {"model": "pop_cosmo" if joint else "pop", "family": family}
    if trace.attrs != attrs or sorted(trace.coords) != ["m_grid", "q_grid", "z_grid"]:
        raise AssertionError(f"fit ({family}, {model}): trace attrs {trace.attrs}, coords {sorted(trace.coords)}")

    # the deterministics against a second evaluation on the run's own draws: the bump's through the kernels
    # against the plain path on the card, another family's on the card against the same on the CPU
    to_data = stages.pop_cosmo_data_from_tables if joint else stages.pop_data_from_tables
    data = to_data(pe, sel, dev)
    if bump and joint:
        bounds, qry = lk.dl_bounds_of(data), lk.query_table(data)
        det_fn = lambda s, plain: lk.pop_cosmo_deterministics(s, data, N_GRID, N_Z, bounds, qry,  # noqa: E731
                                                              plain=plain)
    elif bump:
        rows = lk.pop_rows(data)
        det_fn = lambda s, plain: lk.pop_deterministics(s, data, N_GRID, rows, plain=plain)  # noqa: E731
    if bump:
        det = {plain: sampler.compute_deterministics(seen["spec"], seen["thetas"],
                                                     lambda s, plain=plain: det_fn(s, plain))
               for plain in (False, True)}
        ref, second = det[True], {"kernels": det[False], "trace": res.posterior}
    else:
        data_cpu = to_data(pe, sel, "cpu")
        spec_cpu = (fam.cosmo_spec(data_cpu, N_GRID, N_Z, device="cpu") if joint
                    else fam.pop_spec(data_cpu, N_GRID, device="cpu"))
        det_cpu = ((lambda s: fam.cosmo_det(s, data_cpu, N_GRID, N_Z)) if joint
                   else (lambda s: fam.pop_det(s, data_cpu, N_GRID)))
        t_cpu = time.perf_counter()
        ref = sampler.compute_deterministics(spec_cpu, seen["thetas"].cpu(), det_cpu)
        t_cpu = time.perf_counter() - t_cpu
        second = {"trace": res.posterior}
    worst = {}
    for k, r in ref.items():
        for label, got in ((label, arrays[k]) for label, arrays in second.items()):
            d = float((np.abs(got.astype(np.float64) - r) / (1.0 + np.abs(r))).max())
            worst[k] = max(worst.get(k, 0.0), d)
            if not d < 2e-4:
                raise AssertionError(f"fit ({family}, {model}): deterministic {k} ({label}) against the "
                                     f"{'plain path' if bump else 'CPU'}: |d|/(1+|ref|) = {d:.3e} (limit 2e-4)")

    # what the run did, by warmup segment
    st = seen["warm_stats"]
    vg_at = {step: (v, t) for step, v, t in marks}
    segments, start = [], 0
    for n_steps, update in nuts.warmup_schedule(FIT_WARMUP):
        sl = slice(start, start + n_steps)
        per = [vg_at[i + 1][0] - vg_at[i][0] for i in range(start, start + n_steps)]
        segments.append(dict(
            steps=n_steps, mass_update_at_end=update, value_grads=int(sum(per)),
            value_grads_per_transition=[min(per), round(sum(per) / n_steps, 2), max(per)],
            seconds=round(vg_at[start + n_steps][1] - vg_at[start][1], 3),
            mean_accept=round(float(st.accept_prob[:, sl].mean()), 4),
            mean_tree_depth=round(float(st.tree_depth[:, sl].float().mean()), 3),
            step_size_median_min_max=[float(f"{x:.4g}") for x in (st.step_size[:, sl].median(),
                                                                   st.step_size[:, sl].min(),
                                                                   st.step_size[:, sl].max())]))
        start += n_steps
    warm_vg = marks[-1][1] - seen["warmup_vg0"]
    samp_vg = seen["sampling_vg"]
    t = res.timings
    ss = res.sample_stats
    scalar = {k: v for k, v in res.posterior.items() if v.ndim == 2}
    diag = summary(scalar)
    ess_min = min(d["ess"] for d in diag.values())
    rhat_max = max(d["rhat"] for d in diag.values())
    eps = warm.eps
    n_rows = data.events.a.numel() + data.selection.a.numel()
    log(f"{tag} phase {phase} {run_stage.__name__}(mass_family={family!r}) from prior draws ({c} chains, "
        f"{data.events.a.shape[0]} events x {data.events.a.shape[1]} samples + {data.selection.a.numel()} "
        f"injections = {n_rows} rows, {FIT_WARMUP} warmup steps, {FIT_SAMPLES} draws, max_depth {depth}, n_grid "
        f"{N_GRID}" + (f", n_z {N_Z}" if joint else "") + f"): {wall:.2f} s wall (host clock); warmup "
        f"{t['warmup_s']:.2f} s ({warm_vg} batched value+grads, {1e3 * t['warmup_s'] / warm_vg:.2f} ms each, the "
        f"step-size search's {seen['eps_search_vg']} included), sampling {t['sampling_s']:.2f} s ({samp_vg} batched "
        f"value+grads, {1e3 * t['sampling_s'] / samp_vg:.2f} ms each; {n_draws / t['sampling_s']:.3f} draws/s), "
        f"deterministics {t['deterministics_s']:.2f} s; {n_prior} potential evaluation(s) for the prior draws")
    log(f"{tag} phase {phase} warmup by segment: {json.dumps(segments)}")
    log(f"{tag} phase {phase} step sizes: after the search median {float(seen['eps0'].median()):.4g} (min "
        f"{float(seen['eps0'].min()):.4g}, max {float(seen['eps0'].max()):.4g}); adapted (exp log_eps_bar) median "
        f"{float(eps.median()):.4g} (min {float(eps.min()):.4g}, max {float(eps.max()):.4g}); sampling: mean accept "
        f"{float(ss['accept_prob'].mean()):.3f}, mean tree depth {float(ss['tree_depth'].mean()):.2f}, divergences "
        f"{int(ss['diverging'].sum())}; largest covariance asymmetry {asym:.2e}")
    log(f"{tag} phase {phase} diagnostics over {len(scalar)} scalar sites, from {FIT_SAMPLES} draws x {c} chains "
        f"after {FIT_WARMUP} warmup steps (not an ESS/s measurement): min ESS {ess_min:.1f}, max R-hat "
        f"{rhat_max:.3f}; deterministics " + (f"kernels vs plain" if bump else
                                              f"card vs CPU ({t_cpu:.2f} s on the host)")
        + f", largest |d|/(1+|ref|) {max(worst.values()):.2e}; launches {launches}")
    if not (joint and bump):  # the potential's value+grad at the adapted state against a second evaluation
        pot = make_potential(seen["spec"])
        theta = warm.state.theta
        u_k, g_k = value_and_grad(pot, theta)
        if bump:
            label, pot_ref = "kernel A against its plain twin", make_potential(
                lk.pop_model_spec(data, N_GRID, device=dev, plain=True))
            u_p, g_p = value_and_grad(pot_ref, theta)
        else:
            label, pot_ref = "card against CPU", make_potential(spec_cpu)
            u_p, g_p = (x.to(dev) for x in value_and_grad(pot_ref, theta.cpu()))
        du = float(((u_k - u_p).abs() / (1.0 + u_p.abs())).max())
        dg = float(((g_k - g_p).abs() / (1.0 + g_p.abs())).max())
        if du >= 2e-4 or dg >= 5e-3:
            raise AssertionError(f"{family} {model} potential, {label}: |dU|/(1+|U|) {du:.3e}, "
                                 f"|dgrad|/(1+|grad|) {dg:.3e}")
        vg_ms = cuda_ms(lambda: value_and_grad(pot, theta), reps=10)
        extra = ""
        if bump:
            extra = f", {cuda_ms(lambda: value_and_grad(pot_ref, theta), reps=10):.3f} ms with its plain twin"
        log(f"{tag} phase {phase} {family} {model} potential (C={c}, {len(seen['spec'].priors)} sites, {n_rows} "
            f"rows): |dU|/(1+|U|) {du:.3e}, |dgrad|/(1+|grad|) {dg:.3e}, {label}; batched value+grad {vg_ms:.3f} "
            f"ms{extra} (CUDA events, mean of 10)")
        log(f"{tag} phase {phase} profile: " + device_busy_share(
            lambda: [value_and_grad(pot, theta) for _ in range(3)], f"three {family} {model} value+grads", n_vg=3))
    return launches, seen["spec"], seen["prior_theta"]


def fleet_queries(data, chains: int, gen, nobs: int = SBC_NOBS, nsamp: int = SBC_NSAMP, nsel: int = SBC_NSEL):
    """(chains, nobs * nsamp + nsel, 4) query tables, one a chain, in the
    shape of phase 11b's fleet: each chain's own ``nobs`` events of the
    flagship catalog with ``nsamp`` of their samples, and ``nsel`` of its
    injections, picked at random (``gen``)."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import (
        EventData,
        PopCosmoData,
        SelectionData,
        query_table,
        stack_fleet,
    )

    ev, sel = data.events, data.selection
    dev = ev.a.device
    perm = lambda n: torch.randperm(n, generator=gen, device=dev)  # noqa: E731
    parts = []
    for _ in range(chains):
        e = perm(ev.a.shape[0])[:nobs]
        s = torch.stack([perm(ev.a.shape[1])[:nsamp] for _ in range(nobs)])
        j = perm(sel.a.shape[0])[:nsel]
        parts.append(PopCosmoData(EventData(*(torch.gather(x[e], 1, s) for x in ev)),
                                  SelectionData(*(x[j] for x in sel[:4]), sel.log_ndraw)))
    return query_table(stack_fleet(parts))


def b_against_twin(label: str, tables, qry, nobs: int, nsamp: int, gen):
    """Kernel B on ``qry`` ((N, 4) or (C, N, 4)) against its plain twin, both
    epilogues, forward and backward (random cotangents), at phase 3's limits.
    Returns ({rows_fwd, rows_bwd, lse_fwd, lse_bwd: max |err|}, the kernel's
    rows, its (lse_ev, lse_sel), the cotangents (g_rows, g_ev, g_sel))."""
    import torch

    from bumpcosmology_torch.ops import cuda_logwts as kb

    c, n = tables[0].shape[0], qry.shape[-2]
    dev = qry.device
    g_rows = torch.randn((c, n), generator=gen, device=dev)
    g_ev = torch.randn((c, nobs), generator=gen, device=dev)
    g_sel = torch.randn((c,), generator=gen, device=dev)
    res, res_l = [], []
    for rows_fn, lse_fn in ((kb.logwts, kb.logwts_lse), (kb.logwts_plain, kb.logwts_lse_plain)):
        leaves = [x.clone().requires_grad_(True) for x in tables]
        out = rows_fn(*leaves, qry)
        (out.nan_to_num(neginf=0.0) * g_rows).sum().backward()
        res.append((out.detach(), *(x.grad for x in leaves)))
        leaves = [x.clone().requires_grad_(True) for x in tables]
        lse_ev, lse_sel = lse_fn(*leaves, qry, nobs, nsamp)
        torch.autograd.backward([lse_ev, lse_sel], [g_ev, g_sel])
        res_l.append((lse_ev.detach(), lse_sel.detach(), *(x.grad for x in leaves)))
    torch.cuda.synchronize()
    errs = dict(
        rows_fwd=check_close(f"{label} rows values", res[0][0], res[1][0], rtol=2e-5, atol=2e-5),
        rows_bwd=check_cotangents(f"{label} rows", res[0][1:], res[1][1:]),
        lse_fwd=max(check_close(f"{label} lse events", res_l[0][0], res_l[1][0], rtol=2e-5, atol=2e-5),
                    check_close(f"{label} lse selection", res_l[0][1], res_l[1][1], rtol=2e-5, atol=2e-5)),
        lse_bwd=check_cotangents(f"{label} lse", res_l[0][2:], res_l[1][2:]))
    return errs, res[0][0], res_l[0][:2], (g_rows * torch.isfinite(res[0][0]), g_ev, g_sel)


def b_backward_repeats(label: str, tables, qry, nobs: int, nsamp: int, gen) -> str:
    """Kernel B's backward, both epilogues, launched twice on the same inputs
    ((N, 4) or (C, N, 4) query rows, random cotangents): the two results must
    agree bit for bit (the table cotangents are summed in fixed point, the
    scalars and the cluster's combine in a fixed order).  Returns the shape."""
    import torch

    from bumpcosmology_torch.ops import cuda_logwts as kb

    c, n = tables[0].shape[0], qry.shape[-2]
    dev = qry.device
    out = kb._logwts_fwd_cuda(*tables, qry)
    g_rows = torch.randn((c, n), generator=gen, device=dev) * torch.isfinite(out)
    lse_ev, lse_sel = kb._logwts_lse_fwd_cuda(*tables, qry, nobs, nsamp)
    g_ev = torch.randn((c, nobs), generator=gen, device=dev)
    g_sel = torch.randn((c,), generator=gen, device=dev)
    for way, fn in (("rows", lambda: kb._logwts_bwd_cuda(*tables, qry, g_rows)),
                    ("lse", lambda: kb._logwts_lse_bwd_cuda(*tables, qry, lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp))):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        differ = [name for name, x, y in zip(("d_det", "d_bump", "d_scal"), first, second) if not torch.equal(x, y)]
        if differ:
            raise AssertionError(f"{label} {way} backward: two launches on the same inputs differ in {differ}")
    return f"{c} x {n}" + (" per chain" if qry.dim() == 3 else " shared")


def kernel_b_repeats(tag: str, data, sites, tables, qry, gen) -> None:
    """Phase 3, fourth part: :func:`b_backward_repeats` at every shape the
    phase runs B at: the shared table at C = 16 x 38,912 rows, and a query
    table per chain at the SBC fleet's 20 x 2,816 and the leave-one-out
    fleet's 56 x 38,656 rows."""
    import torch

    from bumpcosmology_torch.inference.influence import make_loo_datas
    from bumpcosmology_torch.inference.likelihoods import query_table

    nobs, nsamp = data.events.a.shape
    shapes = [b_backward_repeats("B", tables, qry, nobs, nsamp, gen)]
    shapes.append(b_backward_repeats("B per-chain", b_tables(tiled_sites(sites, SBC_SIMS), data),
                                     fleet_queries(data, SBC_SIMS, gen), SBC_NOBS, SBC_NSAMP, gen))
    with torch.no_grad():
        lq = query_table(make_loo_datas(data))
    shapes.append(b_backward_repeats("B per-chain LOO", b_tables(tiled_sites(sites, lq.shape[0]), data), lq,
                                     nobs - 1, nsamp, gen))
    log(f"{tag} phase 3 kernel B: two backward launches bit-identical (d_det, d_bump, d_scal; rows and lse "
        f"epilogues) at {', '.join(shapes)}")


def kernel_b_large_tables(tag: str, data, sites, qry, gen):
    """Phase 3, fifth part: kernel B on detector tables whose backward bins do
    not fit in a block's shared memory, where the backward takes its second
    route (the detector's bins in device memory): at K = ``LARGE_N_Z`` and at
    the largest K the forward takes, on the flagship's shared table (C = 16,
    38,912 rows), and at K = ``LARGE_N_Z`` on 20 per-chain tables of the SBC
    fleet's shape (20 x 2,816): both epilogues both ways against the twin at
    phase 3's limits (:func:`b_against_twin`) and the backward twice bit for
    bit (:func:`b_backward_repeats`).  Every backward launch here must take
    the second route.  Returns the kernels-line rows of that route at
    K = ``LARGE_N_Z`` on the shared table, both epilogues, timed and bounded."""
    from bumpcosmology_torch.ops import cuda_logwts as kb

    nobs, nsamp = data.events.a.shape
    c, n = next(iter(sites.values())).shape[0], qry.shape[0]
    k_max = min(kb._max_k(False, N_GRID, n), kb._max_k(False, N_GRID, n, nobs, nsamp))
    if k_max <= LARGE_N_Z or kb._max_k(True, N_GRID, n, nobs, nsamp) < k_max:
        raise AssertionError(f"B: the forward's largest K {k_max} is not beyond {LARGE_N_Z}, or the backward "
                             f"does not take it")
    before = _read_counters()
    fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})  # noqa: E731
    t8 = b_tables(sites, data, LARGE_N_Z)
    errs8, _, (lse_ev, lse_sel), (g_rows, g_ev, g_sel) = b_against_twin(f"B K={LARGE_N_Z}", t8, qry, nobs, nsamp, gen)
    shapes = [f"K={LARGE_N_Z} " + b_backward_repeats(f"B K={LARGE_N_Z}", t8, qry, nobs, nsamp, gen)]
    tmax = b_tables(sites, data, k_max)
    errs_max = b_against_twin(f"B K={k_max}", tmax, qry, nobs, nsamp, gen)[0]
    shapes.append(f"K={k_max} " + b_backward_repeats(f"B K={k_max}", tmax, qry, nobs, nsamp, gen))
    t20 = b_tables(tiled_sites(sites, SBC_SIMS), data, LARGE_N_Z)
    fq = fleet_queries(data, SBC_SIMS, gen)
    errs20 = b_against_twin(f"B per-chain K={LARGE_N_Z}", t20, fq, SBC_NOBS, SBC_NSAMP, gen)[0]
    shapes.append(f"K={LARGE_N_Z} " + b_backward_repeats(f"B per-chain K={LARGE_N_Z}", t20, fq, SBC_NOBS, SBC_NSAMP,
                                                         gen))
    launched = {k: v for k, v in _delta(_read_counters(), before).items() if v}
    second = [f"logwts{e}_bwd_global{layout}" for e in ("", "_lse") for layout in ("", "_per_chain")]
    if any(k.startswith(("logwts_bwd", "logwts_lse_bwd")) and k not in second for k in launched) or not all(
            launched.get(k, 0) for k in second):
        raise AssertionError(f"B: the backward beyond its bins' shared memory did not take its second route: "
                             f"{launched}")

    bwd = lambda: kb._logwts_lse_bwd_cuda(*t8, qry, lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp)  # noqa: E731
    rows_bwd = lambda: kb._logwts_bwd_cuda(*t8, qry, g_rows)  # noqa: E731

    def lse_bwd_plain():
        r = kb._evaluate(*t8, qry)
        return kb._bwd_of_rows(r, *t8, kb._lse_row_cotangent(r["out"], lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp))

    (l_ms, l_call), (r_ms, r_call) = both_ms(bwd), both_ms(rows_bwd)
    l_plain, r_plain = cuda_ms(lse_bwd_plain), cuda_ms(lambda: kb._logwts_bwd_plain(*t8, qry, g_rows))
    table_bytes = c * (LARGE_N_Z * 8 + N_GRID * 4 + 15 * 4)
    seg_bytes = c * (nobs + 1) * 4
    rows = {
        "logwts_bwd_global": dict(ms=r_ms, call_ms=r_call, plain_ms=r_plain, max_abs_err=errs8["rows_bwd"],
                                  bound=bound_ms(n * 16 + 2 * table_bytes + c * n * 4, c * n * OPS_B_BWD_PER_QUERY)),
        "logwts_lse_bwd_global": dict(ms=l_ms, call_ms=l_call, plain_ms=l_plain, max_abs_err=errs8["lse_bwd"],
                                      bound=bound_ms(n * 16 + 2 * table_bytes + 2 * seg_bytes,
                                                     c * n * (OPS_B_BWD_PER_QUERY + OPS_B_LSE_BWD_EXTRA))),
    }
    log(f"{tag} phase 3 kernel B beyond the backward bins' shared memory (second route, bins in device memory): "
        f"max|err| against the twin at K={LARGE_N_Z} (C={c}, N={n}) {fmt(errs8)}, at the forward's largest K={k_max} "
        f"{fmt(errs_max)}, per chain at K={LARGE_N_Z} ({SBC_SIMS} x {fq.shape[1]}) {fmt(errs20)}; two backward "
        f"launches bit-identical at {', '.join(shapes)}; launches {launched}; at K={LARGE_N_Z}: lse bwd device "
        f"{l_ms:.5f} ms, call {l_call:.4f} ms (plain {l_plain:.4f}), bound "
        f"{rows['logwts_lse_bwd_global']['bound'][0]:.6f} ms; rows bwd device {r_ms:.5f} ms, call {r_call:.4f} ms (plain {r_plain:.4f}), bound "
        f"{rows['logwts_bwd_global']['bound'][0]:.6f} ms")
    return rows


def kernel_p_phase(tag: str) -> dict:
    """Phase 3p: kernel P on the joint model's 15 priors at C = 4 and C = 128
    (``tools/kernel_times.kernel_p_times``: held to the per-site code within
    ``testing.priors_gaps``' limits, each launch timed, bounded and beside
    the per-site code's eager call on the card).  Returns the kernels-line
    rows of the forward and the backward at C = 4, the flagship benchmark's."""
    from bumpcosmology_torch.tools.kernel_times import kernel_p_times

    def row(fn, err, **graph_kwargs):
        ms, call_ms = both_ms(fn, **graph_kwargs)
        return dict(ms=ms, call_ms=call_ms, max_abs_err=err)

    kernels, shape = kernel_p_times(ROOT, row, check_close, N_GRID, N_Z, SEED)
    log(f"{tag} phase 3p kernel P ({shape['dim']} sites, C = {shape['C']}; max_abs_err is the largest gap over "
        f"testing.priors_gaps' limit, at most 1; ms device time in one replayed graph, call_ms one eager call, "
        f"plain_ms the per-site code's eager call on the card, bound_ms the bytes at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s): " + json.dumps({k: {f: float(f"{v:.4g}") for f, v in r.items()} for k, r in kernels.items()}))
    return {name: dict(kernels[f"{name}_c4"], bound=(kernels[f"{name}_c4"]["bound_ms"], "bytes"))
            for name in PRIORS}


def potential_large_table_phase(tag: str, data, theta, u_1024):
    """Phase 4b: the joint potential of the flagship at ``n_z`` = ``LARGE_N_Z``
    from the committed state (16 chains), a table on kernel B's second
    backward route.  With every launch count set to 0 just before one
    value+grad and read just after: kernel A and B's ``lse`` epilogue once
    each way (the backward on its second route), nothing else.  Against the
    plain twins at phase 4's limits, and twice bit for bit.  Prints
    |U(``LARGE_N_Z``) - U(``N_Z``)| beside the JAX package's note (about 0.10
    nats between n_z = 1,024 and an 8,192-point oracle, its
    ``likelihoods.py:716-721``).  Returns the launch counts."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad

    pot = make_potential(pop_cosmo_model_spec(data, N_GRID, LARGE_N_Z))
    pot_plain = make_potential(pop_cosmo_model_spec(data, N_GRID, LARGE_N_Z, plain=True))
    value_and_grad(pot, theta)  # the backward's route is read once per shape
    _zero_counters()
    u, g = value_and_grad(pot, theta)
    torch.cuda.synchronize()
    launches = _read_counters()
    expected = {"bump_fwd": 1, "bump_bwd": 1, "logwts_lse_fwd": 1, "logwts_lse_bwd_global": 1, "priors_fwd": 1,
                "priors_bwd": 1}
    if {k: v for k, v in launches.items() if v} != expected:
        raise AssertionError(f"potential at n_z={LARGE_N_Z}: launches {launches}, expected {expected}")
    u2, g2 = value_and_grad(pot, theta)
    u_p, g_p = value_and_grad(pot_plain, theta)
    torch.cuda.synchronize()
    if not (torch.isfinite(u).all() and torch.isfinite(g).all()):
        raise AssertionError(f"potential at n_z={LARGE_N_Z}: non-finite value or gradient at the warm thetas")
    if not (torch.equal(u, u2) and torch.equal(g, g2)):
        raise AssertionError(f"potential at n_z={LARGE_N_Z}: two value+grads at the same thetas differ")
    du = float(((u - u_p).abs() / (1.0 + u_p.abs())).max())
    dg = float(((g - g_p).abs() / (1.0 + g_p.abs())).max())
    if du >= 2e-4 or dg >= 5e-3:
        raise AssertionError(f"potential at n_z={LARGE_N_Z}: kernels vs plain |dU|/(1+|U|) {du:.3e}, "
                             f"|dgrad|/(1+|grad|) {dg:.3e}")
    vg_ms = cuda_ms(lambda: value_and_grad(pot, theta), reps=5)
    shift = (u - u_1024).abs()
    log(f"{tag} phase 4b potential at n_z={LARGE_N_Z} (C={theta.shape[0]}): launches "
        f"{ {k: v for k, v in launches.items() if v} }; |dU|/(1+|U|) {du:.3e}, |dgrad|/(1+|grad|) {dg:.3e} against "
        f"the plain twins; two value+grads bit-identical; batched value+grad {vg_ms:.3f} ms (CUDA events, mean of 5); "
        f"|U({LARGE_N_Z}) - U({N_Z})| max {float(shift.max()):.4f}, median {float(shift.median()):.4f} nats "
        f"(the JAX package's note: about 0.10 nats between n_z = 1,024 and an 8,192-point oracle)")
    return launches


def kernel_b_layouts(tag: str, data, sites, tables, qry, gen):
    """Phase 3, second part: kernel B's two query layouts.

    (i) The flagship's shared (N, 4) table copied once per chain, (16, 38,912,
    4): forward values (``rows``, and the ``lse`` epilogue's) bit for bit
    those of the shared table, and both epilogues forward and backward
    against the twin at phase 3's limits.  (ii) 20 distinct per-chain tables
    of 2,816 rows (:func:`fleet_queries`, phase 11b's shape) under the tables
    of 20 chains (the chains of ``sites`` and the first ones again): the same
    checks, then the per-chain ``lse`` kernels timed.  Returns their
    kernels-line rows."""
    import torch

    from bumpcosmology_torch.ops import cuda_logwts as kb

    c = tables[0].shape[0]
    nobs, nsamp = data.events.a.shape
    copied = qry.expand(c, -1, -1).contiguous()
    same = {
        "rows": torch.equal(kb._logwts_fwd_cuda(*tables, qry), kb._logwts_fwd_cuda(*tables, copied)),
        "lse": all(torch.equal(a, b) for a, b in zip(kb._logwts_lse_fwd_cuda(*tables, qry, nobs, nsamp),
                                                      kb._logwts_lse_fwd_cuda(*tables, copied, nobs, nsamp))),
    }
    if not all(same.values()):
        raise AssertionError(f"B: the copied per-chain table's forward values differ from the shared table's: {same}")
    errs_copied = b_against_twin("B copied", tables, copied, nobs, nsamp, gen)[0]
    copied_ms = {name: graph_ms(fn) for name, fn in (
        ("rows_fwd", lambda: kb._logwts_fwd_cuda(*tables, copied)),
        ("lse_fwd", lambda: kb._logwts_lse_fwd_cuda(*tables, copied, nobs, nsamp)))}

    # (ii) 20 distinct per-chain tables of the fleet's shape, under 20 chains' tables
    tables20 = b_tables(tiled_sites(sites, SBC_SIMS), data)
    fq = fleet_queries(data, SBC_SIMS, gen)
    out, errs, times = per_chain_lse_rows("B per-chain", tables20, fq, SBC_NOBS, SBC_NSAMP, gen)
    fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})  # noqa: E731
    log(f"{tag} phase 3 kernel B, the shared table copied per chain ({c} x {qry.shape[0]} x 4): forward values "
        f"bit-identical to the shared table's (rows and lse); max|err| against the twin {fmt(errs_copied)}; device "
        f"ms rows fwd {copied_ms['rows_fwd']:.5f}, lse fwd {copied_ms['lse_fwd']:.5f} (shared: phase 3 above)")
    log(f"{tag} phase 3 kernel B, {fq.shape[0]} distinct per-chain tables of {fq.shape[1]} rows ({SBC_NOBS} events "
        f"x {SBC_NSAMP} samples + {SBC_NSEL} injections a chain, K={tables20[0].shape[1]}, G={N_GRID}): max|err| "
        f"against the twin {fmt(errs)}; {times}")
    return out


def kernel_b_certificate_shape(tag: str, data, sites, gen) -> None:
    """Phase 3, the SBC certificate's shape (phase 15b): 128 distinct
    per-chain tables of 7,680 rows (16 events x 256 samples + 3,584
    injections a chain, :func:`fleet_queries`) under 128 chains' tables at
    ``n_grid`` 128 and ``n_z`` 256: both epilogues, one launch each way,
    against the twin at phase 3's limits (:func:`b_against_twin`)."""
    tables = b_tables(tiled_sites(sites, CERT_SIMS), data, n_z=CERT_N_Z, n_grid=CERT_GRID)
    fq = fleet_queries(data, CERT_SIMS, gen, nobs=CERT_NOBS, nsamp=CERT_NSAMP, nsel=CERT_NSEL)
    errs = b_against_twin("B per-chain certificate", tables, fq, CERT_NOBS, CERT_NSAMP, gen)[0]
    log(f"{tag} phase 3 kernel B at the SBC certificate's shape (phase 15b): {fq.shape[0]} per-chain tables of "
        f"{fq.shape[1]} rows, K={tables[0].shape[1]}, G={tables[1].shape[1]}: max|err| against the twin "
        + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()}))


def tiled_sites(sites, n: int):
    """The constrained ``sites`` (C,) repeated to ``n`` chains."""
    return {k: v.repeat(-(-n // v.shape[0]))[:n] for k, v in sites.items()}


def per_chain_lse_rows(label: str, tables, fq, nobs: int, nsamp: int, gen, suffix: str = ""):
    """Kernel B's ``lse`` epilogue on the per-chain tables ``fq`` (C, N, 4):
    :func:`b_against_twin`, then both ways timed beside the twin and bounded.
    Returns (the kernels-line rows ``logwts_lse_{fwd,bwd}_per_chain<suffix>``,
    the errors, a line of times)."""
    from bumpcosmology_torch.ops import cuda_logwts as kb

    errs, _, (lse_ev, lse_sel), (_, g_ev, g_sel) = b_against_twin(label, tables, fq, nobs, nsamp, gen)
    fwd = lambda: kb._logwts_lse_fwd_cuda(*tables, fq, nobs, nsamp)  # noqa: E731
    bwd = lambda: kb._logwts_lse_bwd_cuda(*tables, fq, lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp)  # noqa: E731

    def bwd_plain():
        r = kb._evaluate(*tables, fq)
        g = kb._lse_row_cotangent(r["out"], lse_ev, lse_sel, g_ev, g_sel, nobs, nsamp)
        return kb._bwd_of_rows(r, *tables, g)

    (f_ms, f_call), (b_ms, b_call) = both_ms(fwd), both_ms(bwd)
    f_plain = cuda_ms(lambda: kb._segment_lse(kb._evaluate(*tables, fq)["out"], nobs, nsamp))
    b_plain = cuda_ms(bwd_plain)
    c, n = fq.shape[:2]
    table_bytes = c * (tables[0].shape[1] * 8 + N_GRID * 4 + 15 * 4)
    seg_bytes = c * (nobs + 1) * 4
    rows = {
        "logwts_lse_fwd_per_chain" + suffix: dict(
            ms=f_ms, call_ms=f_call, plain_ms=f_plain, max_abs_err=errs["lse_fwd"],
            bound=bound_ms(c * n * 16 + table_bytes + seg_bytes, c * n * (OPS_B_FWD_PER_QUERY + OPS_B_LSE_FWD_EXTRA))),
        "logwts_lse_bwd_per_chain" + suffix: dict(
            ms=b_ms, call_ms=b_call, plain_ms=b_plain, max_abs_err=errs["lse_bwd"],
            bound=bound_ms(c * n * 16 + 2 * table_bytes + 2 * seg_bytes,
                           c * n * (OPS_B_BWD_PER_QUERY + OPS_B_LSE_BWD_EXTRA))),
    }
    (bf, bf_by), (bb, bb_by) = (rows[f"logwts_lse_{way}_per_chain{suffix}"]["bound"] for way in ("fwd", "bwd"))
    times = (f"lse fwd device {f_ms:.5f} ms, call {f_call:.4f} ms (plain {f_plain:.4f}), bound {bf:.6f} ms by "
             f"{bf_by}; lse bwd device {b_ms:.5f} ms, call {b_call:.4f} ms (plain {b_plain:.4f}), bound {bb:.6f} ms "
             f"by {bb_by}")
    return rows, errs, times


def kernel_b_comparison_shapes(tag: str, data, sites, qry, gen):
    """Phase 3, third part: kernel B at phase 12's shapes.  (i) The shared
    table at C = 64 (``CompareConfig.batch``: the pointwise matrix's and the
    evidence's batches; the 16 chains' tables four times over): both
    epilogues, both ways, against the twin at phase 3's limits, and the
    ``lse`` forward timed.  (ii) A query table per chain at the
    leave-one-out fleet's shape: the flagship's 56 catalogs with one event
    removed (``influence.make_loo_datas``), 56 x 38,656 rows (55 events x 256
    samples + 24,576 injections a chain) under 56 chains' tables: the same
    checks, then the per-chain ``lse`` kernels timed and bounded.  Returns
    the kernels-line rows of (ii)."""
    import torch

    from bumpcosmology_torch.inference.influence import make_loo_datas
    from bumpcosmology_torch.inference.likelihoods import query_table
    from bumpcosmology_torch.ops import cuda_logwts as kb

    nobs, nsamp = data.events.a.shape
    fmt = lambda d: json.dumps({k: float(f"{v:.3e}") for k, v in d.items()})  # noqa: E731
    t64 = b_tables(tiled_sites(sites, COMPARE_BATCH), data)
    errs64 = b_against_twin(f"B shared C={COMPARE_BATCH}", t64, qry, nobs, nsamp, gen)[0]
    f64, f64_call = both_ms(lambda: kb._logwts_lse_fwd_cuda(*t64, qry, nobs, nsamp))
    n = qry.shape[0]
    b64 = bound_ms(n * 16 + COMPARE_BATCH * (t64[0].shape[1] * 8 + N_GRID * 4 + 15 * 4 + (nobs + 1) * 4),
                   COMPARE_BATCH * n * (OPS_B_FWD_PER_QUERY + OPS_B_LSE_FWD_EXTRA))
    log(f"{tag} phase 3 kernel B, the shared table at C={COMPARE_BATCH} (compare's batch, {n} rows): max|err| "
        f"against the twin {fmt(errs64)}; lse fwd device {f64:.5f} ms, call {f64_call:.4f} ms, bound {b64[0]:.6f} "
        f"ms by {b64[1]}")
    with torch.no_grad():
        lq = query_table(make_loo_datas(data))
    s, n = lq.shape[:2]
    if (s, n) != (nobs, (nobs - 1) * nsamp + data.selection.a.shape[0]):
        raise AssertionError(f"B per-chain LOO: query tables of shape {tuple(lq.shape)}")
    t56 = b_tables(tiled_sites(sites, s), data)
    rows, errs, times = per_chain_lse_rows("B per-chain LOO", t56, lq, nobs - 1, nsamp, gen, suffix="_loo")
    log(f"{tag} phase 3 kernel B, the leave-one-out fleet's {s} per-chain tables of {n} rows ({nobs - 1} events x "
        f"{nsamp} samples + {data.selection.a.shape[0]} injections a chain, {lq.numel() * 4 / 1e6:.1f} MB): max|err| "
        f"against the twin {fmt(errs)}; {times}")
    return rows


def family_repeats_phase(dev, tag: str) -> dict:
    """Phase 15a: the PLPEAK and BROKENPL joint potentials (the fused
    detector-table route in plain PyTorch, no kernel) at the first 16 of 64
    prior draws whose value+grad is finite (seed 0), on the flagship shared
    by the chains and on a fleet of 16 catalogs (the flagship without event
    ``s`` for chain ``s``: a query table per chain, as the SBC fleet reads
    it).  Two value+grads must give the same bits; the first 4 chains are
    held against the same potential on the CPU at phase 4's limits
    (|dU|/(1+|U|) < 2e-4, |dgrad|/(1+|grad|) < 5e-3); each value+grad is
    timed (CUDA events, mean of 5).  Every launch count is set to 0 before
    and read after: none may move.  Returns the launches."""
    import torch

    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.influence import make_loo_datas
    from bumpcosmology_torch.inference.likelihoods import (
        MASS_FAMILIES,
        ModelSpec,
        dl_bounds_of,
        pop_cosmo_loglike,
        take_fleet,
    )
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad
    from bumpcosmology_torch.tools.potential_repeats import family_thetas

    cpu = torch.device("cpu")
    data = load_pop_cosmo_data(CATALOG, device=dev)
    with torch.no_grad():
        fleet = take_fleet(make_loo_datas(data), torch.arange(FAMILY_CHAINS, device=dev))
    bits = lambda x: x.view(torch.int32)  # noqa: E731  (a NaN equals itself)
    results, n_card = {}, [0]

    def card_vg(pot, theta):
        n_card[0] += 1
        return value_and_grad(pot, theta)

    _zero_counters()
    for family in ("plpeak", "brokenpl"):
        fam = MASS_FAMILIES[family]
        theta = family_thetas(fam.cosmo_spec(data, N_GRID, N_Z, device=dev), FAMILY_CHAINS)
        n_card[0] += 1  # family_thetas: one value+grad of its candidates on the card
        for layout, d in (("shared", data), ("fleet", fleet)):
            bounds = dl_bounds_of(d)
            pot = make_potential(fam.cosmo_spec(d, N_GRID, N_Z, device=dev))
            (u1, g1), (u2, g2) = card_vg(pot, theta), card_vg(pot, theta)
            torch.cuda.synchronize()
            if not (torch.equal(bits(u1), bits(u2)) and torch.equal(bits(g1), bits(g2))):
                raise AssertionError(f"{family} joint, {layout} table: two value+grads at the same thetas differ")
            sub = d if layout == "shared" else take_fleet(d, torch.arange(FAMILY_CPU_CHAINS, device=dev))
            sub = sub.to(cpu)
            spec_cpu = ModelSpec(priors=dict(fam.cosmo_priors), device=cpu, loglike=lambda sites, sub=sub, b=bounds:
                                 pop_cosmo_loglike(sites, sub, N_GRID, N_Z, b, build=fam.build))
            u_c, g_c = value_and_grad(make_potential(spec_cpu), theta[:FAMILY_CPU_CHAINS].cpu())
            u_k, g_k = u1[:FAMILY_CPU_CHAINS].cpu(), g1[:FAMILY_CPU_CHAINS].cpu()
            du = float(((u_k - u_c).abs() / (1.0 + u_c.abs())).max())
            dg = float(((g_k - g_c).abs() / (1.0 + g_c.abs())).max())
            if not (du < 2e-4 and dg < 5e-3):
                raise AssertionError(f"{family} joint, {layout} table: card vs CPU |dU|/(1+|U|) {du:.3e}, "
                                     f"|dgrad|/(1+|grad|) {dg:.3e}")
            ms = cuda_ms(lambda: card_vg(pot, theta), reps=5, warmup=1)
            results[f"{family} {layout}"] = dict(du=float(f"{du:.3e}"), dg=float(f"{dg:.3e}"), ms=round(ms, 3))
    launches = _read_counters()
    if any(_but_priors(launches).values()):
        raise AssertionError(f"phase 15a: the families' potentials launched kernels other than P: {launches}")
    check_priors("phase 15a", launches, n_card[0])
    log(f"{tag} phase 15a the families' joint value+grads ({FAMILY_CHAINS} chains; the flagship shared, and "
        f"{FAMILY_CHAINS} leave-one-out catalogs one a chain; kernel P once each way in each of the {n_card[0]} on "
        f"the card): two bit-identical at each; the first "
        f"{FAMILY_CPU_CHAINS} chains card vs CPU and ms a value+grad (CUDA events, mean of 5): {json.dumps(results)}")
    return launches


def certificate_tool_phase(dev, tag: str) -> dict:
    """Phase 15c: ``tools/sbc_certificate.py`` end to end for ``plpeak`` at
    the reference driver's configuration cut to ``CERT_SMOKE_SIMS``
    simulations, ``CERT_SMOKE_WARMUP`` + ``CERT_SMOKE_SAMPLES`` transitions
    at ``max_depth`` ``CERT_SMOKE_DEPTH`` (the campaign stays the
    certificate's 6.5·10⁶ draws: at SNR 20 a 10⁶-draw campaign detects about
    600 injections, fewer than the 3,584 the fresh-noise simulator draws its
    selection set from).  Every launch count is set to 0 just before and read
    just after: the campaign's launches only, kernel C (its SNRs) and kernel
    A's forward at most once (the fiducial population of its draws, which
    ``data/weights.py`` builds once a process: phase 6 has built it), no
    backward and no kernel B (the family's fit is plain PyTorch).  The artifact must carry the
    JAX layout's keys with every rank in [0, n_bins), the rate check must
    have run; the verdict is printed, not held, at this depth.  Returns the
    launches."""
    import numpy as np

    from bumpcosmology_torch.inference import calibration as cal
    from bumpcosmology_torch.tools import sbc_certificate

    overrides = [f"sbc.n_sims={CERT_SMOKE_SIMS}", f"sbc.num_warmup={CERT_SMOKE_WARMUP}",
                 f"sbc.num_samples={CERT_SMOKE_SAMPLES}", f"sbc.max_depth={CERT_SMOKE_DEPTH}"]
    from bumpcosmology_torch.inference import model

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cert_") as tmp:
        _zero_counters()
        r = sbc_certificate.run_certificate("plpeak", out=tmp, device=dev, overrides=overrides)
        launches, n_vg = _read_counters(), model.COUNTS["value_and_grads"]
        with np.load(Path(tmp) / "sbc_ranks.npz") as d:
            art = {k: d[k] for k in d.files}
    proto = cal.COSMO_SBC_SPEC_BUILDERS["plpeak"](device=dev)(None)
    sites = [k for k in proto.priors if k != "R_unit"]
    expected = ({"attrs/model", "attrs/n_sims", "attrs/all_pass", "ranks/n_bins", "pvalues/site", "pvalues/p",
                 "pvalues/passed", "rate_check/ranks", "rate_check/attrs/p", "rate_check/attrs/passed",
                 "rate_check/attrs/method"} | {f"ranks/{k}" for k in sites} | {f"pvalues/attrs/{k}" for k in sites})
    _stage_artifact_keys("phase 15c sbc_ranks.npz", art, expected)
    n_bins = int(art["ranks/n_bins"])
    if any(not np.all((art[f"ranks/{k}"] >= 0) & (art[f"ranks/{k}"] < n_bins)) for k in sites):
        raise AssertionError("phase 15c: a rank outside [0, n_bins)")
    if r["rate_p"] is None or not np.isfinite(r["rate_p"]):
        raise AssertionError("phase 15c: the rate check did not run")
    if (launches["snr_integral"] == 0 or launches["bump_fwd"] > 1
            or any(v for k, v in launches.items() if k not in ("snr_integral", "bump_fwd") + PRIORS)):
        raise AssertionError(f"phase 15c: launches {launches} (the campaign's: kernel C, A's forward at most "
                             "once; the fleet's priors: P)")
    check_priors("phase 15c", launches, n_vg, n_vg + 16)  # the 16 start candidates' potentials
    log(f"{tag} phase 15c sbc_certificate --family plpeak cut to {CERT_SMOKE_SIMS} simulations, "
        f"{CERT_SMOKE_WARMUP} + {CERT_SMOKE_SAMPLES} transitions at max_depth {CERT_SMOKE_DEPTH}: wall "
        f"{r['wall_s']:.2f} s (campaign {r['campaign_s']:.2f}, simulations {r['simulate_s']:.2f}, candidates "
        f"{r['init_s']:.2f}, warmup {r['warmup_s']:.2f}, sampling {r['sampling_s']:.2f}, rate check "
        f"{r['rate_check_s']:.2f}); {r['value_grads']} batched value+grads at {r['ms_per_value_grad']:.2f} ms; "
        f"verdict {'PASS' if r['passed'] else 'FAIL'} (printed, not held: min p {r['min_p']:.3f}), rate check p "
        f"{r['rate_p']:.3f}; launches {launches}")
    return launches


def _now() -> float:
    import torch

    torch.cuda.synchronize()
    return time.perf_counter()


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _stage_artifact_keys(name: str, keys, expected) -> None:
    if set(keys) != set(expected):
        raise AssertionError(f"{name}: keys {sorted(set(keys) ^ set(expected))} differ from the JAX layout's")


def sbc_phase(dev, tag: str, model: str):
    """Phase 11a (``model="pop"``) and 11b (``"pop_cosmo"``): ``_stage_sbc``
    at ``SBCConfig``'s defaults but for the fit's depth (``SBC_WARMUP`` warmup
    steps, ``SBC_SAMPLES`` draws, ``max_depth`` ``SBC_DEPTH``) and, for the
    joint model, a campaign of ``SBC_COSMO_CAMPAIGN`` draws (the default
    200,000 detect some 120 injections at SNR 20, fewer than the 2,048 the
    fresh-noise simulator draws its pool from: the stage raises there, as
    the JAX package's does).  Every launch count is set to 0 just before the
    stage and read just after, and read at the window edges: the 16 initial
    candidates' potentials (kernel A's forward and, joint, B's per-chain
    ``lse`` forward once each), then the fleet fit (one of each kernel each
    way per batched value+grad, B through its per-chain layout, never the
    shared one).  The artifact must carry the JAX layout's keys, every rank
    lie in [0, n_bins), and (joint) the rate check give numbers.  On the
    joint model the fleet potential of 3 simulations is held against the same
    on the CPU at phase 4's limits.  Returns the stage's launch counts."""
    import numpy as np
    import torch

    import bumpcosmology_torch.mock as mock
    from bumpcosmology_torch.inference import calibration as cal
    from bumpcosmology_torch.inference import fleet as fleet_mod
    from bumpcosmology_torch.inference.likelihoods import take_fleet
    from bumpcosmology_torch.inference.model import value_and_grad
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.pipeline.config import PathsConfig, PipelineConfig, SBCConfig

    joint = model == "pop_cosmo"
    phase = "11b" if joint else "11a"
    sbc = SBCConfig(model=model, num_warmup=SBC_WARMUP, num_samples=SBC_SAMPLES, max_depth=SBC_DEPTH)
    if joint:
        sbc.campaign_ndraw = SBC_COSMO_CAMPAIGN
    log(f"{tag} phase {phase} cut: num_warmup {sbc.num_warmup} (default 200), num_samples {sbc.num_samples} "
        f"(default 256), max_depth {sbc.max_depth} (default 8)"
        + (f"; campaign_ndraw {sbc.campaign_ndraw} (default 200,000: too few detections for the fresh-noise pool)"
           if joint else ""))
    marks, seen, counts = {}, {}, {"value_grad": 0}
    real = dict(draw=mock.draw_injection_campaign, fleet=fleet_mod.fleet_fit, stack=cal.stack_fleet,
                write=stages.write_sbc_artifact, mu=cal.selection_mu_samples)

    def draw(*args, **kwargs):
        out = real["draw"](*args, **kwargs)
        marks["campaign"] = _now()
        return out

    def stack(datas):
        marks["simulated"], seen["at_stack"] = _now(), _read_counters()
        seen["datas_list"] = datas
        return real["stack"](datas)

    def fit(make_pot, datas, theta0, *args, **kwargs):
        marks["init"], seen["at_fleet"] = _now(), _read_counters()

        def counted_make_pot(d):
            pot = make_pot(d)

            def counted(theta):
                counts["value_grad"] += 1  # the fleet makes value+grads only
                return pot(theta)

            return counted

        res = real["fleet"](counted_make_pot, datas, theta0, *args, **kwargs)
        marks["fleet"], seen["after_fleet"] = _now(), _read_counters()
        seen.update(res=res, datas=datas, make_pot=make_pot)
        return res

    def mu(*args, **kwargs):
        t = _now()
        out = real["mu"](*args, **kwargs)
        marks["mu_s"] = _now() - t
        return out

    def write(*args, **kwargs):
        marks["write"] = _now()
        bad = real["write"](*args, **kwargs)
        marks["written"] = _now()
        return bad

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sbc_") as tmp:
        cfg = PipelineConfig(paths=PathsConfig(data_dir=tmp), sbc=sbc)
        mock.draw_injection_campaign, fleet_mod.fleet_fit, cal.stack_fleet = draw, fit, stack
        stages.write_sbc_artifact, cal.selection_mu_samples = write, mu
        try:
            _zero_counters()
            t0 = time.perf_counter()
            stages._stage_sbc(cfg, device=dev)
            wall = _now() - t0
            launches = _read_counters()
        finally:
            mock.draw_injection_campaign, fleet_mod.fleet_fit, cal.stack_fleet = real["draw"], real["fleet"], real[
                "stack"]
            stages.write_sbc_artifact, cal.selection_mu_samples = real["write"], real["mu"]
        path = Path(tmp) / "sbc_ranks.npz"
        with np.load(path) as d:
            art = {k: d[k] for k in d.files}
    res, datas = seen["res"], seen["datas"]
    n_vg, s = counts["value_grad"], res.thetas.shape[0]

    # the launches: the candidates' window, then the fleet's
    init, fleet = _delta(seen["at_fleet"], seen["at_stack"]), _delta(seen["after_fleet"], seen["at_fleet"])
    b = "logwts_lse_fwd_per_chain", "logwts_lse_bwd_per_chain"
    others = lambda d, keep: [k for k, v in d.items() if v and k not in keep]  # noqa: E731
    ok_init = init["bump_fwd"] == 16 and (init[b[0]] == 16 if joint else True)
    ok_init &= not others(init, ("bump_fwd",) + ((b[0],) if joint else ()) + PRIORS)
    ok_fleet = fleet["bump_fwd"] == fleet["bump_bwd"] == n_vg > 0
    if joint:
        ok_fleet &= fleet[b[0]] == fleet[b[1]] == n_vg
    ok_fleet &= not others(fleet, ("bump_fwd", "bump_bwd") + (b if joint else ()) + PRIORS)
    if not (ok_init and ok_fleet):
        raise AssertionError(f"sbc {model}: launches not once per potential: candidates {init}, fleet {fleet} "
                             f"({n_vg} batched value+grads)")
    check_priors(f"sbc {model} candidates", init, 0, 16)
    check_priors(f"sbc {model} fleet", fleet, n_vg)

    # the artifact
    sites = [k[len("ranks/"):] for k in art if k.startswith("ranks/") and k != "ranks/n_bins"]
    expected = ["attrs/model", "attrs/n_sims", "attrs/all_pass", "ranks/n_bins", "pvalues/site", "pvalues/p",
                "pvalues/passed"] + [f"ranks/{k}" for k in sites] + [f"pvalues/attrs/{k}" for k in sites]
    if joint:
        expected += ["rate_check/ranks", "rate_check/attrs/p", "rate_check/attrs/passed", "rate_check/attrs/method"]
    _stage_artifact_keys("sbc_ranks.npz", art, expected)
    n_bins = int(art["ranks/n_bins"])
    rank_lo, rank_hi = min(int(art[f"ranks/{k}"].min()) for k in sites), max(int(art[f"ranks/{k}"].max()) for k in sites)
    if not (n_bins == SBC_SAMPLES // 4 + 1 and 0 <= rank_lo and rank_hi < n_bins and "R_unit" not in sites
            and all(art[f"ranks/{k}"].shape == (SBC_SIMS,) for k in sites)):
        raise AssertionError(f"sbc {model}: ranks in [{rank_lo}, {rank_hi}] with n_bins {n_bins}, sites {sites}")
    if joint and not np.isfinite(art["rate_check/ranks"]).all():
        raise AssertionError("sbc: the rate-reconstruction check gave no numbers")

    # the fleet's potential at its last draws: ms per batched value+grad, profile, and (joint) card against CPU
    pot = seen["make_pot"](datas)
    theta = res.thetas[:, -1].contiguous()
    vg_ms = cuda_ms(lambda: value_and_grad(pot, theta), reps=10)
    extra = ""
    if joint:
        idx = torch.arange(FLEET_CPU_SIMS, device=dev)
        sub = take_fleet(datas, idx)
        u_k, g_k = value_and_grad(seen["make_pot"](sub), theta[:FLEET_CPU_SIMS])
        u_c, g_c = value_and_grad(seen["make_pot"](sub.to("cpu")), theta[:FLEET_CPU_SIMS].cpu())
        u_c, g_c = u_c.to(dev), g_c.to(dev)
        du = float(((u_k - u_c).abs() / (1.0 + u_c.abs())).max())
        dg = float(((g_k - g_c).abs() / (1.0 + g_c.abs())).max())
        if du >= 2e-4 or dg >= 5e-3 or not bool(torch.isfinite(u_k).all()):
            raise AssertionError(f"sbc fleet potential, card against CPU: |dU|/(1+|U|) {du:.3e}, "
                                 f"|dgrad|/(1+|grad|) {dg:.3e}")
        extra = f"; fleet potential of {FLEET_CPU_SIMS} simulations, card against CPU: |dU|/(1+|U|) {du:.3e}, " \
                f"|dgrad|/(1+|grad|) {dg:.3e}"
    n_rows = datas.events.a[0].numel() + datas.selection.a.shape[-1]
    split = dict(campaign=marks["campaign"] - t0, simulation=marks["simulated"] - marks["campaign"],
                 candidates=marks["init"] - marks["simulated"], fleet_warmup=res.warmup_s,
                 fleet_sampling=res.sampling_s,
                 ranks_pvalues_rate_check=marks["write"] - marks["fleet"], rate_check_mu=marks.get("mu_s", 0.0),
                 write=marks["written"] - marks["write"])
    pvals = {str(k): round(float(p), 3) for k, p in zip(art["pvalues/site"], art["pvalues/p"])}
    fit_s = res.warmup_s + res.sampling_s
    log(f"{tag} phase {phase} _stage_sbc(model={model!r}): {SBC_SIMS} simulations x {n_rows} rows a chain "
        f"({datas.events.a.shape[1]} events x {datas.events.a.shape[2]} samples + {datas.selection.a.shape[-1]} "
        f"injections), fleet width S = {s}, {SBC_WARMUP} warmup steps + {SBC_SAMPLES} draws at max_depth "
        f"{SBC_DEPTH}: {wall:.2f} s wall (host clock, s: {json.dumps({k: round(v, 3) for k, v in split.items()})}); "
        f"{n_vg} batched value+grads, {1e3 * fit_s / n_vg:.2f} ms each in the fleet, {vg_ms:.3f} ms alone at S = {s} "
        f"(CUDA events, mean of 10); adapted step size median {float(res.eps.median()):.4g}, sampling mean accept "
        f"{float(res.accept.mean()):.3f}{extra}")
    log(f"{tag} phase {phase} ranks in [{rank_lo}, {rank_hi}] of n_bins {n_bins} over {len(sites)} sites; p-values "
        f"(meaningless at this depth, not held) {json.dumps(pvals)}"
        + (f"; rate check p {float(art['rate_check/attrs/p']):.3f} over {art['rate_check/ranks'].size} trials"
           if joint else "")
        + f"; launches: stage {launches}, candidates {init}, fleet {fleet}")
    log(f"{tag} phase {phase} profile: " + device_busy_share(
        lambda: [value_and_grad(pot, theta) for _ in range(3)], f"three fleet value+grads at S = {s}", n_vg=3))
    return launches


def score_check_phase(dev, tag: str):
    """Phase 11c: ``_stage_score_check`` at ``ScoreCheckConfig``'s defaults
    (a 6.5e6-draw campaign, nobs 16, nsamp 256, nsel 3,584, n_grid 128, n_z
    256) but for the catalog count (``SCORE_CATALOGS`` of 200).  Launches: each
    catalog's term gradients once each way for kernel A and B's shared-table
    ``lse`` epilogue (one 2-row batch), each simulation kernel A's forward and
    kernel C; the artifact must carry the JAX layout's keys and finite z.
    Returns the stage's launch counts."""
    import numpy as np

    from bumpcosmology_torch.inference import calibration as cal
    from bumpcosmology_torch.inference import score_check as sc
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.pipeline.config import PathsConfig, PipelineConfig, ScoreCheckConfig

    score = ScoreCheckConfig(n_catalogs=SCORE_CATALOGS)
    log(f"{tag} phase 11c cut: n_catalogs {score.n_catalogs} (default 200)")
    sums = {"simulate": {}, "term_grads": {}}
    secs = {"simulate": 0.0, "term_grads": 0.0}
    real = dict(sim=cal.make_mock_pop_cosmo_simulator_fresh, grads=sc.joint_term_grads)

    def timed(kind, fn):
        def run(*args):
            before, t = _read_counters(), _now()
            out = fn(*args)
            secs[kind] += _now() - t
            for k, v in _delta(_read_counters(), before).items():
                sums[kind].setdefault(k, []).append(v)
            return out
        return run

    def make_sim(*args, **kwargs):
        marks["campaign"] = _now()
        return timed("simulate", real["sim"](*args, **kwargs))

    marks = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_score_") as tmp:
        cfg = PipelineConfig(paths=PathsConfig(data_dir=tmp), score=score)
        cal.make_mock_pop_cosmo_simulator_fresh = make_sim
        sc.joint_term_grads = lambda *a, **k: timed("term_grads", real["grads"](*a, **k))
        try:
            _zero_counters()
            t0 = time.perf_counter()
            stages._stage_score_check(cfg, device=dev)
            wall = _now() - t0
            launches = _read_counters()
        finally:
            cal.make_mock_pop_cosmo_simulator_fresh, sc.joint_term_grads = real["sim"], real["grads"]
        with np.load(Path(tmp) / "score_check.npz") as d:
            _stage_artifact_keys("score_check.npz", d.files, ["attrs/model", "attrs/n_catalogs", "attrs/z_bar",
                                                              "attrs/all_pass", "site", "mean", "se", "z"])
            z, sites = d["z"], [str(x) for x in d["site"]]
    n = SCORE_CATALOGS
    tg, sim = sums["term_grads"], sums["simulate"]
    one_each = ("bump_fwd", "bump_bwd", "logwts_lse_fwd", "logwts_lse_bwd")
    ok = (len(tg["bump_fwd"]) == n and all(tg[k] == [1] * n for k in one_each)
          and not any(sum(v) for k, v in tg.items() if k not in one_each)
          and len(sim["bump_fwd"]) == n and min(sim["bump_fwd"]) >= 1 and min(sim["snr_integral"]) >= 1
          and not any(sum(v) for k, v in sim.items() if k.startswith("logwts")))
    if not ok or z.shape != (3, len(sites)) or not np.isfinite(z).all():
        raise AssertionError(f"score check: launches by catalog {tg}, simulation {sim}; z {z.shape}")
    log(f"{tag} phase 11c _stage_score_check(model='pop_cosmo'): {n} catalogs of {score.nobs} events x "
        f"{score.nsamp} samples + {score.nsel} injections, n_grid {score.n_grid}, n_z {score.n_z}: {wall:.2f} s "
        f"wall (host clock, s: campaign {marks['campaign'] - t0:.3f}, simulations {secs['simulate']:.3f}, term "
        f"gradients {secs['term_grads']:.3f} ({1e3 * secs['term_grads'] / n:.2f} ms a catalog: one forward and "
        f"one backward of a 2-row batch)); max TOTAL |z| {float(np.abs(z[2]).max()):.2f} over {len(sites)} sites "
        f"(not held at this count); launches {launches}, kernel C {sum(sim['snr_integral'])} in the simulations")
    return launches



def _site_label(names) -> str:
    """The stage's model name of a list of sampled sites (phase 12 has the bump's and PLPeak's traces)."""
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES

    for fam, suffix in (("bump", ""), ("plpeak", "_plpeak")):
        if list(names) == list(MASS_FAMILIES[fam].pop_priors):
            return "pop" + suffix
        if list(names) == list(MASS_FAMILIES[fam].cosmo_priors):
            return "pop_cosmo" + suffix
    raise AssertionError(f"unknown sites {list(names)}")


# launches of one device batch of phase 12, by model: the joint bump's pointwise and evidence batches run kernel
# A's forward and kernel B's lse forward (shared table); its PPC batches kernel B's rows forward; the pop bump
# kernel A's forward alone; PLPeak no kernel; every evidence batch (a potential) kernel P's forward besides
_BATCH_LAUNCHES = {
    ("pointwise", "pop"): {"bump_fwd": 1}, ("pointwise", "pop_cosmo"): {"bump_fwd": 1, "logwts_lse_fwd": 1},
    ("pointwise", "pop_cosmo_plpeak"): {},
    ("evidence", "pop"): {"bump_fwd": 1, "priors_fwd": 1},
    ("evidence", "pop_cosmo"): {"bump_fwd": 1, "logwts_lse_fwd": 1, "priors_fwd": 1},
    ("evidence", "pop_cosmo_plpeak"): {"priors_fwd": 1},
    ("ppc", "pop"): {"bump_fwd": 1}, ("ppc", "pop_cosmo"): {"bump_fwd": 1, "logwts_fwd": 1},
    ("ppc", "pop_cosmo_plpeak"): {},
}


def _timed(batches: list, key, fn):
    """``fn`` wrapped to record (key, its launches, its ms by CUDA events) per call."""
    import torch

    def run(*args, **kwargs):
        before = _read_counters()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(*args, **kwargs)
        stop.record()
        torch.cuda.synchronize()
        batches.append((key, {k: v for k, v in _delta(_read_counters(), before).items() if v},
                        start.elapsed_time(stop)))
        return out

    return run


def _check_batches(stage: str, batches: list, expected_counts: dict) -> str:
    """Every batch launched what ``_BATCH_LAUNCHES`` says, and each model made
    ``expected_counts[key]`` batches; returns ms per batch by key."""
    seen = {}
    for key, launches, ms in batches:
        if launches != _BATCH_LAUNCHES[key]:
            raise AssertionError(f"{stage}: a {key} batch launched {launches}, not {_BATCH_LAUNCHES[key]}")
        seen.setdefault(key, []).append(ms)
    if {k: len(v) for k, v in seen.items()} != expected_counts:
        raise AssertionError(f"{stage}: batches by model {({k: len(v) for k, v in seen.items()})}, expected "
                             f"{expected_counts}")
    return "; ".join(f"{k[0]} {k[1]}: {len(v)} batches, median {sorted(v)[len(v) // 2]:.3f} ms (first {v[0]:.3f})"
                     for k, v in seen.items())


def model_comparison_phase(dev, tag: str, data_dir):
    """Phase 12: the model-comparison stages on the traces of phases 7 (the
    joint bump), 8 (the pop bump) and 10b (the joint PLPeak), which those
    phases wrote into ``data_dir`` beside the flagship's fit inputs.  Every
    launch count is set to 0 before each stage and read after it.

    (a) ``_stage_compare`` at ``CompareConfig``'s defaults (160 draws a
    trace in batches of 64): every pointwise and evidence batch of the joint
    bump launches kernel A's forward and kernel B's ``lse`` forward once, the
    pop bump's kernel A's forward once, PLPeak's nothing, and no backward
    anywhere; each pointwise row sums to ``pop_loglike`` /
    ``pop_cosmo_loglike`` at the same draw (|d|/(1+|ref|) < 2e-4); the joint
    bump's matrix on the card against the CPU on its first 64 draws (phase
    4's limit, 2e-4).  (b) ``_stage_ppc`` at ``PpcConfig``'s defaults
    (batches of 32): the joint bump's batches through kernel B's ``rows``
    forward once each; on the first batch, kernel B against its twin on the
    batch's own tables at B's value limits, and the weights on the card
    against the CPU's at phase 4's limit (2e-4: each device builds its own
    tables, kernel A's among them); every p-value in [0, 1].  (c)
    ``_stage_prior_sens``: host only, no launch, the JAX layout's keys.  (d)
    ``_stage_loo`` with the joint model on phase 7's trace, cut as phase 11
    cuts (``LOO_WARMUP`` warmup steps, ``LOO_SAMPLES`` draws, ``max_depth``
    ``LOO_DEPTH``): 56 chains, each reading its own query table of 38,656
    rows through kernel B; the 32 start candidates launch A's forward and B's
    per-chain ``lse`` forward once each, the fleet one of each kernel each way
    per batched value+grad; the fleet's potential for 3 catalogs card against
    CPU at phase 4's limits; every influence z finite.  The values of elpd,
    p_loo, k̂ and log Z are printed, not held (the traces are short).  Returns
    the launch counts by path."""
    import numpy as np
    import torch

    from bumpcosmology_torch.inference import evidence, influence, model_compare, ppc
    from bumpcosmology_torch.inference import fleet as fleet_mod
    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import value_and_grad
    from bumpcosmology_torch.pipeline import stages
    from bumpcosmology_torch.ops import cuda_logwts
    from bumpcosmology_torch.pipeline.config import FitConfig, LooConfig, PathsConfig, PipelineConfig
    from bumpcosmology_torch.utils.io import read_table
    from bumpcosmology_torch.utils.trace import load_trace

    cfg = PipelineConfig(paths=PathsConfig(data_dir=str(data_dir)), fit=FitConfig(n_grid=N_GRID, n_z=N_Z),
                         loo=LooConfig(num_warmup=LOO_WARMUP, num_samples=LOO_SAMPLES, max_depth=LOO_DEPTH))
    c_cmp, c_ppc = cfg.compare, cfg.ppc
    pe, sel = read_table(cfg.paths.path("pe-samples.npz")), read_table(cfg.paths.path("selection-samples.npz"))
    traces = {name: load_trace(cfg.paths.path(fname)).posterior for name, fname in (
        ("pop", "trace.npz"), ("pop_cosmo", "trace_cosmo.npz"), ("pop_cosmo_plpeak", "trace_cosmo_plpeak.npz"))}
    n_draws = {k: next(iter(v.values())).size for k, v in traces.items()}
    launches, walls = {}, {}
    log(f"{tag} phase 12 traces from phases 8, 7 and 10b: {json.dumps(n_draws)} draws; CompareConfig "
        f"{json.dumps(vars(c_cmp))}, PpcConfig {json.dumps(vars(c_ppc))}; the LOO fleet cut: num_warmup {LOO_WARMUP} "
        f"(default 400), num_samples {LOO_SAMPLES} (default 256), max_depth {LOO_DEPTH} (default 8)")

    # ---- (a) _stage_compare ---------------------------------------------
    batches = []
    real = dict(pm=model_compare.pointwise_matrix, pot=evidence.make_potential)

    def pm(fn, posterior, names, *args, **kwargs):
        return real["pm"](_timed(batches, ("pointwise", _site_label(names)), fn), posterior, names, *args, **kwargs)

    def make_pot(spec):
        return _timed(batches, ("evidence", _site_label(spec.priors)), real["pot"](spec))

    model_compare.pointwise_matrix, evidence.make_potential = pm, make_pot
    try:
        _zero_counters()
        t0 = time.perf_counter()
        table = stages._stage_compare(cfg, device=dev)
        walls["12a_compare"] = _now() - t0
        launches["12a_compare"] = _read_counters()
    finally:
        model_compare.pointwise_matrix, evidence.make_potential = real["pm"], real["pot"]
    n_pw = {k: -(-min(v, c_cmp.max_draws) // c_cmp.batch) for k, v in n_draws.items()}
    n_ev = {k: 2 * -(-(min(v, c_cmp.max_draws) - min(v, c_cmp.max_draws) // 2) // c_cmp.batch)
            for k, v in n_draws.items()}
    times = _check_batches("compare", batches, {**{("pointwise", k): v for k, v in n_pw.items()},
                                                **{("evidence", k): v for k, v in n_ev.items()}})
    with np.load(cfg.paths.path("model_compare.npz")) as d:
        art = {k: d[k] for k in d.files}
    if str(art["attrs/table"]) != table or sorted(k for k in art if k.endswith("/pointwise")) != sorted(
            f"{k}/pointwise" for k in traces):
        raise AssertionError(f"compare: the artifact's table or matrices are not the stage's: {sorted(art)}")
    # each row sums to the model's log-likelihood at the same draw
    pop_data, cosmo_data = (stages.pop_data_from_tables(pe, sel, dev), stages.pop_cosmo_data_from_tables(pe, sel, dev))
    bounds, qry, rows = lk.dl_bounds_of(cosmo_data, margin=0.1), lk.query_table(cosmo_data), lk.pop_rows(pop_data)
    loglikes = {
        "pop": lambda s: lk.pop_loglike(s, pop_data, N_GRID, rows),
        "pop_cosmo": lambda s: lk.pop_cosmo_loglike(s, cosmo_data, N_GRID, N_Z, bounds, qry),
        "pop_cosmo_plpeak": lambda s: lk.pop_cosmo_loglike(s, cosmo_data, N_GRID, N_Z, bounds, qry,
                                                           build=lk.MASS_FAMILIES["plpeak"].build),
    }
    priors = {"pop": lk.POP_PRIORS, "pop_cosmo": lk.POP_COSMO_PRIORS, "pop_cosmo_plpeak": lk.PLPEAK_COSMO_PRIORS}
    sums, stats = {}, {}
    for name, post in traces.items():
        flat = {k: torch.tensor(post[k].reshape(-1), dtype=torch.float32, device=dev) for k in priors[name]}
        with torch.inference_mode():
            ll = torch.cat([loglikes[name]({k: v[lo:lo + c_cmp.batch] for k, v in flat.items()})
                            for lo in range(0, n_draws[name], c_cmp.batch)]).double().cpu().numpy()
        mat = art[f"{name}/pointwise"].astype(np.float64)
        sums[name] = float((np.abs(mat.sum(1) - ll) / (1.0 + np.abs(ll))).max())
        if not (mat.shape == (n_draws[name], len(np.unique(pe["evt"]))) and np.isfinite(mat).all()
                and sums[name] < 2e-4):
            raise AssertionError(f"compare {name}: pointwise matrix {mat.shape}, rows against the log-likelihood "
                                 f"|d|/(1+|ref|) {sums[name]:.3e} (limit 2e-4)")
        g = f"{name}/attrs/"
        stats[name] = {"elpd": round(float(art[g + "elpd"]), 3), "p_loo": round(float(art[g + "p_loo"]), 3),
                       "max_khat": round(float(art[f"{name}/khat"].max()), 3),
                       "waic_elpd": round(float(art[g + "waic_elpd"]), 3),
                       "log_z": round(float(art[g + "log_z"]), 3) if g + "log_z" in art else "failed"}
    # the joint bump's matrix on the card against the CPU on the same draws
    cpu_data = stages.pop_cosmo_data_from_tables(pe, sel, "cpu")
    cpu_bounds, cpu_qry = lk.dl_bounds_of(cpu_data, margin=0.1), lk.query_table(cpu_data)
    first = {k: v.reshape(-1)[:COMPARE_CPU_DRAWS][None] for k, v in traces["pop_cosmo"].items()}
    t_cpu = time.perf_counter()
    mat_cpu = model_compare.pointwise_matrix(
        lambda s: model_compare.pop_cosmo_pointwise_loglike(s, cpu_data, N_GRID, N_Z, cpu_bounds, qry=cpu_qry),
        first, list(priors["pop_cosmo"]), batch=COMPARE_CPU_DRAWS, device="cpu")
    t_cpu = time.perf_counter() - t_cpu
    mat_card = art["pop_cosmo/pointwise"][:COMPARE_CPU_DRAWS]
    d_cpu = float((np.abs(mat_card - mat_cpu) / (1.0 + np.abs(mat_cpu))).max())
    if not d_cpu < 2e-4:
        raise AssertionError(f"compare: the joint pointwise matrix, card against CPU: |d|/(1+|ref|) {d_cpu:.3e}")
    log(f"{tag} phase 12a _stage_compare: {walls['12a_compare']:.2f} s wall (host clock); {times}; rows against "
        f"the log-likelihood, largest |d|/(1+|ref|) {json.dumps({k: float(f'{v:.3e}') for k, v in sums.items()})}; "
        f"the joint matrix card against CPU on {COMPARE_CPU_DRAWS} draws {d_cpu:.3e} ({t_cpu:.2f} s on the host); "
        f"launches {launches['12a_compare']}")
    log(f"{tag} phase 12a by model (not held; {max(n_draws.values())} draws of unconverged chains): "
        f"{json.dumps(stats)}")
    log("phase 12a table:\n" + table + ("\n" + str(art["attrs/bf_table"]) if str(art["attrs/bf_table"]) else ""))
    for k in ("bump_bwd", "logwts_bwd", "logwts_lse_bwd", "logwts_fwd", "logwts_lse_fwd_per_chain",
              "logwts_lse_bwd_per_chain", "snr_integral", "priors_bwd"):
        if launches["12a_compare"][k]:
            raise AssertionError(f"compare: {k} launched {launches['12a_compare'][k]} times")

    # ---- (b) _stage_ppc ---------------------------------------------------
    batches = []
    real = dict(joint=ppc.pop_cosmo_event_sel_logwts, pop=ppc._pop_event_sel_logwts)

    def joint_w(sites, *args, build=None, **kwargs):
        key = ("ppc", "pop_cosmo" if build is None else "pop_cosmo_plpeak")
        return _timed(batches, key, real["joint"])(sites, *args, build=build, **kwargs)

    def pop_w(sites, *args, build=None, **kwargs):
        return _timed(batches, ("ppc", "pop" if build is None else "pop_plpeak"), real["pop"])(
            sites, *args, build=build, **kwargs)

    ppc.pop_cosmo_event_sel_logwts, ppc._pop_event_sel_logwts = joint_w, pop_w
    try:
        _zero_counters()
        t0 = time.perf_counter()
        path = stages._stage_ppc(cfg, device=dev)
        walls["12b_ppc"] = _now() - t0
        launches["12b_ppc"] = _read_counters()
    finally:
        ppc.pop_cosmo_event_sel_logwts, ppc._pop_event_sel_logwts = real["joint"], real["pop"]
    times = _check_batches("ppc", batches, {("ppc", k): -(-min(v, c_ppc.n_draws) // c_ppc.batch)
                                            for k, v in n_draws.items()})
    with np.load(path) as d:
        pvals = {k[: -len("/attrs/p_value")]: float(d[k]) for k in d.files if k.endswith("/attrs/p_value")}
    if len(pvals) != 9 or not all(0.0 <= p <= 1.0 for p in pvals.values()):
        raise AssertionError(f"ppc: p-values {pvals}")
    # the first joint batch: kernel B against its twin on the batch's own tables and rows (B's value limits),
    # and the whole device part on the card against the CPU (phase 4's limit: the tables are built on each
    # device, kernel A's table among them, so their float32 rounding adds to B's)
    flat = {k: traces["pop_cosmo"][k].reshape(-1)[:c_ppc.batch] for k in priors["pop_cosmo"]}
    tables = b_tables({k: torch.as_tensor(v, device=dev) for k, v in flat.items()}, cosmo_data)
    ppc_qry = lk.query_table(cosmo_data)
    err_b = check_close("ppc batch, kernel B against its twin", cuda_logwts.logwts(*tables, ppc_qry),
                        cuda_logwts.logwts_plain(*tables, ppc_qry), rtol=2e-5, atol=2e-5)
    w_card = ppc._logwts_matrix(flat, cosmo_data, N_GRID, N_Z, None, c_ppc.batch, device=dev)
    w_cpu = ppc._logwts_matrix(flat, cpu_data, N_GRID, N_Z, None, c_ppc.batch, device="cpu")
    d_w = 0.0
    for part, a, b in zip(("events", "selection"), w_card, w_cpu):
        fin = np.isfinite(b)
        if not np.array_equal(fin, np.isfinite(a)):
            raise AssertionError(f"ppc weights ({part}): non-finite entries differ between card and CPU")
        d_w = max(d_w, float((np.abs(a[fin] - b[fin]) / (1.0 + np.abs(b[fin]))).max()))
    if not d_w < 2e-4:
        raise AssertionError(f"ppc weights, card against CPU: |d|/(1+|ref|) {d_w:.3e} (limit 2e-4)")
    log(f"{tag} phase 12b _stage_ppc: {walls['12b_ppc']:.2f} s wall (host clock); {times}; the first joint batch "
        f"({c_ppc.batch} draws): kernel B against its twin max|err| {err_b:.3e} (rtol 2e-5, atol 2e-5), the "
        f"weights card against CPU |d|/(1+|ref|) {d_w:.3e}; p-values (not held) "
        f"{json.dumps({k: round(v, 3) for k, v in pvals.items()})}; launches {launches['12b_ppc']}")

    # ---- (c) _stage_prior_sens ---------------------------------------------
    _zero_counters()
    t0 = time.perf_counter()
    path = stages._stage_prior_sens(cfg, device=dev)
    walls["12c_prior_sens"] = _now() - t0
    launches["12c_prior_sens"] = _read_counters()
    with np.load(path) as d:
        keys = sorted(d.files)
    _stage_artifact_keys("prior_sensitivity.npz", keys, [f"{g}/{k}" for g in traces for k in (
        "perturbation", "site", "shift_sd", "sd_ratio", "ess_frac")])
    if any(launches["12c_prior_sens"].values()):
        raise AssertionError(f"prior_sens: launches {launches['12c_prior_sens']} (the stage is host only)")
    log(f"{tag} phase 12c _stage_prior_sens: {walls['12c_prior_sens']:.2f} s wall (host clock), no launch; "
        f"{len(keys)} arrays")

    # ---- (d) _stage_loo: the leave-one-out fleet ------------------------------
    marks, seen, counts = {}, {}, {"value_grad": 0}
    real = dict(make=influence.make_loo_datas, fleet=fleet_mod.fleet_fit)

    def make(data):
        out = real["make"](data)
        marks["datas"], seen["at_datas"] = _now(), _read_counters()
        return out

    def fit(make_pot, datas, theta0, *args, **kwargs):
        marks["init"], seen["at_fleet"] = _now(), _read_counters()

        def counted_make_pot(d):
            pot = make_pot(d)

            def counted(theta):
                counts["value_grad"] += 1  # the fleet makes value+grads only
                return pot(theta)

            return counted

        res = real["fleet"](counted_make_pot, datas, theta0, *args, **kwargs)
        marks["fleet"], seen["after_fleet"] = _now(), _read_counters()
        seen.update(res=res, datas=datas, make_pot=make_pot)
        return res

    influence.make_loo_datas, fleet_mod.fleet_fit = make, fit
    try:
        _zero_counters()
        t0 = time.perf_counter()
        stages._stage_loo(cfg, device=dev)
        walls["12d_loo"] = _now() - t0
        launches["12d_loo"] = _read_counters()
    finally:
        influence.make_loo_datas, fleet_mod.fleet_fit = real["make"], real["fleet"]
    res, datas, n_vg = seen["res"], seen["datas"], counts["value_grad"]
    s = res.thetas.shape[0]
    init, fleet = _delta(seen["at_fleet"], seen["at_datas"]), _delta(seen["after_fleet"], seen["at_fleet"])
    b = "logwts_lse_fwd_per_chain", "logwts_lse_bwd_per_chain"
    others = lambda d, keep: [k for k, v in d.items() if v and k not in keep]  # noqa: E731
    ok = (init["bump_fwd"] == init[b[0]] == 32 and not others(init, ("bump_fwd", b[0]) + PRIORS)
          and fleet["bump_fwd"] == fleet["bump_bwd"] == fleet[b[0]] == fleet[b[1]] == n_vg > 0
          and not others(fleet, ("bump_fwd", "bump_bwd") + b + PRIORS) and s == len(np.unique(pe["evt"])))
    if not ok:
        raise AssertionError(f"loo: launches not once per potential: candidates {init}, fleet {fleet} ({n_vg} "
                             f"batched value+grads, {s} chains)")
    check_priors("loo candidates", init, 0, 32)
    check_priors("loo fleet", fleet, n_vg)
    with np.load(cfg.paths.path("influence.npz")) as d:
        art = {k: d[k] for k in d.files}
    sites = sorted({k.split("/")[0] for k in art} - {"attrs", "event"})
    _stage_artifact_keys("influence.npz", art, ["attrs/model", "event"] + [f"{site}/{k}" for site in sites for k in (
        "mean_loo", "delta_mean", "z")])
    z = np.stack([art[f"{site}/z"] for site in sites])
    if sites != sorted(lk.POP_COSMO_PRIORS) or z.shape != (len(sites), s) or not np.isfinite(z).all():
        raise AssertionError(f"loo: influence z of shape {z.shape} over sites {sites} is not finite")
    pot = seen["make_pot"](datas)
    theta = res.thetas[:, -1].contiguous()
    vg_ms = cuda_ms(lambda: value_and_grad(pot, theta), reps=10)
    idx = torch.arange(FLEET_CPU_SIMS, device=dev)
    sub = lk.take_fleet(datas, idx)
    u_k, g_k = value_and_grad(seen["make_pot"](sub), theta[:FLEET_CPU_SIMS])
    u_c, g_c = (x.to(dev) for x in value_and_grad(seen["make_pot"](sub.to("cpu")), theta[:FLEET_CPU_SIMS].cpu()))
    du = float(((u_k - u_c).abs() / (1.0 + u_c.abs())).max())
    dg = float(((g_k - g_c).abs() / (1.0 + g_c.abs())).max())
    if du >= 2e-4 or dg >= 5e-3 or not bool(torch.isfinite(u_k).all()):
        raise AssertionError(f"loo fleet potential, card against CPU: |dU|/(1+|U|) {du:.3e}, "
                             f"|dgrad|/(1+|grad|) {dg:.3e}")
    fit_s = res.warmup_s + res.sampling_s
    worst = np.unravel_index(np.abs(z).argmax(), z.shape)
    split = dict(loo_datas=marks["datas"] - t0, candidates=marks["init"] - marks["datas"], fleet_warmup=res.warmup_s,
                 fleet_sampling=res.sampling_s, summary_write=walls["12d_loo"] - (marks["fleet"] - t0))
    n_rows = datas.events.a[0].numel() + datas.selection.a.shape[-1]
    log(f"{tag} phase 12d _stage_loo(model='pop_cosmo'): {s} chains x {n_rows} rows a chain ({datas.events.a.shape[1]} "
        f"events x {datas.events.a.shape[2]} samples + {datas.selection.a.shape[-1]} injections), {LOO_WARMUP} warmup "
        f"steps + {LOO_SAMPLES} draws at max_depth {LOO_DEPTH}: {walls['12d_loo']:.2f} s wall (host clock, s: "
        f"{json.dumps({k: round(v, 3) for k, v in split.items()})}); {n_vg} batched value+grads, "
        f"{1e3 * fit_s / n_vg:.2f} ms each in the fleet, {vg_ms:.3f} ms alone at S = {s} (CUDA events, mean of 10); "
        f"adapted step size median {float(res.eps.median()):.4g}, sampling mean accept {float(res.accept.mean()):.3f}; "
        f"fleet potential of {FLEET_CPU_SIMS} catalogs, card against CPU: |dU|/(1+|U|) {du:.3e}, |dgrad|/(1+|grad|) "
        f"{dg:.3e}; largest |z| {float(np.abs(z).max()):.2f} (site {sites[worst[0]]}, event {worst[1]}; not held); "
        f"launches: stage {launches['12d_loo']}, candidates {init}, fleet {fleet}")
    log(f"{tag} phase 12d profile: " + device_busy_share(
        lambda: [value_and_grad(pot, theta) for _ in range(3)], f"three LOO fleet value+grads at S = {s}", n_vg=3))
    log(f"{tag} phase 12 stage wall times (host clock, s): {json.dumps({k: round(v, 3) for k, v in walls.items()})}")
    return launches


# ------------------------------------------------------------------ phase 14


def scale_out_rank(rank: int, store: Path) -> None:
    """One rank of phase 14 (a, b), in its own process on the one card: see
    :func:`scale_out_phase`.  Writes ``rank<r>.json`` and its fits' draws
    (``rank<r>_rows.npz``, ``rank<r>_split.npz``; rank 0 also the dense
    fit's, ``dense.npz``) into ``store``, whose ``file://`` store joins the
    ranks.  Every rank makes the same collectives in the same order; a check
    that fails raises (and the phase stops the other rank)."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.likelihoods import POP_COSMO_PRIORS, pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import ModelSpec, make_potential, value_and_grad
    from bumpcosmology_torch.inference.nuts import NutsConfig
    from bumpcosmology_torch.inference.sampler import _tree_map, fit
    from bumpcosmology_torch.parallel import make_mesh, make_sharded_pop_cosmo_loglike, shard_pop_cosmo_data
    from bumpcosmology_torch.utils.checkpoint import load_warmup

    # NCCL refuses two ranks on one device: gloo, with the CUDA tensors staged through the host
    dist.init_process_group("gloo", init_method=f"file://{store}/store", world_size=SCALE_RANKS, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        dev = resolve_device(None)  # the card
        gen = torch.Generator(device=dev).manual_seed(SEED + 14)
        data = load_pop_cosmo_data(CATALOG)
        theta = load_warmup(WARMUP16).state.theta
        split = make_mesh(1)  # one chain row, the data split over the ranks
        rows = make_mesh(SCALE_RANKS)  # a chain row a rank, the data whole in each
        shard = shard_pop_cosmo_data(data, split)
        spec = pop_cosmo_model_spec(shard, N_GRID, N_Z)
        out = {"backend": str(dist.get_backend()), "mesh": dict(split.shape),
               "rows_a_rank": int(shard.events.a.numel() + shard.selection.a.shape[0])}

        # (a) the main path: one joint value+grad of the committed chains on the shard
        pot = make_potential(spec)
        value_and_grad(pot, theta)  # first call: the tables' allocations and the kernels' loading
        _zero_counters()
        u, g = value_and_grad(pot, theta)
        torch.cuda.synchronize()
        vg = {"launches": _read_counters(), "ms": cuda_ms(lambda: value_and_grad(pot, theta), reps=10)}
        explicit = make_potential(ModelSpec(dict(POP_COSMO_PRIORS),
                                            make_sharded_pop_cosmo_loglike(split, data, N_GRID, N_Z), dev))
        u_e, g_e = value_and_grad(explicit, theta)
        if not (torch.equal(u_e, u) and torch.equal(g_e, g)):
            raise AssertionError("phase 14a: make_sharded_pop_cosmo_loglike and the spec on the shard differ")
        dense = make_potential(pop_cosmo_model_spec(data, N_GRID, N_Z))
        value_and_grad(dense, theta)
        u_d, g_d = value_and_grad(dense, theta)
        du = float(((u - u_d).abs() / (1.0 + u_d.abs())).max())
        dg = float(((g - g_d).abs() / (1.0 + g_d.abs())).max())
        if not (du < 2e-4 and dg < 5e-3) or not bool(torch.isfinite(u).all() and torch.isfinite(g).all()):
            raise AssertionError(f"phase 14a against dense: |dU|/(1+|U|) {du:.3e}, |dgrad|/(1+|grad|) {dg:.3e}")
        vg.update(du=du, dg=dg, dense_ms=cuda_ms(lambda: value_and_grad(dense, theta), reps=10),
                  checks=kernels_against_plain("14a shard", shard, theta, gen))
        out["vg"] = vg

        # (b) fit(mesh=): two chain rows; one row over the data split, from prior draws and from the committed
        # adapted state (rank 0 runs the dense fit of the latter beside it)
        kw = dict(num_samples=MESH_FIT_SAMPLES, num_chains=MESH_FIT_CHAINS, cfg=NutsConfig(max_depth=MESH_FIT_DEPTH),
                  verbose=False)
        warm = _tree_map(lambda t: t[:MESH_FIT_CHAINS].contiguous(), load_warmup(WARMUP16))
        n = MESH_FIT_CHAINS // SCALE_RANKS
        for name, mesh, fit_data, mine, start in (
                ("rows", rows, shard_pop_cosmo_data(data, rows), slice(rank * n, (rank + 1) * n),
                 dict(num_warmup=MESH_FIT_WARMUP)),
                ("split", split, shard, slice(None), dict(num_warmup=MESH_FIT_WARMUP)),
                ("split_warm", split, shard, None, dict(num_warmup=0, warmup_state=warm))):
            _zero_counters()
            t0 = time.perf_counter()
            res = fit(pop_cosmo_model_spec(fit_data, N_GRID, N_Z), SEED, mesh=mesh, **start, **kw)
            torch.cuda.synchronize()
            out[name] = {"wall_s": time.perf_counter() - t0, "launches": _read_counters(), "mesh": dict(mesh.shape),
                         "timings": res.timings}
            np.savez(store / f"rank{rank}_{name}.npz", **res.posterior)
            if name == "split_warm" and rank == 0:
                t0 = time.perf_counter()
                res_d = fit(pop_cosmo_model_spec(data, N_GRID, N_Z), SEED, **start, **kw)
                out["dense_fit_s"] = time.perf_counter() - t0
                np.savez(store / "dense.npz", **res_d.posterior)
            if mine is not None:  # the kernels at the fit's shape (its chains and rows a rank), at its last state
                out[name]["checks"] = kernels_against_plain(f"14b {name}", fit_data,
                                                            res.final_state.state.theta[mine].contiguous(), gen)
        (store / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def scale_out_phase(dev, tag: str, spec, theta, data_dir: Path) -> dict:
    """Phase 14: the scale-out layer and the host utilities on the card.

    (a) ``SCALE_RANKS`` ranks on the one card (processes of this script,
    gloo), the flagship split along ``data`` (56 events x 128 PE samples +
    12,288 injections a rank): the joint value+grad of the 16 committed
    chains through a spec built on the shard, with every launch count set to
    0 just before one value+grad and read just after (kernels A and B's
    ``lse`` once each way on each rank), held against the dense value+grad
    on the card at phase 4's limits; ``make_sharded_pop_cosmo_loglike`` must
    give the same bits; and at this shape :func:`kernels_against_plain`.
    (b) ``fit(mesh=)`` cut in depth only, twice: on two chain rows (a 2 x 1
    mesh: (4, 5) finite draws, the rows drawing differently) and on one row
    over the data split (a 1 x 2 mesh: the two ranks' draws identical, each
    rank having computed its own, and within ``MESH_FIT_DENSE_TOL`` of a
    dense fit from the same seed); after each, :func:`kernels_against_plain`
    at its shape.  (c) ``native.network_snr_native`` against kernel C on
    ``NATIVE_ROWS`` rows at ``tests/test_native.py``'s rtol 5e-3 / atol
    1e-3.  (d) The ``dNdm_PISN_effects`` curves on the card (one launch of
    kernel A) against the CPU at A's forward limits.  (e)
    ``utils.profiling.trace`` around one value+grad writes a non-empty
    trace.  (f) Which plotting libraries import; with all three, the figures
    of ``data_dir``'s traces and stage artifacts are drawn.  Returns the
    launch counts by path."""
    import importlib
    import shutil

    import numpy as np
    import torch

    from bumpcosmology_torch import native
    from bumpcosmology_torch.data.weights import planck18_dl_np
    from bumpcosmology_torch.figures import plots
    from bumpcosmology_torch.inference.model import make_potential, value_and_grad
    from bumpcosmology_torch.mock.snr import network_snr_batched
    from bumpcosmology_torch.utils.profiling import trace

    launches = {}
    # (a, b): the ranks, each writing its output to a file; one that fails stops the other
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        store = Path(tmp)
        t0 = time.perf_counter()
        logs = [open(store / f"rank{r}.log", "w") for r in range(SCALE_RANKS)]
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--scale-out-rank", str(r),
                                   "--store", str(store)], cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
                 for r, f in enumerate(logs)]
        try:
            while any(p.poll() is None for p in procs) and not any(p.poll() for p in procs):
                if time.perf_counter() - t0 > SCALE_TIMEOUT_S:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in logs:
                f.close()
        if any(p.returncode != 0 for p in procs):
            raise AssertionError("phase 14 ranks failed: " + " | ".join(
                f"rank {r} rc {p.returncode}: {(store / f'rank{r}.log').read_text()[-3000:]}"
                for r, p in enumerate(procs)))
        ranks_wall = time.perf_counter() - t0
        outs = [json.loads((store / f"rank{r}.json").read_text()) for r in range(SCALE_RANKS)]
        draws = {name: [dict(np.load(store / f"rank{r}_{name}.npz")) for r in range(SCALE_RANKS)]
                 for name in ("rows", "split", "split_warm")}
        dense = dict(np.load(store / "dense.npz"))
    per_vg = {"bump_fwd": 1, "bump_bwd": 1, "logwts_lse_fwd": 1, "logwts_lse_bwd": 1, "priors_fwd": 1, "priors_bwd": 1}
    for r, out in enumerate(outs):
        got = out["vg"]["launches"]
        if any(v != per_vg.get(k, 0) for k, v in got.items()):
            raise AssertionError(f"phase 14a rank {r}: not one launch of A, B's lse and P each way in a value+grad: "
                                 f"{got}")
        launches[f"14a_sharded_vg_rank{r}"] = got
    log(f"{tag} phase 14a {SCALE_RANKS} ranks on one card, backend {outs[0]['backend']} (CUDA tensors staged "
        f"through the host; NCCL refuses two ranks on one device), mesh {outs[0]['mesh']}, "
        f"{outs[0]['rows_a_rank']} rows a rank, {theta.shape[0]} chains; one value+grad on the shard, kernels A, "
        f"B's lse and P once each way on each rank, make_sharded_pop_cosmo_loglike bit-identical to it; " + "; ".join(
            f"rank {r}: against dense |dU|/(1+|U|) {o['vg']['du']:.3e}, |dgrad|/(1+|grad|) {o['vg']['dg']:.3e}, "
            f"{o['vg']['ms']:.3f} ms sharded, {o['vg']['dense_ms']:.3f} ms dense (CUDA events, mean of 10)"
            for r, o in enumerate(outs)))
    for r, o in enumerate(outs):
        log(f"{tag} phase 14a rank {r} against the plain versions: {o['vg']['checks']}")

    for name in draws:
        for r, d in enumerate(draws[name]):
            for k, v in d.items():
                if v.shape[:2] != (MESH_FIT_CHAINS, MESH_FIT_SAMPLES) or not np.isfinite(v).all():
                    raise AssertionError(f"phase 14b fit(mesh=) {name}, rank {r}: site {k} of shape {v.shape} not "
                                         f"finite at ({MESH_FIT_CHAINS}, {MESH_FIT_SAMPLES})")
        for r, out in enumerate(outs):
            got = out[name]["launches"]
            if got["bump_bwd"] != got["logwts_lse_bwd"] or got["bump_bwd"] == 0:
                raise AssertionError(f"phase 14b fit(mesh=) {name}, rank {r}: not one launch of A and B each way "
                                     f"a value+grad: {got}")
            check_priors(f"phase 14b fit(mesh=) {name}, rank {r}", got, got["logwts_lse_bwd"], got["logwts_lse_fwd"])
            launches[f"14b_fit_{name}_rank{r}"] = got
    n = MESH_FIT_CHAINS // SCALE_RANKS
    if np.array_equal(draws["rows"][0]["a"][:n], draws["rows"][0]["a"][n:]):
        raise AssertionError("phase 14b fit(mesh=) on two chain rows: the rows drew the same")
    for name in ("split", "split_warm"):  # each rank returns the draws it computed itself (a chain group of one)
        for k in draws[name][0]:
            if not all(np.array_equal(d[k], draws[name][0][k]) for d in draws[name][1:]):
                raise AssertionError(f"phase 14b fit(mesh=) {name} over the data split: the ranks lost lockstep on "
                                     f"site {k}")
    gap = max(float((np.abs(draws["split_warm"][0][k] - dense[k]) / (1.0 + np.abs(dense[k]))).max()) for k in dense)
    if not gap <= MESH_FIT_DENSE_TOL:
        raise AssertionError(f"phase 14b fit(mesh=) over the data split from the committed state against the dense "
                             f"fit: max |d|/(1+|ref|) {gap:.3e} beyond {MESH_FIT_DENSE_TOL}")
    for name, what in (("rows", f"two chain rows, {MESH_FIT_WARMUP} warmup steps from prior draws, the rows drawing "
                                "differently"),
                       ("split", f"one row over the data split, {MESH_FIT_WARMUP} warmup steps from prior draws, "
                                 "both ranks' draws identical"),
                       ("split_warm", f"one row over the data split, no warmup from the committed adapted state, both "
                                      f"ranks' draws identical, against the dense fit from the same state and seed "
                                      f"max |d|/(1+|ref|) {gap:.3e} (limit {MESH_FIT_DENSE_TOL}; dense fit "
                                      f"{outs[0]['dense_fit_s']:.2f} s)")):
        o = outs[0][name]
        log(f"{tag} phase 14b fit(mesh=) on mesh {o['mesh']} ({what}): {MESH_FIT_CHAINS} chains, "
            f"{MESH_FIT_SAMPLES} draws, max_depth {MESH_FIT_DEPTH}: draws finite at ({MESH_FIT_CHAINS}, "
            f"{MESH_FIT_SAMPLES}); {o['wall_s']:.2f} s on rank 0 "
            f"({json.dumps({k: round(v, 3) for k, v in o['timings'].items()})}); rank 0's launches {o['launches']}")
        for r, out in enumerate(outs):
            if "checks" in out[name]:
                log(f"{tag} phase 14b {name} rank {r} at the fit's last state against the plain versions: "
                    f"{out[name]['checks']}")
    log(f"{tag} phase 14 both ranks' processes {ranks_wall:.2f} s wall from start to exit")

    # (c) the native library's SNR against kernel C
    rng = np.random.default_rng(SEED)
    m1, q, z = rng.uniform(10, 60, NATIVE_ROWS), rng.uniform(0.4, 1.0, NATIVE_ROWS), rng.uniform(0.05, 1.0, NATIVE_ROWS)
    args = (m1 * (1 + z), m1 * q * (1 + z), planck18_dl_np(z), np.arccos(rng.uniform(-1, 1, NATIVE_ROWS)),
            rng.uniform(0, 2 * np.pi, NATIVE_ROWS), np.arcsin(rng.uniform(-1, 1, NATIVE_ROWS)),
            rng.uniform(0, np.pi, NATIVE_ROWS), rng.uniform(0, 2 * np.pi, NATIVE_ROWS))
    t0 = time.perf_counter()
    got = native.network_snr_native(*args)
    native_s = time.perf_counter() - t0
    _zero_counters()
    card = network_snr_batched(*args)
    launches["14c_native_snr"] = _read_counters()
    if launches["14c_native_snr"]["snr_integral"] == 0:
        raise AssertionError("phase 14c: kernel C did not launch")
    worst = 0.0
    for det in ("H1", "L1", "V1", "net"):
        err = np.abs(got[det] - card[det])
        lim = 1e-3 + 5e-3 * np.abs(card[det])
        if not (np.isfinite(got[det]).all() and (err <= lim).all()):
            raise AssertionError(f"phase 14c native SNR {det} against kernel C: |d| {err.max():.3e} beyond "
                                 "rtol 5e-3 / atol 1e-3")
        worst = max(worst, float((err / lim).max()))
    log(f"{tag} phase 14c native SNR ({NATIVE_ROWS} rows, H1/L1/V1/net) against kernel C: within rtol 5e-3 / atol "
        f"1e-3 (largest share of the limit {worst:.3f}); built by make -C native: make "
        f"{'found' if shutil.which('make') else 'not found'}, g++ {'found' if shutil.which('g++') else 'not found'}; "
        f"first call with the build {native_s:.2f} s")

    # (d) the bump curves of dNdm_PISN_effects, card against CPU
    _zero_counters()
    m, on_card = plots._pisn_curves(dev)
    launches["14d_pisn_curves"] = _read_counters()
    if launches["14d_pisn_curves"]["bump_fwd"] != 1:
        raise AssertionError(f"phase 14d: the five curves are not one launch of kernel A: {launches['14d_pisn_curves']}")
    _, on_cpu = plots._pisn_curves("cpu")
    err_d = max(check_close(f"phase 14d {label}", torch.as_tensor(on_card[label]), torch.as_tensor(on_cpu[label]),
                            rtol=1e-4, atol=5e-5) for label in on_cpu)
    log(f"{tag} phase 14d dNdm_PISN_effects: {len(on_card)} curves of {m.size} masses, one launch of kernel A, "
        f"card against CPU max|d| {err_d:.3e} (rtol 1e-4 / atol 5e-5)")

    # (e) the profiler's trace around one value+grad
    pot = make_potential(spec)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        with trace(tmp):
            value_and_grad(pot, theta)
            torch.cuda.synchronize()
        files = list(Path(tmp).glob("trace-*.json"))
        sizes = [f.stat().st_size for f in files]
        n_cuda = sum('"cat": "kernel"' in f.read_text() for f in files)
    if len(files) != 1 or sizes[0] == 0:
        raise AssertionError(f"phase 14e: profiling.trace wrote {len(files)} file(s) of {sizes} bytes")
    log(f"{tag} phase 14e utils.profiling.trace around one joint value+grad: {sizes[0]} bytes of Chrome trace, "
        f"device kernels {'recorded' if n_cuda else 'not recorded'}")

    # (f) the plotting libraries of this host
    found = {}
    for name in plots.PLOTTING_LIBRARIES:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    if all(found.values()):
        from bumpcosmology_torch.pipeline.config import PipelineConfig

        cfg = PipelineConfig()
        cfg.paths.data_dir = str(data_dir)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_figures_") as tmp:
            t0 = time.perf_counter()
            made = plots.render_all(cfg, out_dir=tmp, fmt="png", device=dev)
            drawn = f"drew {len(made)} figures from phases 7-12's artifacts in {time.perf_counter() - t0:.2f} s"
    else:
        drawn = "figures not drawn here (they are drawn on a host with all three)"
    log(f"{tag} phase 14f plotting libraries on this host: {json.dumps(found)}; {drawn}")
    return launches

if __name__ == "__main__":
    sys.exit(main())
