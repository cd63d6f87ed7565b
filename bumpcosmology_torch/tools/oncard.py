"""What the on-card scripts share: timers, the card's peaks and the bound
they give, the check of a kernel against its plain twin, kernel B's tables
and checks at the flagship's and the SBC fleet's shapes, and the flagship
catalog taken back to the source frame.

``chip_smoke.py`` at the root of the repository imports it, and so do
``kernel_times.py`` and ``potential_repeats.py`` beside it.  Importing it
imports only ``torch`` and the standard library: its functions import the
package when they are called.  So a tool run by path with ``--root DIR``
imports this file by name from its own directory, and every kernel these
functions reach is the package under ``DIR``'s.  Needs one NVIDIA GPU
where it times or checks a kernel.
"""
from __future__ import annotations

import math
import subprocess

SEED = 20261016
N_GRID, N_Z = 256, 1024  # the flagship's bump table and detector table

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
GRAPH_LAUNCHES = 20

# the SBC fleet's shape (SBCConfig: 20 simulations of 12 events x 64 samples; the joint model's 2,048 injections)
SBC_SIMS, SBC_NOBS, SBC_NSAMP, SBC_NSEL = 20, 12, 64, 2048
# the mock stages' injection campaign through kernel C, and the rows its plain twin takes at a time
MOCK_NDRAW = 10_000_000
MOCK_SEED = 333_165_393
PLAIN_CHUNK = 65536


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi."""
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


def timed_row(fn, err, **graph_kwargs) -> dict:
    """A kernel's row of a report: ``ms`` and ``call_ms`` (:func:`both_ms`) and ``max_abs_err``."""
    ms, call_ms = both_ms(fn, **graph_kwargs)
    return dict(ms=ms, call_ms=call_ms, max_abs_err=err)


def bound_ms(n_bytes: float, n_ops: float):
    """(ms, by): the least time of the work, the larger of ``n_bytes`` at
    the HBM rate and ``n_ops`` FP32 operations at the FP32 rate, and which."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def check_cotangents(label, got3, ref3) -> float:
    """Kernel B's three cotangents against the twin's: rtol 5e-4, atol 5e-4 x max |ref|."""
    worst = 0.0
    for name, got, ref in zip(("d_det", "d_bump", "d_scal"), got3, ref3):
        scale = float(ref.abs().max())
        worst = max(worst, check_close(f"{label} {name}", got, ref, rtol=5e-4, atol=5e-4 * scale))
    return worst


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


def tiled_sites(sites, n: int):
    """The constrained ``sites`` (C,) repeated to ``n`` chains."""
    return {k: v.repeat(-(-n // v.shape[0]))[:n] for k, v in sites.items()}


def fleet_queries(data, chains: int, gen, nobs: int = SBC_NOBS, nsamp: int = SBC_NSAMP, nsel: int = SBC_NSEL):
    """(chains, nobs * nsamp + nsel, 4) query tables, one a chain, in the
    shape of the SBC fleet: each chain's own ``nobs`` events of the joint
    ``data`` with ``nsamp`` of their samples, and ``nsel`` of its
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
    epilogues, forward and backward (random cotangents): values rtol 2e-5 /
    atol 2e-5, cotangents by :func:`check_cotangents`.  Returns ({rows_fwd,
    rows_bwd, lse_fwd, lse_bwd: max |err|}, the kernel's rows, its (lse_ev,
    lse_sel), the cotangents (g_rows, g_ev, g_sel))."""
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


def flagship_source_tables(catalog):
    """The joint ``catalog`` (``benchmarks/flagship_catalog.npz``) as
    ``run_pop_cosmo_fit``'s input: source-frame columns recovered on the
    host, the inverse of the stage's own conversion (z from dL at Planck18,
    m1 = m1_det / (1 + z), the weight divided by the Jacobian the stage
    multiplies in)."""
    import numpy as np

    from bumpcosmology_torch.data.weights import dm1sqz_dm1ddqdl, planck18_z_of_dl_np

    with np.load(catalog) as d:
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
