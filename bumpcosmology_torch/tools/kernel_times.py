"""Time kernel A, B, C or P of another checkout on the same card, beside this one's.

    python3 bumpcosmology_torch/tools/kernel_times.py --kernel a|b|c|p [--root DIR]

(run by path, not with ``-m``: the package it times is the one under ``--root``).

``chip_smoke.py`` phases 2, 3 and 6 give the kernels' device times for the checkout
it lies in.  This tool gives the same figures for any checkout of the
repository, so that two commits are compared within one job on one card.  It
builds the kernel's source under ``--root`` (default: this checkout), launches
it forward and backward at the flagship shapes on the warm thetas of
``benchmarks/flagship_warmup16.npz``, holds each launch against that checkout's
plain twin at ``chip_smoke.py``'s limits, and prints one JSON line: for each
kernel ``ms`` (device time) and ``call_ms`` (one eager wrapper call), taken with
``chip_smoke.py``'s own timers, and ``max_abs_err``; with the card's name and
power limit.  Needs one NVIDIA GPU and nvcc.

* ``--kernel a``: ``csrc/bump.cu`` at C = 16, G = 256 (phase 2's limits: forward
  rtol 1e-4 / atol 5e-5, VJP rtol 2e-4 / atol 1e-5).
* ``--kernel b``: ``csrc/logwts.cu`` at C = 16, N = 38,912, K = 1024, G = 256, the
  ``rows`` kernels and, where the checkout has them, the ``lse`` kernels (phase
  3's limits); where it takes a query table per chain, also the shared table
  copied once per chain (``*_copied``, 16 x 38,912 x 4) and 20 distinct
  per-chain tables of 2,816 rows (``*_per_chain``, the SBC fleet's shape,
  ``chip_smoke.fleet_queries``) and the leave-one-out fleet's 56 tables of
  38,656 rows (``*_per_chain_loo``, ``influence.make_loo_datas``).
* ``--kernel c``: ``csrc/snr.cu`` on the rows of phase 6's 10^7-draw campaign
  (the same draws as ``chip_smoke.run_campaign``'s, about 7 s of host draws a run), phase 6's
  limits (rtol 2e-5 / atol 1e-6, the same exact zeros) and timers (5 calls in
  one replayed graph), and the device time of each launch of a call
  (``device_ms_by_launch``, from a ``torch.profiler`` trace of 5 eager calls).
* ``--kernel p``: ``csrc/priors.cu`` on the joint model's 15 priors at C = 4 (the
  benchmark's flagship cell) and C = 128 (an SBC fleet), at
  ``testing.prior_thetas``; held to the per-site code on the CPU within
  ``testing.priors_gaps``' limits; with each launch's bound from the bytes it
  moves (``bound_ms``), its operations being a few hundred, and the per-site
  code's eager call on the card (``plain_ms``).

To compare a commit with its parent, from the root of the checkout (``_archive/``
is git-ignored):

    mkdir -p _archive/parent && git archive HEAD^ | tar -x -C _archive/parent
    for root in _archive/parent . . _archive/parent; do
        python3 bumpcosmology_torch/tools/kernel_times.py --kernel a --root $root
    done
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def warm_sites(root: Path, n_grid: int, n_z: int):
    """(data, constrained sites of the 16 warm chains) from the files under ``root``."""
    import torch

    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import constrain
    from bumpcosmology_torch.utils.checkpoint import load_warmup

    data = load_pop_cosmo_data(root / "benchmarks" / "flagship_catalog.npz")
    warm = load_warmup(root / "benchmarks" / "flagship_warmup16.npz")
    with torch.no_grad():
        return data, constrain(pop_cosmo_model_spec(data, n_grid, n_z), warm.state.theta)


def kernel_a_times(root: Path, row, check_close, n_grid: int, n_z: int, seed: int):
    """({kernel: row}, shape) of ``csrc/bump.cu`` under ``root``."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import population_from_sites
    from bumpcosmology_torch.ops import cuda_bump as ka

    mp = population_from_sites(warm_sites(root, n_grid, n_z)[1]).mass
    p5 = torch.stack([mp.a, mp.b, mp.mpisn, mp.mbhmax, mp.sigma], dim=1).contiguous()
    c = p5.shape[0]
    g = torch.randn((c, n_grid), generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda")
    # as autograd pairs them: each backward gets its own forward's table
    out, ref = ka._bump_fwd_cuda(p5, n_grid), ka._bump_fwd_plain(p5, n_grid)
    kernels = {
        "bump_fwd": row(lambda: ka._bump_fwd_cuda(p5, n_grid), check_close("A-fwd", out, ref, 1e-4, 5e-5)),
        "bump_bwd": row(lambda: ka._bump_bwd_cuda(p5, out, g, n_grid),
                        check_close("A-bwd", ka._bump_bwd_cuda(p5, out, g, n_grid),
                                    ka._bump_bwd_plain(p5, ref, g, n_grid), 2e-4, 1e-5)),
    }
    return kernels, dict(C=c, G=n_grid)


def kernel_b_times(root: Path, row, check_close, n_grid: int, n_z: int, seed: int):
    """({kernel: row}, shape) of ``csrc/logwts.cu`` under ``root``."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import (
        cosmo_from_sites,
        dl_bounds_of,
        population_from_sites,
        query_table,
    )
    from bumpcosmology_torch.models.cosmology import build_cosmology, build_detector_table
    from bumpcosmology_torch.models.population import build_population
    from bumpcosmology_torch.ops import cuda_logwts as kb

    data, sites = warm_sites(root, n_grid, n_z)
    with torch.no_grad():
        pop = build_population(population_from_sites(sites), n_grid)
        det = build_detector_table(build_cosmology(cosmo_from_sites(sites), n=n_z), *dl_bounds_of(data), n=n_z)
        tables = (det.cols.contiguous(), pop.mass_table.log_bump.contiguous(), kb.pack_scalars(pop, det).contiguous())
    qry = query_table(data)
    c, n = tables[0].shape[0], qry.shape[0]
    nobs, nsamp = data.events.a.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    kernels = {}

    def cotangent_error(label, got3, ref3):
        return max(check_close(f"{label} {name}", got, ref, rtol=5e-4, atol=5e-4 * float(ref.abs().max()))
                   for name, got, ref in zip(("d_det", "d_bump", "d_scal"), got3, ref3))

    ref_out = kb._evaluate(*tables, qry)["out"]
    g = torch.randn((c, n), generator=gen, device="cuda") * torch.isfinite(ref_out)
    kernels["logwts_fwd"] = row(lambda: kb._logwts_fwd_cuda(*tables, qry),
                                check_close("B-fwd", kb._logwts_fwd_cuda(*tables, qry), ref_out, 2e-5, 2e-5))
    kernels["logwts_bwd"] = row(lambda: kb._logwts_bwd_cuda(*tables, qry, g),
                                cotangent_error("B-bwd", kb._logwts_bwd_cuda(*tables, qry, g),
                                                kb._logwts_bwd_plain(*tables, qry, g)))
    if hasattr(kb, "_logwts_lse_fwd_cuda"):
        g_ev = torch.randn((c, nobs), generator=gen, device="cuda")
        g_sel = torch.randn((c,), generator=gen, device="cuda")
        ref_ev, ref_sel = kb._segment_lse(ref_out, nobs, nsamp)
        fwd = lambda: kb._logwts_lse_fwd_cuda(*tables, qry, nobs, nsamp)  # noqa: E731
        bwd = lambda: kb._logwts_lse_bwd_cuda(*tables, qry, ref_ev, ref_sel, g_ev, g_sel, nobs, nsamp)  # noqa: E731
        kernels["logwts_lse_fwd"] = row(fwd, max(check_close("B-lse-fwd events", fwd()[0], ref_ev, 2e-5, 2e-5),
                                                 check_close("B-lse-fwd selection", fwd()[1], ref_sel, 2e-5, 2e-5)))
        r = kb._evaluate(*tables, qry)
        g_rows = kb._lse_row_cotangent(r["out"], ref_ev, ref_sel, g_ev, g_sel, nobs, nsamp)
        kernels["logwts_lse_bwd"] = row(bwd, cotangent_error("B-lse-bwd", bwd(), kb._bwd_of_rows(r, *tables, g_rows)))
    if "logwts_fwd_per_chain" in kb.LAUNCHES:  # a query table per chain
        kernels.update(per_chain_layouts(data, sites, tables, qry, row, gen))
    return kernels, dict(C=c, N=n, K=n_z, G=n_grid)


def per_chain_layouts(data, sites, tables, qry, row, gen):
    """Kernel B on (C, N, 4) query tables: the shared table copied per chain,
    the SBC fleet's 20 distinct tables and the leave-one-out fleet's 56 (each
    held by ``chip_smoke.b_against_twin``)."""
    import torch

    from bumpcosmology_torch.inference.influence import make_loo_datas
    from bumpcosmology_torch.inference.likelihoods import query_table
    from bumpcosmology_torch.ops import cuda_logwts as kb
    from chip_smoke import SBC_NOBS, SBC_NSAMP, SBC_SIMS, b_against_twin, b_tables, fleet_queries, tiled_sites

    nobs, nsamp = data.events.a.shape
    c = tables[0].shape[0]
    copied = qry.expand(c, -1, -1).contiguous()
    errs = b_against_twin("B copied", tables, copied, nobs, nsamp, gen)[0]
    out = {"logwts_fwd_copied": row(lambda: kb._logwts_fwd_cuda(*tables, copied), errs["rows_fwd"]),
           "logwts_lse_fwd_copied": row(lambda: kb._logwts_lse_fwd_cuda(*tables, copied, nobs, nsamp),
                                        errs["lse_fwd"])}
    t20 = b_tables({k: torch.cat([v, v[: SBC_SIMS - c]]) for k, v in sites.items()}, data)
    fq = fleet_queries(data, SBC_SIMS, gen)
    errs, _, (lse_ev, lse_sel), (_, g_ev, g_sel) = b_against_twin("B per-chain", t20, fq, SBC_NOBS, SBC_NSAMP, gen)
    out["logwts_lse_fwd_per_chain"] = row(lambda: kb._logwts_lse_fwd_cuda(*t20, fq, SBC_NOBS, SBC_NSAMP),
                                          errs["lse_fwd"])
    out["logwts_lse_bwd_per_chain"] = row(
        lambda: kb._logwts_lse_bwd_cuda(*t20, fq, lse_ev, lse_sel, g_ev, g_sel, SBC_NOBS, SBC_NSAMP), errs["lse_bwd"])
    with torch.no_grad():
        lq = query_table(make_loo_datas(data))
    t56 = b_tables(tiled_sites(sites, lq.shape[0]), data)
    errs, _, (lse_ev, lse_sel), (_, g_ev, g_sel) = b_against_twin("B per-chain LOO", t56, lq, nobs - 1, nsamp, gen)
    out["logwts_lse_fwd_per_chain_loo"] = row(lambda: kb._logwts_lse_fwd_cuda(*t56, lq, nobs - 1, nsamp),
                                              errs["lse_fwd"])
    out["logwts_lse_bwd_per_chain_loo"] = row(
        lambda: kb._logwts_lse_bwd_cuda(*t56, lq, lse_ev, lse_sel, g_ev, g_sel, nobs - 1, nsamp), errs["lse_bwd"])
    return out


def kernel_c_times(root: Path, row, check_close, n_grid: int, n_z: int, seed: int):
    """({kernel: row}, shape) of ``csrc/snr.cu`` under ``root``, on the campaign's rows."""
    import torch

    from bumpcosmology_torch.mock import catalog, psd, snr
    from bumpcosmology_torch.mock import cuda_snr as kc
    from chip_smoke import MOCK_NDRAW, MOCK_SEED, PLAIN_CHUNK

    seen, network = {}, snr.network_snr

    def kept(m1, m2, dl, *args, **kwargs):  # the rows the campaign sends to kernel C
        seen["rows"] = (m1, m2, dl)
        return network(m1, m2, dl, *args, **kwargs)

    snr.network_snr = kept
    try:
        catalog.draw_injection_campaign(ndraw=MOCK_NDRAW, seed=MOCK_SEED, device=torch.device("cuda"))
    finally:
        snr.network_snr = network
    m1, m2, dl = seen["rows"]
    f_grid = snr.frequency_grid(device=m1.device)
    inv_psd = 1.0 / psd.PSDS["H1"](f_grid)
    grid = dict(f_min=float(f_grid[0]), f_max=float(f_grid[-1]), n_f=f_grid.shape[0], amp_scale=kc.AMP_SCALE)
    fn = lambda: kc._snr_integral_cuda(m1, m2, dl, inv_psd, **grid)  # noqa: E731
    got, ref = fn(), kc.snr_integral_plain(m1, m2, dl, inv_psd, **grid, chunk=PLAIN_CHUNK)
    torch.cuda.synchronize()
    check_close("C exact zeros", (got == 0).float(), (ref == 0).float(), 0.0, 0.0)  # the same zeros
    timed = row(fn, check_close("C", got, ref, 2e-5, 1e-6), launches=5, replays=2)
    timed["device_ms_by_launch"] = device_ms_by_launch(fn)
    return {"snr_integral": timed}, dict(N=m1.shape[0], n_f=grid["n_f"])


def kernel_p_times(root: Path, row, check_close, n_grid: int, n_z: int, seed: int):
    """({kernel: row}, shape) of ``csrc/priors.cu`` under ``root``; its
    ``max_abs_err`` is the largest of ``testing.priors_gaps``' gaps over their
    limits, which must not pass 1.  ``plain_ms`` is one eager call of the
    per-site code on the card: the forward's ``_log_prior_and_jac`` and
    ``constrain``, the backward's autograd pass through them alone."""
    import torch

    from bumpcosmology_torch.inference.likelihoods import POP_COSMO_PRIORS
    from bumpcosmology_torch.inference.model import ModelSpec, _log_prior_and_jac, constrain
    from bumpcosmology_torch.ops import cuda_priors as kp
    from bumpcosmology_torch.testing import prior_thetas, priors_gaps, priors_twin
    from chip_smoke import bound_ms, cuda_ms

    spec = ModelSpec(priors=dict(POP_COSMO_PRIORS), loglike=None)
    rows, dim = kp.table_rows(spec.priors), spec.dim
    table = kp.device_table(spec.priors, torch.device("cuda"), torch.float32)
    kernels = {}
    for c in (4, 128):
        theta = prior_thetas(c, dim, seed=seed)
        gen = torch.Generator().manual_seed(seed)
        g_lp, g_sites = torch.randn((c,), generator=gen), torch.randn((c, dim), generator=gen)
        t, gl, gs = theta.cuda(), g_lp.cuda(), g_sites.t().contiguous().cuda()  # the sites' cotangents site-major
        lp, sites = kp._priors_fwd_cuda(t, table)
        got = (lp.cpu(), sites.t().cpu(), kp._priors_bwd_cuda(t, table, gs, gl).cpu())
        gaps = priors_gaps(got, priors_twin(spec, theta, g_lp, g_sites), rows)
        err = max(gaps["sites"], gaps["log_prior"], gaps["grad"])
        if not gaps["same_finite"] or err > 1.0:
            raise AssertionError(f"P C={c}: kernel against the per-site code {gaps}")
        th = t.clone().requires_grad_(True)
        outs = [_log_prior_and_jac(spec, th), *constrain(spec, th).values()]
        cots = [gl, *gs.unbind(0)]
        plain_fwd = lambda: (_log_prior_and_jac(spec, t), constrain(spec, t))  # noqa: E731
        plain_bwd = lambda: torch.autograd.grad(outs, th, cots, retain_graph=True)  # noqa: E731
        # each launch's bound: the bytes it must move (theta, sites or the two cotangents, dtheta, the table)
        words = c * dim
        kernels[f"priors_fwd_c{c}"] = row(lambda: kp._priors_fwd_cuda(t, table), err)
        kernels[f"priors_fwd_c{c}"].update(bound_ms=bound_ms(4 * (2 * words + c + table.numel()), 0)[0],
                                           plain_ms=cuda_ms(plain_fwd))
        kernels[f"priors_bwd_c{c}"] = row(lambda: kp._priors_bwd_cuda(t, table, gs, gl), err)
        kernels[f"priors_bwd_c{c}"].update(bound_ms=bound_ms(4 * (3 * words + c + table.numel()), 0)[0],
                                           plain_ms=cuda_ms(plain_bwd))
    return kernels, dict(C=[4, 128], dim=dim)


def device_ms_by_launch(fn, calls: int = 5):
    """{kernel name: mean device ms a call} of the launches of ``fn()``, from a
    ``torch.profiler`` trace of ``calls`` eager calls."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"\(anonymous namespace\)::|^void ", "", e.name).split("(")[0][:60]
            by[name] = by.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return by


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("a", "b", "c", "p"), required=True)
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--no-check", action="store_true",
                    help="report max_abs_err without holding it to the limits: for timing a copy with a part of "
                         "the kernel removed on purpose, to see what that part costs")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))  # the timers and limits of this checkout's chip_smoke.py
    from chip_smoke import N_GRID, N_Z, SEED, both_ms, card_line, check_close

    sys.path.insert(0, str(root))  # the package under --root

    def row(fn, err, **graph_kwargs):
        ms, call_ms = both_ms(fn, **graph_kwargs)
        return dict(ms=ms, call_ms=call_ms, max_abs_err=err)

    if args.no_check:
        def check_close(name, got, ref, rtol, atol):  # noqa: F811
            return float((got - ref).abs().max())

    times = {"a": kernel_a_times, "b": kernel_b_times, "c": kernel_c_times, "p": kernel_p_times}[args.kernel]
    kernels, shape = times(root, row, check_close, N_GRID, N_Z, SEED)
    torch.cuda.synchronize()
    print(json.dumps(dict(root=str(root), kernel=args.kernel, card=card_line(), shape=shape, kernels=kernels,
                          checked=not args.no_check)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
