"""Time kernel A, B, C, P, F or T of another checkout on the same card, beside this one's.

    python3 bumpcosmology_torch/tools/kernel_times.py --kernel a|b|c|p|f|t [--root DIR]

(run by path, not with ``-m``: the package it times is the one under ``--root``).

``chip_smoke.py`` phases 2, 3 and 6 give the kernels' device times for the checkout
it lies in.  This tool gives the same figures for any checkout of the
repository, so that two commits are compared within one job on one card.  It
builds the kernel's source under ``--root`` (default: this checkout), launches
it forward and backward at the flagship shapes on the warm thetas of
``benchmarks/flagship_warmup16.npz``, holds each launch against that checkout's
plain twin at ``chip_smoke.py``'s limits, and prints one JSON line: for each
kernel ``ms`` (device time) and ``call_ms`` (one eager wrapper call), taken with
the timers of this checkout's ``tools/oncard.py``, and ``max_abs_err``; with the
card's name and power limit.  Needs one NVIDIA GPU and nvcc.

* ``--kernel a``: ``csrc/bump.cu`` at C = 16, G = 256 (phase 2's limits: forward
  rtol 1e-4 / atol 5e-5, VJP rtol 2e-4 / atol 1e-5).
* ``--kernel b``: ``csrc/logwts.cu`` at C = 16, N = 38,912, K = 1024, G = 256, the
  ``rows`` kernels and, where the checkout has them, the ``lse`` kernels (phase
  3's limits); where it takes a query table per chain, also the shared table
  copied once per chain (``*_copied``, 16 x 38,912 x 4) and 20 distinct
  per-chain tables of 2,816 rows (``*_per_chain``, the SBC fleet's shape,
  ``oncard.fleet_queries``) and the leave-one-out fleet's 56 tables of
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
* ``--kernel f``: ``csrc/families.cu`` (POWER-LAW+PEAK) at the shape of the
  benchmark's cell ``flagship_plpeak.nuts``: its cut catalog (56 x 128 PE
  samples and 1,024 injections, one query table shared by the chains), the
  detector table at n_z = 1,024, the q-norm table at n_grid = 256 and the 4
  chains of its committed adapted state, the log-likelihood's cotangents;
  and, where the checkout has POWER LAW + SPLINE, the same for that family
  at ``gwtc3_pspline.nuts``'s shape (the whole catalog, 38,912 rows a
  chain, and the spline's coefficient table; its rows' operations from
  ``cardbench/counts_pspline.py``);
  held to the eager twin on the card (the log-sum-exps within rtol 2e-5, the
  table and site cotangents within phase 3's rtol 5e-4 and 5e-4 of the largest);
  ``bound_ms`` from ``cardbench/counts.py``'s operations of the family (a
  chain-query's and the pivot's, forward or backward) and the bytes read and
  written; ``plain_ms`` one eager call of the twin on the card, its forward
  (the rows' weights, the pivot and ``torch.logsumexp``) or its backward
  (autograd through them into the tables and the sites).
* ``--kernel t``: ``csrc/tables.cu`` at the same cell's shape: the cosmology
  and detector tables at n_z = 1,024 between the cell's dL bounds for its 4
  chains, and, backward, the cotangent of the detector table that kernel F's
  backward gives the cell's log-likelihood; held to the eager table code on the
  card (the table within rtol 2e-5 / atol 2e-5, the sites' cotangents within
  rtol 5e-4 and 5e-4 of the largest); ``bound_ms`` from the bytes read and
  written and the operations a knot and a node need (``T_OPS_PER_KNOT``);
  ``plain_ms`` one eager call of ``build_cosmology`` and
  ``build_detector_table`` on the card, forward, or of autograd through them,
  backward.

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

if __package__:  # imported, as chip_smoke.py imports it
    from bumpcosmology_torch.tools import oncard
else:  # run by path: this checkout's oncard.py from this directory, whatever package --root puts first
    import oncard

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

    from bumpcosmology_torch.inference.likelihoods import query_table
    from bumpcosmology_torch.ops import cuda_logwts as kb

    data, sites = warm_sites(root, n_grid, n_z)
    tables = oncard.b_tables(sites, data, n_z, n_grid)
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
    held by ``oncard.b_against_twin``)."""
    import torch

    from bumpcosmology_torch.inference.influence import make_loo_datas
    from bumpcosmology_torch.inference.likelihoods import query_table
    from bumpcosmology_torch.ops import cuda_logwts as kb

    nobs, nsamp = data.events.a.shape
    c = tables[0].shape[0]
    copied = qry.expand(c, -1, -1).contiguous()
    errs = oncard.b_against_twin("B copied", tables, copied, nobs, nsamp, gen)[0]
    out = {"logwts_fwd_copied": row(lambda: kb._logwts_fwd_cuda(*tables, copied), errs["rows_fwd"]),
           "logwts_lse_fwd_copied": row(lambda: kb._logwts_lse_fwd_cuda(*tables, copied, nobs, nsamp),
                                        errs["lse_fwd"])}
    f_obs, f_samp = oncard.SBC_NOBS, oncard.SBC_NSAMP
    t20 = oncard.b_tables({k: torch.cat([v, v[: oncard.SBC_SIMS - c]]) for k, v in sites.items()}, data)
    fq = oncard.fleet_queries(data, oncard.SBC_SIMS, gen)
    errs, _, (lse_ev, lse_sel), (_, g_ev, g_sel) = oncard.b_against_twin("B per-chain", t20, fq, f_obs, f_samp, gen)
    out["logwts_lse_fwd_per_chain"] = row(lambda: kb._logwts_lse_fwd_cuda(*t20, fq, f_obs, f_samp), errs["lse_fwd"])
    out["logwts_lse_bwd_per_chain"] = row(
        lambda: kb._logwts_lse_bwd_cuda(*t20, fq, lse_ev, lse_sel, g_ev, g_sel, f_obs, f_samp), errs["lse_bwd"])
    with torch.no_grad():
        lq = query_table(make_loo_datas(data))
    t56 = oncard.b_tables(oncard.tiled_sites(sites, lq.shape[0]), data)
    errs, _, (lse_ev, lse_sel), (_, g_ev, g_sel) = oncard.b_against_twin("B per-chain LOO", t56, lq, nobs - 1, nsamp,
                                                                          gen)
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

    seen, network = {}, snr.network_snr

    def kept(m1, m2, dl, *args, **kwargs):  # the rows the campaign sends to kernel C
        seen["rows"] = (m1, m2, dl)
        return network(m1, m2, dl, *args, **kwargs)

    snr.network_snr = kept
    try:
        catalog.draw_injection_campaign(ndraw=oncard.MOCK_NDRAW, seed=oncard.MOCK_SEED,
                                        device=torch.device("cuda"))
    finally:
        snr.network_snr = network
    m1, m2, dl = seen["rows"]
    f_grid = snr.frequency_grid(device=m1.device)
    inv_psd = 1.0 / psd.PSDS["H1"](f_grid)
    grid = dict(f_min=float(f_grid[0]), f_max=float(f_grid[-1]), n_f=f_grid.shape[0], amp_scale=kc.AMP_SCALE)
    fn = lambda: kc._snr_integral_cuda(m1, m2, dl, inv_psd, **grid)  # noqa: E731
    got, ref = fn(), kc.snr_integral_plain(m1, m2, dl, inv_psd, **grid, chunk=oncard.PLAIN_CHUNK)
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
        kernels[f"priors_fwd_c{c}"].update(bound_ms=oncard.bound_ms(4 * (2 * words + c + table.numel()), 0)[0],
                                           plain_ms=oncard.cuda_ms(plain_fwd))
        kernels[f"priors_bwd_c{c}"] = row(lambda: kp._priors_bwd_cuda(t, table, gs, gl), err)
        kernels[f"priors_bwd_c{c}"].update(bound_ms=oncard.bound_ms(4 * (3 * words + c + table.numel()), 0)[0],
                                           plain_ms=oncard.cuda_ms(plain_bwd))
    return kernels, dict(C=[4, 128], dim=dim)


def kernel_f_times(root: Path, row, check_close, n_grid: int, n_z: int, seed: int):
    """({kernel: row}, shape) of ``csrc/families.cu`` under ``root`` for
    POWER-LAW+PEAK at the cell ``flagship_plpeak.nuts``'s shape (``f_fwd_lse``,
    ``f_bwd_lse``) and, where the checkout has the family, for POWER LAW +
    SPLINE at ``gwtc3_pspline.nuts``'s (``f_fwd_lse_pspline``,
    ``f_bwd_lse_pspline``): the benchmark's configurations and data of this
    checkout."""
    from bumpcosmology_torch.ops import cuda_families as kf

    kernels, shape = _kernel_f_family("plpeak", "flagship_plpeak", row, check_close)
    if "pspline" in kf.FAMILIES:
        more, shape["pspline"] = _kernel_f_family("pspline", "gwtc3_pspline", row, check_close)
        kernels.update((f"{k}_pspline", v) for k, v in more.items())
    return kernels, shape


def _kernel_f_family(family: str, config_name: str, row, check_close):
    """({kernel: row}, shape) of kernel F for ``family`` at the shape of the
    benchmark's configuration ``config_name``, its committed adapted state's
    chains, the log-likelihood's cotangents."""
    import torch

    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import constrain
    from bumpcosmology_torch.models import plpeak
    from bumpcosmology_torch.models.cosmology import DetectorFrameTable, build_cosmology, build_detector_table
    from bumpcosmology_torch.models.parameters import RedshiftParams
    from bumpcosmology_torch.ops import cuda_families as kf
    from bumpcosmology_torch.utils.checkpoint import load_warmup
    from cardbench import counts, counts_pspline, harness

    dev = torch.device("cuda")
    config = json.loads((harness.BENCH_DIR / "configs" / f"{config_name}.json").read_text())
    raw = harness.cut_catalog(harness.read_catalog(harness.data_path(config, "catalog")), config["events"],
                              config["pe_samples"], config["injections"])
    data = harness.program_data(raw, dev)
    n_grid, n_z, c = config["n_grid"], config["n_z"], config["chains"]
    spec = lk.MASS_FAMILIES[family].cosmo_spec(data, n_grid=n_grid, n_z=n_z, device=dev)
    with torch.no_grad():
        sites = constrain(spec, load_warmup(harness.data_path(config, "warmup_state"), device=dev).state.theta[:c])
        pop = lk.MASS_FAMILIES[family].build(sites, n_grid, pivot=False)  # the tables alone, as F's route
        params, dm, log_nq = pop.params, pop.dm, pop.log_nq
        det = build_detector_table(build_cosmology(lk.cosmo_from_sites(sites), n=n_z), *lk.dl_bounds_of(data), n=n_z)
        scal = kf.family_scalars(family, params.mass, params.redshift).contiguous()
    spline = getattr(pop, "coef", None)
    qry = lk.query_table(data)
    nobs, nsamp = data.events.a.shape
    n = qry.shape[0]
    args = (family, det.cols, log_nq, scal, qry)
    extra = {} if spline is None else {"spl": spline.detach().contiguous()}
    fwd = lambda: kf._fwd(*args, det.v0, det.dv, dm, nobs, nsamp, **extra)  # noqa: E731
    lse_ev, lse_sel = fwd()
    g_ev, g_sel = torch.ones_like(lse_ev), torch.full_like(lse_sel, -float(nobs))  # the log-likelihood's
    bwd = lambda: kf._bwd(*args, lse_ev, lse_sel, g_ev, g_sel, det.v0, det.dv, dm, nobs, nsamp, **extra)  # noqa: E731
    got = bwd()

    # the eager twin on the card, differentiable in the inputs that F differentiates
    leaves = scal.clone().requires_grad_(True)
    col = {k: leaves[:, i] for i, k in enumerate(kf.SLOTS[family])}
    nq_l, cols_l = log_nq.clone().requires_grad_(True), det.cols.clone().requires_grad_(True)
    red = RedshiftParams(col["lam"], col["kappa"], col["zp"])
    if family == "plpeak":
        mass = plpeak.PLPeakMassParams(*(col[k] for k in plpeak.PLPeakMassParams._fields))
        inputs, make = [cols_l, nq_l, leaves], lambda: plpeak.PLPeakIntensity(  # noqa: E731
            params=plpeak.PLPeakPopulationParams(mass, red), dm=dm, log_nq=nq_l, log_norm=torch.zeros_like(col["mmin"]))
    else:
        from bumpcosmology_torch.models import pspline

        spl_l = spline.detach().clone().requires_grad_(True)
        mass = pspline.PSplineMassParams(*(col[k] for k in pspline.PSplineMassParams._fields[:-1]), heights=None)
        inputs, make = [cols_l, nq_l, leaves, spl_l], lambda: pspline.PSplineIntensity(  # noqa: E731
            params=pspline.PSplinePopulationParams(mass, red), dm=dm, log_nq=nq_l,
            log_norm=torch.zeros_like(col["mmin"]), coef=spl_l)

    def plain_fwd():
        pop = make()
        pop = pop._replace(log_norm=plpeak._pivot_log_norm(pop))
        w = lk._cosmo_frame_logwts_fused(pop, DetectorFrameTable(det.params, det.v0, det.dv, cols_l), qry)
        return (torch.logsumexp(w[:, :nobs * nsamp].reshape(c, nobs, nsamp), -1),
                torch.logsumexp(w[:, nobs * nsamp:], -1))

    ref_ev, ref_sel = plain_fwd()
    plain_bwd = lambda: torch.autograd.grad((ref_ev, ref_sel), inputs, (g_ev, g_sel), retain_graph=True)  # noqa: E731
    ref = plain_bwd()
    err_fwd = max(check_close("F lse_ev", lse_ev, ref_ev.detach(), 2e-5, 2e-5),
                  check_close("F lse_sel", lse_sel, ref_sel.detach(), 2e-5, 2e-5))
    err_bwd = max(check_close(f"F d_{name}", a, b, 5e-4, 5e-4 * float(b.abs().max()) + 1e-5)
                  for name, a, b in zip(("det", "nq", "scal", "spline"), got, ref))

    if family == "plpeak":
        terms = counts.FAMILY_QUERY_OPS["plpeak"]
        ops = [c * (n * sum(t[i] for t in terms) + sum(t[i] for t in terms if t[0] in counts.PIVOT_TERMS))
               for i in (1, 2)]
    else:  # counts_pspline's rows: the forward's Row::eval, the backward's recomputation and chain rule
        ops = [c * n * sum(k for _, _, k in counts_pspline.ROW_FWD), c * n * counts_pspline.row_bwd_ops()]
    words = 2 * n_z + n_grid + kf._NS + (0 if spline is None else spline[0].numel())
    read = 4 * (n * 4 + c * words)  # the query rows, the tables and the sites
    kernels = {}
    bounds = (oncard.bound_ms(read + 4 * c * (nobs + 1), ops[0]),
              oncard.bound_ms(2 * read + 8 * c * (nobs + 1), ops[1]))
    for name, fn, err, plain, (b_ms, b_by) in (("f_fwd_lse", fwd, err_fwd, plain_fwd, bounds[0]),
                                               ("f_bwd_lse", bwd, err_bwd, plain_bwd, bounds[1])):
        kernels[name] = row(fn, err)
        kernels[name].update(bound_ms=b_ms, bound_by=b_by, plain_ms=oncard.cuda_ms(plain))
    return kernels, dict(C=c, N=n, nobs=nobs, nsamp=nsamp, K=n_z, n_m=n_grid)


# FP32 operations kernel T needs a knot and its detector node, forward and backward
# (csrc/tables_math.cuh, counted once, special functions as one): a knot's E(z) 10, its segment 4,
# the prefix sum 1, its entries 9; a node's bracket and z 9, the lookup's bracket 6, two lerps 6,
# the log-Jacobian 4.  The backward: the forward's 49, then node_grad 30, knot_grad 20, the two
# segments' cotangents 4, efunc_grad 12.
T_OPS_PER_KNOT = (49, 115)


def kernel_t_times(root: Path, row, check_close, n_grid: int, n_z: int, seed: int):
    """({kernel: row}, shape) of ``csrc/tables.cu`` under ``root`` at the cell
    ``flagship_plpeak.nuts``'s shape (the benchmark's configuration and data of
    this checkout)."""
    import torch

    from bumpcosmology_torch.inference import likelihoods as lk
    from bumpcosmology_torch.inference.model import constrain
    from bumpcosmology_torch.models.cosmology import DEFAULT_ZMAX, build_cosmology, build_detector_table
    from bumpcosmology_torch.models.parameters import CosmoParams
    from bumpcosmology_torch.ops import cuda_families as kf
    from bumpcosmology_torch.ops import cuda_tables as kt
    from bumpcosmology_torch.utils.checkpoint import load_warmup
    from cardbench import harness

    dev = torch.device("cuda")
    config = json.loads((harness.BENCH_DIR / "configs" / "flagship_plpeak.json").read_text())
    raw = harness.cut_catalog(harness.read_catalog(harness.data_path(config, "catalog")), config["events"],
                              config["pe_samples"], config["injections"])
    data = harness.program_data(raw, dev)
    n_grid, n_z, c = config["n_grid"], config["n_z"], config["chains"]
    spec = lk.MASS_FAMILIES["plpeak"].cosmo_spec(data, n_grid=n_grid, n_z=n_z, device=dev)
    bounds = lk.dl_bounds_of(data)
    with torch.no_grad():
        sites = constrain(spec, load_warmup(harness.data_path(config, "warmup_state"), device=dev).state.theta[:c])
        pop = lk.MASS_FAMILIES["plpeak"].build(sites, n_grid, pivot=False)
    cosmo = tuple(sites[k].contiguous() for k in ("h", "Om", "w"))
    grid = kt._grid(n_z, *bounds, DEFAULT_ZMAX)

    def plain_fwd(leaves=cosmo):
        return build_detector_table(build_cosmology(CosmoParams(*leaves), n=n_z), *bounds, n=n_z)

    # the cotangent of the detector table that kernel F's backward gives the cell's log-likelihood
    det = plain_fwd()
    cols = det.cols.clone().requires_grad_(True)
    scal = kf.family_scalars("plpeak", pop.params.mass, pop.params.redshift).contiguous()
    qry = lk.query_table(data)
    nobs, nsamp = data.events.a.shape
    lse_ev, lse_sel = kf.family_lse("plpeak", det._replace(cols=cols), pop.log_nq, pop.dm, scal, qry, nobs, nsamp)
    (g,) = torch.autograd.grad(lse_ev.sum() - nobs * lse_sel.sum(), [cols])

    fwd = lambda: kt._fwd(*cosmo, n_z, grid)  # noqa: E731
    bwd = lambda: kt._bwd(*cosmo, g, n_z, grid)  # noqa: E731
    leaves = [x.clone().requires_grad_(True) for x in cosmo]
    ref_cols = plain_fwd(leaves).cols
    plain_bwd = lambda: torch.stack(torch.autograd.grad(ref_cols, leaves, g, retain_graph=True))  # noqa: E731
    ref = plain_bwd()
    err_fwd = check_close("T cols", fwd(), ref_cols.detach(), 2e-5, 2e-5)
    err_bwd = check_close("T d_sites", bwd(), ref, 5e-4, 5e-4 * float(ref.abs().max()) + 1e-5)

    word = cosmo[0].element_size()  # the sites read, the table written (forward) or read (backward), the cotangents
    bounds_ms = (oncard.bound_ms(word * c * (3 + 2 * n_z), c * n_z * T_OPS_PER_KNOT[0]),
                 oncard.bound_ms(word * c * (3 + 2 * n_z + 3), c * n_z * T_OPS_PER_KNOT[1]))
    kernels = {}
    for name, fn, err, plain, (b_ms, b_by) in (("t_fwd", fwd, err_fwd, lambda: plain_fwd(), bounds_ms[0]),
                                               ("t_bwd", bwd, err_bwd, plain_bwd, bounds_ms[1])):
        kernels[name] = row(fn, err)
        kernels[name].update(bound_ms=b_ms, bound_by=b_by, plain_ms=oncard.cuda_ms(plain))
    return kernels, dict(C=c, n_z=n_z, dl_bounds=list(bounds))


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
    ap.add_argument("--kernel", choices=("a", "b", "c", "p", "f", "t"), required=True)
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
    sys.path.insert(0, str(root))  # the package under --root
    check_close = oncard.check_close
    if args.no_check:
        def check_close(name, got, ref, rtol, atol):
            return float((got - ref).abs().max())

    times = {"a": kernel_a_times, "b": kernel_b_times, "c": kernel_c_times, "p": kernel_p_times,
             "f": kernel_f_times, "t": kernel_t_times}[args.kernel]
    kernels, shape = times(root, oncard.timed_row, check_close, oncard.N_GRID, oncard.N_Z, oncard.SEED)
    torch.cuda.synchronize()
    print(json.dumps(dict(root=str(root), kernel=args.kernel, card=oncard.card_line(), shape=shape,
                          kernels=kernels, checked=not args.no_check)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
