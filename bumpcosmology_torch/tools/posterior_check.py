"""Hold the port's float32 joint fit against the committed float64 golden trace.

    python -m bumpcosmology_torch.tools.posterior_check [--device cuda|cpu]
        [--chains N --warmup W --samples S] [--checkpoint PATH] [--warmup-only] [--probe T]

The counterpart of the JAX package's ``tests/test_f64_crosscheck.py::
test_joint_f32_matches_f64_golden``.  It reads ``benchmarks/golden_joint_f64.npz``
(its ``config`` and ``post_*`` draws: a float64 NUTS fit of the joint
model), builds the same mock catalog with :func:`benchdata.mock_pop_cosmo_data`
on the CPU (the float64 host draws; the SNR of the CPU's plain path, so that
no detection near the threshold moves with the device) and moves it to
``--device``, builds ``pop_cosmo_model_spec(data, n_grid, n_z)`` at the
golden's grids, and runs the port's float32 :func:`fit` with
``NutsConfig()`` defaults (default 2 chains, 500 warmup steps, 400 draws,
seed 11: the JAX test's).  Then every site's summary is held against the
golden's with the JAX test's limits: split r-hat below 1.05, the means
within 4 combined Monte-Carlo standard errors, the sd ratio between 0.7 and
1.4.  It prints a table of the sites, then one JSON line (the worst |z|, the
sd ratio farthest from 1, the largest r-hat, the wall, the batched
value+grads, the device and, on a GPU, the card's name and power limit) and
exits 1 if any limit fails.

A fit longer than one job splits in two through ``fit(checkpoint_path=)``:
``--warmup-only --checkpoint P`` adapts and writes the warmup state to
``P``; the same command without ``--warmup-only`` then finds it and samples
(every 100 draws ``P.sampling.npz`` keeps the draws so far, and a rerun
resumes there).  ``--probe T`` runs T warmup transitions alone and prints
the projection of the whole fit's wall from their rate.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

GOLDEN = Path(__file__).resolve().parents[2] / "benchmarks" / "golden_joint_f64.npz"
RHAT_MAX = 1.05
Z_MAX = 4.0
SD_RATIO = (0.7, 1.4)
SEED = 11

__all__ = ["load_golden", "golden_catalog", "compare", "main"]


def load_golden():
    """(config dict, {site: (chains, draws) float64 draws}) of the golden trace."""
    with np.load(GOLDEN) as d:
        cfg = json.loads(str(d["config"]))
        post = {k[len("post_"):]: np.asarray(d[k]) for k in d.files if k.startswith("post_")}
    return cfg, post


def golden_catalog(cfg: dict):
    """The golden's mock catalog, built on the CPU from its seed."""
    from bumpcosmology_torch.benchdata import mock_pop_cosmo_data

    return mock_pop_cosmo_data(nobs=cfg["nobs"], nsamp=cfg["nsamp"], nsel=cfg["nsel"],
                               ndraw_campaign=cfg["ndraw_campaign"], threshold=cfg["threshold"],
                               seed=cfg["seed"], device="cpu")


def compare(summ: dict, golden: dict):
    """Each site of ``summ`` against ``golden`` (both :func:`summary` dicts):
    (rows, worst).  A row holds the two means and sds, |z| (the means'
    difference over the combined Monte-Carlo standard error, each side's
    sd / sqrt(ESS)), the sd ratio, the fit's r-hat and whether all three
    limits hold; ``worst`` the largest |z| and r-hat, the sd ratio farthest
    from 1 (in log), and ``ok``.  The sites must be the same."""
    if set(summ) != set(golden):
        raise ValueError(f"sites differ: fit {sorted(summ)}, golden {sorted(golden)}")
    rows = []
    for site in golden:
        a, b = summ[site], golden[site]
        se = math.hypot(a["sd"] / math.sqrt(max(a["ess"], 1.0)), b["sd"] / math.sqrt(max(b["ess"], 1.0)))
        z = abs(a["mean"] - b["mean"]) / max(se, 1e-12)
        ratio = a["sd"] / b["sd"]
        ok = a["rhat"] < RHAT_MAX and z < Z_MAX and SD_RATIO[0] < ratio < SD_RATIO[1]
        rows.append(dict(site=site, mean=a["mean"], golden_mean=b["mean"], sd=a["sd"], golden_sd=b["sd"],
                         z=z, sd_ratio=ratio, rhat=a["rhat"], ess=a["ess"], ok=bool(ok)))
    worst = dict(z=max(r["z"] for r in rows), rhat=max(r["rhat"] for r in rows),
                 sd_ratio=max((r["sd_ratio"] for r in rows), key=lambda x: abs(math.log(x))),
                 ok=all(r["ok"] for r in rows))
    return rows, worst


def table(rows) -> str:
    head = f"{'site':>10} {'mean':>11} {'golden':>11} {'sd':>10} {'golden sd':>10} {'|z|':>6} {'sd ratio':>8} " \
           f"{'rhat':>6} {'ess':>7}"
    lines = [head]
    for r in rows:
        lines.append(f"{r['site']:>10} {r['mean']:>11.5g} {r['golden_mean']:>11.5g} {r['sd']:>10.4g} "
                     f"{r['golden_sd']:>10.4g} {r['z']:>6.2f} {r['sd_ratio']:>8.3f} {r['rhat']:>6.3f} "
                     f"{r['ess']:>7.0f}" + ("" if r["ok"] else "  FAIL"))
    return "\n".join(lines)


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the device's type."""
    if dev.type != "cuda":
        return dev.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _counting(spec, counts: dict):
    """``spec`` whose log-likelihood counts its batched calls with gradients on (value+grads)."""
    import torch

    def loglike(sites):
        counts["value_grad" if torch.is_grad_enabled() else "value"] += 1
        return spec.loglike(sites)

    return spec._replace(loglike=loglike)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--samples", type=int, default=400)
    ap.add_argument("--checkpoint", default=None, help="warmup checkpoint path (fit(checkpoint_path=))")
    ap.add_argument("--warmup-only", action="store_true", help="adapt, write --checkpoint and stop")
    ap.add_argument("--probe", type=int, default=0, help="run this many warmup transitions and project the wall")
    args = ap.parse_args(argv)
    if args.warmup_only and args.checkpoint is None:
        ap.error("--warmup-only needs --checkpoint")

    import torch

    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.inference.diagnostics import summary
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec
    from bumpcosmology_torch.inference.model import make_potential
    from bumpcosmology_torch.inference.nuts import NutsConfig, run_warmup
    from bumpcosmology_torch.inference.sampler import _finite_prior_init, fit
    from bumpcosmology_torch.utils.checkpoint import save_warmup

    dev = resolve_device(args.device)
    cfg, golden = load_golden()
    t0 = time.perf_counter()
    counts = {"value_grad": 0, "value": 0}
    spec = _counting(pop_cosmo_model_spec(golden_catalog(cfg), n_grid=cfg["n_grid"], n_z=cfg["n_z"], device=dev),
                     counts)
    setup_s = time.perf_counter() - t0
    record = dict(device=str(dev), card=card_line(dev), chains=args.chains, warmup=args.warmup,
                  samples=args.samples, seed=SEED, setup_s=round(setup_s, 3))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if args.probe or args.warmup_only:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        theta0 = _finite_prior_init(spec, make_potential(spec), gen, args.chains)
        steps = args.probe or args.warmup
        t1 = time.perf_counter()
        warm, stats = run_warmup(make_potential(spec), theta0, steps, NutsConfig(), generator=gen, device=dev)
        sync()
        wall = time.perf_counter() - t1
        record.update(stage="probe" if args.probe else "warmup", transitions=steps, wall_s=round(wall, 3),
                      value_grads=counts["value_grad"], ms_per_value_grad=round(1e3 * wall / counts["value_grad"], 3),
                      value_grads_per_transition=round(counts["value_grad"] / steps, 1),
                      mean_tree_depth=round(float(stats.tree_depth.float().mean()), 2))
        if args.probe:
            record["projected_wall_s"] = round(wall / steps * (args.warmup + args.samples), 1)
        else:
            save_warmup(args.checkpoint, warm)
            record["checkpoint"] = args.checkpoint
        print(json.dumps(record))
        return 0

    t1 = time.perf_counter()
    res = fit(spec, SEED, num_warmup=args.warmup, num_samples=args.samples, num_chains=args.chains,
              cfg=NutsConfig(), checkpoint_path=args.checkpoint, verbose=True, device=dev)
    sync()
    wall = time.perf_counter() - t1
    rows, worst = compare(res.summary(), summary(golden))
    print(table(rows))
    record.update(stage="fit", wall_s=round(wall, 3), timings={k: round(v, 3) for k, v in res.timings.items()},
                  value_grads=counts["value_grad"], divergences=int(np.sum(res.sample_stats["diverging"])),
                  mean_n_leapfrog=round(float(np.mean(res.sample_stats["n_leapfrog"])), 1),
                  worst_z=round(worst["z"], 4), worst_sd_ratio=round(worst["sd_ratio"], 4),
                  max_rhat=round(worst["rhat"], 4), ok=worst["ok"],
                  sites={r["site"]: dict(z=round(r["z"], 3), sd_ratio=round(r["sd_ratio"], 4), rhat=round(r["rhat"], 4),
                                         ess=round(r["ess"], 1)) for r in rows})
    print(json.dumps(record))
    return 0 if worst["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
