"""Run one of the JAX package's three 128-simulation SBC certificates with the port.

    python -m bumpcosmology_torch.tools.sbc_certificate --family {bump,plpeak,brokenpl}
        [--seed S] [--out DIR] [--probe T] [--checkpoint P [--warmup-only]] [--device cuda|cpu]
        [section.key=value ...]

The JAX package certifies each joint mass family by one fresh-noise SBC
suite of 128 simulations, committed with its per-site verdicts under
``benchmarks/sbc/``: the bump (``sbc_ranks_bump_128_run3.h5``), POWER-LAW+PEAK
(``sbc_ranks_plpeak_128_softwall.h5``) and BROKEN POWER LAW
(``sbc_ranks_brokenpl_128_certified.h5``).  Their drivers set one
configuration, :data:`CERTIFICATE` (16 events x 256 PE samples and 3,584
selection rows a simulation from a 6.5·10⁶-draw campaign at SNR 20, 600
warmup steps and 512 draws thinned by 8, PE banks of 16,384, ``n_grid`` 128,
``n_z`` 256), the family's model and its seed (:data:`FAMILIES`).  This tool
builds that :class:`PipelineConfig` field for field (the fresh-noise
simulator and ``max_depth`` 8 are ``SBCConfig``'s defaults, which the
drivers kept), then applies ``key=value`` overrides in the pipeline CLI's
syntax (for rehearsals at a cut size only), and runs the port's own
``_stage_sbc`` on ``--device`` (default the card).

It writes ``sbc_ranks.npz`` (the stage's artifact) and ``sbc_certificate.json``
(this report) to ``--out`` and prints each site's p beside the reference
artifact's (:data:`REFERENCE`, copied from the ``.h5`` files, which a host
without h5py cannot read; a test holds the copy to them), the verdict (every
site at p >= 0.01, the JAX package's rule), the rate check's p, the wall by
part (campaign, simulations, initial candidates, warmup, sampling, rate
check), the fleet's batched value+grads (ms each, and a transition), the
divergent draws, the kernels' launches and the card's name and power limit.  It exits 1 when the
verdict fails or when a joint suite's rate check did not run (the stage
only warns there, as the JAX package's does).

``--probe T`` (T < 20) draws the campaign and the 128 catalogs, runs the
first T fleet transitions and projects the suite's wall from their rate,
writing no artifact; it also times one value+grad with all 128 chains
active and with 64, 16 and 1 (NUTS evaluates the chains still
integrating).  Its transitions come before the first step-size and mass
adaptation, and in a fleet in lockstep the deepest chain sets each
transition's length, so the later transitions' rate may differ either
way.  On the card, probe first:

    python -m bumpcosmology_torch.tools.sbc_certificate --family bump --probe 10

A suite longer than one job splits at the end of the fleet's warmup:
``--checkpoint P --warmup-only`` draws everything, adapts, writes the
adapted state and the generator's state to ``P`` and the warmup's report
to ``sbc_certificate_warmup.json``; the same command without
``--warmup-only`` draws the same campaign and catalogs again, finds ``P``
and samples from it (the ranks of one unsplit run, bit for bit).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["CERTIFICATE", "FAMILIES", "REFERENCE", "certificate_config", "run_certificate", "main"]

# the fields that the reference drivers set, the same for the three families
CERTIFICATE = {
    "sbc.n_sims": 128,
    "sbc.nobs": 16,
    "sbc.nsamp": 256,
    "sbc.nsel": 3584,
    "sbc.campaign_ndraw": 6_500_000,
    "sbc.num_warmup": 600,
    "sbc.num_samples": 512,
    "sbc.thin": 8,
    "sbc.threshold": 20.0,
    "sbc.pe_bank_size": 16384,
    "fit.n_grid": 128,
    "fit.n_z": 256,
}
# family -> (model, the reference's seed, its driver, its artifact)
FAMILIES = {
    "bump": ("pop_cosmo", 766001, "scratch/r4_sbc_bump_c.py", "benchmarks/sbc/sbc_ranks_bump_128_run3.h5"),
    "plpeak": ("plpeak_cosmo", 744001, "scratch/r4_sbc_plpeak.py", "benchmarks/sbc/sbc_ranks_plpeak_128_softwall.h5"),
    "brokenpl": ("brokenpl_cosmo", 733303, "scratch/r5_sbc_brokenpl_seed3.py",
                 "benchmarks/sbc/sbc_ranks_brokenpl_128_certified.h5"),
}
# each reference artifact's pvalues/p by site and its rate_check p (None: the artifact has no rate_check group)
REFERENCE = {
    "bump": ({
        "Om": 0.4488920034257041, "a": 0.9723399260561224, "b": 0.7946256443064365, "beta": 0.5563325420959568,
        "c": 0.2821898299426348, "dkappa": 0.5404568187577321, "dmbhmax": 0.7946256443064365,
        "h": 0.3045856926325375, "lam": 0.9723399260561224, "log_fpl": 0.8986438045978524,
        "mpisn": 0.1326874425364631, "sigma": 0.5884365403375236, "w": 0.7646551179758229,
        "zp": 0.048715976147641296,
    }, None),
    "plpeak": ({
        "Om": 0.8091341714961995, "alpha": 0.23150527656700087, "beta_q": 0.8755390252983378,
        "delta_m": 0.21330930508341656, "dkappa": 0.3404609120311281, "h": 0.8232783432788754,
        "lam": 0.5884365403375236, "lam_peak": 0.11581006686665953, "mmax": 0.8091341714961994,
        "mmin": 0.5723331919692176, "mu_m": 0.653383341363466, "sigma_m": 0.8091341714961994,
        "w": 0.08755917095280248, "zp": 0.887367368615323,
    }, None),
    "brokenpl": ({
        "Om": 0.7646551179758228, "alpha1": 0.06558784011493973, "alpha2": 0.0722893681906465,
        "beta_q": 0.9377828069903966, "bfrac": 0.977330650215643, "delta_m": 0.13268744253646295,
        "dkappa": 0.3045856926325375, "h": 0.29323520206828035, "lam": 0.5723331919692176,
        "mmax": 0.2508775553573986, "mmin": 0.6046189446684883, "w": 0.6696181835369475,
        "zp": 0.13268744253646295,
    }, 0.019166836449254005),
}
P_MIN = 0.01  # the JAX package's write_sbc_artifact rule


def certificate_config(family: str, seed=None, out=".", overrides=()):
    """The reference driver's ``PipelineConfig`` for ``family``, at ``seed``
    (default the reference's), writing to ``out``, then ``overrides``
    (``section.key=value`` strings)."""
    from bumpcosmology_torch.pipeline.config import PipelineConfig

    model, ref_seed = FAMILIES[family][:2]
    fields = {**CERTIFICATE, "sbc.model": model, "sbc.fresh_noise": True, "sbc.max_depth": 8,
              "sbc.seed": ref_seed if seed is None else seed}
    cfg = PipelineConfig.load(None, [f"{k}={json.dumps(v) if not isinstance(v, str) else v}"
                                     for k, v in fields.items()] + list(overrides))
    cfg.paths.data_dir = str(out)
    return cfg


def card_line(dev) -> str:
    """The card's name and power limit as nvidia-smi gives them (the CPU: "cpu")."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _launches() -> dict:
    """The kernel wrappers' launch counts (A, B and C), by qualified name."""
    from bumpcosmology_torch.utils.profiling import counters

    return {k: v for k, v in counters().items() if k.startswith("cuda_")}


def run_certificate(family: str, seed=None, out=".", probe: int = 0, device=None, overrides=(),
                    checkpoint=None, warmup_only: bool = False) -> dict:
    """Run the suite (or its ``probe``, or its warmup alone) and return the
    report that :func:`main` prints and writes."""
    from bumpcosmology_torch.device import resolve_device
    from bumpcosmology_torch.pipeline.stages import _stage_sbc

    if not 0 <= probe < 20:
        raise ValueError(f"probe must lie in [0, 20) transitions (the opening buffer's), got {probe}")
    dev = resolve_device(device)
    cfg = certificate_config(family, seed, out, overrides)
    c = cfg.sbc
    before = _launches()
    t0 = time.perf_counter()
    rep = _stage_sbc(cfg, device=dev, probe=probe, checkpoint_path=checkpoint, warmup_only=warmup_only)
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
    transitions = c.num_warmup + c.num_samples
    evals = rep["warmup_evals"] + rep["sampling_evals"]
    fleet_s = rep["warmup_s"] + rep["sampling_s"]
    report = dict(
        family=family, model=c.model, seed=c.seed, n_sims=c.n_sims, card=card_line(dev), device=str(dev),
        wall_s=wall, campaign_s=rep["campaign_s"], simulate_s=rep["simulate_s"], init_s=rep["init_s"],
        warmup_s=rep["warmup_s"], sampling_s=rep["sampling_s"], value_grads=evals,
        warmup_value_grads=rep["warmup_evals"], sampling_value_grads=rep["sampling_evals"],
        ms_per_value_grad=1e3 * fleet_s / max(evals, 1),
        value_grads_per_transition=evals / max(rep["warmup_transitions"] + rep["sampling_transitions"], 1),
        divergences=rep["divergences"], kernel_launches=launches,
        checkpoint=None if checkpoint is None else str(checkpoint),
        warmup_resumed=checkpoint is not None and not warmup_only and rep["warmup_transitions"] == 0,
        overrides=list(overrides),
    )
    if probe:
        per_transition = rep["warmup_s"] / probe
        report.update(probe_transitions=probe, projected_s=rep["campaign_s"] + rep["simulate_s"] + rep["init_s"]
                      + per_transition * transitions, ms_by_active_chains=rep["probe_ms_by_chains"])
        return report
    if warmup_only:
        return report
    ref_p, ref_rate = REFERENCE[family]
    pvals = rep["pvalues"]
    report.update(rate_check_s=rep["rate_check_s"], write_s=rep["write_s"], pvalues=pvals,
                  reference_pvalues={k: ref_p.get(k) for k in pvals}, passed=not rep["bad"], failing=rep["bad"],
                  min_p=min(pvals.values()), rate_p=rep["rate_p"], reference_rate_p=ref_rate,
                  artifact=str(rep["artifact"]))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", required=True, choices=sorted(FAMILIES))
    ap.add_argument("--seed", type=int, default=None, help="the suite's seed (default the reference's)")
    ap.add_argument("--out", default=".", help="directory of sbc_ranks.npz and sbc_certificate.json")
    ap.add_argument("--probe", type=int, default=0, help="run this many fleet transitions (< 20) and project")
    ap.add_argument("--checkpoint", default=None, help="split the fleet at the end of its warmup through this file")
    ap.add_argument("--warmup-only", action="store_true", help="stop after writing --checkpoint")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    unknown = [a for a in rest if "=" not in a]
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.warmup_only and not args.checkpoint:
        ap.error("--warmup-only needs --checkpoint")
    r = run_certificate(args.family, args.seed, out, args.probe, args.device, rest, args.checkpoint,
                        args.warmup_only)
    print(f"[certificate] {r['family']} ({r['model']}), seed {r['seed']}, {r['n_sims']} simulations on {r['card']}")
    print(f"[certificate] wall {r['wall_s']:.1f} s: campaign {r['campaign_s']:.1f}, simulations "
          f"{r['simulate_s']:.1f}, initial candidates {r['init_s']:.1f}, warmup {r['warmup_s']:.1f}, sampling "
          f"{r['sampling_s']:.1f}" + (f", rate check {r['rate_check_s']:.1f}" if "rate_check_s" in r else "")
          + (" (the warmup resumed from the checkpoint)" if r["warmup_resumed"] else ""))
    print(f"[certificate] {r['value_grads']} batched value+grads, {r['ms_per_value_grad']:.2f} ms each, "
          f"{r['value_grads_per_transition']:.1f} a transition; {r['divergences']} divergent draws; kernel "
          f"launches {r['kernel_launches']}")
    if args.probe:
        print(f"[certificate] probe: {args.probe} transitions; projected suite wall {r['projected_s']:.0f} s "
              f"({r['projected_s'] / 60:.1f} min, without the rate check); ms a value+grad by active chains "
              + json.dumps({k: round(v, 2) for k, v in r["ms_by_active_chains"].items()}))
        print(json.dumps(r))
        return 0
    if args.warmup_only:
        print(f"[certificate] warmup written to {args.checkpoint}; run again without --warmup-only to sample")
        (out / "sbc_certificate_warmup.json").write_text(json.dumps(r, indent=1) + "\n")
        print(json.dumps(r))
        return 0
    print(f"[certificate] {'site':10s} {'p':>8s} {'reference p':>12s}")
    for site in sorted(r["pvalues"]):
        ref = r["reference_pvalues"][site]
        print(f"[certificate] {site:10s} {r['pvalues'][site]:8.4f} {ref if ref is None else f'{ref:12.4f}'}")
    rate = "did not run" if r["rate_p"] is None else f"p = {r['rate_p']:.4f}"
    ref_rate = "none recorded" if r["reference_rate_p"] is None else f"{r['reference_rate_p']:.4f}"
    print(f"[certificate] rate check: {rate} (reference: {ref_rate})")
    print(f"[certificate] verdict: {'PASS' if r['passed'] else 'FAIL'} (min p {r['min_p']:.4f}; every site at "
          f"p >= {P_MIN}" + ("" if r["passed"] else f"; failing {r['failing']}") + ")")
    (out / "sbc_certificate.json").write_text(json.dumps(r, indent=1) + "\n")
    print(json.dumps(r))
    if r["rate_p"] is None:
        print("[certificate] FAIL: the rate check did not run", file=sys.stderr)
        return 1
    return 0 if r["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
