"""Repeat a flagship potential's value+grad: count the bit-identical results, and time it.

    python3 bumpcosmology_torch/tools/potential_repeats.py [--root DIR]
        [--models joint,pop,plpeak_joint,brokenpl_joint] [--fleet S] [--repeats N]

(run by path, not with ``-m``: the package it measures is the one under
``--root``, default this checkout).  It builds the kernels of that checkout
and, on ``benchmarks/flagship_catalog.npz`` under ``--root``, evaluates the
batched value+grad of each model's potential once, then ``N`` times more
(default 20): ``joint``, ``make_potential(pop_cosmo_model_spec(data, 256,
1024))`` at the 16 warm thetas of ``benchmarks/flagship_warmup16.npz``;
``pop``, ``make_potential(pop_model_spec(...))`` on the same catalog taken
back to the source frame (``oncard.flagship_source_tables``), at the
warm thetas' 12 population sites; ``plpeak_joint`` and ``brokenpl_joint``,
the family's joint model (``MASS_FAMILIES[family].cosmo_spec``, the fused
detector-table route in plain PyTorch) at the first 16 of 64 prior draws
(seed 0) whose value and gradient are finite on the flagship.  ``--fleet S``
evaluates the joint models on a fleet instead, chain ``s`` reading its own
catalog: the flagship without event ``s`` (``influence.make_loo_datas``), S
of them, through a query table per chain (the SBC and LOO fleets' layout),
at the same thetas (the first S).  It prints one JSON line a model: how
many repeats give the first value and the first gradient bit for bit, the
largest absolute gradient difference, ``ms`` (CUDA events around the
repeats, divided by ``N``: what a sampler waits for a value+grad), and from a
``torch.profiler`` trace of three value+grads the device kernels and the
device-busy milliseconds a value+grad; with the card's name and power
limit.  Needs one NVIDIA GPU and nvcc.  Comparing checkouts in one job
(the parent unpacked under the git-ignored ``_archive/``) shows what a
change did:

    for root in _archive/parent . . _archive/parent; do
        python3 bumpcosmology_torch/tools/potential_repeats.py --root $root
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


def family_thetas(spec, n: int = 16, candidates: int = 64, seed: int = 0):
    """The first ``n`` of ``candidates`` prior draws of ``spec`` whose value
    and gradient are finite."""
    import torch

    from bumpcosmology_torch.inference.model import make_potential, prior_sample, value_and_grad

    gen = torch.Generator(device=spec.device).manual_seed(seed)
    cands = prior_sample(spec, gen, shape=(candidates,))
    u, g = value_and_grad(make_potential(spec), cands)
    keep = (torch.isfinite(u) & torch.isfinite(g).all(-1)).nonzero().squeeze(1)[:n]
    if keep.numel() < n:
        raise RuntimeError(f"only {keep.numel()} of {candidates} prior draws have a finite value+grad")
    return cands[keep]


def potential(root: Path, model: str, fleet: int = 0, device=None):
    """(potential, thetas) of ``model`` on the flagship under ``root`` (on a
    fleet of ``fleet`` leave-one-out catalogs, for a joint model), on
    ``device`` (``None``: the card)."""
    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.influence import make_loo_datas
    from bumpcosmology_torch.inference.likelihoods import MASS_FAMILIES, pop_model_spec, take_fleet
    from bumpcosmology_torch.inference.model import make_potential
    from bumpcosmology_torch.pipeline.stages import pop_data_from_tables
    from bumpcosmology_torch.utils.checkpoint import load_warmup

    catalog = root / "benchmarks" / "flagship_catalog.npz"
    theta = load_warmup(root / "benchmarks" / "flagship_warmup16.npz", device=device).state.theta
    if model == "pop":
        if fleet:
            raise ValueError("--fleet takes the joint models only")
        # the joint model's sites are the cosmology's 3 and then the population's 12, in the pop model's order
        spec = pop_model_spec(pop_data_from_tables(*oncard.flagship_source_tables(catalog)), 256, device=device)
        return make_potential(spec), theta[:, 3:]
    family = "bump" if model == "joint" else model[: -len("_joint")]
    cosmo_spec = MASS_FAMILIES[family].cosmo_spec
    data = load_pop_cosmo_data(catalog, device=device)
    if family != "bump":
        theta = family_thetas(cosmo_spec(data, 256, 1024, device=device))
    if fleet:
        import torch

        data = take_fleet(make_loo_datas(data), torch.arange(fleet, device=theta.device))
        theta = theta[:fleet]
    return make_potential(cosmo_spec(data, 256, 1024, device=device)), theta


def device_profile(fn, calls: int = 3):
    """(device kernels, device-busy ms) a call of ``fn``, from a profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in events) / 1e3
    return len(events) / calls, busy / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--models", default="joint")
    ap.add_argument("--fleet", type=int, default=0, help="evaluate the joint models on this many catalogs, "
                    "one a chain (0: the flagship, shared by the chains)")
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    import torch

    if not torch.cuda.is_available():
        print("potential_repeats: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))  # the package under --root
    from bumpcosmology_torch.inference.model import value_and_grad
    from bumpcosmology_torch.ops import _build

    _build.build_kernels()
    for model in args.models.split(","):
        pot, theta = potential(root, model, args.fleet)
        u0, g0 = value_and_grad(pot, theta)
        same_u = same_g = 0
        max_dg = 0.0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        results = [value_and_grad(pot, theta) for _ in range(args.repeats)]
        end.record()
        torch.cuda.synchronize()
        for u, g in results:  # bit patterns: a NaN equals itself
            same_u += bool(torch.equal(u.view(torch.int32), u0.view(torch.int32)))
            same_g += bool(torch.equal(g.view(torch.int32), g0.view(torch.int32)))
            max_dg = max(max_dg, float((g - g0).abs().max()))
        kernels, busy = device_profile(lambda: value_and_grad(pot, theta))
        print(json.dumps(dict(root=str(root), model=model, fleet=args.fleet, card=oncard.card_line(),
                              repeats=args.repeats, value_bit_identical=same_u, grad_bit_identical=same_g,
                              max_abs_grad_diff=max_dg, ms=start.elapsed_time(end) / args.repeats,
                              device_kernels=kernels, device_busy_ms=busy)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
