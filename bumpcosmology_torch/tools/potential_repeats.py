"""Repeat a flagship potential's value+grad: count the bit-identical results, and time it.

    python3 bumpcosmology_torch/tools/potential_repeats.py [--root DIR] [--models joint,pop] [--repeats N]

(run by path, not with ``-m``: the package it measures is the one under
``--root``, default this checkout).  It builds the kernels of that checkout
and, on ``benchmarks/flagship_catalog.npz`` and the 16 warm thetas of
``benchmarks/flagship_warmup16.npz`` under ``--root``, evaluates the batched
value+grad of each model's potential once, then ``N`` times more (default
20): ``joint``, ``make_potential(pop_cosmo_model_spec(data, 256, 1024))``;
``pop``, ``make_potential(pop_model_spec(...))`` on the same catalog taken
back to the source frame (``chip_smoke.flagship_source_tables``), at the
warm thetas' 12 population sites.  It prints one JSON line a model: how
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

HERE = Path(__file__).resolve().parents[2]


def potential(root: Path, model: str):
    """(potential, thetas) of ``model`` on the flagship under ``root``."""
    from bumpcosmology_torch.benchdata import load_pop_cosmo_data
    from bumpcosmology_torch.inference.likelihoods import pop_cosmo_model_spec, pop_model_spec
    from bumpcosmology_torch.inference.model import make_potential
    from bumpcosmology_torch.pipeline.stages import pop_data_from_tables
    from bumpcosmology_torch.utils.checkpoint import load_warmup
    from chip_smoke import flagship_source_tables

    theta = load_warmup(root / "benchmarks" / "flagship_warmup16.npz").state.theta
    if model == "joint":
        data = load_pop_cosmo_data(root / "benchmarks" / "flagship_catalog.npz")
        return make_potential(pop_cosmo_model_spec(data, 256, 1024)), theta
    # the joint model's sites are the cosmology's 3 and then the population's 12, in the pop model's order
    return make_potential(pop_model_spec(pop_data_from_tables(*flagship_source_tables()), 256)), theta[:, 3:]


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
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    import torch

    if not torch.cuda.is_available():
        print("potential_repeats: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))  # this checkout's chip_smoke.py, for its tables and card line
    from chip_smoke import card_line

    sys.path.insert(0, str(root))  # the package under --root
    from bumpcosmology_torch.inference.model import value_and_grad
    from bumpcosmology_torch.ops import _build

    _build.build_kernels()
    for model in args.models.split(","):
        pot, theta = potential(root, model)
        u0, g0 = value_and_grad(pot, theta)
        same_u = same_g = 0
        max_dg = 0.0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        results = [value_and_grad(pot, theta) for _ in range(args.repeats)]
        end.record()
        torch.cuda.synchronize()
        for u, g in results:
            same_u += bool(torch.equal(u, u0))
            same_g += bool(torch.equal(g, g0))
            max_dg = max(max_dg, float((g - g0).abs().max()))
        kernels, busy = device_profile(lambda: value_and_grad(pot, theta))
        print(json.dumps(dict(root=str(root), model=model, card=card_line(), repeats=args.repeats,
                              value_bit_identical=same_u, grad_bit_identical=same_g, max_abs_grad_diff=max_dg,
                              ms=start.elapsed_time(end) / args.repeats, device_kernels=kernels,
                              device_busy_ms=busy)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
