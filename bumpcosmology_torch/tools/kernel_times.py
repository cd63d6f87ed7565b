"""Time kernel A or kernel B of another checkout on the same card, beside this one's.

    python3 bumpcosmology_torch/tools/kernel_times.py --kernel a|b [--root DIR]

(run by path, not with ``-m``: the package it times is the one under ``--root``).

``chip_smoke.py`` phases 2 and 3 give the kernels' device times for the checkout
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
  3's limits).

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
    return kernels, dict(C=c, N=n, K=n_z, G=n_grid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("a", "b"), required=True)
    ap.add_argument("--root", default=str(HERE))
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))  # the timers and limits of this checkout's chip_smoke.py
    from chip_smoke import N_GRID, N_Z, SEED, both_ms, card_line, check_close

    sys.path.insert(0, str(root))  # the package under --root

    def row(fn, err):
        ms, call_ms = both_ms(fn)
        return dict(ms=ms, call_ms=call_ms, max_abs_err=err)

    times = kernel_a_times if args.kernel == "a" else kernel_b_times
    kernels, shape = times(root, row, check_close, N_GRID, N_Z, SEED)
    torch.cuda.synchronize()
    print(json.dumps(dict(root=str(root), kernel=args.kernel, card=card_line(), shape=shape, kernels=kernels)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
