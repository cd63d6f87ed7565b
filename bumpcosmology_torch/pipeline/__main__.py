"""Pipeline CLI: ``python -m bumpcosmology_torch.pipeline <stage...> [options] [section.key=value ...]``.

Examples:
  python -m bumpcosmology_torch.pipeline list
  python -m bumpcosmology_torch.pipeline sample_cosmo --data-dir /scratch/run1
  python -m bumpcosmology_torch.pipeline mock_injections mock.ndraw=100000
  d=$(mktemp -d); python -m bumpcosmology_torch.pipeline sample --rehearsal --device cpu --data-dir $d \
      paths.pe_raw_dir=$d/pe-samples-raw paths.injection_file=$d/endo3_bbhpop-LIGO-T2100113-v12.hdf5

Targets are stage names (``list`` shows them, fresh or stale), ``all``
(``sample``, ``sample_cosmo``, ``figures`` and ``report``) or ``mock`` (the
mock universe through ``mock_year_samples``).  Stages run on the card unless
``--device cpu`` is given; without CUDA and without ``--device cpu`` the
command raises.  Ingestion (``fetch``, ``draw_pe_samples``,
``draw_selection_samples``) needs h5py and runs on a host that has it; the
fit inputs it writes (``pe-samples.npz``, ``selection-samples.npz``) are
what the card's stages read.

Flags of the JAX package's CLI: ``--platform`` is ``--device`` here;
``--host-devices`` is dropped (it made virtual CPU devices for XLA's mesh;
the port's mesh is made of ``torch.distributed`` ranks, which a stage run
from the command line does not start); ``--no-compile-cache`` is dropped
(nothing is compiled with XLA; the kernels' nvcc builds are kept in
``bumpcosmology_torch/_build/``, or in the directory that the environment
variable ``BUMPCOSMOLOGY_CACHE_DIR`` names).  The figures and the report need matplotlib, seaborn and pandas:
on the card's host they may be drawn elsewhere from the copied artifacts
(``figures report --device cpu``).  ``--rehearsal`` attempts no download here (the JAX package's
tries Zenodo first and falls back when that fails): a rehearsal is for a
host without network.  ``--data-dir`` moves the artifacts only, as in the
JAX package: the raw inputs stay at ``paths.pe_raw_dir`` and
``paths.injection_file`` (``data/...`` by default), which ``key=value``
arguments move.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.pipeline.config import PipelineConfig
from bumpcosmology_torch.pipeline.stages import build_pipeline
from bumpcosmology_torch.utils.compile_cache import enable_compilation_cache

GROUPS = {
    "all": ["sample", "sample_cosmo", "figures", "report"],
    "mock": ["mock_year_samples"],
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bumpcosmology_torch.pipeline", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("targets", nargs="+", help="stage names, 'all', 'mock', or 'list'")
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument("--data-dir", default=None, help="artifact directory")
    parser.add_argument("--force", action="store_true", help="ignore artifact freshness")
    parser.add_argument("--device", default="cuda",
                        help="torch device the stages run on (default cuda; 'cpu' runs the plain PyTorch path "
                             "on the host); the JAX package's --platform")
    parser.add_argument("--rehearsal", action="store_true",
                        help="offline fallback: if the inputs are absent, write format-faithful rehearsal "
                             "fixtures (data/rehearsal.py) without attempting a download, and complete the "
                             "pipeline against them")
    args, rest = parser.parse_known_args(argv)
    unknown = [a for a in rest if "=" not in a]
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)} (--platform is --device here; "
                     "--host-devices and --no-compile-cache are not ported)")
    device = resolve_device(args.device)
    enable_compilation_cache()  # BUMPCOSMOLOGY_CACHE_DIR, if set, holds the kernels' builds

    cfg = PipelineConfig.load(args.config, rest)
    if args.data_dir:
        cfg.paths.data_dir = args.data_dir
    if args.rehearsal:
        cfg.ingest.rehearsal_fallback = True

    pipe = build_pipeline(cfg, device=device)
    if args.targets == ["list"]:
        for name, stage in pipe.stages.items():
            status = "fresh" if stage.fresh() else "stale"
            print(f"{name:24s} [{status}] -> {', '.join(str(o) for o in stage.outputs)}")
        return 0

    Path(cfg.paths.data_dir).mkdir(parents=True, exist_ok=True)
    targets = []
    for t in args.targets:
        targets.extend(GROUPS.get(t, [t]))
    pipe.run(targets, force=args.force)
    return 0


if __name__ == "__main__":
    sys.exit(main())
