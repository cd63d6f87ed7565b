"""Figure CLI: ``python -m bumpcosmology_torch.figures <name|all> [options]``.

Resolves each figure's input artifact under ``--data-dir`` (see
``bumpcosmology_torch.figures.plots.FIGURES``); a missing artifact skips its
figure with a note.  The bump curves of ``dNdm_PISN_effects`` are built on
``--device`` (default ``cuda``: kernel A; ``cpu``: its plain twin), as the
pipeline CLI takes it; the JAX package's CLI pins its figures to the CPU.
The figures can be drawn on a host with matplotlib and seaborn from
artifacts that the card wrote.

Example:
  python -m bumpcosmology_torch.figures all --data-dir data --out-dir figures --fmt png --device cpu
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from bumpcosmology_torch.figures.plots import FIGURES


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="bumpcosmology_torch.figures", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("names", nargs="+", help=f"figure names or 'all'; known: {sorted(FIGURES)}")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--out-dir", default="figures")
    parser.add_argument("--fmt", default="pdf", choices=["pdf", "png"])
    parser.add_argument("--device", default="cuda",
                        help="torch device of the bump curves (default cuda; 'cpu' runs the plain PyTorch path)")
    args = parser.parse_args(argv)

    names = sorted(FIGURES) if args.names == ["all"] else args.names
    rc = 0
    for name in names:
        if name not in FIGURES:
            print(f"[figures] unknown figure {name!r}", file=sys.stderr)
            rc = 2
            continue
        fn, artifact = FIGURES[name]
        out = Path(args.out_dir) / f"{name}.{args.fmt}"
        if artifact is None:
            fn(out=out, device=args.device)
        else:
            src = Path(args.data_dir) / artifact
            if not src.exists():
                print(f"[figures] {name}: missing input {src}, skipping")
                continue
            fn(src, out=out)
        print(f"[figures] wrote {out}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
