"""Run one cell of the port's benchmark once.

    python cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets the cell up (imports, the card, the kernels' libraries, the data and
the entry's own warm-up), measures for ``--seconds`` seconds, judges what
the window produced against the plain reference, and prints one JSON
object as the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics and the
profiled stretch's breakdown.  The numbers compared, each beside its limit,
are the last lines of standard error and the last key of the result.

The kernels' libraries are built once into ``cardbench/.cache/kernels``
inside the checkout, and loaded from there by every later run.  Exits 2
without a result when the card that the cell asks for is not there, and
non-zero without a result when modules of JAX or of the JAX package are
loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))
os.environ.setdefault("CUDA_CACHE_PATH", str(BENCH_DIR / ".cache" / "nv"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from cardbench import harness

    manifest = harness.load_manifest()
    cell, _ = harness.cell_of(manifest, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cardbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count() = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from bumpcosmology_torch.utils import enable_compilation_cache

    enable_compilation_cache(str(BENCH_DIR / ".cache" / "kernels"))
    rc, result, lines = harness.run_benchmark(manifest, args.workload, args.seed, args.seconds, bool(args.trace),
                                              "cuda", T_START)
    if result is None:
        return rc
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
