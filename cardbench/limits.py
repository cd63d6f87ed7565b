"""The readings that the limits of ``correct`` are set from: the program's
gaps to the plain reference and its lower-precision control's, over seeds.

    python cardbench/limits.py --workload <name> --seeds 11,12,... --seconds 8 [--out FILE]

Sets the cell up once, then for each seed drives the entry through a window
of ``--seconds`` at the cell's own sizes and load, and judges what it
recorded twice against the float64 reference: the program's own
value+grads and leapfrogs, and the control's.  The control is the reference
put in the program's place in the nearest precision below the
configuration's float32 with TF32 off: the log-likelihood and its gradient
in float32 with every stage's tensors rounded to TF32's 10 mantissa bits
(``reference.bump_joint.round_tf32``), and the plain leapfrog run in TF32
(``harness.leapfrog_gaps``).  Prints one JSON line a seed and appends it to
``--out``.  The benchmark's own runs do not run it.
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


def readings(cell, seeds, seconds, device, sync, limits, out=None):
    """One dict a seed: the window's value+grads and both sides' numbers."""
    from cardbench import harness

    rows = []
    for seed in seeds:
        window, recorder, _ = harness.measure(cell, seed, seconds, False, sync)
        program = harness.judge(cell, recorder, window.chains, device, limits, seed)
        control = harness.judge(cell, recorder, window.chains, device, limits, seed, control=True)
        row = {"seed": seed, "value_and_grads": window.count, "checked": len(recorder.items()),
               "program": program, "control": control}
        print(json.dumps(row), flush=True)
        if out is not None:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        rows.append(row)
        del recorder
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from cardbench import harness

    manifest = harness.load_manifest()
    cell_entry, config_entry = harness.cell_of(manifest, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("cardbench/limits.py: no CUDA device", file=sys.stderr)
        return 2
    from bumpcosmology_torch.utils import enable_compilation_cache

    enable_compilation_cache(str(BENCH_DIR / ".cache" / "kernels"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(harness.load_config(config_entry), harness.load_traffic(cell_entry["traffic"]), "cuda")
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(cell, seeds, args.seconds, "cuda", torch.cuda.synchronize,
                    harness.limits_of(args.workload), args.out)
    for side in ("program", "control"):
        for name in harness.NUMBERS:
            xs = [r[side][name] for r in rows]
            print(f"{args.workload} {side} {name}: min {min(xs)!r} max {max(xs)!r}", file=sys.stderr)
    print(f"{harness.power_limit()}; {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
