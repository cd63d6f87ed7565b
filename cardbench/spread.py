"""Spreads of a cell's runs, for setting its bounds.

    python cardbench/spread.py SET1_DIR SET2_DIR

Each directory holds one file a run whose last line is the run's result
(``run.py``'s standard output).  Prints, for each end-to-end metric, each
set's median and spread (the distance between the first and the third
quartile of ``statistics.quantiles(values, n=4)``, over the median), the
wider of the two, five times it, and how far the second set's median lies
from the first's.
"""
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def results(directory):
    out = []
    for path in sorted(Path(directory).iterdir()):
        lines = path.read_text().strip().splitlines()
        if lines:
            out.append(json.loads(lines[-1]))
    return out


def main(argv=None) -> int:
    from cardbench.harness import quartile_spread

    dirs = (argv or sys.argv[1:])
    sets = [results(d) for d in dirs]
    names = sorted({k for s in sets for r in s for k in r["metrics"]})
    for name in names:
        vals = [[r["metrics"][name]["value"] for r in s if name in r["metrics"]] for s in sets]
        spreads = [quartile_spread(v) for v in vals]
        medians = [statistics.median(v) for v in vals]
        print(f"{name}: medians {medians!r} spreads {spreads!r} widest {max(spreads)!r} "
              f"x5 {5 * max(spreads)!r} second median off the first by {medians[-1] / medians[0] - 1!r}")
    print("correct:", [[r["correct"] for r in s] for s in sets])
    return 0


if __name__ == "__main__":
    sys.exit(main())
