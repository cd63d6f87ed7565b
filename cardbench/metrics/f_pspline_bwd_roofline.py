"""f_pspline_bwd_roofline: kernel F's backward for POWER LAW + SPLINE
(``families_bwd_kernel`` with the family code 2, by its name in the trace)
in the profiled stretch: the sum of its bounds (each launch's chains, from
the cell's shapes; ``cardbench/counts_pspline.py``) over its device time, in
percent.  Each launch is paired with its value+grad's chains (one launch
each); ``None`` where no such launch ran."""
import re

from cardbench import counts_pspline

KERNEL = re.compile(r"families_bwd_kernel<(float|double), (\(int\))?2,")


def read(run):
    chains = run.stretch_chains()
    launches = [(s, e) for s, e, name in run.trace.get("device", ()) if KERNEL.search(name)]
    t = sum(e - s for s, e in launches) * 1e-6
    if not chains or t <= 0.0 or not launches:
        return None
    if len(launches) != len(chains):  # pair the launches with the mean chains
        chains = [sum(chains) / len(chains)] * len(launches)
    s = run.shapes
    bound = sum(counts_pspline.f_pspline_bwd_bound_s(c, s["queries"], s["n_z"], s["n_grid"], s["nobs"],
                                                     s["per_chain"]) for c in chains)
    return 100.0 * bound / t
