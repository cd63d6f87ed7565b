"""b_lse_bwd_roofline: kernel B's ``lse`` backward (``logwts_bwd_kernel`` with
its ``lse`` epilogue) in the profiled stretch: the sum of its bounds (each
launch's chains, from the cell's shapes) over its device time, in percent.
Each launch is paired with its value+grad's chains (one launch each)."""

KERNEL = "logwts_bwd_kernel<true"


def read(run):
    chains = run.stretch_chains()
    t = run.device_time_s(KERNEL)
    launches = sum(1 for _, _, name in run.trace.get("device", ()) if KERNEL in name)
    if not chains or t <= 0.0 or not launches:
        return None
    if launches != len(chains):  # pair the launches with the mean chains
        chains = [sum(chains) / len(chains)] * launches
    s = run.shapes
    bound = sum(run.counts.b_lse_bwd_bound_s(c, s["queries"], s["n_z"], s["n_grid"], s["nobs"], s["per_chain"])
                for c in chains)
    return 100.0 * bound / t
