"""a_bump_roofline: kernel A (``bump_fwd_kernel`` and ``bump_bwd_kernel``) in
the profiled stretch: the sum of its forward and backward bounds (each
launch's chains, from the cell's shapes; one special-function result a
cell at the card's largest SM clock) over their device time, in percent."""

KERNELS = ("bump_fwd_kernel", "bump_bwd_kernel")


def read(run):
    chains = run.stretch_chains()
    t = run.device_time_s(*KERNELS)
    bwd = sum(1 for _, _, name in run.trace.get("device", ()) if KERNELS[1] in name)
    if not chains or t <= 0.0 or not bwd:
        return None
    if bwd != len(chains):  # pair the launches with the mean chains
        chains = [sum(chains) / len(chains)] * bwd
    bound = sum(run.counts.a_bump_bound_s(c, run.shapes["n_grid"], run.clock_hz) for c in chains)
    return 100.0 * bound / t
