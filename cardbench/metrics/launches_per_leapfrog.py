"""launches_per_leapfrog: device activities (kernels, copies, memsets) in
the profiled stretch per batched value+grad made in it."""


def read(run):
    n = len(run.stretch_chains())
    if not run.trace or not n:
        return None
    return len(run.trace["device"]) / n
