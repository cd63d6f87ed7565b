"""leapfrog_ms_mean: the mean milliseconds from one batched value+grad's
start to the next's over the traced window's leapfrogs outside the
profiled stretch: the window's time a leapfrog, NUTS's host work included.
The traced run ends each log-likelihood's span in a synchronise, so it
reads a little above an untraced run's mean."""


def read(run):
    w = run.window
    idx = w.outside_stretch()
    if not idx:
        return None
    intervals = w.intervals()
    return 1e3 * sum(intervals[i] for i in idx) / len(idx)
