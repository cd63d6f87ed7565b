"""outside_loglike_ms: mean milliseconds a leapfrog spends outside the
harness's span around the spec's log-likelihood, over the traced window's
leapfrogs outside the profiled stretch: NUTS's own host work and the
launches of its bookkeeping, and the priors and transforms of the
potential, forward and backward.  The span runs from the log-likelihood's
call to the return of its gradient by the sites, which in a traced run
ends in a synchronise: the span holds the log-likelihood's device work."""


def read(run):
    w = run.window
    if not w.span_sync or not w.exits:
        return None
    idx = [i for i in w.outside_stretch() if i in w.exits]
    if not idx:
        return None
    ends = w.entries[1:] + [w.close_t]
    return 1e3 * sum(ends[i] - w.exits[i] for i in idx) / len(idx)
