"""mfu.leapfrog: the FP32 operations that the batched value+grads of the
traced window need (counted from the cell's mass family, its shapes and
each value+grad's chains with the frozen per-unit counts), over the
window's time outside the profiled stretch, against the card's 67 TFLOP/s,
in percent."""


def read(run):
    w, s = run.window, run.shapes
    idx = w.outside_stretch()
    if not idx:
        return None
    intervals = w.intervals()
    ops = sum(run.counts.leapfrog_ops(w.chains[i], s["n_grid"], s["queries"], s["family"]) for i in idx)
    return 100.0 * ops / sum(intervals[i] for i in idx) / run.counts.FP32_OPS_PER_S
