"""device_idle_pct: the share of the profiled stretch in which no device
activity ran, from the union of the device's intervals
(``chip_smoke.py::device_busy_share``'s reading), in percent."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
