"""spline_ms: mean milliseconds of the port's ``loglike.spline`` span in a
value+grad of the profiled stretch: POWER LAW + SPLINE's table of cubic
coefficients (its 18 heights through the fixed coefficient map, a
``(C, 19, 4)`` table), inside ``loglike.tables``, over the stretch's
complete value+grads that build it (``cardbench/program_record.py``).  Host
clock, profiler on; ``None`` where the program records no such span."""
import bisect

from cardbench import program_record

SPLINE = "loglike.spline"


def read(run):
    spans = program_record.program_spans()
    vgs = program_record.value_and_grads(spans)
    if vgs is None:
        return None
    starts = [v["start"] for v in vgs]
    per = [0] * len(vgs)
    seen = [False] * len(vgs)
    for name, _, s, e in spans:
        if name != SPLINE:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= vgs[i]["end"]:
            per[i] += e - s
            seen[i] = True
    return program_record.mean_ms(t for t, hit in zip(per, seen) if hit)
