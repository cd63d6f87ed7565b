"""qnorm_ms: mean milliseconds of the port's ``loglike.qnorm`` span in a
value+grad of the profiled stretch: the forward build of a power-law-in-q
family's q-norm table (an ``n_grid`` x 128 grid of Planck tapers a chain)
and its pivot, over the stretch's complete value+grads that build it
(``cardbench/program_record.py``).  Host clock, profiler on; ``None`` where
the program records no such span."""
import bisect

from cardbench import program_record

QNORM = "loglike.qnorm"


def read(run):
    spans = program_record.program_spans()
    vgs = program_record.value_and_grads(spans)
    if vgs is None:
        return None
    starts = [v["start"] for v in vgs]
    per = [0] * len(vgs)
    seen = [False] * len(vgs)
    for name, _, s, e in spans:
        if name != QNORM:
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= vgs[i]["end"]:
            per[i] += e - s
            seen[i] = True
    return program_record.mean_ms(t for t, hit in zip(per, seen) if hit)
