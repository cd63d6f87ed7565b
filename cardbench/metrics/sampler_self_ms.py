"""sampler_self_ms: mean milliseconds a leapfrog spends between value+grads
in the profiled stretch: from the end of one ``potential.value_and_grad``
span of the port to the start of the next (NUTS's bookkeeping, masking,
host syncs and subtree merges), over the stretch's complete value+grads
(``cardbench/program_record.py``).  The port's spans, on the host clock;
the profiler's per-op cost is in it."""
from cardbench import program_record


def read(run):
    vgs = program_record.value_and_grads()
    return None if vgs is None else program_record.mean_ms(v["next"] - v["end"] for v in vgs)
