"""idle_in_sampler_pct: the share of the card's idle time (the complement
of the union of its activities, as ``device_idle_pct`` reads it) that falls
between value+grads, outside every ``potential.value_and_grad`` span of the
port, from the first complete value+grad of the profiled stretch to the end
of the last one's interval, in percent.  The port's spans (host clock) move
onto the trace's clock by one offset: the median, over the stretch's
value+grads, of the trace's start of the port's marker op inside
``potential.loglike`` less that span's start (``cardbench/program_record.py``)."""
from cardbench import program_record


def read(run):
    vgs = program_record.value_and_grads()
    offset = program_record.trace_offset_us(run)
    if vgs is None or offset is None:
        return None
    return program_record.idle_outside_value_and_grads_pct(vgs, run.trace.get("device", ()), offset[0])
