"""loglike_ms: mean milliseconds of the log-likelihood in a value+grad of
the profiled stretch: the port's ``potential.loglike`` (forward) plus
``loglike.backward`` (from its output's gradient to its sites') spans, over
the stretch's complete value+grads (``cardbench/program_record.py``).  Host
clock, profiler on; the traced run's synchronise as the gradient reaches the
sites is in it."""
from cardbench import program_record


def read(run):
    vgs = program_record.value_and_grads()
    return None if vgs is None else program_record.mean_ms(v["loglike"] + v["backward"] for v in vgs)
