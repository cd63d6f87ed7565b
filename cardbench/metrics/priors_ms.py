"""priors_ms: mean milliseconds of a value+grad in the profiled stretch
outside the log-likelihood: the port's ``potential.value_and_grad`` span
less its ``potential.loglike`` and ``loglike.backward`` spans (the
constraining transforms, the priors and their Jacobians, forward and
backward), over the stretch's complete value+grads
(``cardbench/program_record.py``).  Host clock, profiler on."""
from cardbench import program_record


def read(run):
    vgs = program_record.value_and_grads()
    if vgs is None:
        return None
    return program_record.mean_ms(v["end"] - v["start"] - v["loglike"] - v["backward"] for v in vgs)
