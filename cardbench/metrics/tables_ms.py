"""tables_ms: mean milliseconds of the port's ``loglike.tables`` span in a
value+grad of the profiled stretch: the forward build of the bump table
(kernel A), the cosmology table and the detector table, over the stretch's
complete value+grads that build them (``cardbench/program_record.py``).
Host clock, profiler on."""
from cardbench import program_record


def read(run):
    vgs = program_record.value_and_grads()
    if vgs is None:
        return None
    return program_record.mean_ms(v["tables"] for v in vgs if v["n_tables"])
