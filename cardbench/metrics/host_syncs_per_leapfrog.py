"""host_syncs_per_leapfrog: the port's reads of the device in NUTS's
transitions (``nuts.host_syncs``) over its batched value+grads
(``model.value_and_grads``), both counted over the whole run by the port's
own counters (``bumpcosmology_torch.utils.profiling.counters``)."""
from cardbench import program_record


def read(run):
    c = program_record.program_counters()
    if c is None or not c.get("model.value_and_grads") or "nuts.host_syncs" not in c:
        return None
    return c["nuts.host_syncs"] / c["model.value_and_grads"]
