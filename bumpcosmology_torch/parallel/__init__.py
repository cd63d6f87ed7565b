"""The scale-out layer: (chains, data) meshes of ``torch.distributed`` ranks
and the likelihood data split over them; see the JAX package's ``parallel``."""
from bumpcosmology_torch.parallel.mesh import (
    CHAIN_AXIS,
    DATA_AXIS,
    Mesh,
    make_mesh,
    replicated,
    chain_sharding,
)
from bumpcosmology_torch.parallel.sharding import (
    DataShard,
    pop_data_pspecs,
    pop_cosmo_data_pspecs,
    shard_pop_data,
    shard_pop_cosmo_data,
    make_sharded_pop_loglike,
    make_sharded_pop_cosmo_loglike,
)
