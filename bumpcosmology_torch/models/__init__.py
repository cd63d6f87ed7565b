"""L1 population & cosmology models (PyTorch); see the JAX package's ``models``."""
from bumpcosmology_torch.models.parameters import (
    MassParams,
    RedshiftParams,
    CosmoParams,
    PopulationParams,
    DEFAULT_MASS,
    DEFAULT_REDSHIFT,
    DEFAULT_RATE,
    DEFAULT_POPULATION,
    PLANCK18,
)
from bumpcosmology_torch.models.mass import (
    MBH_MIN,
    MREF,
    MassFunctionTable,
    build_mass_function,
    log_dndm,
    mean_mbh_from_mco,
    largest_mco,
    log_dndm_co,
    log_smooth_turnon,
)
from bumpcosmology_torch.models.redshift import log_dndv
from bumpcosmology_torch.models.population import (
    QREF,
    COORDS,
    PopulationIntensity,
    build_population,
    log_dndmdqdv,
)
from bumpcosmology_torch.models.cosmology import (
    CosmologyTable,
    build_cosmology,
    efunc,
    hubble_distance,
    z_at_dl,
    z_at_dc,
    dc_at_z,
    dl_at_z,
    ddl_dz_at_z,
    dvc_and_ddl_at_z,
    vc_at_z,
    dvc_dz_at_z,
    log_diff_comoving_volume_rate,
    planck18_table,
    planck18_log_dvdz_grid,
)
