"""L5: the reference's eight figures and the diagnostics stages' five, and
the report; see the JAX package's ``figures``."""
from bumpcosmology_torch.figures.plots import (
    FIGURES,
    EXTRA_FIGURES,
    render_all,
    dndm_fitted,
    cosmo_params_corner,
    h_zoomin,
    omh2_zoomin,
    shape_corner,
    m1_vs_m2,
    dndm_pisn_effects,
    mock_observation_corner,
)
