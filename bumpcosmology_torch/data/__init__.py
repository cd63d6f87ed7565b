"""Importance weights at fixed Planck18; see the JAX package's ``data``.

Only ``weights`` is ported so far (the mock campaign needs it); the GWTC
loaders and resampling come in a later slice.
"""
from bumpcosmology_torch.data.weights import (
    default_pop_wt,
    li_prior_wt,
    dm1sqz_dm1ddqdl,
    planck18_dl_np,
    planck18_dc_np,
    planck18_z_of_dl_np,
    planck18_dvc_dz_np,
    planck18_efunc_np,
)
