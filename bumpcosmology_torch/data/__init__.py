"""L3: catalog ingestion and importance weighting; see the JAX package's ``data``.

``gwtc`` reads the GWTC PE releases and the O3 injection file, ``resample``
redraws injections, ``rehearsal`` writes format-faithful input files from
the mock universe and ``fetch`` downloads the real ones.  The readers and
writers import h5py when they are called.
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
from bumpcosmology_torch.data.gwtc import (
    extract_posterior_samples,
    extract_selection_samples,
    RejectedEventError,
)
from bumpcosmology_torch.data.resample import resample_injections, importance_neff
