"""Mock universe: inverse-CDF samplers, waveform, PSDs, antenna patterns, the
SNR integral (kernel C, ``cuda_snr``) and the catalog pipeline; see the JAX
package's ``mock``."""
from bumpcosmology_torch.mock.sampling import MadauZPDF, PowerLawPDF, InterpolatedPDF
from bumpcosmology_torch.mock.waveform import phenom_a_amplitude, chirp_mass, chirp_time_bound
from bumpcosmology_torch.mock.detector import DETECTORS, antenna_pattern
from bumpcosmology_torch.mock.psd import aligo_design_psd, advirgo_design_psd, tabulated_psd, PSDS
from bumpcosmology_torch.mock.snr import frequency_grid, network_snr, network_snr_batched
from bumpcosmology_torch.mock.catalog import (
    Z_HORIZON,
    CHIRP_DIST_MIN,
    DETECTION_SNR,
    draw_injection_campaign,
    campaign_summary,
    add_observation_noise,
    Uncertainties,
    draw_mock_pe_samples,
    draw_one_year_catalog,
)
