"""Design-sensitivity noise PSDs (tensor code); counterpart of the JAX
package's ``mock/psd.py``.

* **aLIGO design**: the analytic fit of Ajith 2011 (arXiv:1107.1267),
  S_n(f) = 1e-49 [x^-4.14 - 5 x^-2 + 111 (1 - x^2 + x^4/2)/(1 + x^2/2)],
  x = f/215 Hz, amplitude-calibrated to the published P1200087 BNS range.
* **AdV design**: the aLIGO shape rescaled in amplitude by 0.55 (a documented
  approximation of the design horizon ratio).
* :func:`tabulated_psd` wraps a physical (f, S_n) table with a log-log lerp.

**float32 scaling**: physical strain PSDs (~1e-49..1e-46 /Hz) underflow
float32, so every PSD here returns S_n / ``PSD_SCALE`` with
``PSD_SCALE = 1e-46``; the SNR code scales amplitudes by ``AMP_SCALE = 1e23``
so that ``AMP_SCALE**2 * PSD_SCALE = 1``.  Masked bins (below ``f_low``)
return +inf, so they contribute zero SNR.
"""
from __future__ import annotations

import numpy as np
import torch

from bumpcosmology_torch.ops.interp import interp

__all__ = ["PSD_SCALE", "aligo_design_psd", "advirgo_design_psd", "tabulated_psd", "PSDS"]

PSD_SCALE = 1e-46  # returned PSDs are S_n / PSD_SCALE
_ADV_AMPLITUDE_RATIO = 0.55  # AdV/aLIGO design horizon ratio (amplitude)
# pins the analytic fit's 1.4+1.4 Msun range (220 Mpc) to the published 181 Mpc
_ALIGO_RANGE_CALIBRATION = (220.0 / 181.0) ** 2


def aligo_design_psd(f, f_low: float = 10.0):
    """Analytic aLIGO design PSD in units of ``PSD_SCALE``/Hz."""
    f = torch.as_tensor(f)
    x = f / 215.0
    s = 1e-3 * _ALIGO_RANGE_CALIBRATION * (
        x ** (-4.14) - 5.0 / (x * x) + 111.0 * (1.0 - x * x + 0.5 * x**4) / (1.0 + 0.5 * x * x)
    )
    return torch.where((f < f_low) | (s <= 0), torch.inf, s)


def advirgo_design_psd(f, f_low: float = 10.0):
    """Advanced Virgo design PSD (scaled units): the amplitude-rescaled aLIGO shape."""
    return aligo_design_psd(f, f_low) / (_ADV_AMPLITUDE_RATIO**2)


def tabulated_psd(freqs: np.ndarray, values: np.ndarray, f_low: float = 10.0):
    """Wrap a tabulated *physical* (f, S_n) curve as a scaled-PSD callable
    (log-log interpolation, constant beyond the table's ends)."""
    lf = np.log(np.asarray(freqs, dtype=np.float64))
    lv = np.log(np.asarray(values, dtype=np.float64) / PSD_SCALE)

    def psd(f):
        f = torch.as_tensor(f)
        as_f = dict(dtype=f.dtype, device=f.device)
        out = torch.exp(interp(torch.log(f), torch.as_tensor(lf, **as_f), torch.as_tensor(lv, **as_f)))
        return torch.where(f < f_low, torch.inf, out)

    return psd


PSDS = {"H1": aligo_design_psd, "L1": aligo_design_psd, "V1": advirgo_design_psd}
