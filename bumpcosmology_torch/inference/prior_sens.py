"""Prior-sensitivity analysis by importance reweighting (L2); counterpart of
the JAX package's ``inference/prior_sens.py``.

A saved trace is a draw set from  p(θ|d) ∝ L(d|θ)·π(θ).  For an alternative
prior π'(θ) that differs only in (some) marginal factors, the posterior under
π' is recovered without refitting,

    w_s ∝ π'(θ_s) / π(θ_s)          (the likelihood cancels draw by draw)

evaluated on the *constrained* values, where the transform Jacobians cancel
too.  Reweighted means and sds say how much each posterior summary is prior
driven; the Kish effective sample size of the weights says when the
alternative is too far for reweighting (ess/n below about 0.1).

The default battery widens or narrows each site's prior scale by 2x
(Normal/TruncatedNormal: scale; Uniform: half-width about its midpoint,
clipped to the original support).

Host only: the log-densities are the port's own distributions
(:mod:`~bumpcosmology_torch.inference.distributions`) evaluated on float64
CPU tensors, the rest numpy.  No device work.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bumpcosmology_torch.inference.distributions import Normal, TruncatedNormal, Uniform

__all__ = [
    "PriorSensResult",
    "reweight_posterior",
    "scaled_prior",
    "prior_sensitivity_suite",
]


class PriorSensResult(NamedTuple):
    """One alternative-prior reweighting.

    name        : label of the alternative (e.g. "h: scale x2")
    site        : the perturbed site
    ess_frac    : Kish ESS of the weights / number of draws
    mean        : site -> reweighted posterior mean
    sd          : site -> reweighted posterior sd
    shift_sd    : site -> (reweighted mean − original mean) / original sd
    sd_ratio    : site -> reweighted sd / original sd
    """

    name: str
    site: str
    ess_frac: float
    mean: Dict[str, float]
    sd: Dict[str, float]
    shift_sd: Dict[str, float]
    sd_ratio: Dict[str, float]


def _log_prob_np(dist, x: np.ndarray) -> np.ndarray:
    """``dist.log_prob`` at float64 ``x``, in float64 on the host."""
    return dist.log_prob(torch.as_tensor(x, dtype=torch.float64)).double().numpy()


def reweight_posterior(
    posterior: Dict[str, np.ndarray],
    old_priors: Dict[str, object],
    new_priors: Dict[str, object],
    name: str = "",
    site: str = "",
) -> PriorSensResult:
    """Reweight ``posterior`` from ``old_priors`` to ``new_priors``.

    ``new_priors`` only needs the sites that *change*; all draws outside the
    new prior's support get weight zero (a -inf log-ratio).
    """
    flat = {k: np.asarray(v).reshape(-1).astype(np.float64) for k, v in posterior.items()
            if k in old_priors}
    n = len(next(iter(flat.values())))
    log_w = np.zeros(n)
    for s, new in new_priors.items():
        old = old_priors[s]
        log_w += _log_prob_np(new, flat[s]) - _log_prob_np(old, flat[s])
    log_w -= np.max(log_w[np.isfinite(log_w)]) if np.any(np.isfinite(log_w)) else 0.0
    w = np.exp(log_w)
    tot = w.sum()
    if tot <= 0:
        raise ValueError(f"prior reweighting '{name}': all draws have zero weight")
    w /= tot
    ess_frac = float(1.0 / np.sum(w**2) / n)

    mean, sd, shift, ratio = {}, {}, {}, {}
    for s, x in flat.items():
        m0, s0 = float(x.mean()), float(x.std())
        m1 = float(np.sum(w * x))
        v1 = float(np.sum(w * (x - m1) ** 2))
        s1 = math.sqrt(max(v1, 0.0))
        mean[s], sd[s] = m1, s1
        shift[s] = (m1 - m0) / s0 if s0 > 0 else 0.0
        ratio[s] = s1 / s0 if s0 > 0 else 1.0
    return PriorSensResult(
        name=name, site=site, ess_frac=ess_frac,
        mean=mean, sd=sd, shift_sd=shift, sd_ratio=ratio,
    )


def scaled_prior(dist, factor: float):
    """The same prior family with its scale multiplied by ``factor``.

    Normal/TruncatedNormal: scale × factor, same location and (hard) bounds.
    Uniform: half-width × factor about the midpoint, intersected with the
    original interval (hard physical bounds never widen).  Returns ``None``
    when the perturbation is a no-op (e.g. widening a Uniform).
    """
    if isinstance(dist, Normal):
        return Normal(dist.loc, dist.scale * factor)
    if isinstance(dist, TruncatedNormal):
        return TruncatedNormal(dist.loc, dist.scale * factor, low=dist.low, high=dist.high)
    if isinstance(dist, Uniform):
        if factor >= 1.0:
            return None  # cannot widen beyond hard bounds
        mid = 0.5 * (dist.low + dist.high)
        half = 0.5 * (dist.high - dist.low) * factor
        return Uniform(mid - half, mid + half)
    return None


def prior_sensitivity_suite(
    posterior: Dict[str, np.ndarray],
    priors: Dict[str, object],
    factors: Sequence[float] = (0.5, 2.0),
    sites: Optional[Sequence[str]] = None,
) -> list:
    """The default battery: rescale each site's prior by each factor.

    Returns a list of :class:`PriorSensResult`, skipping no-op perturbations;
    low-ESS reweightings are returned as-is (``ess_frac`` lets callers warn).
    """
    out = []
    for s in (sites if sites is not None else list(priors)):
        for f in factors:
            new = scaled_prior(priors[s], f)
            if new is None:
                continue
            try:
                res = reweight_posterior(
                    posterior, priors, {s: new},
                    name=f"{s}: scale x{f:g}", site=s,
                )
            except ValueError:
                continue
            out.append(res)
    return out
