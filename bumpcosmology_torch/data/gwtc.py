"""GWTC catalog and O3 injection-file ingestion (L3, host-side numpy);
counterpart of the JAX package's ``data/gwtc.py`` (``src/scripts/weighting.py:48-171``).

Importance-resampled PE samples from GWTC-2.1/GWTC-3 posterior files, and
detected injections from the LIGO O3 sensitivity-injection file, with the
same acceptance rules:

* an event is rejected when its median secondary mass is below 5 Msun, or
  when the effective sample size of the reweighting falls under ``2 * nsamp``;
* an injection is detected when any of the four search FARs is below the
  threshold (1/yr), with ``Ndraw = n_accepted + n_rejected`` and pdraw per
  year of analysis time.

h5py is imported by the functions that read a file, so that importing this
module needs neither it nor pandas; the GPU host has neither, and ingestion
runs on a host that has h5py.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from bumpcosmology_torch.data.weights import li_prior_wt
from bumpcosmology_torch.models.mass import MBH_MIN

__all__ = ["extract_posterior_samples", "extract_selection_samples", "RejectedEventError"]

# HDF5 groups holding posterior sample tables, by catalog era (``weighting.py:74-81``)
_PE_GROUPS = ("PublicationSamples/posterior_samples", "C01:Mixed/posterior_samples")

_FAR_KEYS = (
    "injections/far_pycbc_hyperbank",
    "injections/far_pycbc_bbh",
    "injections/far_gstlal",
    "injections/far_mbta",
)

SECONDS_PER_YEAR = 3600.0 * 24.0 * 365.25


class RejectedEventError(ValueError):
    """Raised when an event fails the m2 or Neff acceptance cuts."""


def _posterior_table(f, file):
    """The posterior sample table of an open file: a canonical group, else any
    ``C01:*`` analysis that carries one (some releases have only per-waveform
    analyses)."""
    for group in _PE_GROUPS:
        top, name = group.split("/")
        if top in f and name in f[top]:
            return np.asarray(f[group])
    for key in sorted(f.keys()):
        if key.startswith("C01:") and "posterior_samples" in f[key]:
            return np.asarray(f[key]["posterior_samples"])
    raise ValueError(f"could not read posterior samples from {file}")


def extract_posterior_samples(file, nsamp: int, desired_pop_wt: Optional[Callable] = None,
                              rng: Optional[np.random.Generator] = None):
    """(m1, q, z, pop_wt) importance-resampled to ``desired_pop_wt(m1, q, z)``
    (default: the PE prior itself).

    Reads whichever GWTC posterior group the file carries, keeps its finite
    rows, reweights from the LALInference/Bilby prior to the target, rejects
    low-m2 and low-Neff events, then draws ``nsamp`` samples with replacement
    in proportion to the weights (``weighting.py:48-103``).
    """
    import h5py

    if rng is None:
        rng = np.random.default_rng()
    with h5py.File(file, "r") as f:
        samples = _posterior_table(f, file)

    m1 = np.asarray(samples["mass_1_source"], dtype=np.float64)
    q = np.asarray(samples["mass_ratio"], dtype=np.float64)
    z = np.asarray(samples["redshift"], dtype=np.float64)

    # a real file's rare non-finite rows are dropped rather than let poison the weights
    finite = np.isfinite(m1) & np.isfinite(q) & np.isfinite(z)
    if not finite.all():
        if finite.sum() < max(4 * nsamp, 100):
            raise RejectedEventError(f"only {int(finite.sum())} finite posterior rows in {file}")
        print(f"[gwtc] {file}: dropping {int((~finite).sum())} non-finite posterior rows")
        m1, q, z = m1[finite], q[finite], z[finite]

    if np.median(q * m1) < MBH_MIN:
        raise RejectedEventError(f"median m2 < {MBH_MIN} Msun in {file}")

    pop_wt = li_prior_wt(m1, q, z) if desired_pop_wt is None else desired_pop_wt(m1, q, z)
    wt = pop_wt / li_prior_wt(m1, q, z)
    wt = wt / np.sum(wt)
    neff = 1.0 / np.sum(wt * wt)
    if neff < 2 * nsamp:
        raise RejectedEventError(f"Neff = {neff:.1f} < {2 * nsamp} in {file}")

    inds = rng.choice(len(m1), size=nsamp, p=wt)
    return m1[inds], q[inds], z[inds], pop_wt[inds]


def extract_selection_samples(file, nsamp: int, desired_pop_wt: Optional[Callable] = None,
                              far_threshold: float = 1.0, rng: Optional[np.random.Generator] = None):
    """(m1, q, z, pdraw, ndraw) of ``nsamp`` detected injections, drawn in
    proportion to ``desired_pop_wt / pdraw`` (default: uniformly).

    Detection is the OR of whichever of the four search FARs the file has
    (a NaN FAR: not analysed, not detected); ``Ndraw = n_accepted +
    n_rejected``; pdraw is per year of analysis time, and renormalized to
    ``pop_wt / (Σ(pop_wt/pdraw) / Ndraw)`` so that selection integrals stay
    unbiased after the draw (``weighting.py:105-171``).  The returned
    ``ndraw`` is ``nsamp``, as the reference's.
    """
    import h5py

    if rng is None:
        rng = np.random.default_rng()
    with h5py.File(file, "r") as f:
        m1 = np.asarray(f["injections/mass1_source"], dtype=np.float64)
        q = np.asarray(f["injections/mass2_source"], dtype=np.float64) / m1
        z = np.asarray(f["injections/redshift"], dtype=np.float64)
        pdraw = (np.asarray(f["injections/mass1_source_mass2_source_sampling_pdf"], dtype=np.float64)
                 * np.asarray(f["injections/redshift_sampling_pdf"], dtype=np.float64) * m1)
        detected = np.zeros(len(m1), dtype=bool)
        found_far = 0
        for key in _FAR_KEYS:
            grp, name = key.split("/")
            if name not in f[grp]:
                # some injection releases omit one of the four searches
                print(f"[gwtc] {file}: FAR column {name} absent; skipping")
                continue
            far = np.asarray(f[key], dtype=np.float64)
            detected |= np.nan_to_num(far, nan=np.inf) < far_threshold
            found_far += 1
        if found_far == 0:
            raise ValueError(f"no FAR columns found in {file}")
        ndraw = float(f.attrs["n_accepted"] + f.attrs["n_rejected"])
        t_years = (f.attrs["end_time_s"] - f.attrs["start_time_s"]) / SECONDS_PER_YEAR
        pdraw = pdraw / t_years

    m1, q, z, pdraw = m1[detected], q[detected], z[detected], pdraw[detected]
    pop_wt = pdraw if desired_pop_wt is None else desired_pop_wt(m1, q, z)
    unnorm = pop_wt / pdraw
    p = unnorm / np.sum(unnorm)
    pdraw_new = pop_wt / (np.sum(unnorm) / ndraw)
    inds = rng.choice(len(m1), size=nsamp, p=p)
    return m1[inds], q[inds], z[inds], pdraw_new[inds], float(nsamp)
