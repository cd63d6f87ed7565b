"""Synthetic inputs for the tests and the on-card check.

* :func:`synthetic_pop_data`: source-frame catalogs, the same numpy draws
  as the JAX package's ``testing.py::synthetic_pop_data``.
* :func:`synthetic_pop_cosmo_data`: detector-frame catalogs; counterpart of
  the JAX package's ``testing.py::synthetic_pop_cosmo_data``.  Same numpy
  draws from the seed; dL comes from this package's fixed Planck18 table, so
  the values agree with the JAX helper's to float32 rounding.  Tests that
  compare the two packages carry the JAX data across with
  :mod:`bumpcosmology_torch.convert` instead, so both see identical inputs.
* :func:`synthetic_source_tables`: the same kind of source-frame catalog as
  the column tables the fit stages read (``pe-samples``: m1 q z wt evt;
  ``selection-samples``: m1 q z pdraw ndraw), for any mass family.
* :func:`snr_knot_rows`: injections whose transition frequencies sit on the
  stored knots of kernel C's grid, where a count off by one moves a term.
* :data:`PRIOR_SETS`, :func:`prior_thetas`, :func:`priors_twin` and
  :func:`priors_gaps`: the models' prior sets and one with every family and
  truncation, unconstrained points that reach the transforms' ends, the
  per-site code's log prior, sites and gradient, and the limits that the
  priors kernel (``csrc/priors.cu``) is held to against them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bumpcosmology_torch.inference.distributions import Normal, TruncatedNormal, Uniform
from bumpcosmology_torch.inference.likelihoods import (
    BROKENPL_COSMO_PRIORS,
    PLPEAK_COSMO_PRIORS,
    POP_COSMO_PRIORS,
    POP_PRIORS,
    PopCosmoData,
    PopData,
    make_pop_cosmo_data,
    make_pop_data,
)
from bumpcosmology_torch.models.cosmology import dl_at_z, planck18_table

__all__ = ["synthetic_pop_data", "synthetic_pop_cosmo_data", "synthetic_source_tables", "snr_knot_rows",
           "PRIOR_SETS", "prior_thetas", "priors_twin", "priors_gaps"]

# every family and truncation case once, with supports that do and do not straddle 0
_EVERY_PRIOR_CASE = {
    "normal": Normal(-0.4, 2.5),
    "uniform": Uniform(-3.0, 5.0),
    "trunc_both": TruncatedNormal(0.3, 0.15, low=0.0, high=1.0),
    "trunc_low": TruncatedNormal(2.0, 2.0, low=1.0),
    "trunc_high": TruncatedNormal(-1.0, 0.5, high=0.25),
    "trunc_none": TruncatedNormal(0.5, 3.0),
}
PRIOR_SETS = {"pop_cosmo": POP_COSMO_PRIORS, "pop": POP_PRIORS, "plpeak_cosmo": PLPEAK_COSMO_PRIORS,
              "brokenpl_cosmo": BROKENPL_COSMO_PRIORS, "every_case": _EVERY_PRIOR_CASE}


def _source_frame(nobs, nsamp, nsel, seed):
    rng = np.random.default_rng(seed)
    m1 = rng.uniform(8.0, 70.0, size=(nobs, nsamp))
    q = rng.uniform(0.3, 1.0, size=(nobs, nsamp))
    z = rng.uniform(0.02, 1.5, size=(nobs, nsamp))
    pdraw = rng.uniform(0.5, 2.0, size=(nobs, nsamp))
    m1_s = rng.uniform(8.0, 70.0, size=nsel)
    q_s = rng.uniform(0.3, 1.0, size=nsel)
    z_s = rng.uniform(0.02, 1.5, size=nsel)
    pd_s = rng.uniform(0.5, 2.0, size=nsel)
    return m1, q, z, pdraw, m1_s, q_s, z_s, pd_s


def synthetic_pop_data(nobs=56, nsamp=128, nsel=1024, seed=0, device=None) -> PopData:
    """A source-frame catalog (m1, q, z) on ``device`` (``None`` means CUDA)."""
    return make_pop_data(*_source_frame(nobs, nsamp, nsel, seed), ndraw=float(nsel * 100), device=device)


def synthetic_pop_cosmo_data(nobs=56, nsamp=128, nsel=1024, seed=0, device=None) -> PopCosmoData:
    """A detector-frame catalog (m1_det, q, dL) on ``device`` (``None`` means CUDA)."""
    m1, q, z, pd, m1s, qs, zs, pds = _source_frame(nobs, nsamp, nsel, seed)
    table = planck18_table(device)

    def dl(zz):
        zt = torch.as_tensor(zz, dtype=torch.float32, device=table.dl.device).reshape(1, -1)
        return dl_at_z(table, zt).reshape(np.shape(zz)).cpu().numpy()

    return make_pop_cosmo_data(m1 * (1 + z), q, dl(z), pd, m1s * (1 + zs), qs, dl(zs), pds,
                               ndraw=float(nsel * 100), device=device)


def synthetic_source_tables(nobs=8, nsamp=32, nsel=128, seed=0):
    """``(pe, sel)`` column dicts for ``run_pop_fit`` / ``run_pop_cosmo_fit``:
    uniform draws (m1 in [8, 70], q in [0.3, 1], z in [0.02, 1.5], weights in
    [0.5, 2]), events labelled ``GW00``, ``GW01``, ..., ``ndraw`` 100 x nsel."""
    rng = np.random.default_rng(seed)
    n = nobs * nsamp
    pe = {"m1": rng.uniform(8.0, 70.0, n), "q": rng.uniform(0.3, 1.0, n), "z": rng.uniform(0.02, 1.5, n),
          "wt": rng.uniform(0.5, 2.0, n), "evt": np.repeat([f"GW{i:02d}" for i in range(nobs)], nsamp)}
    sel = {"m1": rng.uniform(8.0, 70.0, nsel), "q": rng.uniform(0.3, 1.0, nsel), "z": rng.uniform(0.02, 1.5, nsel),
           "pdraw": rng.uniform(0.5, 2.0, nsel), "ndraw": np.full(nsel, 100.0 * nsel)}
    return pe, sel


def snr_knot_rows(f_grid: torch.Tensor, knots=None, ratios=(0.1, 0.45, 1.0), span: int = 12, seed: int = 0):
    """``(m1, m2, dl)`` float32 injections on ``f_grid``'s device whose
    ``f_merg``, ``f_ring`` or ``f_cut`` (as :func:`~bumpcosmology_torch.mock.cuda_snr.row_scalars`
    rounds them) equals a stored knot of ``f_grid``, or the float32 one ulp
    below or above it.

    For each transition, knot (index in ``knots``, default every knot) and
    mass ratio, the total mass that puts the transition on the knot is solved
    in float64; then ``m1`` is stepped by up to ``span`` ulps either way, and
    the first step that lands each of the three targets gives a row.  ``dl``
    is drawn from ``seed``, log-uniform over [0.1, 10] Gpc.
    """
    from bumpcosmology_torch.mock.cuda_snr import row_scalars
    from bumpcosmology_torch.mock.waveform import FCUT, FMERG, FRING, MSUN_S

    dev = f_grid.device
    idx = torch.arange(f_grid.shape[0], device=dev) if knots is None else torch.as_tensor(knots, device=dev)
    f_k = f_grid[idx]
    targets = torch.stack([torch.nextafter(f_k, f_k.new_tensor(-math.inf)), f_k,
                           torch.nextafter(f_k, f_k.new_tensor(math.inf))])  # (3, K)
    steps = torch.arange(-span, span + 1, device=dev, dtype=torch.int32)
    m1s, m2s = [], []
    for which, (a, b, c) in enumerate((FMERG, FRING, FCUT)):
        for q in ratios:
            eta = q / (1.0 + q) ** 2
            m_total = (a * eta * eta + b * eta + c) / (math.pi * MSUN_S * f_k.double())
            m1 = (m_total / (1.0 + q)).float()
            m1c = (m1.view(torch.int32)[:, None] + steps).view(torch.float32)  # (K, 2 span + 1)
            m2c = (m1.double() * q).float()[:, None].expand_as(m1c)
            fx = row_scalars(m1c.reshape(-1), m2c.reshape(-1))[(0, 1, 3)[which]].reshape(m1c.shape)
            for target in targets:
                hit = fx == target[:, None]
                found = hit.any(1)
                first = hit.int().argmax(1)
                rows = torch.nonzero(found).squeeze(1)
                m1s.append(m1c[rows, first[rows]])
                m2s.append(m2c[rows, first[rows]])
    m1, m2 = torch.cat(m1s), torch.cat(m2s)
    rng = np.random.default_rng(seed)
    dl = torch.as_tensor(np.exp(rng.uniform(np.log(0.1), np.log(10.0), m1.shape[0])).astype(np.float32), device=dev)
    return m1, m2, dl


def prior_thetas(chains: int, dim: int, seed: int = 0, dtype=torch.float32) -> torch.Tensor:
    """``(chains, dim)`` unconstrained points on the CPU: N(0, 3^2) draws, the
    first rows replaced by +40 and -40 in every site (where the sigmoid
    saturates to 0 or 1 and exp(u) is huge or tiny), then a row of zeros
    (the softplus subgradients' tie), as many of these as there are chains."""
    gen = torch.Generator().manual_seed(seed)
    theta = 3.0 * torch.randn((chains, dim), generator=gen, dtype=torch.float64)
    for k, value in enumerate((40.0, -40.0, 0.0)[:chains]):
        theta[k] = value
    return theta.to(dtype)


def priors_twin(spec, theta: torch.Tensor, g_log_prior: torch.Tensor, g_sites: torch.Tensor):
    """``(log_prior (C,), sites (C, dim), grad (C, dim), size (C,))`` of the
    per-site code of ``inference/model.py`` at ``theta``: the gradient is that
    of ``g_log_prior . log_prior + sum_i g_sites[:, i] . site_i``, and ``size``
    the sum of the magnitudes of the log prior's finite terms."""
    from bumpcosmology_torch.inference.model import _log_prior_and_jac, constrain

    th = theta.detach().requires_grad_(True)
    lp = _log_prior_and_jac(spec, th)
    sites = constrain(spec, th)
    loss = (g_log_prior * lp).sum() + sum((g_sites[:, i] * sites[k]).sum() for i, k in enumerate(spec.names))
    (grad,) = torch.autograd.grad(loss, th)
    with torch.no_grad():
        terms = torch.stack([t for i, d in enumerate(spec.priors.values())
                             for t in (d.log_prob(sites[spec.names[i]]).to(theta.dtype).expand(theta.shape[:-1]),
                                       d.constrain_log_jac(theta[..., i]))], -1)
        size = torch.where(torch.isfinite(terms), terms.abs(), 0.0).sum(-1)
    return lp.detach(), torch.stack([sites[k].detach() for k in spec.names], -1), grad, size


def priors_gaps(got, ref, rows) -> dict:
    """Each gap of the priors kernel's ``(log_prior, sites, grad)`` to the
    per-site code's ``ref`` (:func:`priors_twin`) over its limit (a gap passes
    at 1 or less), and whether the two log priors are -inf in the same entries.

    Float32: sites within 1e-6 relative, plus four ulps of the site's larger
    finite bound (low + width * s, low + exp(u) and high - exp(u) can land
    near 0, where an ulp or two of the sigmoid or the exp, which the card and
    the CPU round apart, is most of the value); the log prior within 1e-6 of
    itself plus the sum of its terms' magnitudes; gradients within 1e-5 of
    1 + |ref|.  Float64: 1e-14, 1e-7 and 1e-12 likewise; the log prior's 1e-7
    because the per-site code's uniform density is a float32 number whatever
    theta's dtype (``torch.where`` of two Python numbers)."""
    lp, sites, grad = got
    lp_ref, sites_ref, grad_ref, size = ref
    f32 = sites_ref.dtype == torch.float32
    eps = torch.finfo(sites_ref.dtype).eps
    bound = torch.tensor([max([0.0] + [abs(v) for v in (r[4], r[5]) if math.isfinite(v)]) for r in rows],
                         dtype=sites_ref.dtype)
    site_tol = (1e-6 if f32 else 1e-14) * sites_ref.abs() + 4 * eps * bound
    fin = torch.isfinite(lp_ref)
    lp_tol = (1e-6 if f32 else 1e-7) * (lp_ref.abs() + size)

    def ratio(gap, tol):  # an exact entry passes even at a limit of 0
        return float(torch.where(gap == 0, 0.0, gap / tol).max()) if gap.numel() else 0.0

    return dict(
        same_finite=bool(torch.equal(fin, torch.isfinite(lp)) and torch.equal(lp[~fin], lp_ref[~fin])),
        sites=ratio((sites - sites_ref).abs(), site_tol),
        log_prior=ratio((lp - lp_ref).abs()[fin], lp_tol[fin]),
        grad=ratio((grad - grad_ref).abs(), (1e-5 if f32 else 1e-12) * (1.0 + grad_ref.abs())),
    )
