"""Predictive model comparison: PSIS-LOO and WAIC over per-event likelihoods
(L2); counterpart of the JAX package's ``inference/model_compare.py``.

The hierarchical likelihood decomposes per event,

    log L(θ) = Σ_i ℓ_i(θ),   ℓ_i(θ) = log p̂(d_i | θ) − log μ_sel(θ)

(each detected event's Monte-Carlo marginal minus its share of the
``−nobs·log μ_sel`` factor), and that matrix of ``ℓ_i`` over posterior draws
feeds the standard leave-one-out machinery: :func:`psis_loo`
(Pareto-smoothed importance sampling, Vehtari, Gelman & Gabry 2017, with the
per-event k̂ diagnostic), :func:`waic` and the ranking table :func:`compare`.

**Device part.** :func:`pop_pointwise_loglike` and
:func:`pop_cosmo_pointwise_loglike` take sites of shape ``(C,)`` and return
``(C, nobs)``; :func:`pointwise_matrix` feeds them ``batch`` thinned draws at
a time as the chain axis C, under ``torch.inference_mode`` (no kernel keeps
residuals for a backward).  The joint bump's per-event term is exactly the
per-event log-sum-exp of kernel B's ``lse`` epilogue
(:func:`~bumpcosmology_torch.inference.likelihoods.pop_cosmo_segment_lse`),
so its ``(C, N)`` rows are never materialised; the population-only bump
takes kernel A and its plain-torch source-frame rows; the other families
their plain routes through ``build``.  The JAX package pads the last batch
to its compiled shape; nothing is compiled here, so the tail is evaluated at
its own size.

**Host part.** The GPD fit, the smoothing, LOO, WAIC and the table are the
JAX package's float64 numpy, so the same matrix gives the same numbers.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.likelihoods import (
    PopCosmoData,
    PopData,
    _pop_event_sel_logwts,
    pop_cosmo_segment_lse,
)
from bumpcosmology_torch.models.mass import DEFAULT_N_GRID

__all__ = [
    "pop_pointwise_loglike",
    "pop_cosmo_pointwise_loglike",
    "pointwise_matrix",
    "fit_gpd",
    "psis_smooth_logratios",
    "psis_loo",
    "waic",
    "compare",
    "LooResult",
    "WaicResult",
]


# ---------------------------------------------------------------- pointwise


def pop_pointwise_loglike(sites: Dict[str, torch.Tensor], data: PopData, n_grid: int = DEFAULT_N_GRID,
                          build=None, rows=None) -> torch.Tensor:
    """``(C, nobs)`` per-event ℓ_i(θ) of the population-only model for sites
    of shape ``(C,)``; each row sums to
    :func:`~bumpcosmology_torch.inference.likelihoods.pop_loglike`.  ``build``
    selects the mass family (``None``: the bump, its table through kernel A);
    ``rows`` is ``pop_rows(data)`` (computed if not given)."""
    nsamp = data.events.a.shape[-1]
    _, log_w, log_sel_w = _pop_event_sel_logwts(sites, data, n_grid, rows, build=build)
    log_like = torch.logsumexp(log_w, -1) - math.log(nsamp)
    log_mu_sel = torch.logsumexp(log_sel_w, -1) - data.selection.log_ndraw
    return log_like - log_mu_sel[..., None]


def pop_cosmo_pointwise_loglike(sites: Dict[str, torch.Tensor], data: PopCosmoData, n_grid: int = DEFAULT_N_GRID,
                                n_z: int = 1024, dl_bounds=None, build=None, qry=None) -> torch.Tensor:
    """``(C, nobs)`` per-event ℓ_i(θ) of the joint model for sites of shape
    ``(C,)``; each row sums to
    :func:`~bumpcosmology_torch.inference.likelihoods.pop_cosmo_loglike`.
    The bump's per-event and selection log-sum-exps come from one launch of
    kernel B's ``lse`` epilogue (``dl_bounds`` defaulting to the data's, as
    the port's likelihood does); another family takes its plain route (fused
    with ``dl_bounds``, non-fused without, as in the JAX package)."""
    nsamp = data.events.a.shape[-1]
    lse_ev, lse_sel = pop_cosmo_segment_lse(sites, data, n_grid, n_z, dl_bounds, qry, build=build)
    log_mu_sel = lse_sel - data.selection.log_ndraw
    return lse_ev - math.log(nsamp) - log_mu_sel[..., None]


def pointwise_matrix(
    pointwise_fn: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
    posterior: Dict[str, np.ndarray],
    site_names,
    max_draws: int = 1024,
    seed: int = 0,
    batch: int = 64,
    device=None,
) -> np.ndarray:
    """(S, nobs) pointwise log-likelihood matrix from a constrained trace.

    ``posterior`` maps site name → (chains, draws) arrays (a saved trace's
    posterior); draws are flattened across chains and uniformly thinned to
    ``max_draws``.  ``pointwise_fn`` takes sites of shape ``(C,)`` on
    ``device`` (``None`` means CUDA) and returns ``(C, nobs)``; it runs on
    ``batch`` draws at a time (the tail at its own size).  ``seed`` is
    unused, as in the JAX package (the thinning is deterministic).
    """
    dev = resolve_device(device)
    flat = {k: np.asarray(posterior[k]).reshape(-1) for k in site_names}
    total = next(iter(flat.values())).shape[0]
    if total > max_draws:
        idx = np.linspace(0, total - 1, max_draws).round().astype(int)
        flat = {k: v[idx] for k, v in flat.items()}
        total = max_draws

    rows = []
    with torch.inference_mode():
        for lo in range(0, total, batch):
            hi = min(lo + batch, total)
            chunk = {k: torch.tensor(v[lo:hi], dtype=torch.float32, device=dev) for k, v in flat.items()}
            rows.append(pointwise_fn(chunk).cpu().numpy())
    return np.concatenate(rows, axis=0)


# ------------------------------------------------------------------- PSIS


def fit_gpd(x: np.ndarray):
    """(k, sigma) of a generalized Pareto fit to exceedances ``x`` ≥ 0.

    Zhang & Stephens (2009) profile-posterior estimator — the same method
    arviz/loo use; no optimizer, quadrature over a data-driven θ grid.
    """
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = x.size
    if n < 5 or x[-1] <= 0:
        return np.inf, np.nan
    prior_bs = 3.0
    m_est = 30 + int(math.sqrt(n))
    jj = np.arange(1, m_est + 1)
    quart = x[int(n / 4 + 0.5) - 1]
    b = 1.0 / x[-1] + (1.0 - np.sqrt(m_est / (jj - 0.5))) / (prior_bs * quart)
    # ξ(b) = mean log1p(−b·x) (ML identity); profile loglik of each candidate
    xi_of_b = np.mean(np.log1p(-b[:, None] * x[None, :]), axis=1)
    l_b = n * (np.log(-(b / xi_of_b)) - xi_of_b - 1.0)
    with np.errstate(over="ignore"):
        w = 1.0 / np.sum(np.exp(l_b - l_b[:, None]), axis=1)
    b_post = np.sum(b * w)
    k = float(np.mean(np.log1p(-b_post * x)))  # ξ̂: > 0 = heavy tail
    sigma = -k / b_post
    # weakly informative prior on k: 10 pseudo-draws at k=0.5 (as arviz/loo)
    k = (n * k + 10.0 * 0.5) / (n + 10.0)
    return float(k), float(sigma)


def psis_smooth_logratios(log_ratios: np.ndarray):
    """(smoothed normalized log-weights, k̂) for one event's draws.

    Fits a GPD to the largest-M raw ratios (M = min(0.2·S, 3·√S)), replaces
    them with expected order statistics of the fit, truncates at the raw
    maximum, and self-normalizes (Vehtari+ 2017 §3.2).
    """
    lr = np.asarray(log_ratios, dtype=np.float64)
    lr = lr - lr.max()  # shift: GPD k is scale-invariant, exp() stays finite
    S = lr.size
    m = int(min(math.ceil(0.2 * S), 3.0 * math.sqrt(S)))
    if m < 5:
        return lr - np.log(np.sum(np.exp(lr))), 0.0

    order = np.argsort(lr)
    tail_idx = order[-m:]
    cutoff = np.exp(lr[order[-m - 1]])
    exceed = np.exp(lr[tail_idx]) - cutoff  # ratio-scale exceedances
    k, sigma = fit_gpd(exceed)
    if np.isfinite(k) and sigma > 0:
        # replace the tail by expected order statistics: GPD quantiles at (j-0.5)/m
        p = (np.arange(1, m + 1) - 0.5) / m
        if abs(k) < 1e-6:
            q = -sigma * np.log1p(-p)
        else:
            q = sigma / k * (np.power(1.0 - p, -k) - 1.0)
        smoothed = np.log(q + cutoff)
        smoothed = np.minimum(smoothed, 0.0)  # truncate at the raw maximum
        lr = lr.copy()
        lr[tail_idx] = smoothed  # tail_idx ascending in lr; q ascending too
    lw = lr - lr.max()
    lw = lw - np.log(np.sum(np.exp(lw)))
    return lw, (k if np.isfinite(k) else np.inf)


class LooResult(NamedTuple):
    elpd: float
    se: float
    p_loo: float
    elpd_i: np.ndarray  # (nobs,)
    khat: np.ndarray  # (nobs,)


class WaicResult(NamedTuple):
    elpd: float
    se: float
    p_waic: float
    elpd_i: np.ndarray


def psis_loo(ll: np.ndarray) -> LooResult:
    """PSIS-LOO from an (S draws, nobs events) pointwise log-lik matrix."""
    ll = np.asarray(ll, dtype=np.float64)
    S, n = ll.shape
    elpd_i = np.empty(n)
    khat = np.empty(n)
    lppd_i = np.empty(n)
    for i in range(n):
        lw, k = psis_smooth_logratios(-ll[:, i])
        elpd_i[i] = _logsumexp_np(lw + ll[:, i])
        khat[i] = k
        lppd_i[i] = _logsumexp_np(ll[:, i]) - math.log(S)
    elpd = float(np.sum(elpd_i))
    se = float(math.sqrt(n * np.var(elpd_i)))
    p_loo = float(np.sum(lppd_i - elpd_i))
    return LooResult(elpd=elpd, se=se, p_loo=p_loo, elpd_i=elpd_i, khat=khat)


def waic(ll: np.ndarray) -> WaicResult:
    """WAIC from the same (S, nobs) matrix."""
    ll = np.asarray(ll, dtype=np.float64)
    S, n = ll.shape
    lppd_i = np.array([_logsumexp_np(ll[:, i]) - math.log(S) for i in range(n)])
    p_i = np.var(ll, axis=0, ddof=1)
    elpd_i = lppd_i - p_i
    return WaicResult(
        elpd=float(np.sum(elpd_i)),
        se=float(math.sqrt(n * np.var(elpd_i))),
        p_waic=float(np.sum(p_i)),
        elpd_i=elpd_i,
    )


def compare(results: Dict[str, LooResult]) -> str:
    """elpd ranking table with paired difference SEs (best model first)."""
    names = sorted(results, key=lambda k: -results[k].elpd)
    best = results[names[0]]
    lines = [f"{'model':16s} {'elpd':>10s} {'se':>7s} {'d_elpd':>8s} {'d_se':>7s} {'max_k':>6s}"]
    for name in names:
        r = results[name]
        d = r.elpd - best.elpd
        diff_i = r.elpd_i - best.elpd_i
        d_se = math.sqrt(diff_i.size * np.var(diff_i)) if name != names[0] else 0.0
        lines.append(
            f"{name:16s} {r.elpd:10.2f} {r.se:7.2f} {d:8.2f} {d_se:7.2f} "
            f"{np.max(r.khat):6.2f}"
        )
    return "\n".join(lines)


def _logsumexp_np(x: np.ndarray) -> float:
    m = np.max(x)
    return float(m + np.log(np.sum(np.exp(x - m))))
