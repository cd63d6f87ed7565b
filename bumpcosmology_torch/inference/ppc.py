"""Posterior predictive checks: does the fitted population reproduce the
observed catalog? (L2); counterpart of the JAX package's ``inference/ppc.py``.

For each thinned posterior draw θ_s the *detected* population the model
predicts is the injection set reweighted by population weights,

    W_j(θ) ∝ exp(log dN(x_j | θ) − log pdraw_j),       j = 1..nsel,

(the selection integral's own weights, so selection effects are included);
the *observed* catalog under θ_s is one PE sample per event, drawn with
probability ∝ exp(log w_ik(θ_s)) over each event's samples.  The statistic
per observable is the one-sample Kolmogorov–Smirnov distance of the nobs
observed points against the weighted predicted CDF, calibrated by
replication (nobs synthetic detections drawn from W_j(θ_s)):

    p = P[ KS(replicated) ≥ KS(observed) ].

**Device part** (:func:`_logwts_matrix`): the ``(S, nobs, nsamp)`` and
``(S, nsel)`` log-weights, ``batch`` draws at a time as the chain axis C,
under ``torch.inference_mode``.  The joint bump takes kernel B's ``rows``
epilogue (:func:`~bumpcosmology_torch.inference.likelihoods.pop_cosmo_event_sel_logwts`),
the population-only model its source-frame rows with kernel A's table.

**A route difference.**  The JAX package passes no ``dl_bounds`` here, so
its bump takes the non-fused route (the cosmology table inverted at each
dL).  The port's bump with ``dl_bounds=None`` takes kernel B's fused route
on the detector table over the data's own dL range, as its deterministics
do: the two agree to float32 rounding against the JAX package's fused route
on the same bounds, and differ by the tables' interpolation against its
non-fused route (about 1e-5 at ``n_z`` = 1024, 2e-3 at 64).  The other
families take the non-fused route in both packages.

**Host part** (everything after the weights): numpy with the JAX package's
``default_rng(seed)`` draws, so the same weights give the same result.  The
replicated draws compare ``(S, nobs, nsel)`` uniforms with the cumulative
weights on the host, as the JAX package does: 352 MB of booleans at S =
256, 56 events and 24,576 injections.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from bumpcosmology_torch.device import resolve_device
from bumpcosmology_torch.inference.likelihoods import (
    PopCosmoData,
    _pop_event_sel_logwts,
    pop_cosmo_event_sel_logwts,
)

__all__ = ["PpcResult", "posterior_predictive_check", "OBSERVABLE_LABELS"]

# column -> human label per model frame (PopData is source frame,
# PopCosmoData detector frame; EventData fields are a/q/c in both)
OBSERVABLE_LABELS = {
    "pop": {"a": "m1 [Msun, source]", "q": "q", "c": "z"},
    "pop_cosmo": {"a": "m1_det [Msun]", "q": "q", "c": "dL [Gpc]"},
}


class PpcResult(NamedTuple):
    """Posterior-predictive check summary.

    p_values   : observable -> posterior-predictive p-value
    ks_obs     : observable -> (S,) KS(observed | θ_s)
    ks_rep     : observable -> (S,) KS(replicated | θ_s)
    grid       : observable -> (ngrid,) evaluation points for the CDF band
    pred_cdf_q : observable -> (3, ngrid) predicted-CDF 16/50/84% band
    obs_cdf_q  : observable -> (3, ngrid) observed-ECDF 16/50/84% band
    labels     : observable -> axis label
    n_draws    : number of posterior draws used
    """

    p_values: Dict[str, float]
    ks_obs: Dict[str, np.ndarray]
    ks_rep: Dict[str, np.ndarray]
    grid: Dict[str, np.ndarray]
    pred_cdf_q: Dict[str, np.ndarray]
    obs_cdf_q: Dict[str, np.ndarray]
    labels: Dict[str, str]
    n_draws: int


def _thin(posterior: Dict[str, np.ndarray], site_names, n_draws: int):
    flat = {k: np.asarray(posterior[k]).reshape(-1) for k in site_names}
    total = next(iter(flat.values())).shape[0]
    if total > n_draws:
        idx = np.linspace(0, total - 1, n_draws).round().astype(int)
        flat = {k: v[idx] for k, v in flat.items()}
        total = n_draws
    return flat, total


def _logwts_matrix(sites_flat, data, n_grid, n_z, build, batch, device=None):
    """Batched (S, nobs, nsamp) event and (S, nsel) selection log-weights on
    ``device`` (``None`` means CUDA), returned as float32 numpy arrays."""
    dev = resolve_device(device)
    data = data.to(dev)
    if isinstance(data, PopCosmoData):
        def batched(s):
            _, _, lw, lsw = pop_cosmo_event_sel_logwts(s, data, n_grid, n_z, None, build=build)
            return lw, lsw
    else:
        def batched(s):
            _, lw, lsw = _pop_event_sel_logwts(s, data, n_grid, build=build)
            return lw, lsw

    total = next(iter(sites_flat.values())).shape[0]
    lws, lsws = [], []
    with torch.inference_mode():
        for lo in range(0, total, batch):
            hi = min(lo + batch, total)
            lw, lsw = batched({k: torch.tensor(v[lo:hi], dtype=torch.float32, device=dev)
                               for k, v in sites_flat.items()})
            lws.append(lw.cpu().numpy())
            lsws.append(lsw.cpu().numpy())
    return np.concatenate(lws, axis=0), np.concatenate(lsws, axis=0)


def _softmax_rows(logw: np.ndarray) -> np.ndarray:
    """Row-normalized exp(logw) with -inf-safe and all--inf-safe handling."""
    m = np.max(logw, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    w = np.exp(logw - m)
    tot = np.sum(w, axis=-1, keepdims=True)
    bad = tot <= 0
    w = np.where(bad, 1.0, w)  # degenerate row -> uniform (cannot happen at posterior draws)
    tot = np.where(bad, w.shape[-1], tot)
    return w / tot


def _ks_against_weighted_cdf(points_cdf: np.ndarray) -> float:
    """One-sample KS of n points given their predicted-CDF values u_i.

    D = max_i max(|u_(i) − i/n|, |u_(i) − (i−1)/n|) — the standard two-sided
    statistic evaluated directly on the probability transform.
    """
    u = np.sort(points_cdf)
    n = len(u)
    i = np.arange(1, n + 1)
    return float(np.max(np.maximum(np.abs(u - i / n), np.abs(u - (i - 1) / n))))


def _check_from_logwts(lw, lsw, ev_cols, sel_cols, S: int, seed: int, model: str,
                       cdf_grid_size: int) -> PpcResult:
    """The host part: every draw, CDF and statistic from the weights ``lw``
    (S, nobs, nsamp) and ``lsw`` (S, nsel) and the data's columns as numpy
    (``ev_cols`` / ``sel_cols``: observable → (nobs, nsamp) / (nsel,))."""
    nobs, nsamp = ev_cols["a"].shape
    rng = np.random.default_rng(seed)

    p_ev = _softmax_rows(lw)  # (S, nobs, nsamp)
    w_sel = _softmax_rows(lsw)  # (S, nsel)

    # one PE sample per event per draw, categorical over the event's samples
    cum_ev = np.cumsum(p_ev, axis=-1)
    u_ev = rng.random((S, nobs, 1))
    pick = np.sum(u_ev > cum_ev, axis=-1).clip(0, nsamp - 1)  # (S, nobs)

    # nobs replicated detections per draw, categorical over injections
    cum_sel = np.cumsum(w_sel, axis=-1)
    u_rep = rng.random((S, nobs, 1))
    pick_rep = np.sum(u_rep > cum_sel[:, None, :], axis=-1).clip(0, w_sel.shape[1] - 1)

    out_p, out_ko, out_kr, out_grid, out_pq, out_oq, out_lab = {}, {}, {}, {}, {}, {}, {}
    labels = OBSERVABLE_LABELS.get(model, OBSERVABLE_LABELS["pop"])
    for col in ("a", "q", "c"):
        x_ev = ev_cols[col]  # (nobs, nsamp)
        x_sel = sel_cols[col]  # (nsel,)
        order = np.argsort(x_sel)
        xs = x_sel[order]
        Wcum = np.cumsum(w_sel[:, order], axis=-1)  # (S, nsel) predicted CDF at xs

        # CDF values of observed picks and replicated picks under each draw
        obs_x = x_ev[np.arange(nobs)[None, :], pick]  # (S, nobs)
        idx_obs = np.searchsorted(xs, obs_x, side="right") - 1
        cdf_obs = np.where(idx_obs >= 0, np.take_along_axis(
            Wcum, np.maximum(idx_obs, 0), axis=-1), 0.0)
        # replicated picks are injection indices in the *unsorted* array:
        rep_x = x_sel[pick_rep]  # (S, nobs)
        idx_rep = np.searchsorted(xs, rep_x, side="right") - 1
        cdf_rep = np.where(idx_rep >= 0, np.take_along_axis(
            Wcum, np.maximum(idx_rep, 0), axis=-1), 0.0)

        ks_o = np.array([_ks_against_weighted_cdf(cdf_obs[s]) for s in range(S)])
        ks_r = np.array([_ks_against_weighted_cdf(cdf_rep[s]) for s in range(S)])
        out_ko[col], out_kr[col] = ks_o, ks_r
        out_p[col] = float(np.mean(ks_r >= ks_o))

        # CDF bands for the figure: predicted (from W) and observed (ECDF of
        # picks), both across draws, on a common grid
        lo, hi = float(xs[0]), float(xs[-1])
        grid = np.linspace(lo, hi, cdf_grid_size)
        gi = np.searchsorted(xs, grid, side="right") - 1
        pred_cdf = np.where(gi[None, :] >= 0, Wcum[:, np.maximum(gi, 0)], 0.0)
        obs_cdf = (obs_x[:, :, None] <= grid[None, None, :]).mean(axis=1)  # (S, ngrid)
        out_grid[col] = grid
        out_pq[col] = np.quantile(pred_cdf, [0.16, 0.5, 0.84], axis=0)
        out_oq[col] = np.quantile(obs_cdf, [0.16, 0.5, 0.84], axis=0)
        out_lab[col] = labels[col]

    return PpcResult(
        p_values=out_p, ks_obs=out_ko, ks_rep=out_kr, grid=out_grid,
        pred_cdf_q=out_pq, obs_cdf_q=out_oq, labels=out_lab, n_draws=S,
    )


def posterior_predictive_check(
    posterior: Dict[str, np.ndarray],
    site_names: Sequence[str],
    data,
    build: Optional[Callable] = None,
    n_grid: int = 256,
    n_z: int = 1024,
    n_draws: int = 256,
    seed: int = 0,
    batch: int = 32,
    model: str = "pop",
    cdf_grid_size: int = 128,
    device=None,
) -> PpcResult:
    """Run the PPC for every observable column of ``data``.

    ``posterior`` maps site name → (chains, draws); ``build`` selects the
    mass family (``None``: the bump).  ``model`` only picks axis labels
    ("pop" or "pop_cosmo").  The weights are computed on ``device`` (``None``
    means CUDA), the rest on the host.
    """
    sites_flat, S = _thin(posterior, site_names, n_draws)
    lw, lsw = _logwts_matrix(sites_flat, data, n_grid, n_z, build, batch, device)
    cols = lambda part: {c: getattr(part, c).cpu().numpy() for c in ("a", "q", "c")}  # noqa: E731
    return _check_from_logwts(lw, lsw, cols(data.events), cols(data.selection), S, seed, model, cdf_grid_size)
