"""Marginal likelihood (evidence) by bridge sampling → Bayes factors (L2);
counterpart of the JAX package's ``inference/evidence.py``.

    Z = ∫ p(data | θ) p(θ) dθ

is estimated from a saved posterior trace by **bridge sampling** (Meng &
Wong 1996) with a moment-matched Gaussian proposal in the model's
*unconstrained* space (Gronau et al. 2017), so log Bayes factors between
the mass families come out of ``pipeline compare``.

* The estimator runs in unconstrained space (``model.unconstrain``), where
  the potential already includes the constraining Jacobian, so Z is kept.
* The trace is split in half: the first half moment-matches the proposal,
  the second enters the estimator (Gronau et al. §4).
* The Monte-Carlo error is the spread of the estimator over ``n_blocks``
  disjoint (posterior-block, proposal-block) pairs.

**Device and host.** The unnormalized log-posterior at the proposal and
posterior points is the port's batched potential, value only, under
``torch.inference_mode`` (:func:`_batched_logq`: ``batch`` points as the
chain axis, the tail at its own size).  Everything else is float64 numpy on
the host, as in the JAX package: the proposal's mean, covariance and
Cholesky factor (``numpy.linalg``, no TF32 anywhere), the Gaussian
log-density, and the fixed-point iteration.  The proposal draws come from
``numpy.random.default_rng(seed)``, so the port draws the JAX package's
proposals and its ``log_z`` differs only through the potentials.
"""
from __future__ import annotations

import math
import warnings
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from bumpcosmology_torch.inference.model import ModelSpec, make_potential, unconstrain

__all__ = ["EvidenceResult", "log_evidence_bridge", "bayes_factor_table"]


class EvidenceResult(NamedTuple):
    log_z: float  # bridge-sampling estimate of log Z
    se: float  # block-resampled standard error of log_z
    n_posterior: int  # posterior draws used in the estimator half
    n_proposal: int  # Gaussian proposal draws
    n_iter: int  # bridge fixed-point iterations to convergence
    converged: bool
    log_z_blocks: np.ndarray  # (n_blocks,) per-block estimates behind ``se``


def _batched_logq(spec: ModelSpec, theta: np.ndarray, batch: int = 512) -> np.ndarray:
    """Unnormalized log posterior −U(θ) at rows of ``theta`` (float64 on the
    host), ``batch`` rows at a time on ``spec.device`` in float32."""
    potential = make_potential(spec)
    n = theta.shape[0]
    out = np.empty(n, dtype=np.float64)
    with torch.inference_mode():
        for lo in range(0, n, batch):
            hi = min(lo + batch, n)
            chunk = torch.as_tensor(theta[lo:hi], dtype=torch.float32, device=spec.device)
            out[lo:hi] = potential(chunk).cpu().numpy()
    return -out


def _gaussian_logpdf(theta: np.ndarray, mean: np.ndarray, chol: np.ndarray) -> np.ndarray:
    """log N(θ | mean, L·Lᵀ) for rows of ``theta`` (host f64)."""
    d = mean.size
    y = np.linalg.solve(chol, (theta - mean).T).T  # L⁻¹ (θ−μ), (n, d)
    logdet = np.sum(np.log(np.diag(chol)))
    return -0.5 * np.sum(y * y, axis=1) - logdet - 0.5 * d * math.log(2.0 * math.pi)


def _bridge_iterate(l1: np.ndarray, l2: np.ndarray, max_iter: int, tol: float):
    """Meng–Wong optimal-bridge fixed point on log-ratio arrays.

    ``l1`` = log q − log g at *proposal* draws; ``l2`` = the same at
    *posterior* draws.  Returns (log_z, n_iter, converged).
    """
    n1, n2 = l1.size, l2.size
    # Optimal-bridge weights (Gronau et al. 2017 eq. 13): the density-ratio
    # terms carry the *posterior*-draw fraction, r carries the *proposal*
    # fraction.  (With n1 == n2 — the default — the two coincide.)
    s_ratio = n2 / (n1 + n2)
    s_r = n1 / (n1 + n2)
    lstar = float(np.median(l2))  # shift so exp() stays in range
    e1 = np.exp(l1 - lstar)
    e2 = np.exp(l2 - lstar)
    if not np.any(e1 > 0.0):
        raise FloatingPointError(
            "bridge sampling: every proposal draw fell outside the "
            "likelihood support — the Gaussian proposal is badly matched "
            "to the posterior (heavy tails vs bounded support?)"
        )
    r = 1.0  # r estimates Z·e^{−lstar}
    logr = 0.0
    for it in range(1, max_iter + 1):
        num = np.mean(e1 / (s_ratio * e1 + s_r * r))
        den = np.mean(1.0 / (s_ratio * e2 + s_r * r))
        r_new = num / den
        delta = abs(math.log(r_new) - logr)
        r, logr = r_new, math.log(r_new)
        if delta < tol:
            return logr + lstar, it, True
    return logr + lstar, max_iter, False


def log_evidence_bridge(
    spec: ModelSpec,
    posterior: Dict[str, np.ndarray],
    seed: int = 0,
    n_proposal: Optional[int] = None,
    max_draws: int = 8192,
    n_blocks: int = 10,
    max_iter: int = 500,
    tol: float = 1e-10,
    batch: int = 512,
) -> EvidenceResult:
    """Bridge-sampling log-evidence of ``spec`` from its posterior trace.

    ``posterior`` maps site name → (chains, draws) constrained arrays (a
    saved trace; deterministic sites are ignored — only ``spec.priors``
    names are read).  ``n_proposal`` defaults to the size of the estimation
    half of the trace.  The potentials run on ``spec.device``.
    """
    names = list(spec.priors)
    flat = {k: np.asarray(posterior[k]).reshape(-1) for k in names}
    total = flat[names[0]].shape[0]
    if total < 64:
        raise ValueError(f"need >= 64 posterior draws for bridge sampling, got {total}")
    if total > max_draws:
        idx = np.linspace(0, total - 1, max_draws).round().astype(int)
        flat = {k: v[idx] for k, v in flat.items()}
        total = max_draws

    # the constrained draws in float32, as the trace and the potential hold them
    with torch.inference_mode():
        theta = unconstrain(spec, {k: torch.tensor(v, dtype=torch.float32) for k, v in flat.items()})
    theta = theta.numpy().astype(np.float64)  # (total, d)

    # Contiguous first-half/second-half split (Gronau et al. §4): the flat
    # order is chain-major, so with several chains the proposal is fitted on
    # the first half of the chains and the estimate made on the rest.
    half = theta.shape[0] // 2
    fit_half, est_half = theta[:half], theta[half:]
    n2 = est_half.shape[0]
    n1 = int(n_proposal) if n_proposal is not None else n2

    mean = fit_half.mean(axis=0)
    cov = np.atleast_2d(np.cov(fit_half, rowvar=False))
    cov += 1e-10 * np.eye(cov.shape[0]) * max(1.0, np.trace(cov))
    chol = np.linalg.cholesky(cov)

    rng = np.random.default_rng(seed)
    prop = mean + rng.standard_normal((n1, mean.size)) @ chol.T

    logq_prop = _batched_logq(spec, prop, batch=batch)
    logq_post = _batched_logq(spec, est_half, batch=batch)
    logg_prop = _gaussian_logpdf(prop, mean, chol)
    logg_post = _gaussian_logpdf(est_half, mean, chol)

    # A proposal draw can land outside the likelihood's support (−inf log q);
    # exp(l1) = 0 there is exactly the right contribution, so just floor it.
    l1 = np.where(np.isfinite(logq_prop), logq_prop - logg_prop, -np.inf)
    l2 = logq_post - logg_post
    if not np.all(np.isfinite(l2)):
        bad = int(np.sum(~np.isfinite(l2)))
        raise FloatingPointError(
            f"{bad}/{n2} posterior draws have non-finite log density — the "
            "trace and the spec disagree (wrong spec for this trace?)"
        )

    log_z, n_iter, converged = _bridge_iterate(l1, l2, max_iter, tol)

    # Block-pair standard error, the block count scaled down with the
    # estimation half (>= 8 draws per block); below 2 blocks, a warning and NaN.
    n_blocks_eff = max(0, min(n_blocks, n2 // 8, n1 // 8))
    blocks = []
    for b in range(n_blocks_eff):
        p_blk = l2[b * n2 // n_blocks_eff : (b + 1) * n2 // n_blocks_eff]
        g_blk = l1[b * n1 // n_blocks_eff : (b + 1) * n1 // n_blocks_eff]
        try:
            lz, _, _ = _bridge_iterate(g_blk, p_blk, max_iter, tol)
        except FloatingPointError:
            continue  # a block whose proposal slice has no in-support draw
        blocks.append(lz)
    blocks = np.asarray(blocks)
    if blocks.size > 1:
        se = float(np.std(blocks, ddof=1) / math.sqrt(blocks.size))
    else:
        warnings.warn(
            f"bridge sampling: too few draws ({n2} estimation-half) for a "
            "block standard error — log_z_se is NaN",
            RuntimeWarning,
            stacklevel=2,
        )
        se = float("nan")

    return EvidenceResult(
        log_z=float(log_z),
        se=se,
        n_posterior=n2,
        n_proposal=n1,
        n_iter=n_iter,
        converged=converged,
        log_z_blocks=blocks,
    )


def bayes_factor_table(results: Dict[str, EvidenceResult]) -> str:
    """log-evidence ranking with log₁₀ Bayes factors vs the best model."""
    names = sorted(results, key=lambda k: -results[k].log_z)
    best = results[names[0]].log_z
    lines = [f"{'model':16s} {'log_Z':>12s} {'se':>7s} {'log10_BF':>9s}"]
    for name in names:
        r = results[name]
        bf = (r.log_z - best) / math.log(10.0)
        lines.append(f"{name:16s} {r.log_z:12.2f} {r.se:7.3f} {bf:9.2f}")
    return "\n".join(lines)
