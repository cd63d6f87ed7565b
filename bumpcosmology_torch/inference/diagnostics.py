"""Convergence diagnostics: split R-hat, effective sample size, summaries;
a copy of the JAX package's ``inference/diagnostics.py`` (numpy only).

The reference defers all convergence assessment to arviz on the saved trace
(``src/scripts/run_fit.py:41-42``); arviz is not a dependency here, so the
standard estimators are implemented directly (Vehtari et al. 2021 split-R̂;
Geyer initial-monotone-sequence ESS as used by Stan/arviz).  Inputs are
numpy arrays shaped (chains, draws) or (chains, draws, ...).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["split_rhat", "ess", "summary"]


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws) -> (2*chains, draws//2)."""
    c, n = x.shape
    half = n // 2
    return np.concatenate([x[:, :half], x[:, half : 2 * half]], axis=0)


def split_rhat(x) -> float:
    """Split-chain potential scale reduction factor (rank-normalization omitted)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    x = _split_chains(x)
    m, n = x.shape
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    w = chain_vars.mean()
    b = n * chain_means.var(ddof=1)
    var_hat = (n - 1) / n * w + b / n
    if w <= 0:
        return np.inf if b > 0 else 1.0
    return float(np.sqrt(var_hat / w))


def _autocovariance_fft(x: np.ndarray) -> np.ndarray:
    """Autocovariance of each row via FFT, biased (divided by n)."""
    m, n = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n].real
    return acov / n


def ess(x) -> float:
    """Bulk effective sample size (Geyer initial monotone sequence, split chains)."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        x = x[None, :]
    x = _split_chains(x)
    m, n = x.shape
    if n < 4:
        return float(m * n)
    acov = _autocovariance_fft(x)
    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = chain_var.mean()
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += x.mean(axis=1).var(ddof=1)
    if var_plus <= 0:
        return float(m * n)

    # combined autocorrelation at each lag (Vehtari et al. 2021 eq. 10)
    rho = 1.0 - (mean_var - acov.mean(axis=0)) / var_plus

    # Geyer initial positive + monotone sequence over lag pairs
    # P_k = rho[2k] + rho[2k+1];  tau = -1 + 2 * sum_k P_k (monotone-capped)
    pair_sums = []
    k = 0
    while 2 * k + 1 < n:
        s = rho[2 * k] + rho[2 * k + 1]
        if s < 0:
            break
        if pair_sums and s > pair_sums[-1]:
            s = pair_sums[-1]
        pair_sums.append(s)
        k += 1
    tau = -1.0 + 2.0 * sum(pair_sums) if pair_sums else 1.0
    tau = max(tau, 1.0 / np.log10(m * n + 10.0))
    return float(min(m * n / tau, m * n * np.log10(m * n + 10.0)))


def summary(samples: Dict[str, np.ndarray]) -> Dict[str, Dict[str, float]]:
    """Per-site mean/sd/quantiles/ESS/R-hat for scalar sites shaped (chains, draws)."""
    out = {}
    for name, x in samples.items():
        x = np.asarray(x)
        if x.ndim != 2:
            continue  # vector deterministics summarized elsewhere
        flat = x.reshape(-1)
        out[name] = {
            "mean": float(flat.mean()),
            "sd": float(flat.std(ddof=1)),
            "q5": float(np.quantile(flat, 0.05)),
            "q50": float(np.quantile(flat, 0.50)),
            "q95": float(np.quantile(flat, 0.95)),
            "ess": ess(x),
            "rhat": split_rhat(x),
        }
    return out
