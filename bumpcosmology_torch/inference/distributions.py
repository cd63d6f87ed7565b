"""Hyperprior families with their bijections to unconstrained space (L2);
counterpart of the JAX package's ``inference/distributions.py``.

Same three families, same transforms and log-Jacobians
(``distributions.py:123-152``): identity for Normal, scaled sigmoid for
Uniform and two-sided TruncatedNormal, exp-shift for one-sided truncation.
Sampling takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch
from torch.special import log_ndtr, ndtri

from bumpcosmology_torch.ops.special import softplus

__all__ = ["Normal", "TruncatedNormal", "Uniform", "Distribution", "log_ndtr", "ndtri"]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def _logit(p):
    return torch.log(p) - torch.log1p(-p)


def _sigmoid_log_jac(u, width):
    return math.log(width) - softplus(-u) - softplus(u)


@functools.lru_cache(maxsize=None)
def _trunc_log_z(loc, scale, low, high) -> float:
    def log_ndtr64(v):
        return float(log_ndtr(torch.tensor(v, dtype=torch.float64)))

    if low is None and high is None:
        return 0.0
    if high is None:
        return log_ndtr64(-(low - loc) / scale)
    if low is None:
        return log_ndtr64((high - loc) / scale)
    la, lb = log_ndtr64((low - loc) / scale), log_ndtr64((high - loc) / scale)
    return lb + math.log1p(-math.exp(la - lb))


class Normal(NamedTuple):
    loc: float = 0.0
    scale: float = 1.0

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - _LOG_SQRT_2PI - math.log(self.scale)

    def sample(self, generator, shape, device, dtype=torch.float32):
        return self.loc + self.scale * torch.randn(shape, generator=generator, device=device, dtype=dtype)

    def unconstrain(self, x):
        return x

    def constrain(self, u):
        return u

    def constrain_log_jac(self, u):
        return torch.zeros_like(u)


class Uniform(NamedTuple):
    low: float
    high: float

    def log_prob(self, x):
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, -math.log(self.high - self.low), -math.inf)

    def sample(self, generator, shape, device, dtype=torch.float32):
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return self.low + (self.high - self.low) * u

    def unconstrain(self, x):
        return _logit(((x - self.low) / (self.high - self.low)).clamp(1e-6, 1.0 - 1e-6))

    def constrain(self, u):
        return self.low + (self.high - self.low) * torch.sigmoid(u)

    def constrain_log_jac(self, u):
        return _sigmoid_log_jac(u, self.high - self.low)


class TruncatedNormal(NamedTuple):
    """Normal(loc, scale) truncated to [low, high] (either side optional)."""

    loc: float
    scale: float
    low: Optional[float] = None
    high: Optional[float] = None

    def _log_z(self) -> float:
        """log P(low < X < high), in float64 (a constant of the prior)."""
        return _trunc_log_z(self.loc, self.scale, self.low, self.high)

    def log_prob(self, x):
        z = (x - self.loc) / self.scale
        lp = -0.5 * z * z - _LOG_SQRT_2PI - math.log(self.scale) - self._log_z()
        lo = -math.inf if self.low is None else self.low
        hi = math.inf if self.high is None else self.high
        return torch.where((x >= lo) & (x <= hi), lp, -math.inf)

    def sample(self, generator, shape, device, dtype=torch.float32):
        ndtr = lambda v: float(torch.special.ndtr(torch.tensor(v, dtype=torch.float64)))  # noqa: E731
        lo_u = 0.0 if self.low is None else ndtr((self.low - self.loc) / self.scale)
        hi_u = 1.0 if self.high is None else ndtr((self.high - self.loc) / self.scale)
        u = lo_u + (hi_u - lo_u) * torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return self.loc + self.scale * ndtri(u.clamp(1e-6, 1.0 - 1e-6))

    def unconstrain(self, x):
        if self.low is not None and self.high is not None:
            return _logit(((x - self.low) / (self.high - self.low)).clamp(1e-6, 1.0 - 1e-6))
        if self.low is not None:
            return torch.log(torch.clamp_min(x - self.low, 1e-10))
        if self.high is not None:
            return torch.log(torch.clamp_min(self.high - x, 1e-10))
        return x

    def constrain(self, u):
        if self.low is not None and self.high is not None:
            return self.low + (self.high - self.low) * torch.sigmoid(u)
        if self.low is not None:
            return self.low + torch.exp(u)
        if self.high is not None:
            return self.high - torch.exp(u)
        return u

    def constrain_log_jac(self, u):
        if self.low is not None and self.high is not None:
            return _sigmoid_log_jac(u, self.high - self.low)
        if self.low is not None or self.high is not None:
            return u
        return torch.zeros_like(u)


Distribution = (Normal, Uniform, TruncatedNormal)
