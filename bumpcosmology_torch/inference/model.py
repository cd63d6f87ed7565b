"""Model specification: priors + log-likelihood → batched potential (L2);
counterpart of the JAX package's ``inference/model.py``.

    U(theta) = -[ sum_i log p_i(x_i) + log|J(theta)| + loglike(x) ]

over the flat unconstrained vector.  Here ``theta`` carries a leading chain
axis ``(C, dim)`` and the potential returns ``(C,)``; the chains are
independent, so one backward of ``U.sum()`` gives every chain's gradient
(:func:`value_and_grad`).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

__all__ = ["ModelSpec", "make_potential", "value_and_grad", "prior_sample", "constrain",
           "unconstrain"]


class ModelSpec(NamedTuple):
    """A probabilistic model: ordered scalar priors + a batched log-likelihood
    (sites of shape ``(C,)`` → ``(C,)``), and the device its data live on."""

    priors: Dict[str, object]
    loglike: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    device: torch.device = torch.device("cpu")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.priors.keys())

    @property
    def dim(self) -> int:
        return len(self.priors)


def constrain(spec: ModelSpec, theta: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Unconstrained ``(..., dim)`` → constrained site dict."""
    return {name: dist.constrain(theta[..., i]) for i, (name, dist) in enumerate(spec.priors.items())}


def unconstrain(spec: ModelSpec, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Constrained site dict → unconstrained ``(..., dim)``."""
    return torch.stack([dist.unconstrain(params[name]) for name, dist in spec.priors.items()], dim=-1)


def _log_prior_and_jac(spec: ModelSpec, theta: torch.Tensor) -> torch.Tensor:
    total = torch.zeros_like(theta[..., 0])
    for i, dist in enumerate(spec.priors.values()):
        u = theta[..., i]
        total = total + dist.log_prob(dist.constrain(u)) + dist.constrain_log_jac(u)
    return total


def make_potential(spec: ModelSpec) -> Callable[[torch.Tensor], torch.Tensor]:
    """U(theta) = -log posterior density; ``(C, dim)`` → ``(C,)``."""

    def potential(theta: torch.Tensor) -> torch.Tensor:
        return -(_log_prior_and_jac(spec, theta) + spec.loglike(constrain(spec, theta)))

    return potential


def value_and_grad(potential: Callable, theta: torch.Tensor):
    """``(U, dU/dtheta)`` for every chain of ``theta`` ``(C, dim)``, detached."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        u = potential(th)
        (grad,) = torch.autograd.grad(u.sum(), th)
    return u.detach(), grad


def prior_sample(spec: ModelSpec, generator: torch.Generator, shape=()) -> torch.Tensor:
    """A prior draw in *unconstrained* space, ``(*shape, dim)`` (chain init)."""
    us = [dist.unconstrain(dist.sample(generator, shape, spec.device)) for dist in spec.priors.values()]
    return torch.stack(us, dim=-1)
