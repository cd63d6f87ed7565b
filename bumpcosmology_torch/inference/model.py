"""Model specification: priors + log-likelihood → batched potential (L2);
counterpart of the JAX package's ``inference/model.py``.

    U(theta) = -[ sum_i log p_i(x_i) + log|J(theta)| + loglike(x) ]

over the flat unconstrained vector.  Here ``theta`` carries a leading chain
axis ``(C, dim)`` and the potential returns ``(C,)``; the chains are
independent, so one backward of ``U.sum()`` gives every chain's gradient
(:func:`value_and_grad`).

While the torch profiler records, a value+grad is the span
``potential.value_and_grad``, the log-likelihood's forward
``potential.loglike`` and its backward ``loglike.backward``
(:mod:`~bumpcosmology_torch.utils.profiling`); :data:`COUNTS` counts the
value+grads whatever the profiler's state.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from bumpcosmology_torch.utils.profiling import backward_span, span

__all__ = ["ModelSpec", "make_potential", "value_and_grad", "prior_sample", "constrain",
           "unconstrain"]

COUNTS = {"value_and_grads": 0}  # batched value+grads made by :func:`value_and_grad`


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
        log_prior = _log_prior_and_jac(spec, theta)
        sites = constrain(spec, theta)
        with span("potential.loglike"):
            ll = backward_span("loglike.backward", "potential.value_and_grad", spec.loglike, sites)
        return -(log_prior + ll)

    return potential


def value_and_grad(potential: Callable, theta: torch.Tensor):
    """``(U, dU/dtheta)`` for every chain of ``theta`` ``(C, dim)``, detached."""
    COUNTS["value_and_grads"] += 1
    with span("potential.value_and_grad"), torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        u = potential(th)
        (grad,) = torch.autograd.grad(u.sum(), th)
    return u.detach(), grad


def prior_sample(spec: ModelSpec, generator: torch.Generator, shape=()) -> torch.Tensor:
    """A prior draw in *unconstrained* space, ``(*shape, dim)`` (chain init)."""
    us = [dist.unconstrain(dist.sample(generator, shape, spec.device)) for dist in spec.priors.values()]
    return torch.stack(us, dim=-1)
