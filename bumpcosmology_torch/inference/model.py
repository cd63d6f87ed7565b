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

The priors and transforms of every site (:func:`log_prior_and_sites`) take
the per-site code below on the CPU, and on the card one launch of the CUDA
kernel ``csrc/priors.cu`` forward and one backward
(:mod:`~bumpcosmology_torch.ops.cuda_priors`), which reads the priors as a
table (``cuda_priors.table_rows``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from bumpcosmology_torch.ops import cuda_priors
from bumpcosmology_torch.utils.profiling import backward_span, span

__all__ = ["ModelSpec", "make_potential", "value_and_grad", "prior_sample", "constrain",
           "unconstrain", "log_prior_and_sites", "data_potential"]

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


def log_prior_and_sites(spec: ModelSpec, theta: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(log_prior, sites)`` of ``theta`` ``(..., dim)``: the sum over sites of
    log prior density and log-Jacobian ``(...,)``, and the constrained site
    dict, each site ``(...,)`` and differentiable back to ``theta``.

    A CPU tensor takes the per-site code (:func:`_log_prior_and_jac`, then
    :func:`constrain`); a CUDA tensor launches ``csrc/priors.cu`` or raises."""
    if theta.device.type == "cpu":
        log_prior = _log_prior_and_jac(spec, theta)
        return log_prior, constrain(spec, theta)
    if theta.device.type != "cuda":
        raise ValueError(f"log_prior_and_sites: unsupported device {theta.device}")
    if theta.dim() == 2:  # (C, dim), the sampler's: no views to add
        log_prior, sites = cuda_priors.log_prior_and_sites(spec.priors, theta)
        return log_prior, dict(zip(spec.names, sites.unbind(0)))
    batch = theta.shape[:-1]
    log_prior, sites = cuda_priors.log_prior_and_sites(spec.priors, theta.reshape(-1, theta.shape[-1]))
    return log_prior.reshape(batch), {name: x.reshape(batch) for name, x in zip(spec.names, sites.unbind(0))}


def make_potential(spec: ModelSpec) -> Callable[[torch.Tensor], torch.Tensor]:
    """U(theta) = -log posterior density; ``(C, dim)`` → ``(C,)``.  Raises
    ``ValueError`` here for a prior of a type the kernel has no row for."""
    cuda_priors.table_rows(spec.priors)

    def potential(theta: torch.Tensor) -> torch.Tensor:
        log_prior, sites = log_prior_and_sites(spec, theta)
        with span("potential.loglike"):
            ll = backward_span("loglike.backward", "potential.value_and_grad", spec.loglike, sites)
        return -(log_prior + ll)

    return potential


def data_potential(spec: ModelSpec, loglike: Callable, data) -> Callable[[torch.Tensor], torch.Tensor]:
    """U(theta) = -(log prior + ``loglike(sites, data)``), the potential of a
    fleet's catalogs ``data`` under ``spec.priors``; ``(C, dim)`` → ``(C,)``.
    Raises ``ValueError`` here for a prior of a type the kernel has no row for."""
    cuda_priors.table_rows(spec.priors)

    def potential(theta: torch.Tensor) -> torch.Tensor:
        log_prior, sites = log_prior_and_sites(spec, theta)
        return -(log_prior + loglike(sites, data))

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
