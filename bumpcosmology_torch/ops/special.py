"""Elementwise special functions shared by the models and the kernels' plain twins."""
from __future__ import annotations

import torch

__all__ = ["softplus"]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), stable for every x and without PyTorch's linear threshold
    (the JAX package's softplus and the CUDA kernels compute it so)."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))
