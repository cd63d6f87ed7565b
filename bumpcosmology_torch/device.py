"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; asking for CUDA on a host without it raises.

    The CPU is used only when the caller names it (``device="cpu"``), as the
    tests do — an entry point never carries on silently on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bumpcosmology_torch: CUDA was requested (device=None means CUDA) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev
