"""The port's device rule: the CUDA card unless the caller names another."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card, or an error when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
