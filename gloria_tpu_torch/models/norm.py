"""BatchNorm with flax's statistics, in eval and train mode.

Parameters and buffers carry torchvision's names (``weight``, ``bias``,
``running_mean``, ``running_var``) so reference checkpoints load as they
are.  Port of ``gloria_tpu.models.norm.SplitBatchNorm``:

- eval mode: ``(x - running_mean) * rsqrt(running_var + eps) * weight +
  bias``, from the running averages;
- train mode: the batch's f32 mean and "fast" variance ``E[x²] − E[x]²``
  clipped at 0, over (N, H, W), normalize in the same order, and the running
  averages move as ``new = 0.9 · old + 0.1 · batch``, with the *biased*
  variance.  ``nn.BatchNorm2d`` instead updates with the unbiased variance
  at momentum 0.1, so it is not used.
"""

from __future__ import annotations

import torch
from torch import nn

# flax's BatchNorm momentum, the weight of the old running average; every
# reference caller passes 0.9
MOMENTUM = 0.9


class BatchNorm2d(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] (any memory format)."""
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None])
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.copy_(MOMENTUM * self.running_mean + (1 - MOMENTUM) * mean)
            self.running_var.copy_(MOMENTUM * self.running_var + (1 - MOMENTUM) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
