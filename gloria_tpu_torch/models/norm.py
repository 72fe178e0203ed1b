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

With a reduced ``dtype`` (``norm.py:44-68`` of the JAX package, as the
backbones build it): the statistics come from the input cast to f32, the
normalization and affine run in f32 on f32 parameters and statistics, and
the output is cast to ``dtype``, in both modes.
"""

from __future__ import annotations

import torch
from torch import nn

from .precision import check_dtype, round_to, widen

# flax's BatchNorm momentum, the weight of the old running average; every
# reference caller passes 0.9
MOMENTUM = 0.9


class BatchNorm2d(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = check_dtype(dtype)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] (any memory format)."""
        cd = self.compute_dtype
        if not self.training:
            # JAX norm.py:66: the running affine on x.astype(f32)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = ((widen(x, cd) - self.running_mean[:, None, None]) * mul[:, None, None]
                 + self.bias[:, None, None])
        else:
            xf = x.float()  # JAX norm.py:47,66: statistics and apply on x.astype(f32)
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                self.running_mean.copy_(MOMENTUM * self.running_mean + (1 - MOMENTUM) * mean)
                self.running_var.copy_(MOMENTUM * self.running_var + (1 - MOMENTUM) * var)
            mul = torch.rsqrt(var + self.eps) * self.weight
            y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return round_to(y, cd)  # JAX norm.py:67-68: the output in dtype
