"""BatchNorm in eval mode: a frozen per-channel affine.

Parameters and buffers carry torchvision's names (``weight``, ``bias``,
``running_mean``, ``running_var``) so reference checkpoints load as they
are.  The output is ``(x - mean) * rsqrt(var + eps) * weight + bias``, the
order of ``gloria_tpu.models.norm.SplitBatchNorm`` with running averages.

Train-mode statistics come with the training slice.  Their trap: the JAX
package updates the running variance with the *biased* batch variance at
momentum 0.9 (``new = 0.9 * old + 0.1 * batch``), where ``nn.BatchNorm2d``
uses the unbiased variance.
"""

from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, C, H, W] (any memory format)."""
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None])
