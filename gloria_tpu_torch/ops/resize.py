"""Bilinear image resize with PyTorch's align_corners semantics.

The reference upsamples the encoder input with
``nn.Upsample(size=(299, 299), mode='bilinear', align_corners=True)``; the
JAX package rebuilds that as two interpolation-matrix products
(``gloria_tpu.ops.resize``).  Here it is the PyTorch operator itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """[B, H, W, C] → [B, H', W', C] (NHWC, the JAX layout).

    The permutes are views: an NHWC tensor is an NCHW tensor in
    ``channels_last`` memory, which ``F.interpolate`` takes as it is."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)
