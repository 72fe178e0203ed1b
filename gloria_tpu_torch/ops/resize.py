"""Image and map resizes with the JAX package's semantics.

- ``resize_bilinear``: the reference upsamples the encoder input with
  ``nn.Upsample(size=(299, 299), mode='bilinear', align_corners=True)``; the
  JAX package rebuilds that as two interpolation-matrix products
  (``gloria_tpu.ops.resize``).  Here it is the PyTorch operator itself.
- ``resize_maps_nearest``: nearest resize of attention maps with the JAX
  package's integer source index ``min(i·in // out, in − 1)``, as a gather.
  ``F.interpolate(mode='nearest')`` computes that index in float and picks
  another row for some (in, out) pairs (6 → 74: one row), so it is not used.
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


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    i = torch.arange(out_size, device=device)
    return torch.clamp((i * in_size) // out_size, max=in_size - 1)


def resize_maps_nearest(maps: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of channel-less maps [..., H, W] → [..., H', W']."""
    h, w = maps.shape[-2:]
    rows = _nearest_index(h, size[0], maps.device)
    cols = _nearest_index(w, size[1], maps.device)
    return maps.index_select(-2, rows).index_select(-1, cols)
