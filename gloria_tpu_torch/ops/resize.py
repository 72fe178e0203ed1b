"""Image and map resizes with the JAX package's semantics.

- ``resize_bilinear``: the reference upsamples the encoder input with
  ``nn.Upsample(size=(299, 299), mode='bilinear', align_corners=True)``; the
  JAX package rebuilds that as two interpolation-matrix products
  (``gloria_tpu.ops.resize``).  In f32 it is the PyTorch operator itself.
  With a reduced ``compute_dtype`` it is the JAX package's two products
  (``resize.py:_apply_separable``): the input and the interpolation
  matrices rounded to that dtype, each product rounded to it, the result
  handed back in the input's dtype.
- ``resize_maps_nearest``: nearest resize of attention maps with the JAX
  package's integer source index ``min(i·in // out, in − 1)``, as a gather.
  ``F.interpolate(mode='nearest')`` computes that index in float and picks
  another row for some (in, out) pairs (6 → 74: one row), so it is not used.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(in_size: int, out_size: int, align_corners: bool) -> np.ndarray:
    """[out, in] interpolation weights, as the JAX package builds them."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1:
        m[0, 0] = 1.0
        return m
    if align_corners:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = np.clip((np.arange(out_size) + 0.5) * scale - 0.5, 0, in_size - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0).astype(np.float32)
    m[np.arange(out_size), i0] += 1.0 - w
    m[np.arange(out_size), i1] += w
    return m


def resize_bilinear(x: torch.Tensor, size: tuple[int, int], align_corners: bool = True,
                    compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, H, W, C] → [B, H', W', C] (NHWC, the JAX layout).

    The permutes are views: an NHWC tensor is an NCHW tensor in
    ``channels_last`` memory, which ``F.interpolate`` takes as it is."""
    xc = x.permute(0, 3, 1, 2)
    if compute_dtype == torch.float32:
        y = F.interpolate(xc, size=tuple(size), mode="bilinear", align_corners=align_corners)
        return y.permute(0, 2, 3, 1)
    # JAX resize.py:67-70: rows, then columns, each product stored in compute_dtype
    h, w = xc.shape[-2:]
    mh, mw = (torch.from_numpy(_bilinear_matrix(n, s, align_corners)).to(x.device, compute_dtype)
              for n, s in ((h, size[0]), (w, size[1])))
    y = torch.matmul(mh, xc.to(compute_dtype))   # [B, C, H', W]
    y = torch.matmul(y, mw.T)                    # [B, C, H', W']
    return y.to(x.dtype, memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    i = torch.arange(out_size, device=device)
    return torch.clamp((i * in_size) // out_size, max=in_size - 1)


def resize_maps_nearest(maps: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of channel-less maps [..., H, W] → [..., H', W']."""
    h, w = maps.shape[-2:]
    rows = _nearest_index(h, size[0], maps.device)
    cols = _nearest_index(w, size[1], maps.device)
    return maps.index_select(-2, rows).index_select(-1, cols)
