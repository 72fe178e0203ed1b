"""Attention overlays: a word-region attention grid brought to image size.

The port's copy of the overlay part of ``gloria_tpu.utils.viz`` (the
reference's ``normalize`` and ``pyramid_attn_overlay``), which
``training.localization.EvaluateLocalization`` scores against the boxes:
``upsample`` (bilinear), ``pyramid`` (upsample, then a heavy Gaussian blur)
and ``windows`` (each cell spread over its receptive window, else the
nearest cell).  The attention plots and the artifact renderer of that
module are not ported yet (ROADMAP.md A6.1, A6.3).  cv2 is imported inside
the functions.
"""

from __future__ import annotations

import numpy as np


def normalize(similarities: np.ndarray, method: str = "norm") -> np.ndarray:
    if method == "norm":
        return (similarities - similarities.mean(axis=0)) / similarities.std(axis=0)
    if method == "standardize":
        return (similarities - similarities.min(axis=0)) / (
            similarities.max(axis=0) - similarities.min(axis=0))
    raise ValueError("normalizing method not implemented")


def pyramid_attn_overlay(attn: np.ndarray, image_shape: tuple[int, int]) -> np.ndarray:
    """An [h, w] grid upsampled by the whole factor, blurred (σ = 20) and
    resized to ``image_shape`` (the reference's ``pyramid_expand`` with a
    large sigma)."""
    import cv2

    attn = np.asarray(attn, np.float32)
    upscale = max(1, image_shape[0] // attn.shape[0])
    big = cv2.resize(attn, (attn.shape[1] * upscale, attn.shape[0] * upscale),
                     interpolation=cv2.INTER_LINEAR)
    sigma = 20.0
    k = int(sigma * 4) | 1
    big = cv2.GaussianBlur(big, (k, k), sigma)
    return cv2.resize(big, image_shape[::-1], interpolation=cv2.INTER_LINEAR)


def upsample_attn_overlay(attn: np.ndarray, image_shape: tuple[int, int]) -> np.ndarray:
    """Bilinear upsample (the ``upsample`` evaluation mode)."""
    import cv2

    return cv2.resize(np.asarray(attn, np.float32), image_shape[::-1],
                      interpolation=cv2.INTER_LINEAR)


def windows_attn_overlay(attn: np.ndarray, image_shape: tuple[int, int],
                         windows: np.ndarray | None = None) -> np.ndarray:
    """Each cell's weight spread uniformly over its window ``(y1, x1, y2,
    x2)``, overlaps averaged; without windows, the nearest cell."""
    if windows is None:
        import cv2

        return cv2.resize(np.asarray(attn, np.float32), image_shape[::-1],
                          interpolation=cv2.INTER_NEAREST)
    out = np.zeros(image_shape, np.float32)
    counts = np.zeros(image_shape, np.float32)
    flat = np.asarray(attn, np.float32).reshape(-1)
    for weight, (y1, x1, y2, x2) in zip(flat, windows.reshape(-1, 4)):
        out[y1:y2, x1:x2] += weight
        counts[y1:y2, x1:x2] += 1
    return out / np.maximum(counts, 1)


ATTN_OVERLAY_MODES = {
    "upsample": upsample_attn_overlay,
    "pyramid": pyramid_attn_overlay,
    "windows": windows_attn_overlay,
}


def get_attn_overlay(attn: np.ndarray, image_shape: tuple[int, int],
                     mode: str = "upsample", **kw) -> np.ndarray:
    return ATTN_OVERLAY_MODES[mode](attn, image_shape, **kw)
