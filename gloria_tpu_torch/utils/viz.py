"""Attention overlays and the training-time attention plots.

The port's copy of the overlay part of ``gloria_tpu.utils.viz`` (the
reference's ``normalize`` and ``pyramid_attn_overlay``), which
``training.localization.EvaluateLocalization`` scores against the boxes:
``upsample`` (bilinear), ``pyramid`` (upsample, then a heavy Gaussian blur)
and ``windows`` (each cell spread over its receptive window, else the
nearest cell); and the attention grid that ``training.plotting.
AttentionPlotCallback`` saves (the reference's ``build_attention_images``):
:func:`to_rgb`, :func:`heatmap_overlay`, :func:`build_attention_images`.
The artifact renderer of that module is not ported yet (ROADMAP.md A6.3).
cv2 and PIL are imported inside the functions.
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


def to_rgb(img: np.ndarray) -> np.ndarray:
    """A uint8 [H, W, 3] image: a grey image repeated over three channels, a
    float image scaled from its own range to 0-255."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    if img.dtype != np.uint8:
        lo, hi = img.min(), img.max()
        img = ((img - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)
    return img


def heatmap_overlay(img: np.ndarray, attn: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """A normalized attention map in the jet colormap, blended over an image."""
    import cv2

    img = to_rgb(img)
    a = np.asarray(attn, np.float32)
    a = (a - a.min()) / (a.max() - a.min() + 1e-8)
    heat = cv2.applyColorMap((a * 255).astype(np.uint8), cv2.COLORMAP_JET)[:, :, ::-1]
    if heat.shape[:2] != img.shape[:2]:
        heat = cv2.resize(heat, img.shape[:2][::-1])
    return (alpha * heat + (1 - alpha) * img).astype(np.uint8)


FONT_MAX = 50  # the band above each row of tiles that holds the words


def build_attention_images(
    imgs: np.ndarray,           # [B, H, W, 3] normalized or uint8
    attn_maps: np.ndarray,      # [B, W_words, h, w]
    words: list[list[str]],
    cap_lens,
    nvis: int = 8,
    rand_vis: bool = False,
    rng: np.random.RandomState | None = None,
) -> np.ndarray:
    """One row for each of ``nvis`` samples (the first ones, or drawn
    without replacement by ``rng``, else ``RandomState(0)``, with
    ``rand_vis``): a 112² tile for each word, its attention upsampled and
    blended over the image, with the word written above it."""
    import cv2
    from PIL import Image, ImageDraw

    B = len(imgs)
    nvis = min(nvis, B)
    idxs = ((rng or np.random.RandomState(0)).choice(B, nvis, replace=False)
            if rand_vis else np.arange(nvis))
    max_words = int(max(cap_lens[i] for i in idxs))
    tile = 112
    canvas = np.zeros((nvis * (tile + FONT_MAX), max_words * (tile + 2), 3), np.uint8)
    pil = Image.fromarray(canvas)
    draw = ImageDraw.Draw(pil)
    for r, i in enumerate(idxs):
        img = cv2.resize(to_rgb(imgs[i]), (tile, tile))
        L = int(cap_lens[i])
        for wpos in range(min(L, max_words)):
            tile_img = heatmap_overlay(img, upsample_attn_overlay(attn_maps[i][wpos], (tile, tile)))
            y0 = r * (tile + FONT_MAX) + FONT_MAX
            x0 = wpos * (tile + 2)
            pil.paste(Image.fromarray(tile_img), (x0, y0))
            word = words[i][wpos] if wpos < len(words[i]) else ""
            draw.text((x0 + 2, y0 - FONT_MAX + 10), word.strip("#"), fill=(255, 255, 255))
    return np.asarray(pil)
