"""Host-side eval image pipeline: letterbox, center crop, normalization.

The port's own copy of the eval half of ``gloria_tpu.data.transforms``:

- ``letterbox_resize``: cv2 ``INTER_AREA`` scale of the long side + centered
  zero padding.  When the long side already equals ``scale`` the resize is
  the identity and is skipped, so an image sent at ``imsize`` needs no cv2;
- ``build_transformation`` for the eval splits: CenterCrop, then
  scale-to-[0,1] + Normalize ('half' or 'imagenet').  The train
  augmentations come with the training slice.

cv2 is imported only inside the functions that resize.  All callables map
HWC uint8/float → HWC float32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..configs import Config

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def letterbox_resize(img: np.ndarray, scale: int) -> np.ndarray:
    """Resize so the long side == scale (INTER_AREA), zero-pad the short side
    centered. Grayscale [H, W] or color [H, W, C]."""
    size = img.shape[:2]
    max_ind = 0 if size[0] >= size[1] else 1
    if max_ind == 0:
        wpercent = scale / float(size[0])
        desirable = (scale, int(float(size[1]) * wpercent))
    else:
        hpercent = scale / float(size[1])
        desirable = (int(float(size[0]) * hpercent), scale)
    if desirable == tuple(size):
        resized = img  # long side already == scale: cv2.resize is the identity
    else:
        import cv2

        resized = cv2.resize(img, desirable[::-1], interpolation=cv2.INTER_AREA)
    if max_ind == 0:
        pad = scale - resized.shape[1]
        pads = [(0, 0), (int(np.floor(pad / 2)), int(np.ceil(pad / 2)))]
    else:
        pad = scale - resized.shape[0]
        pads = [(int(np.floor(pad / 2)), int(np.ceil(pad / 2))), (0, 0)]
    if resized.ndim == 3:
        pads.append((0, 0))
    return np.pad(resized, pads, "constant", constant_values=0)


def to_rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.repeat(img[:, :, None], 3, axis=2)
    return img


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[top : top + size, left : left + size]


def norm_constants(mode: str | None) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """(mean, std) of the post-ToTensor Normalize for ``mode``; the one source
    for host and device normalization.  Raises on unknown modes."""
    if mode == "imagenet":
        return tuple(IMAGENET_MEAN), tuple(IMAGENET_STD)
    if mode == "half":
        return (0.5,) * 3, (0.5,) * 3
    if mode in (None, "none"):
        return (0.0,) * 3, (1.0,) * 3
    raise NotImplementedError(f"normalization not implemented: {mode}")


def normalize(img: np.ndarray, mode: str | None) -> np.ndarray:
    """uint8 HWC → float32 HWC in normalized range (ToTensor + Normalize)."""
    mean, std = norm_constants(mode)
    x = img.astype(np.float32) / 255.0
    if mode in (None, "none"):
        return x
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def build_transformation(cfg: Config, split: str) -> Callable[[np.ndarray], np.ndarray]:
    """Eval transform (``split`` != 'train'): to_rgb, CenterCrop when the
    config has a crop size, ToTensor + Normalize."""
    if split == "train":
        raise NotImplementedError("train augmentations are not ported yet; use an eval split")
    t = cfg.transforms or Config()

    def apply(img: np.ndarray) -> np.ndarray:
        img = to_rgb(img)
        if t.random_crop is not None:
            img = center_crop(img, int(t.random_crop.crop_size))
        return normalize(np.ascontiguousarray(img), t.norm)

    return apply
