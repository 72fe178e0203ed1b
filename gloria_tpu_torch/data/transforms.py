"""Host-side image pipeline: letterbox, crops, augmentations, normalization.

The port's own copy of ``gloria_tpu.data.transforms``:

- ``letterbox_resize``: cv2 ``INTER_AREA`` scale of the long side + centered
  zero padding.  When the long side already equals ``scale`` the resize is
  the identity and is skipped, so an image sent at ``imsize`` needs no cv2;
- ``build_transformation``: train = RandomCrop / RandomHorizontalFlip /
  RandomAffine / ColorJitter with torchvision's sampling semantics, drawn
  from one ``np.random.RandomState(seed)`` in the JAX package's order (one
  seed gives the same arrays in both packages); eval = CenterCrop; then
  scale-to-[0,1] + Normalize ('half' or 'imagenet').

cv2 is imported only inside the functions that resize or warp.  All
callables map HWC uint8/float → HWC float32 (uint8 with
``normalize_output=False``); batch helpers stack to NHWC.
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


# ---------------------------------------------------------------------------
# Augmentations (torchvision sampling semantics)
# ---------------------------------------------------------------------------

def random_crop(img: np.ndarray, size: int, rng: np.random.RandomState) -> np.ndarray:
    h, w = img.shape[:2]
    if h == size and w == size:
        return img
    top = rng.randint(0, h - size + 1)
    left = rng.randint(0, w - size + 1)
    return img[top : top + size, left : left + size]


def random_hflip(img: np.ndarray, p: float, rng: np.random.RandomState) -> np.ndarray:
    if rng.rand() < p:
        return img[:, ::-1]
    return img


def random_affine(
    img: np.ndarray,
    degrees: float | tuple[float, float],
    translate: tuple[float, float] | None,
    scale_range: tuple[float, float] | None,
    rng: np.random.RandomState,
) -> np.ndarray:
    """torchvision RandomAffine: rotation about center + translate + scale."""
    import cv2

    h, w = img.shape[:2]
    if isinstance(degrees, (int, float)):
        degrees = (-abs(degrees), abs(degrees))
    angle = rng.uniform(*degrees)
    tx = ty = 0.0
    if translate is not None:
        tx = rng.uniform(-translate[0], translate[0]) * w
        ty = rng.uniform(-translate[1], translate[1]) * h
    s = rng.uniform(*scale_range) if scale_range is not None else 1.0
    m = cv2.getRotationMatrix2D((w * 0.5, h * 0.5), angle, s)
    m[0, 2] += tx
    m[1, 2] += ty
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_NEAREST, borderValue=0)


def color_jitter(
    img: np.ndarray,
    brightness: tuple[float, float] | None,
    contrast: tuple[float, float] | None,
    rng: np.random.RandomState,
) -> np.ndarray:
    """torchvision ColorJitter with explicit (min, max) ranges, random order.
    The clip's upper bound is 255 for uint8 input and for float input whose
    maximum is above 2, else 1."""
    x = img.astype(np.float32)
    ops = []
    if brightness is not None:
        f = rng.uniform(*brightness)
        ops.append(lambda y: y * f)
    if contrast is not None:
        f2 = rng.uniform(*contrast)

        def _contrast(y):
            gray = (0.299 * y[..., 0] + 0.587 * y[..., 1] + 0.114 * y[..., 2]).mean()
            return y * f2 + gray * (1 - f2)

        ops.append(_contrast)
    for i in rng.permutation(len(ops)):
        x = ops[i](x)
    return np.clip(x, 0, 255.0 if img.dtype == np.uint8 or img.max() > 2 else 1.0)


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


def build_transformation(cfg: Config, split: str, seed: int | None = None,
                         normalize_output: bool = True) -> Callable[[np.ndarray], np.ndarray]:
    """The split's transform: to_rgb, the train augmentations the config
    names (split 'train') or CenterCrop (any other split), then ToTensor +
    Normalize.  The train augmentations draw from one
    ``np.random.RandomState(seed)`` shared by every call of the returned
    function.  ``normalize_output=False`` stops before ToTensor + Normalize
    and rounds back to uint8, for batches normalized on the device; a
    float-valued chain (color_jitter) must not take it."""
    t = cfg.transforms or Config()
    rng = np.random.RandomState(seed)

    def apply(img: np.ndarray) -> np.ndarray:
        img = to_rgb(img)
        if split == "train":
            if t.random_crop is not None:
                img = random_crop(img, int(t.random_crop.crop_size), rng)
            if t.random_horizontal_flip is not None:
                img = random_hflip(img, float(t.random_horizontal_flip), rng)
            if t.random_affine is not None:
                img = random_affine(
                    img, t.random_affine.degrees,
                    tuple(t.random_affine.translate) if t.random_affine.translate else None,
                    tuple(t.random_affine.scale) if t.random_affine.scale else None,
                    rng,
                )
            if t.color_jitter is not None:
                img = color_jitter(
                    img,
                    tuple(t.color_jitter.bightness) if t.color_jitter.bightness else None,  # sic: reference typo
                    tuple(t.color_jitter.contrast) if t.color_jitter.contrast else None,
                    rng,
                )
        elif t.random_crop is not None:
            img = center_crop(img, int(t.random_crop.crop_size))
        if not normalize_output:
            return np.clip(np.rint(np.ascontiguousarray(img)), 0, 255).astype(np.uint8)
        return normalize(np.ascontiguousarray(img), t.norm)

    return apply


def batch_images(imgs: list[np.ndarray], transform: Callable, imsize: int | None = None) -> np.ndarray:
    """letterbox (optional) + transform + stack → NHWC float32."""
    out = []
    for im in imgs:
        if imsize is not None:
            im = letterbox_resize(im, imsize)
        out.append(transform(im))
    return np.stack(out).astype(np.float32)
