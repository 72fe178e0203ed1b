"""Batch assembly: instances → fixed-shape arrays ready for the device.

The port's own copy of ``gloria_tpu.data.collate`` (the reference's
``GloriaCollateFn``):

- images: letterbox to ``data.image.imsize``, then the split's transform →
  NHWC float32, or uint8 when ``data.device_normalize`` moves the
  normalization into the model (off when color jitter is on);
- ``data.native_ingest``: letterbox, crop, flip and normalize in one call
  of the native library per batch (:mod:`.native`) when the train chain is
  only random crop and flip; crop offsets and flips are drawn per batch from
  the collate's own ``RandomState``.  Unlike the JAX package, which falls
  back to cv2 when its library is missing, the port raises;
- text: report cleanup + WordPiece + word-assignment matrices + cap_lens;
- sort by caption length, descending (output-order parity with the
  reference);
- ``segmentation_labels`` from each instance's bounding boxes: their union
  mask at the original resolution → letterbox → center crop;
- host-only keys, which never go to the device: ``_words``, ``_order``,
  ``_ids``, ``_indices``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..configs import Config
from .tokenizer import TextProcessor, WordPieceTokenizer
from .transforms import build_transformation, letterbox_resize, to_rgb


def bbox_to_mask(bbox, shape) -> np.ndarray:
    """[x1, y1, x2, y2] → binary mask [H, W]."""
    m = np.zeros(shape, dtype=np.float32)
    x1, y1, x2, y2 = (int(round(v)) for v in bbox)
    m[max(y1, 0) : max(y2, 0), max(x1, 0) : max(x2, 0)] = 1.0
    return m


def mask_to_bbox(mask: np.ndarray) -> list[float] | None:
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    return [float(xs.min()), float(ys.min()), float(xs.max() + 1), float(ys.max() + 1)]


class GloriaCollate:
    """Callable collate: list of {'image': HW(C) array, 'report': str,
    'bboxes': optional [[x1,y1,x2,y2],...], 'id', 'index'} → model batch dict.

    The transform's ``RandomState`` and ``_native_rng`` are shared by every
    call, so batches built on several threads at once take their draws in
    the order the threads reach them."""

    def __init__(self, cfg: Config, split: str, tokenizer: WordPieceTokenizer,
                 seed: int | None = None, sort_by_len: bool = True):
        self.cfg = cfg
        self.split = split
        self.imsize = int(cfg.data.image.imsize or 256)
        self.crop = (int(cfg.transforms.random_crop.crop_size)
                     if cfg.transforms and cfg.transforms.random_crop else self.imsize)
        t = cfg.transforms or Config()
        # color_jitter emits float pixel values a uint8 cast would truncate,
        # so jittered configs keep host-side normalization
        self.device_normalize = bool(cfg.data.device_normalize) and t.color_jitter is None
        self.transform = build_transformation(
            cfg, split, seed=seed, normalize_output=not self.device_normalize)
        self.text = TextProcessor(tokenizer, num_words=int(cfg.data.text.word_num or 97))
        self.sort_by_len = sort_by_len
        self._native_rng = np.random.RandomState(seed)
        simple_augs = t.random_affine is None and t.color_jitter is None
        # the *_normalize_batch calls fuse the 'half' normalization; under
        # device_normalize the *_u8_batch calls emit raw [N, s, s, 1] pixels
        self.native_ingest = bool(cfg.data.native_ingest and simple_augs
                                  and (self.device_normalize or (t.norm or "half") == "half"))
        if self.native_ingest:
            from . import native

            native.load()  # raises when the library cannot be built or loaded

    def process_img(self, images: list[np.ndarray]) -> np.ndarray:
        if self.native_ingest:
            return self._process_img_native(images)
        out = []
        for im in images:
            if im.dtype != np.uint8:
                lo, hi = float(im.min()), float(im.max())
                im = ((im - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)
            im = letterbox_resize(to_rgb(im), self.imsize)
            out.append(self.transform(im))
        stacked = np.stack(out)
        return stacked if self.device_normalize else stacked.astype(np.float32)

    def _process_img_native(self, images: list[np.ndarray]) -> np.ndarray:
        from . import native

        imgs_u8 = [im if im.dtype == np.uint8 else
                   ((im - im.min()) / (im.max() - im.min() + 1e-8) * 255).astype(np.uint8)
                   for im in images]
        n = len(imgs_u8)
        if self.crop == self.imsize and self.split != "train":
            if self.device_normalize:
                return native.letterbox_u8_batch(imgs_u8, self.imsize)
            return native.letterbox_normalize_batch(imgs_u8, self.imsize)
        if self.split == "train":
            max_off = self.imsize - self.crop
            tops = self._native_rng.randint(0, max_off + 1, size=n)
            lefts = self._native_rng.randint(0, max_off + 1, size=n)
            p_flip = float((self.cfg.transforms or Config()).random_horizontal_flip or 0.0)
            flips = (self._native_rng.rand(n) < p_flip).astype(np.int32)
        else:  # eval: deterministic center crop
            off = int(round((self.imsize - self.crop) / 2.0))
            tops = np.full(n, off)
            lefts = np.full(n, off)
            flips = np.zeros(n, np.int32)
        if self.device_normalize:
            return native.letterbox_crop_u8_batch(
                imgs_u8, self.imsize, self.crop, tops, lefts, flips)
        return native.letterbox_crop_normalize_batch(
            imgs_u8, self.imsize, self.crop, tops, lefts, flips)

    def process_text(self, reports: list[str]) -> dict:
        return self.text(reports)

    def segmentation_labels(self, instances: list[dict],
                            orig_shapes: list[tuple[int, int]]) -> np.ndarray:
        """Union-of-bboxes masks at the *cropped* training resolution: mask in
        original pixels → letterbox resize → center region crop."""
        labels = []
        for inst, shape in zip(instances, orig_shapes):
            mask = np.zeros(shape, np.float32)
            for bbox in inst.get("bboxes") or []:
                mask = np.maximum(mask, bbox_to_mask(bbox, shape))
            mask = letterbox_resize((mask * 255).astype(np.uint8), self.imsize)
            if self.crop != self.imsize:
                off = (self.imsize - self.crop) // 2
                mask = mask[off : off + self.crop, off : off + self.crop]
            labels.append((mask > 127).astype(np.float32))
        return np.stack(labels)

    def __call__(self, instances: list[dict]) -> dict[str, Any]:
        text = self.process_text([inst["report"] for inst in instances])
        order = np.arange(len(instances))
        if self.sort_by_len:
            order = np.argsort(-text["cap_lens"], kind="stable")
        batch = {
            "imgs": self.process_img([instances[i]["image"] for i in order]),
            "caption_ids": text["caption_ids"][order],
            "attention_mask": text["attention_mask"][order],
            "token_type_ids": text["token_type_ids"][order],
            "word_assignment": text["word_assignment"][order],
            "cap_lens": text["cap_lens"][order],
        }
        if any("bboxes" in inst for inst in instances):
            shapes = [np.asarray(instances[i]["image"]).shape[:2] for i in order]
            batch["segmentation_labels"] = self.segmentation_labels(
                [instances[i] for i in order], shapes)
        batch["_words"] = [text["words"][i] for i in order]
        batch["_order"] = order
        if all("id" in inst for inst in instances):
            batch["_ids"] = [instances[i]["id"] for i in order]
        if all("index" in inst for inst in instances):
            batch["_indices"] = np.asarray([instances[i]["index"] for i in order])
        return batch


def device_batch(batch: dict) -> dict:
    """Strip the host-only keys (leading underscore)."""
    return {k: v for k, v in batch.items() if not k.startswith("_")}
