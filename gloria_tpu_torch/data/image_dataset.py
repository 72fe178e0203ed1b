"""Downstream image datasets: CheXpert classification, SIIM pneumothorax
segmentation, RSNA pneumonia classification.

The port's own copy of ``gloria_tpu.data.image_dataset``:

- CheXpert: the 5 competition tasks, NaN → 0, uncertain (-1) → the per-task
  U-ones / U-zeros policy (``constants.CHEXPERT_UNCERTAIN_MAPPINGS``), the
  frontal filter, and ``data.frac`` of the train split sampled with
  ``random_state=42``;
- SIIM: DICOM read with MONOCHROME1 inversion, RLE → mask decode (with the
  reference's column-major transpose), positive/negative balancing for
  segmentation, and a joint scale-and-rotate train augmentation drawn from
  the dataset's ``rng``;
- RSNA: DICOM read, binary target.

``pydicom`` is imported only to read a DICOM file; PNG and JPG paths go
through cv2.  ``cv2`` and ``pandas`` are imported inside the functions that
use them.  Every dataset yields instance dicts that
:class:`SupervisedCollate` turns into ``{"imgs", "labels", "_ids"}``
batches.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np

from .. import constants
from ..configs import Config
from .transforms import build_transformation, letterbox_resize, to_rgb


def read_dicom(img_path: str) -> np.ndarray:
    """DICOM → uint8 grayscale, MONOCHROME1 inverted; PNG/JPG by extension."""
    import cv2

    if str(img_path).lower().endswith((".png", ".jpg", ".jpeg")):
        return cv2.imread(str(img_path), 0)
    import pydicom

    dcm = pydicom.dcmread(img_path)
    x = dcm.pixel_array
    x = cv2.convertScaleAbs(x, alpha=(255.0 / x.max()))
    if dcm.PhotometricInterpretation == "MONOCHROME1":
        x = cv2.bitwise_not(x)
    return x


def rle2mask(rle: str, width: int, height: int) -> np.ndarray:
    """Run-length encoding (relative starts) → float mask [height, width],
    filled column-major as the reference does."""
    mask = np.zeros(width * height)
    array = np.asarray([int(x) for x in rle.split()])
    pos = 0
    for start, length in zip(array[0::2], array[1::2]):
        pos += start
        mask[pos : pos + length] = 1
        pos += length
    return mask.reshape(width, height).T


def _sample_frac(df, cfg: Config, split: str):
    frac = (cfg.data.frac if cfg.data else None) or 1
    if frac != 1 and split == "train":
        df = df.sample(frac=frac, random_state=42)
    return df


class CheXpertImageDataset:
    def __init__(self, cfg: Config, split: str = "train", img_type: str = "Frontal"):
        import pandas as pd

        csv = {"train": constants.CHEXPERT_TRAIN_CSV,
               "valid": constants.CHEXPERT_VALID_CSV}.get(split, constants.CHEXPERT_TEST_CSV)
        df = _sample_frac(pd.read_csv(csv), cfg, split)
        if img_type != "All":
            df = df[df[constants.CHEXPERT_VIEW_COL] == img_type]
        df[constants.CHEXPERT_PATH_COL] = df[constants.CHEXPERT_PATH_COL].apply(
            lambda x: os.path.join(constants.CHEXPERT_DATA_DIR, "/".join(str(x).split("/")[1:])))
        df = df.fillna(0)
        uncertain_mask = {k: -1 for k in constants.CHEXPERT_COMPETITION_TASKS}
        df = df.replace(uncertain_mask, constants.CHEXPERT_UNCERTAIN_MAPPINGS)
        self.df = df.reset_index(drop=True)
        self.cfg = cfg
        self.split = split

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, index: int) -> dict:
        import cv2

        row = self.df.iloc[index]
        img = cv2.imread(str(row[constants.CHEXPERT_PATH_COL]), 0)
        y = np.asarray(list(row[constants.CHEXPERT_COMPETITION_TASKS]), np.float32)
        return {"image": img, "labels": y, "id": row[constants.CHEXPERT_PATH_COL]}


class PneumothoraxImageDataset:
    def __init__(self, cfg: Config, split: str = "train",
                 rng: np.random.RandomState | None = None):
        import pandas as pd

        rng = rng or np.random.RandomState(42)
        csv = {"train": constants.PNEUMOTHORAX_TRAIN_CSV,
               "valid": constants.PNEUMOTHORAX_VALID_CSV}.get(split, constants.PNEUMOTHORAX_TEST_CSV)
        df = pd.read_csv(csv)
        df["class"] = df[" EncodedPixels"].apply(lambda x: x != " -1")
        self.segmentation = (cfg.phase or "").lower() == "segmentation"
        if self.segmentation and split == "train":
            # negatives balanced down to the positive count
            pos, neg = df[df["class"]], df[~df["class"]]
            chosen = rng.choice(neg["ImageId"].unique(), size=pos["ImageId"].nunique(),
                                replace=False)
            df = pd.concat([pos, neg[neg["ImageId"].isin(chosen)]])
        frac = (cfg.data.frac if cfg.data else None) or 1
        if frac != 1 and split == "train":
            ids = df["ImageId"].unique()
            chosen = rng.choice(ids, size=int(len(ids) * frac), replace=False)
            df = df[df["ImageId"].isin(chosen)]
        self.df = df
        self.imgids = df.ImageId.unique().tolist()
        self.by_id = df.groupby("ImageId")
        self.cfg = cfg
        self.split = split
        self.rng = rng

    def __len__(self) -> int:
        return len(self.imgids)

    def __getitem__(self, index: int) -> dict:
        imgid = self.imgids[index]
        group = self.by_id.get_group(imgid)
        x = to_rgb(read_dicom(group.iloc[0]["Path"]))
        out: dict[str, Any] = {"id": imgid}
        if not self.segmentation:
            out["image"] = x
            out["labels"] = np.asarray([float(group.iloc[0]["Label"])], np.float32)
            return out
        import cv2

        size = constants.PNEUMOTHORAX_IMG_SIZE
        rle_list = group[" EncodedPixels"].tolist()
        mask = np.zeros([size, size])
        if rle_list[0] != " -1":
            for rle in rle_list:
                mask += rle2mask(rle, size, size)
        mask = (mask >= 1).astype("float32")
        imsize = int(self.cfg.data.image.imsize or 512)
        mask = letterbox_resize(mask, imsize)
        x = letterbox_resize(x, imsize)
        if self.split == "train" and self.rng.rand() < 0.5:
            # scale ±0.1 and rotate ±10°, image and mask together
            angle = self.rng.uniform(-10, 10)
            scale = self.rng.uniform(0.9, 1.1)
            h, w = x.shape[:2]
            m = cv2.getRotationMatrix2D((w * 0.5, h * 0.5), angle, scale)
            x = cv2.warpAffine(x, m, (w, h), borderValue=0)
            mask = cv2.warpAffine(mask, m, (w, h), borderValue=0)
        out["image"] = x
        out["labels"] = (mask > 0.5).astype(np.float32)
        return out


class PneumoniaImageDataset:
    def __init__(self, cfg: Config, split: str = "train"):
        import pandas as pd

        csv = {"train": constants.PNEUMONIA_TRAIN_CSV,
               "valid": constants.PNEUMONIA_VALID_CSV}.get(split, constants.PNEUMONIA_TEST_CSV)
        df = pd.read_csv(csv)
        if (cfg.phase or "") == "detection":
            df = df[df["Target"] == 1]
        self.df = _sample_frac(df, cfg, split).reset_index(drop=True)
        self.cfg = cfg

    def __len__(self) -> int:
        return len(self.df)

    def __getitem__(self, index: int) -> dict:
        row = self.df.iloc[index]
        return {
            "image": read_dicom(row["Path"]),
            "labels": np.asarray([float(row["Target"])], np.float32),
            "id": row["Path"],
        }


class SupervisedCollate:
    """(image, labels) batches for classification and segmentation:
    classification images are letterboxed to ``data.image.imsize`` and go
    through the split's transform; segmentation images (already at the
    training size, as their masks) skip the letterbox and are only scaled
    to [-1, 1]."""

    def __init__(self, cfg: Config, split: str, segmentation: bool = False,
                 seed: int | None = None):
        self.cfg = cfg
        self.split = split
        self.segmentation = segmentation
        self.imsize = int(cfg.data.image.imsize or 256)
        self.transform = build_transformation(cfg, split, seed=seed)

    def __call__(self, instances: list[dict]) -> dict:
        imgs = []
        for inst in instances:
            im = inst["image"]
            if self.segmentation:
                imgs.append((to_rgb(im).astype(np.float32) / 255.0 - 0.5) / 0.5)
            else:
                imgs.append(self.transform(letterbox_resize(to_rgb(im), self.imsize)))
        return {
            "imgs": np.stack(imgs).astype(np.float32),
            "labels": np.stack([inst["labels"] for inst in instances]).astype(np.float32),
            "_ids": [inst.get("id") for inst in instances],
        }


class SyntheticImageDataset:
    """Hermetic classification and segmentation data: noise images, every
    odd one with a bright box (its class, or its mask)."""

    def __init__(self, size: int = 64, imsize: int = 64, num_classes: int = 5,
                 segmentation: bool = False, seed: int = 0):
        self.size, self.imsize, self.num_classes = size, imsize, num_classes
        self.segmentation = segmentation
        self.seed = seed

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.RandomState(self.seed * 7919 + idx)
        img = (rng.rand(self.imsize, self.imsize) * 255).astype(np.uint8)
        x, y = rng.randint(0, self.imsize // 2, size=2)
        w, h = rng.randint(self.imsize // 8, self.imsize // 3, size=2)
        bright = idx % 2 == 1
        if bright:
            img[y : y + h, x : x + w] = np.minimum(255, img[y : y + h, x : x + w] + 100)
        if self.segmentation:
            mask = np.zeros((self.imsize, self.imsize), np.float32)
            if bright:
                mask[y : y + h, x : x + w] = 1
            return {"image": img, "labels": mask, "id": f"synth/{idx}"}
        labels = np.zeros(self.num_classes, np.float32)
        labels[idx % self.num_classes] = float(bright)
        return {"image": img, "labels": labels, "id": f"synth/{idx}"}
