"""Pretraining datasets: CheXpert image-report pairs + a synthetic set.

The port's own copy of ``gloria_tpu.data.pretraining_dataset`` (the
reference's ``MultimodalPretrainingDataset``): CSV-driven (path,
report-impression) pairs, frontal views only, a caption cache of cleaned
sentences per report (``captions_{split}.pkl`` in the data directory, the
JAX package's format), a random sentence or the full report per item, and a
grayscale read with cv2.  cv2 and pandas are imported only inside the
CheXpert dataset.

The synthetic dataset makes a deterministic corpus of radiology-style
sentences, images with a bright box where the first sentence says, and that
box, from ``(seed, idx)`` alone: the same items as the JAX package's.
"""

from __future__ import annotations

import pickle
import re
from pathlib import Path
from typing import Iterator

import numpy as np

from .. import constants
from ..configs import Config
from .tokenizer import clean_report

_SENT_SPLIT = re.compile(r"[0-9]+\.")


class CheXpertPretrainingDataset:
    """(image path, report) pairs from the CheXpert split CSV."""

    def __init__(self, cfg: Config, split: str = "train",
                 rng: np.random.RandomState | None = None):
        import cv2
        import pandas as pd

        self.cv2 = cv2
        self.cfg = cfg
        self.split = split
        self.rng = rng or np.random.RandomState(42)
        self.full_report = bool(cfg.data.text.full_report)

        csv_path = {
            "train": constants.CHEXPERT_TRAIN_CSV,
            "valid": constants.CHEXPERT_VALID_CSV,
            "test": constants.CHEXPERT_TEST_CSV,
        }[split]
        df = pd.read_csv(csv_path)
        df = df[df[constants.CHEXPERT_VIEW_COL] == "Frontal"]
        self.df = df.reset_index(drop=True)
        self.paths = self.df[constants.CHEXPERT_PATH_COL].tolist()
        self.reports = self.df.get(constants.CHEXPERT_REPORT_COL, "").fillna("").tolist()
        self.root = Path(constants.CHEXPERT_DATA_DIR).parent

        # caption cache keyed by path: cleaned sentences per report.  It is a
        # pickle this package (or the JAX package, same format) wrote itself
        cache = Path(constants.CHEXPERT_DATA_DIR) / f"captions_{split}.pkl"
        if cache.exists():
            self.captions = pickle.loads(cache.read_bytes())
        else:
            self.captions = {}
            for p, rep in zip(self.paths, self.reports):
                sents = [clean_report(s) for s in _SENT_SPLIT.split(str(rep))]
                self.captions[p] = [s for s in sents if s]
            try:
                cache.write_bytes(pickle.dumps(self.captions))
            except OSError:
                pass  # a read-only data directory: the cache is only a speed-up

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> dict:
        path = self.paths[idx]
        img = self.cv2.imread(str(self.root / path), 0)
        sents = self.captions.get(path) or [clean_report(str(self.reports[idx]))]
        if self.full_report:
            report = " ".join(sents)
        else:
            report = sents[self.rng.randint(len(sents))] if sents else ""
        return {"image": img, "report": report, "id": path, "index": idx}


_CONDITIONS = [
    "atelectasis", "cardiomegaly", "consolidation", "edema", "pleural effusion",
    "pneumothorax", "pneumonia", "lung opacity", "fracture", "no finding",
]
_LOCATIONS = [
    "at the left lung base", "at the right lung base", "in the upper lobe",
    "at the mid lung zone", "in the retrocardiac region", "bilaterally",
]
_SEVERITIES = ["mild", "moderate", "severe", "trace", "stable", "improving"]


class SyntheticPretrainingDataset:
    """Deterministic synthetic chest-X-ray-style pairs for hermetic runs."""

    def __init__(self, size: int = 256, imsize: int = 256, seed: int = 0):
        self.size = size
        self.imsize = imsize
        self.seed = seed

    def corpus(self) -> list[str]:
        return [self[i]["report"] for i in range(min(self.size, 64))]

    def __len__(self) -> int:
        return self.size

    # location phrase → box-center fractions: the box sits where the first
    # sentence says, so the pairs carry a real cross-modal signal
    _LOC_CENTERS = {
        "at the left lung base": (0.25, 0.8),
        "at the right lung base": (0.75, 0.8),
        "in the upper lobe": (0.5, 0.2),
        "at the mid lung zone": (0.5, 0.5),
        "in the retrocardiac region": (0.4, 0.65),
        "bilaterally": (0.5, 0.85),
    }
    # condition → brightness delta (so the condition word is also grounded)
    _COND_DELTAS = {c: 40 + 15 * i for i, c in enumerate(_CONDITIONS)}

    def __getitem__(self, idx: int) -> dict:
        rng = np.random.RandomState(self.seed * 100003 + idx)
        sents = []
        for _ in range(rng.randint(1, 4)):
            sents.append(
                f"{_SEVERITIES[rng.randint(len(_SEVERITIES))]} "
                f"{_CONDITIONS[rng.randint(len(_CONDITIONS))]} "
                f"{_LOCATIONS[rng.randint(len(_LOCATIONS))]}"
            )
        report = ". ".join(s.capitalize() for s in sents) + "."
        img = (rng.rand(self.imsize, self.imsize) * 255 * 0.5).astype(np.uint8)
        first = sents[0]
        location = next(loc for loc in _LOCATIONS if first.endswith(loc))
        condition = next(c for c in _CONDITIONS if f" {c} " in f" {first} ")
        cx, cy = self._LOC_CENTERS[location]
        w, h = rng.randint(self.imsize // 8, self.imsize // 4, size=2)
        x = int(np.clip(cx * self.imsize - w / 2 + rng.randint(-4, 5), 0, self.imsize - w))
        y = int(np.clip(cy * self.imsize - h / 2 + rng.randint(-4, 5), 0, self.imsize - h))
        delta = self._COND_DELTAS[condition]
        img[y : y + h, x : x + w] = np.minimum(
            255, img[y : y + h, x : x + w].astype(int) + delta
        ).astype(np.uint8)
        return {
            "image": img,
            "report": report,
            "id": f"synthetic/{idx}",
            "index": idx,
            "bboxes": [[float(x), float(y), float(x + w), float(y + h)]],
        }


def iterate_batches(
    dataset, collate, batch_size: int, *, shuffle: bool = True,
    seed: int = 0, drop_last: bool = True,
) -> Iterator[dict]:
    """Batches of ``dataset`` in one thread, in a ``RandomState(seed)`` order."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    for start in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
        idxs = order[start : start + batch_size]
        if drop_last and len(idxs) < batch_size:
            return
        yield collate([dataset[int(i)] for i in idxs])
