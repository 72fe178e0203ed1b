"""Data modules: cfg → per-split loaders, for every phase.

The port's own copy of ``gloria_tpu.data.data_module``.  In the pretrain
phase, ``chexpert`` and the hermetic ``synthetic`` module build image-report
datasets, a :class:`~.collate.GloriaCollate` per split (seeds 0, 1, 2)
sharing one tokenizer.  In the classification and segmentation phases,
``chexpert``, ``pneumonia``, ``pneumothorax`` and ``synthetic`` build the
image datasets of :mod:`.image_dataset` and a
:class:`~.image_dataset.SupervisedCollate` per split, seeded 0, 1, 2 as
well (the JAX package leaves its task collates unseeded, so its random
crops differ from run to run).  The :class:`~.loader.PrefetchLoader`'s
``to_device`` moves the arrays to the module's device with
``training.train.to_device`` and passes the collate's host-only ``_`` keys
through.

``imagenome`` (:class:`.mimic.ImaGenomeDataModule`, imported when asked
for) builds the ImaGenome grounding datasets behind the same collates.  The
loader runs as one process (``process_index`` 0 of 1) until the
multi-device slice (A7).
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs import Config
from ..training.train import to_device
from ..utils.device import resolve_device
from .collate import GloriaCollate
from .image_dataset import (CheXpertImageDataset, PneumoniaImageDataset,
                            PneumothoraxImageDataset, SupervisedCollate, SyntheticImageDataset)
from .loader import PrefetchLoader
from .pretraining_dataset import CheXpertPretrainingDataset, SyntheticPretrainingDataset
from .tokenizer import WordPieceTokenizer, load_tokenizer

_SPLIT_SEEDS = {"train": 0, "valid": 1, "test": 2}


def _phase(cfg: Config) -> str:
    return (cfg.phase or "pretrain").lower()


class DataModule:
    """Builds datasets, collates and loaders per split for one experiment
    cfg; batches land on ``device`` (the card unless the caller names
    another; with none named and no card, construction raises)."""

    def __init__(self, cfg: Config, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = int(cfg.train.batch_size or 8) if cfg.train else 8
        self.num_workers = int(cfg.train.num_workers or 8) if cfg.train else 8
        self.tokenizer: WordPieceTokenizer | None = None
        self._collates: dict = {}  # split → collate, set by the subclasses

    def dataset(self, split: str):  # subclasses implement
        raise NotImplementedError

    def collate(self, split: str):
        return self._collates[split]

    def to_device(self, batch: dict) -> dict:
        return to_device(batch, self.device)

    def loader(self, split: str, **kw) -> PrefetchLoader:
        return PrefetchLoader(
            self.dataset(split), self.collate(split), self.batch_size,
            shuffle=(split == "train"), num_workers=self.num_workers,
            drop_last=(split == "train"), to_device=self.to_device, **kw,
        )

    def train_dataloader(self):
        return self.loader("train")

    def val_dataloader(self):
        return self.loader("valid")

    def test_dataloader(self):
        return self.loader("test")


def _task_collates(cfg: Config) -> dict:
    seg = _phase(cfg) == "segmentation"
    return {split: SupervisedCollate(cfg, split, segmentation=seg, seed=seed)
            for split, seed in _SPLIT_SEEDS.items()}


class _TaskModule(DataModule):
    """The task phases' data: a :class:`SupervisedCollate` per split."""

    def __init__(self, cfg: Config, **kw):
        super().__init__(cfg, **kw)
        self._collates = _task_collates(cfg)


class _PretrainModule(DataModule):
    """Image-report pairs in the pretrain phase, images otherwise."""

    def __init__(self, cfg: Config, **kw):
        super().__init__(cfg, **kw)
        if _phase(cfg) != "pretrain":
            self._collates = _task_collates(cfg)
            return
        self.tokenizer = self._make_tokenizer()
        self._collates = {split: GloriaCollate(cfg, split, self.tokenizer, seed=seed)
                          for split, seed in _SPLIT_SEEDS.items()}

    def _make_tokenizer(self) -> WordPieceTokenizer:
        text_cfg = (self.cfg.model.text if self.cfg.model else None) or Config()
        try:
            return load_tokenizer(bert_type=text_cfg.bert_type, vocab_file=text_cfg.vocab_file)
        except ValueError:  # no vocab file and no HF cache: a vocabulary from the corpus
            ds = self.dataset("train")
            corpus = []
            for i in range(min(64, len(ds))):
                try:
                    corpus.append(ds[i]["report"])
                except Exception:  # a corrupt instance must not stop the module's build
                    continue
            return load_tokenizer(corpus=corpus or ["no finding"])


class CheXpertDataModule(_PretrainModule):
    def dataset(self, split: str):
        if _phase(self.cfg) == "pretrain":
            return CheXpertPretrainingDataset(self.cfg, split)
        return CheXpertImageDataset(self.cfg, split)


class PneumoniaDataModule(_TaskModule):
    def dataset(self, split: str):
        return PneumoniaImageDataset(self.cfg, split)


class PneumothoraxDataModule(_TaskModule):
    def dataset(self, split: str):
        return PneumothoraxImageDataset(self.cfg, split)


class SyntheticDataModule(_PretrainModule):
    """Hermetic data for every phase, ``data.synthetic_size`` items per split
    (64 by default): image-report pairs (:class:`SyntheticPretrainingDataset`)
    or images with ``model.vision.num_targets`` labels or a mask
    (:class:`SyntheticImageDataset`)."""

    def dataset(self, split: str):
        size = int(self.cfg.data.synthetic_size or 64) if self.cfg.data else 64
        imsize = int(self.cfg.data.image.imsize or 64)
        phase = _phase(self.cfg)
        if phase == "pretrain":
            return SyntheticPretrainingDataset(size=size, imsize=imsize, seed=_SPLIT_SEEDS[split])
        vision = self.cfg.model.vision if self.cfg.model else None
        return SyntheticImageDataset(
            size=size, imsize=imsize, num_classes=int((vision.num_targets if vision else None) or 5),
            segmentation=(phase == "segmentation"), seed=_SPLIT_SEEDS[split])


DATA_MODULES: dict[str, Any] = {
    "chexpert": CheXpertDataModule,
    "pneumonia": PneumoniaDataModule,
    "pneumothorax": PneumothoraxDataModule,
    "synthetic": SyntheticDataModule,
    # "imagenome": data/mimic.py's ImaGenomeDataModule, imported by build_data_module
}


def build_data_module(cfg: Config, device: torch.device | str | None = None) -> DataModule:
    name = (cfg.data.dataset or "synthetic").lower() if cfg.data else "synthetic"
    if name == "imagenome":
        from .mimic import ImaGenomeDataModule

        return ImaGenomeDataModule(cfg, device=device)
    return DATA_MODULES[name](cfg, device=device)
