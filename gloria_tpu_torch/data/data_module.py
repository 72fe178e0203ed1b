"""Data modules: cfg → per-split loaders, for the pretrain phase.

The port's own copy of ``gloria_tpu.data.data_module``: ``chexpert`` and the
hermetic ``synthetic`` module build image-report datasets, a
:class:`~.collate.GloriaCollate` per split (seeds 0, 1, 2) sharing one
tokenizer, and a :class:`~.loader.PrefetchLoader` whose ``to_device``
moves the arrays to the module's device with ``training.train.to_device``
and passes the collate's host-only ``_`` keys through.

Not ported yet, and refused: the classification and segmentation phases
(ROADMAP.md A5) and the ``pneumonia``, ``pneumothorax`` (A5) and
``imagenome`` (A6) modules.  The loader runs as one process
(``process_index`` 0 of 1) until the multi-device slice (A7).
"""

from __future__ import annotations

from typing import Any

import torch

from ..configs import Config
from ..training.train import to_device
from ..utils.device import resolve_device
from .collate import GloriaCollate
from .loader import PrefetchLoader
from .pretraining_dataset import CheXpertPretrainingDataset, SyntheticPretrainingDataset
from .tokenizer import WordPieceTokenizer, load_tokenizer

_UNPORTED_MODULES = {"pneumonia": "A5", "pneumothorax": "A5", "imagenome": "A6"}


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

    # subclasses implement
    def dataset(self, split: str):
        raise NotImplementedError

    def collate(self, split: str):
        raise NotImplementedError

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


class _PretrainModule(DataModule):
    def __init__(self, cfg: Config, **kw):
        if (cfg.phase or "pretrain").lower() != "pretrain":
            raise NotImplementedError(
                f"phase {cfg.phase!r}: only the pretrain phase's data is ported yet "
                "(the classification and segmentation data are queued in ROADMAP.md A5)")
        super().__init__(cfg, **kw)
        self.tokenizer = self._make_tokenizer()
        self._collates = {split: GloriaCollate(cfg, split, self.tokenizer, seed=i)
                          for i, split in enumerate(("train", "valid", "test"))}

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

    def collate(self, split: str) -> GloriaCollate:
        return self._collates[split]


class CheXpertDataModule(_PretrainModule):
    def dataset(self, split: str):
        return CheXpertPretrainingDataset(self.cfg, split)


class SyntheticDataModule(_PretrainModule):
    """Hermetic image-report pairs (:class:`SyntheticPretrainingDataset`),
    ``data.synthetic_size`` items per split (64 by default)."""

    def dataset(self, split: str):
        seeds = {"train": 0, "valid": 1, "test": 2}
        size = int(self.cfg.data.synthetic_size or 64) if self.cfg.data else 64
        imsize = int(self.cfg.data.image.imsize or 64)
        return SyntheticPretrainingDataset(size=size, imsize=imsize, seed=seeds[split])


DATA_MODULES: dict[str, Any] = {
    "chexpert": CheXpertDataModule,
    "synthetic": SyntheticDataModule,
}


def build_data_module(cfg: Config, device: torch.device | str | None = None) -> DataModule:
    name = (cfg.data.dataset or "synthetic").lower() if cfg.data else "synthetic"
    if name in _UNPORTED_MODULES:
        raise NotImplementedError(
            f"data.dataset {name!r} is not ported yet (queued in ROADMAP.md "
            f"{_UNPORTED_MODULES[name]})")
    return DATA_MODULES[name](cfg, device=device)
