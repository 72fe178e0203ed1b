"""Factory layer: cfg → model, optimizer, scheduler and steps.

The port's counterpart of ``gloria_tpu.builder``.  The model comes from
:func:`models.gloria_model.init_gloria` with an explicit seed; torch modules
need no example batch to build, so :func:`init_gloria` takes one only to
keep the JAX signature.  Not ported, and refused: the freeze flags
(ROADMAP.md A5, refused by ``training.train.make_pretrain_steps``) and
``train.loss_chunk`` (A1.8): the port's local loss has one route, the
K1/K2 kernels on a card and their plain versions on the CPU.
"""

from __future__ import annotations

import torch

from .configs import Config
from .models.gloria_model import GLoRIA
from .models.gloria_model import init_gloria as init_gloria_model
from .training import optim
from .training.train import TrainState, create_train_state, make_pretrain_steps


def default_pretrain_config() -> Config:
    """Schema-complete config mirroring ``configs/chexpert_pretrain_config.yaml``
    (the JAX package's ``default_pretrain_config``, value for value)."""
    return Config({
        "experiment_name": "gloria_pretrain",
        "phase": "pretrain",
        "lightning": {
            "trainer": {"max_epochs": 50, "gradient_clip_val": 0.25, "lr": 5.0e-5, "precision": 16},
            "checkpoint_callback": {"monitor": "val_loss", "save_last": True, "mode": "min",
                                    "save_top_k": 10},
            "early_stopping_callback": {"monitor": "val_loss", "min_delta": 0.0, "patience": 10,
                                        "mode": "min"},
        },
        "model": {
            "gloria": {"local_loss_weight": 1.0, "global_loss_weight": 1.0,
                       "temp1": 4.0, "temp2": 5.0, "temp3": 10.0},
            "vision": {"model_name": "resnet_50", "freeze_cnn": False, "pretrained": True},
            "text": {"bert_type": "emilyalsentzer/Bio_ClinicalBERT", "last_n_layers": 4,
                     "aggregate_method": "sum", "norm": False, "embedding_dim": 768,
                     "freeze_bert": False, "agg_tokens": True},
        },
        "data": {"dataset": "chexpert",
                 "text": {"word_num": 97, "captions_per_image": 5, "full_report": False},
                 "image": {"imsize": 256}},
        "transforms": {"norm": "half", "random_crop": {"crop_size": 224}},
        "train": {"batch_size": 48, "num_workers": 18,
                  "optimizer": {"name": "Adam", "weight_decay": 1.0e-6},
                  "scheduler": {"name": "plateau", "monitor": "val_loss", "interval": "epoch",
                                "frequency": 1}},
    })


def build_gloria_model(cfg: Config, seed: int = 0) -> GLoRIA:
    """A GLoRIA with random weights from ``torch.Generator(seed)``, on the CPU."""
    return init_gloria_model(cfg, seed=seed)


def build_optimizer(cfg: Config) -> optim.Optimizer:
    """``train.optimizer`` with ``lightning.trainer.gradient_clip_val``'s clip."""
    trainer = cfg.lightning.trainer if cfg.lightning and cfg.lightning.trainer else Config()
    clip = float(trainer.gradient_clip_val) if trainer.gradient_clip_val else None
    return optim.make_optimizer(cfg, grad_clip=clip)


def build_scheduler(cfg: Config) -> optim.LRScheduler:
    return optim.make_scheduler(cfg)


def steps_per_dispatch(cfg: Config) -> int:
    """``train.steps_per_dispatch`` (the port takes 1 only; A1.8)."""
    return max(1, int((cfg.train.steps_per_dispatch if cfg.train else None) or 1))


def accumulate_grad_batches(cfg: Config) -> int:
    """``lightning.trainer.accumulate_grad_batches`` (the port takes 1 only; A1.8)."""
    t = cfg.lightning.trainer if cfg.lightning and cfg.lightning.trainer else None
    return max(1, int((t.accumulate_grad_batches if t else None) or 1))


def init_gloria(cfg: Config, batch: dict | None = None, seed: int = 0,
                device: torch.device | str | None = None):
    """Model, optimizer state and steps: returns ``(model, state, train_step,
    eval_step)`` with the model on ``device`` (the card unless the caller
    names another).  ``batch`` is not needed (see the module docstring)."""
    if cfg.train and cfg.train.loss_chunk is not None:
        raise NotImplementedError("train.loss_chunk: the port's local loss has one route "
                                  "(queued in ROADMAP.md A1.8)")
    model = build_gloria_model(cfg, seed=seed)
    tx = build_optimizer(cfg)
    state: TrainState = create_train_state(model, tx, seed=seed, device=device)
    train_step, eval_step = make_pretrain_steps(model, tx)
    return model, state, train_step, eval_step
