"""Factory layer: cfg → model, optimizer, scheduler and steps.

The port's counterpart of ``gloria_tpu.builder``.  The model comes from
:func:`models.gloria_model.init_gloria` with an explicit seed; torch modules
need no example batch to build, so :func:`init_gloria` takes one only to
keep the JAX signature.  :func:`build_optimizer` applies the freeze flags
when the model is given (``training.optim.freeze_wrap``).  The downstream
tasks build their models in ``training.tasks``; like JAX, they dispatch one
batch a step, so ``train.steps_per_dispatch`` above 1 raises there.  Not
ported, and refused: ``train.loss_chunk`` (ROADMAP.md A1.8): the port's
local loss has one route, the K1/K2 kernels on a card and their plain
versions on the CPU.
"""

from __future__ import annotations

import torch

from .configs import Config
from .models.gloria_model import GLoRIA
from .models.gloria_model import init_gloria as init_gloria_model
from .models.precision import refuse_dtype
from .training import optim
from .training.checkpoints import restore_train_state
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


def build_gloria_model(cfg: Config, seed: int = 0, dtype: torch.dtype = torch.float32) -> GLoRIA:
    """A GLoRIA with random weights from ``torch.Generator(seed)``, on the CPU,
    computing in ``dtype`` (f32 parameters at every dtype)."""
    return init_gloria_model(cfg, seed=seed, dtype=dtype)


def build_optimizer(cfg: Config, model: torch.nn.Module | None = None) -> optim.Optimizer:
    """``train.optimizer`` with ``lightning.trainer.gradient_clip_val``'s clip;
    given ``model``, masked by the freeze flags when they freeze any of its
    parameters."""
    trainer = cfg.lightning.trainer if cfg.lightning and cfg.lightning.trainer else Config()
    clip = float(trainer.gradient_clip_val) if trainer.gradient_clip_val else None
    tx = optim.make_optimizer(cfg, grad_clip=clip)
    if model is not None:
        labels = optim.partition_trainable(model, optim.trainable_predicate(cfg))
        if "frozen" in labels.values():
            tx = optim.freeze_wrap(tx, labels)
    return tx


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
                device: torch.device | str | None = None, return_attn: bool = False,
                dtype: torch.dtype = torch.float32):
    """Model, optimizer state and steps: returns ``(model, state, train_step,
    eval_step)`` with the model on ``device`` (the card unless the caller
    names another).  ``batch`` is not needed (see the module docstring).
    ``return_attn``: the train step also returns the attention and the
    per-pair similarities (``training.train.make_pretrain_steps``).
    ``dtype``: the compute dtype of the model and its steps, float32 or
    bfloat16, as JAX's ``init_gloria(..., dtype=)``; the driver passes
    ``run.compute_dtype(cfg)``, bfloat16 at precision 16 or bf16."""
    if cfg.train and cfg.train.loss_chunk is not None:
        raise NotImplementedError("train.loss_chunk: the port's local loss has one route "
                                  "(queued in ROADMAP.md A1.8)")
    model = build_gloria_model(cfg, seed=seed, dtype=dtype)
    tx = build_optimizer(cfg, model)
    state: TrainState = create_train_state(model, tx, seed=seed, device=device)
    train_step, eval_step = make_pretrain_steps(model, tx, return_attn=return_attn)
    return model, state, train_step, eval_step


def init_task(cfg: Config, pretrained: dict | None = None, seed: int = 0,
              device: torch.device | str | None = None, resume_from: dict | None = None,
              dtype: torch.dtype = torch.float32):
    """The classification or segmentation phase (``cfg.phase``): returns
    ``(task, state)`` with the task model on ``device`` (the card unless the
    caller names another).

    ``pretrained`` is a GLoRIA state dict whose image encoder is grafted in
    (``training.tasks``); ``resume_from`` is a checkpoint payload of this
    task, whose weights, optimizer state and step are restored instead.
    ``model.vision.freeze_cnn`` masks the optimizer with the freeze flags,
    as the JAX driver does.  Like JAX, the tasks take one batch a dispatch:
    ``train.steps_per_dispatch`` above 1 raises ``ValueError``.  They compute
    in f32, as the JAX driver builds them: another ``dtype`` raises
    ``NotImplementedError`` (ROADMAP.md A1.2)."""
    from .training import tasks

    refuse_dtype(dtype, "the task phases", "A1.2")
    phase = (cfg.phase or "").lower()
    task_cls = {"classification": tasks.ClassificationTask,
                "segmentation": tasks.SegmentationTask}[phase]
    if steps_per_dispatch(cfg) > 1:
        raise ValueError("--steps_per_dispatch is pretrain-only; the classification and "
                         "segmentation tasks dispatch per batch")
    if resume_from is not None:  # the model's shape comes from its own checkpoint
        own = resume_from["model"]
        pretrained = (own if phase == "classification"
                      and any(k.startswith("img_encoder.") for k in own) else None)
    model, patch = task_cls.build_model(cfg, pretrained, seed=seed)
    if resume_from is None:
        model.load_state_dict(tasks.graft_pretrained(model.state_dict(), patch), strict=True)
    tx = build_optimizer(cfg)
    if cfg.model.vision.freeze_cnn:
        tx = optim.freeze_wrap(tx, optim.partition_trainable(model, optim.trainable_predicate(cfg)))
    task = task_cls(model, tasks.build_loss(cfg), tx, accum_steps=accumulate_grad_batches(cfg))
    state = task.init_state(seed=seed, device=device)
    if resume_from is not None:
        restore_train_state(state, resume_from, resume=True)
    return task, state
