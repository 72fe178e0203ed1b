"""Downstream task programs: classification and segmentation.

Port of ``gloria_tpu.training.tasks`` (the reference's Lightning
``ClassificationModel`` and ``SegmentationModel``):

- classification: a linear probe or finetune over a pretrained GLoRIA image
  encoder (``PretrainedImageClassifier``) or a backbone from scratch
  (``ImageClassifier``), BCE, epoch-level mean per-class AUROC and AUPRC,
  the test results written to ``results.csv``;
- segmentation: the ResNet U-Net, Dice, Focal or Mixed loss, the dice
  metric with the reference's empty-mask convention.

A train step runs the model in train mode (BatchNorm on batch statistics,
its running averages moving, a frozen backbone's too, as JAX's mutable
``batch_stats`` do), the loss on the squeezed logits and labels, the
gradients of the trainable parameters only, and the optimizer's update
(the non-finite guard and the clip over those gradients, as
``optax.multi_transform`` gives the inner chain only the trainable leaves).
Frozen parameters get ``requires_grad=False``, so their backward never runs
and they are never written.  One batch a step: accumulation is not ported
yet (ROADMAP.md A1.8).

The encoder moves from a GLoRIA checkpoint by state-dict surgery
(``checkpoints.extract_subtree`` / ``graft_subtree``): the whole
``img_encoder.*`` into the classifier, ``img_encoder.model.*`` into the
U-Net's ``backbone.*``.

One deliberate difference from the JAX driver: JAX's trainer keeps only
≤2-D eval outputs, so its segmentation extractor finds no logits and
raises at the first validation (shown by running the JAX ``run.py`` on a
segmentation config).  Here the validation step adds each sample's dice
[B] (``metrics.dice_per_sample``) and the extractor averages them, which
equals ``dice_score`` over the whole set.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from ..configs import Config
from ..models.resnet import init_weights_
from ..models.unet import ResnetUNet
from ..models.vision_model import ImageClassifier, PretrainedImageClassifier
from ..ops import segmentation_loss as segloss
from . import metrics as M
from .checkpoints import extract_subtree, graft_subtree
from .optim import Optimizer, global_norm
from .train import TrainState, create_train_state, to_device
from .trainer import Callback, _host_array

_GLORIA_BACKBONES = {"gloria_resnet50": "resnet_50", "gloria_resnet18": "resnet_18"}


def build_loss(cfg: Config) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``train.loss_fn`` → loss callable (BCE when absent)."""
    lf = (cfg.train.loss_fn or Config()) if cfg.train else Config()
    kind = lf.type or "BCE"
    if kind == "DiceLoss":
        return segloss.dice_loss
    if kind == "FocalLoss":
        return segloss.focal_loss
    if kind == "MixedLoss":
        alpha = float(lf.alpha or 10.0)
        return lambda logit, y: segloss.mixed_loss(logit, y, alpha=alpha)
    if kind == "BCE":
        pos_weight = torch.tensor(lf.class_weights, dtype=torch.float32) if lf.class_weights else None
        return lambda logit, y: segloss.bce_with_logits(
            logit, y, None if pos_weight is None else pos_weight.to(logit.device))
    raise NotImplementedError(f"{kind} not implemented yet")


def _backbone_name(cfg: Config) -> str:
    name = (cfg.model.vision.model_name if cfg.model and cfg.model.vision else None) or "resnet_50"
    return _GLORIA_BACKBONES.get(name, name)


class SupervisedTask:
    """Train and eval steps over (imgs [B, H, W, 3], labels) batches."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer: Optimizer,
                 accum_steps: int = 1):
        if int(accum_steps) > 1:
            raise NotImplementedError("lightning.trainer.accumulate_grad_batches > 1 in the "
                                      "task phases is not ported yet (queued in ROADMAP.md A1.8)")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        params = list(model.parameters())
        self.trainable = optimizer.select(params)
        kept = {id(p) for p in self.trainable}
        for p in params:
            p.requires_grad_(id(p) in kept)

    def init_state(self, seed: int = 0, device=None) -> TrainState:
        """The model on ``device`` (the card unless the caller names another)
        and the optimizer state over its trainable parameters."""
        return create_train_state(self.model, self.optimizer, seed=seed, device=device)

    def _loss(self, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        return self.loss_fn(torch.squeeze(logits), torch.squeeze(labels))

    def loss_and_grads(self, batch: dict):
        """Train-mode forward, the loss and its gradients on a batch already
        on the model's device: (loss, logits, gradients in the order of
        ``self.trainable``; zeros for a parameter the loss does not reach,
        as in JAX)."""
        self.model.train()
        logits = self.model(batch["imgs"])
        loss = self._loss(logits, batch["labels"])
        grads = torch.autograd.grad(loss, self.trainable, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, self.trainable)]
        return loss.detach(), logits.detach(), grads

    def train_step(self, state: TrainState, batch: dict):
        """One update; returns ``(state, {"loss", "logits"})``, ``state``
        updated in place."""
        loss, logits, grads = self.loss_and_grads(to_device(batch, self.trainable[0].device))
        updates = self.optimizer.update(grads, state.opt_state, self.trainable, global_norm(grads))
        with torch.no_grad():
            torch._foreach_add_(self.trainable, updates)
        state.step += 1
        return state, {"loss": loss, "logits": logits}

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch: dict) -> dict:
        b = to_device(batch, self.trainable[0].device)
        self.model.eval()
        logits = self.model(b["imgs"])
        return {"loss": self._loss(logits, b["labels"]), "logits": logits}

    def validation_step(self, state: TrainState, batch: dict) -> dict:
        """``eval_step`` plus what the epoch metrics read (the driver's eval
        step)."""
        return {**self.eval_step(state, batch), "labels": batch["labels"]}

    def metric_extractor(self, collected: list[dict]) -> dict:
        raise NotImplementedError


class ClassificationTask(SupervisedTask):
    """BCE + epoch AUROC/AUPRC."""

    @staticmethod
    def build_model(cfg: Config, gloria_state: dict | None = None, seed: int = 0):
        """(model with random weights from ``torch.Generator(seed)``, graft
        patch).  With a GLoRIA state dict the classifier is a
        ``PretrainedImageClassifier`` and the patch is its whole
        ``img_encoder``; without, an ``ImageClassifier`` and no patch."""
        num_cls = int(cfg.model.vision.num_targets or 1)
        name = _backbone_name(cfg)
        patch = None
        if gloria_state is not None:
            encoder = extract_subtree(gloria_state, "img_encoder.")
            model = PretrainedImageClassifier(
                name, output_dim=encoder["global_embedder.weight"].shape[0], num_classes=num_cls)
            patch = {"img_encoder.": encoder}
        else:
            model = ImageClassifier(name, num_classes=num_cls)
        init_weights_(model, torch.Generator().manual_seed(seed))
        return model, patch

    @staticmethod
    def epoch_metrics(logits: np.ndarray, labels: np.ndarray) -> dict:
        prob = torch.sigmoid(torch.as_tensor(np.asarray(logits, np.float32))).numpy()
        labels = np.asarray(labels)
        if labels.ndim == 1:
            labels, prob = labels[:, None], prob.reshape(-1, 1)
        return M.classification_metrics(labels, prob)

    def metric_extractor(self, collected: list[dict]) -> dict:
        if not collected:
            return {}
        logits = np.concatenate([c["logits"] for c in collected])
        labels = np.concatenate([c["labels"] for c in collected])
        return {f"val_{k}": v for k, v in self.epoch_metrics(logits, labels).items()}

    @staticmethod
    def write_results(cfg: Config, results: dict) -> None:
        """``results`` as JSON to ``<output_dir>/results.csv`` (the
        reference's file name)."""
        if cfg.output_dir:
            with open(os.path.join(cfg.output_dir, "results.csv"), "w") as fp:
                json.dump(results, fp)


class SegmentationTask(SupervisedTask):
    """U-Net + Mixed loss + the dice metric."""

    @staticmethod
    def build_model(cfg: Config, gloria_state: dict | None = None, seed: int = 0):
        """(U-Net with random weights from ``torch.Generator(seed)``, graft
        patch: the GLoRIA backbone into ``backbone.``, or None)."""
        model = ResnetUNet(_backbone_name(cfg), n_classes=1)
        init_weights_(model, torch.Generator().manual_seed(seed))
        patch = None
        if gloria_state is not None:
            patch = {"backbone.": extract_subtree(gloria_state, "img_encoder.model.")}
        return model, patch

    @staticmethod
    def epoch_metrics(logits: np.ndarray, labels: np.ndarray) -> dict:
        prob = torch.sigmoid(torch.as_tensor(np.asarray(logits, np.float32))).numpy()
        if prob.ndim == 4:
            prob = prob.squeeze(-1)
        return {"dice": M.dice_score(prob, np.asarray(labels))}

    @torch.no_grad()
    def validation_step(self, state: TrainState, batch: dict) -> dict:
        out = self.eval_step(state, batch)
        labels = torch.as_tensor(batch["labels"]).to(out["logits"].device)
        prob = torch.sigmoid(out["logits"]).squeeze(-1)
        return {**out, "labels": labels, "dice_per_sample": M.dice_per_sample(prob, labels)}

    def metric_extractor(self, collected: list[dict]) -> dict:
        if not collected:
            return {}
        per_sample = np.concatenate([c["dice_per_sample"] for c in collected])
        return {"val_dice": float(per_sample.mean()) if len(per_sample) else 0.0}


class LogSegmentationSamples(Callback):
    """Logs the first validation sample's input, mask, overlay and predicted
    probability through ``MetricLogger.log_image`` (the reference's W&B
    image logging)."""

    def on_validation_batch_end(self, trainer, state, metrics, batch, batch_idx):
        if batch_idx != 0 or "logits" not in metrics:
            return
        logger = getattr(trainer, "logger", None)
        if logger is None or not hasattr(logger, "log_image"):
            return
        img = _host_array(batch["imgs"][0]).astype(np.float32)
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-6)
        mask = _host_array(batch["labels"][0]).astype(np.float32).squeeze()
        prob = torch.sigmoid(torch.as_tensor(np.asarray(metrics["logits"][0]))).numpy().squeeze()
        layered = 0.5 * img[..., :3].mean(-1) + 0.5 * mask
        step = trainer.global_step
        logger.log_image("input_image", img, step)
        logger.log_image("mask", mask, step)
        logger.log_image("layered", layered, step)
        logger.log_image("pred", prob, step)


def graft_pretrained(state_dict: dict, patch: dict | None) -> dict:
    """``state_dict`` with each ``{prefix: subtree}`` of ``patch`` grafted in."""
    if patch is None:
        return state_dict
    for prefix, subtree in patch.items():
        state_dict = graft_subtree(state_dict, prefix, subtree)
    return state_dict
