"""Train state and the GLoRIA pretrain / eval steps.

Port of ``gloria_tpu.training.train`` for one batch per optimizer update
(``accum_steps=1``, ``steps_per_dispatch=1``).  A train step runs the model
in train mode (BatchNorm on batch statistics, BERT dropout from a
``torch.Generator`` seeded by the state's seed and step), ``calc_loss``,
the backward pass (the local loss's similarity matrix through the K1/K2
kernels on a card), the global norm of the unclipped gradients, the
optimizer update, and the BatchNorm running statistics, which a step that
the non-finite guard skips leaves as they were.  PyTorch runs eagerly, so
there is nothing to compile: the steps are plain functions.

The freeze flags come in through the optimizer's trainable mask
(``optim.freeze_wrap``, which ``builder.build_optimizer`` applies): the
update skips the frozen parameters, while ``grad_norm`` stays the norm of
every gradient, as in JAX.  Not ported yet, and refused by
:func:`make_pretrain_steps`: gradient accumulation, several steps per
dispatch and training the image transformer; ``calc_loss`` refuses the
flat-attention ablation losses.  A batch with ``segmentation_labels``
trains the attention-supervision term when the config weights it.  With
``return_attn`` (the localization callbacks), the train step also returns
the attention and the per-pair similarities, detached, as the eval step
always does.

Precision: the steps run at the model's compute dtype (``GLoRIA(cfg,
dtype=...)``), train and eval alike, as JAX's steps run its module's.  The
parameters, their gradients, ``grad_norm``, the optimizer state and the
BatchNorm running statistics stay f32 at every dtype (JAX takes the
gradient against its f32 params, with no loss scaling), so the update, the
non-finite guard and the restore of the statistics are the same code;
:func:`make_pretrain_steps` refuses a model whose parameters or buffers
were cast instead.  ``_attn`` and the metrics come out f32.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..configs import Config
from ..models.gloria_model import GLoRIA
from ..models.norm import BatchNorm2d
from ..models.precision import require_float32_state
from ..ops import gloria_loss
from ..utils.device import resolve_device
from .optim import Optimizer, OptState, global_norm

_LONG_KEYS = ("caption_ids", "attention_mask", "token_type_ids", "cap_lens")


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module  # parameters and BatchNorm running statistics
    opt_state: OptState
    step: int
    seed: int              # with ``step``, seeds the dropout masks


def create_train_state(model: torch.nn.Module, optimizer: Optimizer, seed: int = 0,
                       device=None) -> TrainState:
    """Moves ``model`` to ``device`` (the card unless the caller names
    another) and sets up the optimizer state over its trainable parameters."""
    model.to(resolve_device(device))
    params = optimizer.select(list(model.parameters()))
    return TrainState(model=model, opt_state=optimizer.init(params), step=0, seed=int(seed))


def _refuse_unported(cfg: Config) -> None:
    m = cfg.model or Config()
    trainer = cfg.lightning.trainer if cfg.lightning and cfg.lightning.trainer else Config()
    unported = {  # key: (set?, the ROADMAP.md item that ports it)
        "model.image_transformer": (m.image_transformer, "A1.7"),
        "lightning.trainer.accumulate_grad_batches": (
            int(trainer.accumulate_grad_batches or 1) > 1, "A1.8"),
        "train.steps_per_dispatch": (
            int((cfg.train.steps_per_dispatch if cfg.train else None) or 1) > 1, "A1.8"),
    }
    for key, (value, item) in unported.items():
        if value:
            raise NotImplementedError(f"{key}: training with it is not ported yet "
                                      f"(queued in ROADMAP.md {item})")


def to_device(batch: dict, device: torch.device) -> dict:
    """numpy arrays or tensors → tensors on ``device``: ids, masks and
    cap_lens as int64, uint8 images as they are, the rest as float32.  The
    collate's host-only keys (leading underscore: words, order, ids) pass
    through untouched."""
    out = {}
    for k, v in batch.items():
        if k.startswith("_"):
            out[k] = v
            continue
        x = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        if k in _LONG_KEYS:
            x = x.long()
        elif x.dtype != torch.uint8:
            x = x.float()
        out[k] = x.to(device, non_blocking=True)
    return out


def _dropout_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed << 32) + step)


@torch.no_grad()
def attention_outputs(model: GLoRIA, batch: dict, img_l, img_g, txt_l, txt_g, attn) -> dict:
    """The host-only metrics of a step: the diagonal attention maps
    (``_attn`` [B, W, R]) and the per-pair eval-path similarities
    (``_local_sims``, ``_global_sims`` [B], temperatures 4 and 5 as the
    reference's eval), all detached."""
    return {
        "_attn": attn.detach(),
        "_local_sims": gloria_loss.local_similarities_eval_diag(
            img_l.detach(), txt_l.detach(), batch["cap_lens"], temp1=4.0, temp2=5.0,
            sink=model.no_attn_vec),
        "_global_sims": gloria_loss.global_similarities(img_g.detach(), txt_g.detach()).diagonal(),
    }


def loss_and_grads(model: GLoRIA, batch: dict, generator: torch.Generator | None = None,
                   return_attn: bool = False):
    """Train-mode forward, ``calc_loss`` and the backward pass on a batch
    already on the model's device.  Returns (metrics, gradients in the
    order of ``model.parameters()``); a parameter the loss does not reach
    (BERT's pooler) gets zeros, as in JAX.  ``return_attn`` adds
    :func:`attention_outputs` to the metrics."""
    params = list(model.parameters())
    model.train()
    img_l, img_g, txt_l, txt_g, grid = model(batch, generator=generator)
    loss, metrics, attn = model.calc_loss(img_l, img_g, txt_l, txt_g, batch["cap_lens"], grid,
                                          batch.get("segmentation_labels"))
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if gr is None else gr for gr, p in zip(grads, params)]
    device = params[0].device
    out = {k: torch.as_tensor(v, device=device).detach() for k, v in metrics.items()}
    if return_attn:
        out.update(attention_outputs(model, batch, img_l, img_g, txt_l, txt_g, attn))
    return out, grads


def make_pretrain_steps(model: GLoRIA, optimizer: Optimizer,
                        return_attn: bool = False) -> tuple[Callable, Callable]:
    """Returns (train_step(state, batch) -> (state, metrics),
    eval_step(state, batch) -> metrics).

    ``batch`` holds numpy arrays or tensors: imgs [B, H, W, 3],
    caption_ids / attention_mask / token_type_ids [B, T], word_assignment
    [B, W, T], cap_lens [B], optionally segmentation_labels [B, H, W] and
    the collate's host-only ``_`` keys.  Metrics are 0-d tensors on the
    model's device: loss, local_loss0/1, global_loss0/1, no_attn_loss and
    attn_seg_loss (when configured),
    grad_norm and, with the non-finite guard on, nonfinite_steps; with
    ``return_attn``, also :func:`attention_outputs` of the train-mode
    forward.  The train step updates ``state`` in place and returns it."""
    _refuse_unported(model.cfg)
    require_float32_state(model)
    params = list(model.parameters())
    trainable = optimizer.select(params)
    bn_stats = [buf for m in model.modules() if isinstance(m, BatchNorm2d)
                for buf in (m.running_mean, m.running_var)]

    def train_step(state: TrainState, batch: dict):
        device = params[0].device
        b = to_device(batch, device)
        old_stats = [s.clone() for s in bn_stats] if optimizer.skip_nonfinite else None
        metrics, grads = loss_and_grads(
            model, b, generator=_dropout_generator(state.seed, state.step, device),
            return_attn=return_attn)
        metrics["grad_norm"] = global_norm(grads)
        grads = optimizer.select(grads)
        norm = metrics["grad_norm"] if optimizer.trainable is None else global_norm(grads)
        updates = optimizer.update(grads, state.opt_state, trainable, norm)
        with torch.no_grad():
            torch._foreach_add_(trainable, updates)
            if old_stats is not None:
                # the guard zeroes the update of a non-finite step, but its
                # forward has already moved the running statistics: undo that
                ok = torch.isfinite(metrics["grad_norm"])
                for s, old in zip(bn_stats, old_stats):
                    s.copy_(torch.where(ok, s, old))
        if state.opt_state.total_notfinite is not None:
            metrics["nonfinite_steps"] = state.opt_state.total_notfinite.clone()
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        """calc_loss in eval mode, plus :func:`attention_outputs`."""
        model.eval()
        b = to_device(batch, params[0].device)
        img_l, img_g, txt_l, txt_g, grid = model(b)
        _, metrics, attn = model.calc_loss(img_l, img_g, txt_l, txt_g, b["cap_lens"], grid,
                                           b.get("segmentation_labels"))
        return dict(metrics) | attention_outputs(model, b, img_l, img_g, txt_l, txt_g, attn)

    return train_step, eval_step
