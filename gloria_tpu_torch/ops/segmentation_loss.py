"""Segmentation and classification losses: Dice, Focal, Mixed, BCE.

Port of ``gloria_tpu.ops.segmentation_loss`` (the reference's numerics,
quirks included):

- ``dice_coefficient`` applies the sigmoid and returns the *score* over the
  whole batch flattened;
- ``dice_loss`` is per sample, with NO sigmoid, ``1 − (Σ p·t + s) /
  (Σ p^p + t^p + s)``;
- ``focal_loss`` is the numerically stabilized BCE-with-logits focal form;
- ``mixed_loss = α·focal − log(dice_coefficient)``;
- ``bce_with_logits``: torch ``BCEWithLogitsLoss`` (mean, optional
  ``pos_weight``) in JAX's form, ``−(w·t·log σ(x) + (1 − t)·log σ(−x))``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_coefficient(logits: torch.Tensor, target: torch.Tensor,
                     smooth: float = 1.0) -> torch.Tensor:
    pred = torch.sigmoid(logits).reshape(-1)
    t = target.reshape(-1)
    intersection = (pred * t).sum()
    return (2.0 * intersection + smooth) / (pred.sum() + t.sum() + smooth)


def dice_loss(predict: torch.Tensor, target: torch.Tensor, smooth: float = 1.0,
              p: float = 2.0, reduction: str = "mean") -> torch.Tensor:
    b = predict.shape[0]
    pred = predict.reshape(b, -1)
    t = target.reshape(b, -1)
    num = (pred * t).sum(-1) + smooth
    den = (pred**p + t**p).sum(-1) + smooth
    loss = 1 - num / den
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"unexpected reduction {reduction}")


def focal_loss(logits: torch.Tensor, target: torch.Tensor, gamma: float = 2.0) -> torch.Tensor:
    max_val = torch.clamp(-logits, min=0)
    loss = (logits - logits * target + max_val
            + torch.log(torch.exp(-max_val) + torch.exp(-logits - max_val)))
    invprobs = F.logsigmoid(-logits * (target * 2.0 - 1.0))
    return (torch.exp(invprobs * gamma) * loss).mean()


def mixed_loss(logits: torch.Tensor, target: torch.Tensor, alpha: float = 10.0,
               gamma: float = 2.0) -> torch.Tensor:
    return alpha * focal_loss(logits, target, gamma) - torch.log(dice_coefficient(logits, target))


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor,
                    pos_weight: torch.Tensor | None = None) -> torch.Tensor:
    log_p = F.logsigmoid(logits)
    log_not_p = F.logsigmoid(-logits)
    if pos_weight is None:
        loss = -(target * log_p + (1.0 - target) * log_not_p)
    else:
        loss = -(pos_weight * target * log_p + (1.0 - target) * log_not_p)
    return loss.mean()
