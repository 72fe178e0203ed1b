"""Metrics of the downstream tasks: AUROC, average precision, dice.

Port of ``gloria_tpu.training.metrics`` (the attention metrics,
``topk_overlap_metrics`` and ``attention_entropy_np``, come with the
localization slice, ROADMAP.md A6):

- ``binary_auroc`` / ``binary_average_precision``: row-batched over the
  last axis, ties ranked as the JAX package ranks them (average ranks; a
  tie group's precision read at its end), NaN for a row without both
  classes (AP: without a positive).  Tensors in, tensors out, on any device;
  integer or boolean inputs are taken as f32, as in JAX;
- ``classification_metrics``: the mean over classes of AUROC and AUPRC,
  with the reference's NaN→0 guard and the JAX package's deviation: a
  single-class column scores AUROC 0 (the reference raises there) and keeps
  its AP (1.0 all positive, 0.0 all negative).  The JAX package calls
  sklearn; the port computes both in float64 with the functions above, so
  it needs no sklearn;
- ``dice_score``: the reference's ``get_dice``, an empty truth mask scoring
  1 when the prediction is empty too and 0 otherwise;
  ``dice_per_sample`` gives the per-sample values it averages.
"""

from __future__ import annotations

import numpy as np
import torch


def _rows(x: torch.Tensor) -> torch.Tensor:
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.float()
    return x.reshape(-1, x.shape[-1])


def _rankdata(scores: torch.Tensor) -> torch.Tensor:
    """Average ranks (1-based) with ties, per row."""
    order = torch.sort(scores, dim=-1).values.contiguous()
    left = torch.searchsorted(order, scores.contiguous(), side="left")
    right = torch.searchsorted(order, scores.contiguous(), side="right")
    return (left + right + 1).to(scores.dtype) / 2.0


def binary_auroc(scores, labels) -> torch.Tensor:
    """AUROC per row of ``scores`` / ``labels`` [..., P]."""
    s = _rows(scores)
    l = _rows(labels).to(s.dtype)
    ranks = _rankdata(s)
    npos = l.sum(-1)
    nneg = l.shape[-1] - npos
    auc = ((ranks * l).sum(-1) - npos * (npos + 1) / 2.0) / (npos * nneg)
    auc = torch.where((npos > 0) & (nneg > 0), auc, torch.full_like(auc, float("nan")))
    return auc.reshape(torch.as_tensor(scores).shape[:-1])


def binary_average_precision(scores, labels) -> torch.Tensor:
    """sklearn's ``average_precision_score`` per row, tie-exact:
    AP = Σ over positives of the precision at the end of its tie group / n_pos."""
    s = _rows(scores)
    l = _rows(labels).to(s.dtype)
    n = s.shape[-1]
    desc = torch.sort(-s, dim=-1).values.contiguous()  # ascending of the negated scores
    count_ge = torch.searchsorted(desc, (-s).contiguous(), side="right")  # scores ≥ s_i
    order = torch.argsort(-s, dim=-1, stable=True)
    cum_tp = torch.cumsum(torch.gather(l, -1, order), dim=-1)
    tp_ge = torch.gather(cum_tp, -1, (count_ge - 1).clamp(0, n - 1))
    prec = tp_ge / count_ge.clamp_min(1).to(s.dtype)
    npos = l.sum(-1)
    ap = (prec * l).sum(-1) / npos.clamp_min(1)
    ap = torch.where(npos > 0, ap, torch.full_like(ap, float("nan")))
    return ap.reshape(torch.as_tensor(scores).shape[:-1])


def classification_metrics(y: np.ndarray, prob: np.ndarray) -> dict:
    """Mean per-class AUROC and AUPRC of labels ``y`` and probabilities
    ``prob`` [N, C] (module docstring for the guards)."""
    y = torch.as_tensor(np.asarray(y, np.float64)).T
    prob = torch.as_tensor(np.asarray(prob, np.float64)).T
    auroc, auprc = [], []
    for y_cls, p_cls in zip(y, prob):
        if bool(torch.isnan(p_cls).any()):
            auroc.append(0.0)
            auprc.append(0.0)
            continue
        ap = float(binary_average_precision(p_cls, y_cls))
        auprc.append(0.0 if np.isnan(ap) else ap)  # all negative: sklearn's 0
        auroc.append(float(binary_auroc(p_cls, y_cls)) if len(torch.unique(y_cls)) > 1 else 0.0)
    return {"auroc": float(np.mean(auroc)), "auprc": float(np.mean(auprc))}


def dice_per_sample(probability, truth, threshold: float = 0.5) -> torch.Tensor:
    """Each sample's dice [B] (``dice_score``'s terms, in sample order), on
    the device of ``probability``."""
    prob = torch.as_tensor(probability)
    truth = torch.as_tensor(truth, device=prob.device)
    b = truth.shape[0]
    p = (prob.reshape(b, -1) > threshold).float()
    t = (truth.reshape(b, -1) > 0.5).float()
    t_sum, p_sum = t.sum(-1), p.sum(-1)
    dice_pos = 2 * (p * t).sum(-1) / (p + t).sum(-1).clamp_min(1e-12)
    return torch.where(t_sum == 0, (p_sum == 0).float(), dice_pos)


def dice_score(probability, truth, threshold: float = 0.5) -> float:
    """The mean of :func:`dice_per_sample` (0.0 for an empty batch)."""
    if len(truth) == 0:
        return 0.0
    return float(dice_per_sample(probability, truth, threshold).mean())
