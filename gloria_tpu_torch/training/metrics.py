"""Metrics: AUROC, average precision, dice, and the localization metrics.

Port of ``gloria_tpu.training.metrics``:

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
  ``dice_per_sample`` gives the per-sample values it averages;
- ``topk_overlap_metrics``: precision, recall, F1 and IoU of the top
  ``fraction`` of pixels per row, with the reference's strict ``>`` against
  the (k+1)-th largest score; ``attention_entropy_np``;
- ``roc_curve`` / ``precision_recall_curve``: one row's curves in numpy,
  equal to sklearn's functions of the same names (defaults:
  ``drop_intermediate`` on for the ROC, off for precision-recall), which
  the JAX package calls for the localization artifacts.
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


def topk_overlap_metrics(scores, labels, fraction: float, *, sorted_desc=None) -> dict:
    """Threshold each row of ``scores`` [..., P] at its top ``fraction`` of
    pixels: ``k = int(P·fraction)`` (k = 0 predicts nothing), the threshold
    is the (k+1)-th largest score and a pixel is predicted when it is
    strictly above it (under ties, fewer than k).  Returns precision,
    recall, f1 and iou [...] against ``labels``.  ``sorted_desc``, each
    row sorted descending, lets several fractions share one sort."""
    s = _rows(scores)
    l = _rows(labels).to(s.dtype)
    P = s.shape[-1]
    k = int(P * fraction)
    if sorted_desc is None:
        sorted_desc = -torch.sort(-s, dim=-1).values
    thresh = sorted_desc.reshape(-1, P)[:, k : k + 1]
    pred = (s > thresh).to(s.dtype)
    tp = (pred * l).sum(-1)
    fp = (pred * (1 - l)).sum(-1)
    fn = ((1 - pred) * l).sum(-1)
    precision = tp / (tp + fp).clamp_min(1e-12)
    recall = tp / (tp + fn).clamp_min(1e-12)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-12)
    iou = tp / (tp + fp + fn).clamp_min(1e-12)
    shape = torch.as_tensor(scores).shape[:-1]
    return {"precision": precision.reshape(shape), "recall": recall.reshape(shape),
            "f1": f1.reshape(shape), "iou": iou.reshape(shape)}


def attention_entropy_np(attn: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    p = np.maximum(attn, eps)
    return -(p * np.log(p)).sum(-1)


def _confusion_at_thresholds(y_true, y_score):
    """sklearn's ``confusion_matrix_at_thresholds`` without weights: the
    false and true positives (float64) above each distinct score, from the
    highest down, and those scores."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(-y_score, kind="stable")
    y_score, y_true = y_score[order], (y_true[order] == 1).astype(np.float64)
    idx = np.r_[np.nonzero(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score):
    """sklearn's ``roc_curve`` (binary 0/1 labels, no weights,
    ``drop_intermediate=True``): (fpr, tpr, thresholds), starting at
    (0, 0) with threshold inf; fpr (tpr) is NaN without a negative
    (positive) label."""
    fps, tps, thresholds = _confusion_at_thresholds(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score):
    """sklearn's ``precision_recall_curve`` (binary 0/1 labels, no weights,
    ``drop_intermediate=False``): (precision, recall, thresholds), recall
    decreasing, ending at (1, 0); recall is 1 throughout without a positive
    label."""
    fps, tps, thresholds = _confusion_at_thresholds(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps)
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1]
