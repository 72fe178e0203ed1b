"""Word-region localization: evaluation against boxes, instance reweighting.

The port's counterpart of ``gloria_tpu.training.localization`` (the
reference's ``EvaluateLocalization`` and ``WeightInstancesByLocalization``
callbacks):

- :class:`EvaluateLocalization`: each sentence's attention map (the mean
  over its valid words) is brought to the label's size (``upsample``,
  ``pyramid`` or ``windows``, :mod:`..utils.viz`) and scored against the
  union of its boxes: AUROC, average precision, precision / recall / F1 /
  IoU of the top 5, 10, 20 and 30% of pixels, the attention's entropy and
  its no-attention weight, plus the step's per-pair local and global
  similarities.  The rows go to ``<save_dir>/<split>/sentences.csv``, with
  ``attn`` / ``image`` / ``label`` (``.npy``) and ``roc_curve`` /
  ``pr_curve`` (``.npz``) folders when ``save_full_data``; the batch means
  go to the metric logger under ``localization/``.  The metrics of a batch
  are computed in one batched call on the batch's device (the card in the
  driver; JAX runs them on its device too), the overlays and curves on the
  host.  Each split's rows go to its own folder; JAX writes the validation
  rows into ``train/`` (ROADMAP.md C).
- :class:`WeightInstancesByLocalization`: a score per training instance
  (the attention's entropy, or its no-attention weight) and, at the end of
  a training epoch, the loader's ``sample_weights`` set to softmax(score /
  temp) for the next epoch, both distributions logged as histograms.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..configs import Config
from ..ops.gloria_loss import make_word_mask
from ..utils.viz import get_attn_overlay
from . import metrics as M
from .trainer import Callback

PERCENTILE_THRESHOLDS = (0.05, 0.1, 0.2, 0.3)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def sent_bboxes_to_segmentation_label(shape, bboxes) -> np.ndarray:
    label = np.zeros(shape, np.float32)
    for bbox in bboxes:
        x1, y1, x2, y2 = (int(round(v)) for v in bbox)
        label[y1 : y2 + 1, x1 : x2 + 1] = 1.0
    return label


def sentence_attention(attn, cap_lens, grid: tuple[int, int]) -> np.ndarray:
    """[B, W, R] word attention → [B, h, w] mean over each text's valid
    words (train word slice), on the host."""
    attn = _host(attn)
    B, W, R = attn.shape
    mask = make_word_mask(torch.as_tensor(_host(cap_lens)), W, "train").numpy()[..., None]
    mean = (attn * mask).sum(1) / np.maximum(mask.sum(1), 1)
    return mean.reshape(B, *grid)


def batch_localization_metrics(overlays, labels, grid_attn: np.ndarray,
                               thresholds=PERCENTILE_THRESHOLDS) -> dict[str, np.ndarray]:
    """Per-row metrics of ``overlays`` [B, H, W] (attention at label size)
    against ``labels`` [B, H, W] (box-union masks), computed on the device
    of ``labels`` when it is a tensor, else on the CPU; ``grid_attn`` [B, h,
    w] is the raw sentence attention the entropy is taken of.  A row whose
    label is empty gets NaN (entropy and no-attention weight excepted)."""
    device = labels.device if isinstance(labels, torch.Tensor) else torch.device("cpu")
    B = overlays.shape[0]
    s = torch.as_tensor(overlays).to(device, torch.float32).reshape(B, -1)
    l = torch.as_tensor(labels).to(device, torch.float32).reshape(B, -1)
    flat_attn = np.asarray(grid_attn).reshape(B, -1)
    no_attn_weight = 1.0 - flat_attn.sum(-1)
    ent_dist = np.concatenate([no_attn_weight[:, None], flat_attn], axis=1)
    out = {
        "auroc": _host(M.binary_auroc(s, l)),
        "avg_precision": _host(M.binary_average_precision(s, l)),
        "attn_entropy": M.attention_entropy_np(ent_dist),
        "no_attn_weight": no_attn_weight,
    }
    sorted_desc = -torch.sort(-s, dim=-1).values  # one sort shared by every threshold
    for p in thresholds:
        tk = M.topk_overlap_metrics(s, l, p, sorted_desc=sorted_desc)
        tk = {k: _host(v) for k, v in tk.items()}
        out[f"precision_at_{p:f}"] = tk["precision"]
        out[f"recall_at_{p:f}"] = tk["recall"]
        out[f"f1_at_{p:f}"] = tk["f1"]
        out[f"iou_at_{p:f}"] = tk["iou"]
    empty = _host(l.sum(-1) == 0)
    for k in out:
        if k not in ("attn_entropy", "no_attn_weight"):
            out[k] = np.where(empty, np.nan, out[k])
    return out


class EvaluateLocalization(Callback):
    def __init__(self, cfg: Config, save_dir: str | None = None,
                 eval_attn_overlay_mode: str = "upsample",
                 plot_attn_overlay_mode: str = "upsample",
                 log_train_every: int = 100,
                 save_full_data: bool = False,
                 thresholds=PERCENTILE_THRESHOLDS):
        self.cfg = cfg
        self.save_dir = Path(save_dir) if save_dir else None
        self.eval_mode = eval_attn_overlay_mode
        self.plot_mode = plot_attn_overlay_mode  # for the plots of ROADMAP.md A6.1
        self.log_train_every = log_train_every
        self.save_full_data = save_full_data
        self.thresholds = thresholds
        self._rows: dict[str, list[dict]] = defaultdict(list)  # by split
        self._artifacts: dict[str, dict] = defaultdict(lambda: defaultdict(dict))

    # -- core ------------------------------------------------------------------
    def evaluate_batch(self, attn, batch, sims: dict | None = None, split: str = "test") -> dict:
        """Scores one batch's diagonal attention ``attn`` [B, W, R] against
        ``batch["segmentation_labels"]``; keeps its rows under ``split`` and
        returns the batch means."""
        labels = batch["segmentation_labels"]
        B = labels.shape[0]
        R = attn.shape[-1]
        side = int(round(R ** 0.5))
        grid_attn = sentence_attention(attn, batch["cap_lens"], (side, side))
        size = tuple(labels.shape[1:3])
        overlays = np.stack([get_attn_overlay(g, size, self.eval_mode) for g in grid_attn])
        result = batch_localization_metrics(overlays, labels, grid_attn, self.thresholds)
        ids = batch.get("_ids") or [f"instance_{i}" for i in range(B)]
        sents = [" ".join(w for w in words if not w.startswith("["))
                 for words in (batch.get("_words") or [[]] * B)]
        if sims:
            sims = {k: _host(v) for k, v in sims.items()}
        if self.save_full_data:
            labels_host, imgs_host = _host(labels), _host(batch["imgs"])
        artifacts = self._artifacts[split]
        for i in range(B):
            row = {"dicom_sent_id": str(ids[i]).replace("/", "_"),
                   "sentence": sents[i] if i < len(sents) else ""}
            row.update({k: float(v[i]) for k, v in result.items()})
            if sims:
                row["local_sims"] = float(sims["local"][i]) if "local" in sims else None
                row["global_sims"] = float(sims["global"][i]) if "global" in sims else None
            self._rows[split].append(row)
            if self.save_full_data:
                sid = row["dicom_sent_id"]
                artifacts["attn"][sid] = grid_attn[i]
                artifacts["image"][sid] = imgs_host[i]
                artifacts["label"][sid] = labels_host[i]
                self._curves(artifacts, sid, overlays[i], labels_host[i])
        return {k: float(np.nanmean(v)) for k, v in result.items()}

    @staticmethod
    def _curves(artifacts: dict, sid: str, overlay: np.ndarray, label: np.ndarray) -> None:
        if label.sum() == 0:
            artifacts["roc_curve"][sid] = ()
            artifacts["pr_curve"][sid] = ()
            return
        artifacts["roc_curve"][sid] = M.roc_curve(label.reshape(-1), overlay.reshape(-1))
        artifacts["pr_curve"][sid] = M.precision_recall_curve(label.reshape(-1), overlay.reshape(-1))

    # -- Trainer hooks --------------------------------------------------------
    def _maybe_eval(self, trainer, state, metrics, batch, split):
        if "segmentation_labels" not in batch or "_attn" not in metrics:
            return
        sims = {name: metrics[f"_{name}_sims"] for name in ("local", "global")
                if f"_{name}_sims" in metrics} or None
        means = self.evaluate_batch(metrics["_attn"], batch, sims=sims, split=split)
        trainer.logger.log({f"localization/{k}": v for k, v in means.items()},
                           trainer.global_step, split)

    def on_train_batch_end(self, trainer, state, metrics, batch, batch_idx):
        if batch_idx % self.log_train_every == 0:
            self._maybe_eval(trainer, state, metrics, batch, "train")

    def on_validation_batch_end(self, trainer, state, metrics, batch, batch_idx):
        self._maybe_eval(trainer, state, metrics, batch, "val")

    def on_test_batch_end(self, trainer, state, metrics, batch, batch_idx):
        self._maybe_eval(trainer, state, metrics, batch, "test")

    def on_epoch_end(self, trainer, state, split, epoch_metrics):
        # a training epoch ends after its validation: both splits are written
        for pending in list(self._rows):
            self.flush(pending)

    # -- persistence ------------------------------------------------------------
    def flush(self, split: str) -> str | None:
        """Writes ``split``'s rows and artifacts (each epoch's replace the
        last's) and forgets them; returns the CSV's path."""
        rows = self._rows.pop(split, [])
        artifacts = self._artifacts.pop(split, {})
        if not rows or self.save_dir is None:
            return None
        import pandas as pd

        out_dir = self.save_dir / split
        out_dir.mkdir(parents=True, exist_ok=True)
        csv_path = out_dir / "sentences.csv"
        pd.DataFrame(rows).to_csv(csv_path, index=False)
        for folder, items in artifacts.items():
            folder_dir = out_dir / folder
            folder_dir.mkdir(exist_ok=True)
            for sid, arr in items.items():
                if folder.endswith("_curve"):
                    np.savez(folder_dir / sid, *arr)
                else:
                    np.save(folder_dir / sid, arr)
        return str(csv_path)


class WeightInstancesByLocalization(Callback):
    """Curriculum reweighting: per-instance scores → softmax sampler weights
    for the train loader's next epoch (``loader`` must be the instance the
    trainer iterates)."""

    def __init__(self, loader, dataset_size: int, weight_mode: str = "attn_entropy",
                 temp: float = 0.2):
        assert weight_mode in ("attn_entropy", "no_attn_score")
        self.loader = loader
        self.weight_mode = weight_mode
        self.temp = temp
        self.scores = np.zeros(dataset_size, np.float64)
        self.seen = np.zeros(dataset_size, bool)

    def on_train_batch_end(self, trainer, state, metrics, batch, batch_idx):
        if "_attn" not in metrics or "_indices" not in batch:
            return
        attn = _host(metrics["_attn"])
        B, W, R = attn.shape
        side = int(round(R ** 0.5))
        flat = sentence_attention(attn, batch["cap_lens"], (side, side)).reshape(B, -1)
        if self.weight_mode == "no_attn_score":
            score = 1.0 - flat.sum(-1)
        else:
            dist = np.concatenate([(1.0 - flat.sum(-1))[:, None], flat], 1)
            score = M.attention_entropy_np(dist)
        for i, idx in enumerate(np.asarray(batch["_indices"])):
            self.scores[int(idx)] = score[i]
            self.seen[int(idx)] = True

    def on_epoch_end(self, trainer, state, split, epoch_metrics):
        if split != "train" or not self.seen.any():
            return
        s = self.scores.copy()
        s[~self.seen] = s[self.seen].mean()
        z = np.exp((s - s.max()) / self.temp)
        weights = z / z.sum()
        self.loader.sample_weights = weights
        logger = getattr(trainer, "logger", None)
        if logger is not None and hasattr(logger, "log_histogram"):
            logger.log_histogram("train/weights_hist", s, trainer.global_step)
            logger.log_histogram("train/weights_softmax_hist", weights, trainer.global_step)
            logger.log({"train/weights_mean": float(s.mean())}, trainer.global_step, split)
