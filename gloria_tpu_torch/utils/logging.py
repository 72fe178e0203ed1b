"""Metric logging: CSV per split, a JSON-lines mirror, optional W&B.

The port's own copy of ``gloria_tpu.utils.logging.MetricLogger``: it always
persists locally (``metrics_<split>.csv``, whose header is the first row's
keys; later rows with keys outside that header also go whole to
``metrics_<split>.jsonl``), writes histograms to ``histograms.jsonl``, and
mirrors to wandb when ``use_wandb`` is set and the package imports.  Only
rank 0 writes: ``torch.distributed.get_rank()`` when a process group is
initialized, else 0.
"""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path
from typing import Any

import numpy as np


def process_rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MetricLogger:
    def __init__(self, output_dir: str | Path | None, project: str | None = None,
                 experiment: str | None = None, use_wandb: bool = False):
        if process_rank() != 0:  # one writer: the values are the same on every rank
            output_dir = None
            use_wandb = False
        self.output_dir = Path(output_dir) if output_dir else None
        if self.output_dir:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self._csv_files: dict[str, Any] = {}
        self._csv_writers: dict[str, Any] = {}
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=experiment, dir=str(self.output_dir))
            except Exception:  # noqa: BLE001 -- the local files stay the record
                self._wandb = None

    def log(self, metrics: dict, step: int, split: str = "train") -> None:
        metrics = {k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()}
        if self.output_dir:
            if split not in self._csv_writers:
                fh = open(self.output_dir / f"metrics_{split}.csv", "a", newline="")
                self._csv_files[split] = fh
                writer = csv.DictWriter(fh, fieldnames=["step", "time"] + sorted(metrics))
                writer.writeheader()
                self._csv_writers[split] = writer
            fieldnames = self._csv_writers[split].fieldnames
            row = {"step": step, "time": round(time.time(), 3)}
            row.update({k: metrics.get(k) for k in fieldnames if k not in ("step", "time")})
            if any(v is not None for k, v in row.items() if k not in ("step", "time")):
                self._csv_writers[split].writerow(row)
                self._csv_files[split].flush()
            # keys outside the header (val metrics after a first epoch
            # without validation) are not dropped: the whole row goes to JSONL
            if set(metrics) - set(fieldnames):
                with open(self.output_dir / f"metrics_{split}.jsonl", "a") as jf:
                    jf.write(json.dumps({"step": step, **metrics}) + "\n")
        if self._wandb is not None:
            self._wandb.log({f"{split}/{k}": v for k, v in metrics.items()}, step=step)

    def log_histogram(self, name: str, values, step: int) -> None:
        """Summary and bin counts to ``histograms.jsonl``; a native
        histogram to wandb when it is on."""
        arr = np.asarray(values, dtype=np.float64).reshape(-1)
        if self.output_dir is not None and arr.size:
            counts, edges = np.histogram(arr, bins=min(64, max(1, arr.size)))
            with open(self.output_dir / "histograms.jsonl", "a") as fh:
                fh.write(json.dumps({
                    "name": name, "step": step,
                    "mean": float(arr.mean()), "std": float(arr.std()),
                    "min": float(arr.min()), "max": float(arr.max()),
                    "counts": counts.tolist(), "edges": edges.tolist(),
                }) + "\n")
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Histogram(arr)}, step=step)

    def log_image(self, name: str, image, step: int) -> None:
        """``<name>_step<step>.png`` (values in [0, 1] or uint8).  Fail-soft,
        as in the JAX package: a plot must never stop a training run, and
        PIL may be absent."""
        if self.output_dir is not None:
            try:
                from PIL import Image

                arr = np.asarray(image)
                if arr.dtype != np.uint8:
                    arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
                Image.fromarray(arr).save(self.output_dir / f"{name}_step{step}.png")
            except Exception:  # noqa: BLE001
                pass
        if self._wandb is not None:
            import wandb

            self._wandb.log({name: wandb.Image(image)}, step=step)

    def close(self) -> None:
        for fh in self._csv_files.values():
            fh.close()
        self._csv_files.clear()
        self._csv_writers.clear()
        if self._wandb is not None:
            self._wandb.finish()
