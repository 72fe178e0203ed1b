"""Attention plots saved during pretraining (``train.nvis``).

The port's counterpart of ``gloria_tpu.training.plotting`` (the reference's
``PretrainModel.training_step`` plotting branch, ``GLoRIA.plot_attn_maps``):
every ``train.update_interval`` train batches, the per-word attention grid
of ``nvis`` samples of the batch is written to
``<output_dir>/attention_maps_step<global step>.png``
(``utils.viz.build_attention_images``).  The driver turns the train step's
``return_attn`` on when it adds this callback.

The attention, images and caption lengths go to the host on a plotted batch
only: the trainer hands callbacks the loader's batch and the step's
metrics, whose tensors may be on the card.  Unlike JAX, which swallows
every error of the save, a failing save raises: a lost plot does not pass
in silence.
"""

from __future__ import annotations

from pathlib import Path

from ..configs import Config
from ..utils.viz import build_attention_images
from .trainer import Callback, _host_array


class AttentionPlotCallback(Callback):
    def __init__(self, cfg: Config, output_dir: str | None = None):
        self.every = int(cfg.train.update_interval or 1000) if cfg.train else 1000
        self.nvis = int(cfg.train.nvis or 8) if cfg.train else 8
        self.rand_vis = bool(cfg.train.rand_vis) if cfg.train else False
        self.output_dir = Path(output_dir or cfg.output_dir or ".")

    def on_train_batch_end(self, trainer, state, metrics, batch, batch_idx):
        if batch_idx % self.every or "_attn" not in metrics:
            return
        from PIL import Image

        attn = _host_array(metrics["_attn"])
        B, W, R = attn.shape
        side = int(round(R ** 0.5))
        words = batch.get("_words") or [["?"] * W] * B
        img_set = build_attention_images(
            _host_array(batch["imgs"]), attn.reshape(B, W, side, side),
            words, _host_array(batch["cap_lens"]),
            nvis=min(self.nvis, B), rand_vis=self.rand_vis,
        )
        self.output_dir.mkdir(parents=True, exist_ok=True)
        Image.fromarray(img_set).save(
            self.output_dir / f"attention_maps_step{trainer.global_step}.png")
