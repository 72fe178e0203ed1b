"""Training orchestration: the epoch loop around the train and eval steps.

The port's counterpart of ``gloria_tpu.training.trainer`` (the reference's
Lightning ``Trainer``): epochs with Lightning's ``limit_*_batches``
semantics, validation every ``check_val_every_n_epoch``, train metrics and
the LR every ``update_interval`` optimizer steps, the LR scheduler stepped on
the monitored metric and pushed into the optimizer state, a checkpoint every
epoch carrying the trainer's own state (epoch, global step, scheduler, early
stopping) for resume, early stopping, and graceful preemption: SIGTERM or
SIGUSR1 sets a flag, and ``fit`` saves and returns at the next batch
boundary.

A step's 0-d loss stays on the device; the epoch's losses are stacked and
read once at its end, so a train step needs no device→host read unless it
is on the logging cadence.

Not ported yet, and refused: stacking several loader batches into one step
(``accumulate_grad_batches`` > 1, ``train.steps_per_dispatch`` > 1;
ROADMAP.md A1.8).
"""

from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from ..configs import Config
from ..utils.logging import MetricLogger
from . import optim
from .checkpoints import CheckpointManager
from .train import TrainState


def _device_only(batch: dict) -> dict:
    """The batch without the collate's host-only keys (leading underscore);
    the callbacks still see the whole batch."""
    if isinstance(batch, dict):
        return {k: v for k, v in batch.items() if not k.startswith("_")}
    return batch


def _host_array(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class Callback:
    """Hook surface (the parts of Lightning's the reference uses)."""

    def on_train_batch_end(self, trainer, state, metrics, batch, batch_idx): ...
    def on_validation_batch_end(self, trainer, state, metrics, batch, batch_idx): ...
    def on_test_batch_end(self, trainer, state, metrics, batch, batch_idx): ...
    def on_epoch_end(self, trainer, state, split, epoch_metrics): ...


class ProfileTrace(Callback):
    """A ``torch.profiler`` trace (CPU and, on a card, CUDA activity) of
    ``steps`` train steps after the first ``skip``, written as a Chrome trace
    to ``<log_dir>/trace.json`` (``python -m gloria_tpu_torch.run --profile
    N`` puts it under ``<output_dir>/profile``).  It synchronizes the card
    before it stops, so the trace holds the finished device work.  Fail-soft:
    a profiler error prints a warning and training goes on."""

    def __init__(self, log_dir, steps: int = 5, skip: int = 2):
        self.log_dir = Path(log_dir)
        self.steps = steps
        self.skip = skip
        self._prof = None
        self._done = False
        self._seen = 0  # completed optimizer steps

    def on_train_batch_end(self, trainer, state, metrics, batch, batch_idx):
        if self._done:
            return
        self._seen += 1
        try:
            if self._prof is None and self._seen >= self.skip:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(ProfilerActivity.CUDA)
                self._prof = profile(activities=activities)
                self._prof.__enter__()
            elif self._prof is not None and self._seen >= self.skip + self.steps:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof, self._prof, self._done = self._prof, None, True
                prof.__exit__(None, None, None)
                self.log_dir.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(self.log_dir / "trace.json"))
                print(f"profile trace ({self.steps} steps) written to {self.log_dir}")
        except Exception as exc:  # noqa: BLE001 -- profiling must never stop training
            self._prof, self._done = None, True
            print(f"WARNING: profiler trace failed: {exc}")


@dataclass
class EarlyStopping:
    monitor: str = "val_loss"
    patience: int = 10
    min_delta: float = 0.0
    mode: str = "min"
    best: float = field(default=math.inf)
    bad_epochs: int = 0
    stopped: bool = False

    def __post_init__(self):
        if self.mode == "max":
            self.best = -math.inf

    def step(self, value: float) -> bool:
        improved = ((value < self.best - self.min_delta) if self.mode == "min"
                    else (value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.stopped = True
        return self.stopped

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in ("best", "bad_epochs", "stopped")}

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


class Trainer:
    def __init__(
        self,
        cfg: Config,
        train_step: Callable,
        eval_step: Callable | None = None,
        *,
        callbacks: list[Callback] | None = None,
        logger: MetricLogger | None = None,
        checkpoints: CheckpointManager | None = None,
        metric_extractor: Callable[[list], dict] | None = None,
    ):
        self.cfg = cfg
        self.train_step = train_step
        self.eval_step = eval_step
        self.callbacks = callbacks or []
        lightning = cfg.lightning or Config()
        trainer_cfg = lightning.trainer or Config()
        self.max_epochs = int(trainer_cfg.max_epochs or 1)
        self.limit_train_batches = trainer_cfg.limit_train_batches
        self.limit_val_batches = trainer_cfg.limit_val_batches
        for key, value in (("lightning.trainer.accumulate_grad_batches",
                            trainer_cfg.accumulate_grad_batches),
                           ("train.steps_per_dispatch",
                            cfg.train.steps_per_dispatch if cfg.train else None)):
            if int(value or 1) > 1:
                raise NotImplementedError(
                    f"{key} > 1: stacking loader batches into one step is not ported yet "
                    "(queued in ROADMAP.md A1.8)")
        self.check_val_every_n_epoch = int(trainer_cfg.check_val_every_n_epoch or 1)
        self.logger = logger or MetricLogger(cfg.output_dir)
        self.checkpoints = checkpoints
        self.scheduler = optim.make_scheduler(cfg)
        es_cfg = lightning.early_stopping_callback
        self.early_stopping = (
            EarlyStopping(
                monitor=es_cfg.monitor or "val_loss",
                patience=int(es_cfg.patience or 10),
                min_delta=float(es_cfg.min_delta or 0.0),
                mode=es_cfg.mode or "min",
            )
            if es_cfg
            else None
        )
        self.metric_extractor = metric_extractor or (lambda collected: {})
        self.global_step = 0
        # resume: the epoch counter, the scheduler and early stopping travel
        # in the checkpoint's meta (``trainer_state``)
        self.start_epoch = 0
        # preemption: SIGTERM / SIGUSR1 set this; fit() saves and returns at
        # the next batch boundary
        self.interrupted = False

    def _install_signal_handlers(self) -> dict:
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                previous[sig] = signal.signal(
                    sig, lambda signum, frame: setattr(self, "interrupted", True))
            except ValueError:  # not the main thread
                pass
        return previous

    @staticmethod
    def _restore_signal_handlers(previous: dict) -> None:
        for sig, handler in previous.items():
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass

    # -- resume ------------------------------------------------------------------
    def state_dict(self, epochs_completed: int) -> dict:
        d = {"epoch": int(epochs_completed), "global_step": int(self.global_step),
             "scheduler": self.scheduler.state_dict()}
        if self.early_stopping is not None:
            d["early_stopping"] = self.early_stopping.state_dict()
        return d

    def load_state_dict(self, d: dict) -> None:
        if not d:
            return
        self.start_epoch = int(d.get("epoch", 0))
        self.global_step = int(d.get("global_step", 0))
        if d.get("scheduler"):
            self.scheduler.load_state_dict(d["scheduler"])
        if d.get("early_stopping") and self.early_stopping is not None:
            self.early_stopping.load_state_dict(d["early_stopping"])

    @staticmethod
    def _limit(limit, loader) -> int | None:
        """Lightning's semantics: a float ≤ 1 is a fraction of the batches,
        anything else a count."""
        if limit is None:
            return None
        if isinstance(limit, float) and limit <= 1.0:
            try:
                return max(1, int(len(loader) * limit))
            except TypeError:
                return None
        return int(limit)

    # -- loops -------------------------------------------------------------------
    def _run_eval(self, state: TrainState, loader: Iterable, split: str) -> dict:
        if self.eval_step is None:
            return {}
        max_batches = self._limit(self.limit_val_batches, loader)
        sums: dict[str, float] = {}
        count = 0
        collected: list[dict] = []
        for batch_idx, batch in enumerate(loader):
            if max_batches is not None and batch_idx >= max_batches:
                break
            out = self.eval_step(state, _device_only(batch))
            metrics = out[0] if isinstance(out, tuple) else out
            host = {k: _host_array(v) for k, v in metrics.items()}
            # keep only ≤2-D metrics (logits and labels for the extractor):
            # batched attention maps would hold GBs of host memory
            collected.append({k: v for k, v in host.items() if np.ndim(v) <= 2})
            for k, v in host.items():
                if np.ndim(v) == 0:
                    sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
            for cb in self.callbacks:
                hook = cb.on_validation_batch_end if split == "val" else cb.on_test_batch_end
                hook(self, state, host, batch, batch_idx)
        epoch_metrics = {f"{split}_{k}": v / max(count, 1) for k, v in sums.items()}
        epoch_metrics.update(self.metric_extractor(collected))
        return epoch_metrics

    def fit(self, state: TrainState, train_loader: Iterable,
            val_loader: Iterable | None = None) -> TrainState:
        previous_handlers = self._install_signal_handlers()
        try:
            return self._fit(state, train_loader, val_loader)
        finally:
            self._restore_signal_handlers(previous_handlers)

    def _save(self, state: TrainState, epoch_metrics: dict, epochs_completed: int) -> None:
        self.checkpoints.save(state, step=self.global_step, metrics=epoch_metrics, cfg=self.cfg,
                              trainer_state=self.state_dict(epochs_completed=epochs_completed))

    def _fit(self, state: TrainState, train_loader: Iterable,
             val_loader: Iterable | None) -> TrainState:
        if self.start_epoch and hasattr(train_loader, "epoch"):
            # continue the shuffle sequence where the first run left off (the
            # loader orders epoch e by seed + e)
            train_loader.epoch = self.start_epoch
        update_interval = int(self.cfg.train.update_interval or 100) if self.cfg.train else 100
        for epoch in range(self.start_epoch, self.max_epochs):
            t0 = time.time()
            n = 0
            max_batches = self._limit(self.limit_train_batches, train_loader)
            device_losses = []  # read once at the end of the epoch
            for batch_idx, batch in enumerate(train_loader):
                if max_batches is not None and batch_idx >= max_batches:
                    break
                if self.interrupted:
                    break
                state, metrics = self.train_step(state, _device_only(batch))
                self.global_step += 1
                n += 1
                device_losses.append(metrics["loss"])
                for cb in self.callbacks:
                    cb.on_train_batch_end(self, state, metrics, batch, batch_idx)
                if (n - 1) % update_interval == 0:
                    host = {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}
                    host["lr"] = self.scheduler.current_lr
                    self.logger.log(host, self.global_step, "train")

            loss_sum = float(torch.stack(device_losses).sum()) if device_losses else 0.0
            epoch_metrics = {"train_loss": loss_sum / max(n, 1), "epoch_time": time.time() - t0}
            if self.interrupted:
                # preemption: save the mid-epoch state now; a --resume reruns
                # the interrupted epoch (its order is a function of seed + epoch)
                epoch_metrics["interrupted"] = 1.0
                self.logger.log(epoch_metrics, self.global_step, "epoch")
                if self.checkpoints is not None:
                    self._save(state, epoch_metrics, epochs_completed=epoch)
                    self.checkpoints.wait()  # on disk before the process exits
                return state
            if val_loader is not None and (epoch + 1) % self.check_val_every_n_epoch == 0:
                epoch_metrics.update(self._run_eval(state, val_loader, "val"))
            for cb in self.callbacks:
                cb.on_epoch_end(self, state, "train", epoch_metrics)
            self.logger.log(epoch_metrics, self.global_step, "epoch")

            monitor = self.cfg.train and self.cfg.train.scheduler and self.cfg.train.scheduler.monitor
            new_lr = self.scheduler.step(epoch_metrics.get(monitor or "val_loss"))
            optim.set_learning_rate(state.opt_state, new_lr)

            # early stopping sees the epoch before the save, so the saved
            # trainer state holds this epoch's observation (the JAX trainer
            # steps it after the save, and a resume there loses one epoch of
            # its history); when to stop is the same
            stop = False
            if self.early_stopping is not None:
                v = epoch_metrics.get(self.early_stopping.monitor)
                stop = v is not None and self.early_stopping.step(float(v))
            if self.checkpoints is not None:
                self._save(state, epoch_metrics, epochs_completed=epoch + 1)
            if stop:
                break
        if self.checkpoints is not None:
            self.checkpoints.wait()  # async saves on disk before fit() returns
        return state

    def validate(self, state: TrainState, loader: Iterable) -> dict:
        m = self._run_eval(state, loader, "val")
        self.logger.log(m, self.global_step, "val")
        return m

    def test(self, state: TrainState, loader: Iterable) -> dict:
        m = self._run_eval(state, loader, "test")
        self.logger.log(m, self.global_step, "test")
        for cb in self.callbacks:
            cb.on_epoch_end(self, state, "test", m)
        return m
