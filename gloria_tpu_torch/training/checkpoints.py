"""Checkpoints: top-k and last by a monitored metric, config and trainer state
beside the weights, warm start and full resume.

The port's counterpart of ``gloria_tpu.training.checkpoints``, with the same
bookkeeping: ``manifest.json`` (``{"entries": [{"name", "step", "metric"}],
"last"}``), ``<name>.meta.json`` holding ``{"extra": ..., "cfg": ...}``,
top-k by the monitored metric with ``save_last``, saves without the metric
kept only as the newest of them, the in-flight async save protected from
pruning, and :meth:`CheckpointManager.best` / :meth:`~CheckpointManager.last`
skipping names whose directory does not exist.

The format is the port's own (no orbax): each ``step_XXXXXXXX/`` directory
holds ``state.pt``, written by ``torch.save``.  For a :class:`TrainState` it
holds ``{"model": state_dict (BatchNorm running statistics included),
"opt_state": {lr, count, mu, nu, trace, total_notfinite}, "step", "seed"}``;
any other dict of tensors is written as it is.  A save writes into a
temporary directory and renames it into place, so a manifest name whose
directory is missing is a write that never finished.  Tensors are copied to
the host in the caller's thread; with ``async_save`` the file is written on
one background thread, one save in flight at a time.

Only rank 0 writes (``utils.logging.process_rank``).  Checkpoint surgery
works on state-dict prefixes: :func:`extract_subtree` takes the entries
under a prefix, :func:`graft_subtree` puts them under another, which is how
a GLoRIA image encoder moves into a task model (``training.tasks``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import torch

from ..configs import Config
from ..utils.logging import process_rank
from .train import TrainState

STATE_FILE = "state.pt"
_OPT_FIELDS = ("lr", "count", "mu", "nu", "trace", "total_notfinite")


def _to_host(obj: Any) -> Any:
    """A copy of ``obj`` whose tensors are new CPU tensors (read here, in the
    caller's thread: a writer thread never touches a CUDA tensor)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def state_payload(state: Any) -> Any:
    """What ``state.pt`` holds for ``state`` (a :class:`TrainState` or a tree
    of tensors), with every tensor copied to the host."""
    if isinstance(state, TrainState):
        opt = state.opt_state
        state = {"model": state.model.state_dict(),
                 "opt_state": {f: getattr(opt, f) for f in _OPT_FIELDS},
                 "step": int(state.step), "seed": int(state.seed)}
    return _to_host(state)


def restore_train_state(state: TrainState, payload: dict, *, resume: bool) -> TrainState:
    """Load a checkpoint's weights into ``state.model`` (warm start); with
    ``resume`` also its optimizer state, ``step`` and ``seed``.  Tensors move
    to the model's device."""
    state.model.load_state_dict(payload["model"], strict=True)
    if resume:
        if "opt_state" not in payload:
            raise ValueError("a resume needs a training checkpoint (one with opt_state)")
        device = next(state.model.parameters()).device
        saved, opt = payload["opt_state"], state.opt_state
        for f in _OPT_FIELDS:
            value = saved.get(f)
            if isinstance(value, torch.Tensor):
                value = value.to(device)
            elif isinstance(value, list):
                value = [v.to(device) for v in value]
            setattr(opt, f, value)
        state.step, state.seed = int(payload["step"]), int(payload["seed"])
    return state


def _nbytes(obj: Any) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0


def _write_state(path: Path, payload: Any) -> None:
    """``payload`` (already on the host) to ``path/state.pt`` through a
    temporary directory renamed into place."""
    tmp = path.parent / f".{path.name}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def _read_state(path: Path) -> Any:
    return torch.load(Path(path) / STATE_FILE, map_location="cpu", weights_only=True)


def _read_meta(path: Path) -> dict:
    meta_path = path.parent / f"{path.name}.meta.json"
    return json.loads(meta_path.read_text()) if meta_path.exists() else {}


class CheckpointManager:
    def __init__(self, directory: str | Path, monitor: str = "val_loss",
                 mode: str = "min", save_top_k: int = 10, save_last: bool = True,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.async_save = async_save
        self.manifest_path = self.dir / "manifest.json"
        self.manifest: dict = {"entries": [], "last": None}
        if self.manifest_path.exists():
            self.manifest = json.loads(self.manifest_path.read_text())
        # one record per finished write: name, GB, seconds to copy to the
        # host and to write (the driver prints them)
        self.saves: list[dict] = []
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None

    def wait(self) -> None:
        """Block until the in-flight async save is on disk; re-raise its error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            error, self._writer_error = self._writer_error, None
            raise RuntimeError("the background checkpoint write failed") from error

    def save_tokenizer(self, tokenizer) -> None:
        """The training tokenizer, once, at ``<dir>/tokenizer/`` so every
        ``step_*`` checkpoint under it is self-contained for ``load_gloria``."""
        if tokenizer is not None and process_rank() == 0:
            tokenizer.save_vocab(self.dir / "tokenizer")

    def _write(self, name: str, state: Any, cfg: Config | None, extra: dict) -> None:
        t0 = time.perf_counter()
        payload = state_payload(state)
        copy_s = time.perf_counter() - t0
        meta = {"extra": extra}
        if cfg is not None:
            meta["cfg"] = cfg.to_dict()
        (self.dir / f"{name}.meta.json").write_text(json.dumps(meta))

        def write() -> None:
            t = time.perf_counter()
            _write_state(self.dir / name, payload)
            self.saves.append({"name": name, "gb": _nbytes(payload) / 1e9,
                               "copy_s": copy_s, "write_s": time.perf_counter() - t})

        if not self.async_save:
            write()
            return

        def background() -> None:
            try:
                write()
            except BaseException as exc:  # noqa: BLE001 -- raised to the caller by wait()
                self._writer_error = exc

        self._writer = threading.Thread(target=background, name="CheckpointWriter", daemon=False)
        self._writer.start()

    def save(self, state: Any, step: int, metrics: dict | None = None,
             cfg: Config | None = None, trainer_state: dict | None = None) -> str:
        if process_rank() != 0:  # one writer: the state is the same on every rank
            return str(self.dir / f"step_{step:08d}")
        self.wait()  # one async save in flight at a time
        metrics = metrics or {}
        metric = metrics.get(self.monitor)
        name = f"step_{step:08d}"
        extra = {"step": step, "metrics": {k: float(v) for k, v in metrics.items()}}
        if trainer_state is not None:
            extra["trainer_state"] = trainer_state
        self._write(name, state, cfg, extra)
        entry = {"name": name, "step": step, "metric": None if metric is None else float(metric)}
        self.manifest["entries"] = [e for e in self.manifest["entries"] if e["name"] != name] + [entry]
        if self.save_last:
            self.manifest["last"] = name
        # never prune the directory the writer thread may still be writing; if
        # unworthy it goes at the next save, after the wait
        self._prune(protect=name if self.async_save else None)
        self.manifest_path.write_text(json.dumps(self.manifest))
        return str(self.dir / name)

    def _prune(self, protect: str | None = None) -> None:
        scored = [e for e in self.manifest["entries"] if e["metric"] is not None]
        sign = 1 if self.mode == "min" else -1
        scored.sort(key=lambda e: sign * e["metric"])
        keep = {e["name"] for e in scored[: self.save_top_k]}
        # saves without the metric (epochs without validation) survive only as
        # the newest of them; keeping all would defeat save_top_k
        unscored = [e["name"] for e in self.manifest["entries"] if e["metric"] is None]
        if unscored:
            keep.add(unscored[-1])
        if self.manifest.get("last"):
            keep.add(self.manifest["last"])
        if protect is not None:
            keep.add(protect)
        for e in list(self.manifest["entries"]):
            if e["name"] not in keep:
                shutil.rmtree(self.dir / e["name"], ignore_errors=True)
                (self.dir / f"{e['name']}.meta.json").unlink(missing_ok=True)
                self.manifest["entries"].remove(e)

    def _durable(self, name: str) -> bool:
        """A name whose directory is missing is a write that never finished
        (the temporary directory is renamed into place only at the end)."""
        return (self.dir / name).is_dir()

    def best(self) -> str | None:
        scored = [e for e in self.manifest["entries"]
                  if e["metric"] is not None and self._durable(e["name"])]
        if not scored:
            return self.last()
        sign = 1 if self.mode == "min" else -1
        best = min(scored, key=lambda e: sign * e["metric"])
        return str(self.dir / best["name"])

    def last(self) -> str | None:
        """The newest durable checkpoint: past a manifest ``last`` whose write
        never finished, to the newest entry that exists on disk."""
        names = [e["name"] for e in self.manifest["entries"]]
        if self.manifest.get("last"):
            names.append(self.manifest["last"])
        for name in reversed(list(dict.fromkeys(names))):
            if self._durable(name):
                return str(self.dir / name)
        return None

    def restore(self, path: str | Path) -> tuple[Any, Config | None, dict]:
        """(``state.pt``'s payload on the CPU, the saved config, the extra record)."""
        self.wait()  # the requested checkpoint may still be in flight
        path = Path(path)
        meta = _read_meta(path)
        cfg = Config(meta["cfg"]) if "cfg" in meta else None
        return _read_state(path), cfg, meta.get("extra", {})


def save_checkpoint(path: str | Path, state: Any, cfg: Config | None = None,
                    tokenizer=None) -> None:
    """One checkpoint without a manager's bookkeeping.  With ``tokenizer``
    the vocabulary goes to the sibling ``<name>.tokenizer/`` so that
    ``api.load_gloria(path)`` restores the exact tokenizer."""
    path = Path(path)
    _write_state(path, state_payload(state))
    if cfg is not None:
        (path.parent / f"{path.name}.meta.json").write_text(json.dumps({"cfg": cfg.to_dict()}))
    if tokenizer is not None:
        tokenizer.save_vocab(path.parent / f"{path.name}.tokenizer")


def load_checkpoint(path: str | Path) -> tuple[Any, Config | None]:
    """(``state.pt``'s payload on the CPU, the saved config or None)."""
    path = Path(path)
    meta = _read_meta(path)
    return _read_state(path), (Config(meta["cfg"]) if "cfg" in meta else None)


def load_checkpoint_meta(path: str | Path) -> dict:
    """The ``extra`` record a :class:`CheckpointManager` wrote next to
    ``path`` (step, metrics, ``trainer_state``); {} when absent."""
    return _read_meta(Path(path)).get("extra", {})


def is_checkpoint(path: str | Path) -> bool:
    """Whether ``path`` is a directory written by this module."""
    return (Path(path) / STATE_FILE).is_file()


# ---------------------------------------------------------------------------
# Cross-model surgery on state-dict prefixes
# ---------------------------------------------------------------------------

def extract_subtree(state_dict: dict, prefix: str) -> dict:
    """The entries under ``prefix`` (ending in ``.``), without it: the JAX
    package's ``extract_subtree(variables, path)`` (``img_encoder.`` for its
    ``('params', 'img_encoder')`` and the BatchNorm statistics with it)."""
    sub = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
    if not sub:
        raise KeyError(f"no entries under {prefix!r}")
    return sub


def graft_subtree(state_dict: dict, prefix: str, subtree: dict) -> dict:
    """A copy of ``state_dict`` whose entries under ``prefix`` are replaced
    by ``subtree``'s, put under ``prefix``."""
    out = {k: v for k, v in state_dict.items() if not k.startswith(prefix)}
    out.update({f"{prefix}{k}": v for k, v in subtree.items()})
    return out
