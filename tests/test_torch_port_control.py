"""The port's training control plane against the JAX package: the config
reader, the LR schedulers, early stopping, the checkpoint manager's
bookkeeping, its async writes, the tokenizer's persistence and the metric
logger.

Tolerances: none.  Every comparison is exact: the same values and Python
types from the config reader as ``yaml.safe_load``; the same learning rates
(the same float operations in the same order), stop epochs, surviving
checkpoint names, ``best()`` and ``last()``; byte-equal vocab files; the
same CSV header and rows with the ``time`` column left out.
"""

import csv
import json
import math
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from gloria_tpu.configs import Config as JConfig
from gloria_tpu.configs import iter_leaves as j_iter_leaves
from gloria_tpu.data import tokenizer as jtok
from gloria_tpu.training import optim as joptim
from gloria_tpu.training import trainer as jtrainer
from gloria_tpu.training.checkpoints import CheckpointManager as JManager
from gloria_tpu.utils.logging import MetricLogger as JLogger
from gloria_tpu_torch import configs as tconfigs
from gloria_tpu_torch.configs import Config as TConfig
from gloria_tpu_torch.data import tokenizer as ttok
from gloria_tpu_torch.training import optim as toptim
from gloria_tpu_torch.training import trainer as ttrainer
from gloria_tpu_torch.training.checkpoints import CheckpointManager as TManager
from gloria_tpu_torch.utils.logging import MetricLogger as TLogger
from test_run_driver import CFG as DRIVER_CFG

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _same(got, ref, path="cfg"):
    """Equal values of the same Python types, keys in the same order."""
    assert type(got) is type(ref) or (isinstance(got, dict) and isinstance(ref, dict)), \
        (path, got, ref)
    if isinstance(ref, dict):
        assert list(got) == list(ref), path
        for k in ref:
            _same(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(got), path
    else:
        assert got == ref, (path, got, ref)


# ---- the config reader -----------------------------------------------------

def test_reader_covers_every_shipped_config():
    assert len(CONFIGS) >= 7


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_reader_matches_yaml_safe_load(path):
    ref = yaml.safe_load(path.read_text())
    _same(tconfigs.load_config(str(path)).to_dict(), ref)


def test_reader_keeps_yaml_1_1_types():
    cfg = tconfigs.load_config(str(ROOT / "configs" / "chexpert_pretrain_config.yaml"))
    assert cfg.train.optimizer.weight_decay == "1e-6"   # no dot: a string, as in yaml
    assert cfg.lightning.trainer.lr == 5e-05 and isinstance(cfg.lightning.trainer.lr, float)
    assert cfg.lightning.trainer.precision == "bf16"
    assert cfg.lightning.checkpoint_callback.save_last is True
    assert cfg.lightning.checkpoint_callback.dirpath == "./data/ckpt"
    assert cfg.parallel.fsdp == 1 and isinstance(cfg.parallel.fsdp, int)


def test_reader_matches_yaml_on_the_driver_config():
    text = yaml.safe_dump(DRIVER_CFG, sort_keys=False)
    _same(tconfigs.loads_config(text).to_dict(), yaml.safe_load(text))
    _same(tconfigs.loads_config(text).to_dict(), DRIVER_CFG)


SCALARS = """\
a: 1e-6
b: 0.00005
c: 16
d: bf16
e:
f: 'x # y'  # a comment
g: "q\\u00e9\\t"
h: yes
i: 0x1f
j: 010
k: .inf
l: -1.5e+3
m: 1_000
n: ~
o: 'it''s'
p: a#b
q: off
r: -.5
s: "1"
t: +12
nested:
    deeper:
        x: 1

    y: 2   # back one level
z: null
"""


def test_reader_resolves_scalars_as_yaml_does():
    _same(tconfigs.loads_config(SCALARS).to_dict(), yaml.safe_load(SCALARS))


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n",
    "a: [1, 2]\n",
    "a: {b: 1}\n",
    "a:\n  - 1\n  - 2\n",
    "a: !!str 1\n",
    "a: |\n  block\n",
    "a: 2001-12-14\n",
    "a:\n    b: 1\n  c: 2\n",
    "--- \na: 1\n",
], ids=["anchor", "flow-list", "flow-map", "block-list", "tag", "block-scalar", "timestamp",
        "bad-indent", "document"])
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(tconfigs.ConfigSyntaxError):
        tconfigs.loads_config(text)


@pytest.mark.parametrize("path", CONFIGS[:3], ids=lambda p: p.name)
def test_save_config_reads_back_the_same_in_both_readers(path, tmp_path):
    ref = yaml.safe_load(path.read_text())
    cfg = TConfig(ref)
    cfg.set_path("extra.small", 1e-6)
    cfg.set_path("extra.big", 1.5e300)
    ref = cfg.to_dict()
    out = tmp_path / "config.yaml"
    tconfigs.save_config(cfg, str(out))
    _same(yaml.safe_load(out.read_text()), ref)
    _same(tconfigs.load_config(str(out)).to_dict(), ref)
    _same(json.loads(out.read_text()), ref)


def test_config_paths_and_merge_match_jax():
    ops = [("set_path", "a.b.c", 1), ("set_path", "a.d", "x"), ("merge", {"a": {"b": {"e": 2}}}),
           ("set_path", "a.b", 3), ("merge", {"f": None})]
    j, t = JConfig(), TConfig()
    for op, *args in ops:
        getattr(j, op)(*args)
        getattr(t, op)(*args)
    _same(t.to_dict(), j.to_dict())
    for path in ("a.b", "a.d", "a.missing", "f", "nope.x"):
        assert t.get_path(path, "dflt") == j.get_path(path, "dflt")
    merged = tconfigs.merge_configs({"a": {"x": 1}}, None, {"a": {"y": 2}})
    assert merged.to_dict() == {"a": {"x": 1, "y": 2}}
    assert list(tconfigs.iter_leaves(t)) == list(j_iter_leaves(j))


# ---- LR schedulers and early stopping ----------------------------------------

METRICS = [5.0, 4.0, 4.5, 4.5, 4.6, 4.7, 4.8, 4.9, 5.0, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5, 3.6,
           3.7, None, 2.0, 2.5]


@pytest.mark.parametrize("name", ["plateau", "warmup", "cos", "step", "const", "none"])
def test_scheduler_matches_jax(name):
    cfg = {"train": {"scheduler": {"name": name}}, "lightning": {"trainer": {"lr": 1e-3}}}
    js, ts = joptim.make_scheduler(JConfig(cfg)), toptim.make_scheduler(TConfig(cfg))
    assert ts.current_lr == js.current_lr
    for i, m in enumerate(METRICS):
        assert ts.step(m) == js.step(m), (name, i)
        if i == 9:  # a round trip of the state mid-sequence
            restored = toptim.make_scheduler(TConfig(cfg))
            restored.load_state_dict(json.loads(json.dumps(ts.state_dict())))
            ts = restored
        assert ts.state_dict() == js.state_dict()


def test_scheduler_max_mode_and_unknown_name():
    js = joptim.LRScheduler(name="plateau", base_lr=0.1, mode="max", patience=1)
    ts = toptim.LRScheduler(name="plateau", base_lr=0.1, mode="max", patience=1)
    for m in METRICS:
        assert ts.step(m) == js.step(m)
    with pytest.raises(ValueError, match="unknown scheduler"):
        toptim.LRScheduler(name="cyclic", base_lr=0.1).step(1.0)


@pytest.mark.parametrize("mode,patience,min_delta", [("min", 3, 0.0), ("min", 2, 0.2),
                                                     ("max", 3, 0.0)])
def test_early_stopping_matches_jax(mode, patience, min_delta):
    j = jtrainer.EarlyStopping(patience=patience, min_delta=min_delta, mode=mode)
    t = ttrainer.EarlyStopping(patience=patience, min_delta=min_delta, mode=mode)
    stops = []
    for i, m in enumerate(m for m in METRICS if m is not None):
        if i == 5:
            restored = ttrainer.EarlyStopping(patience=patience, min_delta=min_delta, mode=mode)
            restored.load_state_dict(t.state_dict())
            t = restored
        stopped = t.step(m)
        assert stopped == j.step(m)
        assert t.state_dict() == j.state_dict()
        stops.append(stopped)
    assert any(stops)  # the sequence reaches a stop


def test_trainer_limit_is_lightnings():
    loader = list(range(10))
    for limit in (None, 0.25, 1.0, 0.01, 3, 20, 2.5):
        assert ttrainer.Trainer._limit(limit, loader) == jtrainer.Trainer._limit(limit, loader)


# ---- the checkpoint manager ----------------------------------------------------

SAVES = [  # (step, val_loss or None)
    (1, 3.0), (2, None), (3, 1.0), (4, 2.0), (5, None), (6, 5.0), (7, 0.5), (8, None), (9, 4.0)]


def _jax_tree(step):
    return {"w": jnp.full((4,), float(step)), "step": jnp.asarray(step, jnp.int32)}


def _torch_tree(step):
    return {"w": torch.full((4,), float(step)), "step": torch.tensor(step, dtype=torch.int32)}


def _rel(path, root):
    return None if path is None else str(Path(path).relative_to(root))


@pytest.mark.parametrize("mode,top_k,save_last", [("min", 2, True), ("max", 3, False),
                                                  ("min", 1, False)])
def test_manager_bookkeeping_matches_jax(tmp_path, mode, top_k, save_last):
    jm = JManager(tmp_path / "jax", mode=mode, save_top_k=top_k, save_last=save_last)
    tm = TManager(tmp_path / "torch", mode=mode, save_top_k=top_k, save_last=save_last)
    for step, loss in SAVES:
        metrics = {} if loss is None else {"val_loss": loss}
        jm.save(_jax_tree(step), step=step, metrics=metrics)
        tm.save(_torch_tree(step), step=step, metrics=metrics)
        assert tm.manifest == jm.manifest
        assert _rel(tm.best(), tmp_path / "torch") == _rel(jm.best(), tmp_path / "jax")
        assert _rel(tm.last(), tmp_path / "torch") == _rel(jm.last(), tmp_path / "jax")
    on_disk = sorted(p.name for p in (tmp_path / "torch").iterdir() if p.name.startswith("step_"))
    assert on_disk == sorted(x for e in tm.manifest["entries"]
                             for x in (e["name"], e["name"] + ".meta.json"))
    # a new manager reads the same manifest and agrees
    again = TManager(tmp_path / "torch", mode=mode, save_top_k=top_k, save_last=save_last)
    assert again.best() == tm.best() and again.last() == tm.last()


def test_manager_restore_gives_tensors_cfg_and_extra(tmp_path):
    tm = TManager(tmp_path, save_top_k=2)
    path = tm.save(_torch_tree(3), step=3, metrics={"val_loss": 1.5},
                   cfg=TConfig({"experiment_name": "x"}), trainer_state={"epoch": 1})
    payload, cfg, extra = tm.restore(path)
    assert torch.equal(payload["w"], _torch_tree(3)["w"]) and int(payload["step"]) == 3
    assert cfg.experiment_name == "x"
    assert extra == {"step": 3, "metrics": {"val_loss": 1.5}, "trainer_state": {"epoch": 1}}
    assert not list(tmp_path.glob(".*tmp*"))  # the temporary directory was renamed away


# the port's counterparts of tests/test_checkpoints_async.py

def _tree(step: int):
    rng = np.random.RandomState(step)
    return {"params": {"w": torch.from_numpy(rng.randn(64, 64).astype(np.float32)),
                       "b": torch.from_numpy(rng.randn(64).astype(np.float32))},
            "step": torch.tensor(step, dtype=torch.int32)}


def test_async_save_roundtrip(tmp_path):
    mgr = TManager(tmp_path, monitor="val_loss", save_top_k=1, async_save=True)
    path = mgr.save(_tree(3), step=3, metrics={"val_loss": 1.0},
                    cfg=TConfig({"experiment_name": "async"}))
    mgr.wait()
    restored, cfg, extra = mgr.restore(path)
    assert int(restored["step"]) == 3
    assert torch.equal(restored["params"]["w"], _tree(3)["params"]["w"])
    assert cfg.experiment_name == "async" and extra["step"] == 3
    assert mgr.saves[-1]["name"] == "step_00000003" and mgr.saves[-1]["gb"] > 0


def test_async_sequence_prunes_like_sync(tmp_path):
    results = {}
    for mode, async_save in (("sync", False), ("async", True)):
        d = tmp_path / mode
        mgr = TManager(d, monitor="val_loss", save_top_k=2, save_last=True,
                       async_save=async_save)
        for step, loss in ((1, 3.0), (2, 1.0), (3, 2.0), (4, 5.0)):
            mgr.save(_tree(step), step=step, metrics={"val_loss": loss})
        mgr.wait()
        kept = sorted(e["name"] for e in mgr.manifest["entries"])
        results[mode] = (kept, _rel(mgr.best(), d), _rel(mgr.last(), d))
        assert {"step_00000002", "step_00000003", "step_00000004"} == set(kept), kept
        restored, _, _ = mgr.restore(mgr.best())
        assert int(restored["step"]) == 2
    assert results["sync"] == results["async"]


def test_async_protects_in_flight_unworthy_save(tmp_path, monkeypatch):
    from gloria_tpu_torch.training import checkpoints

    real_write = checkpoints._write_state

    def slow_write(path, payload):  # keep the write in flight while save() returns
        time.sleep(0.3)
        real_write(path, payload)

    monkeypatch.setattr(checkpoints, "_write_state", slow_write)
    mgr = TManager(tmp_path, monitor="val_loss", save_top_k=1, save_last=False, async_save=True)
    mgr.save(_tree(1), step=1, metrics={"val_loss": 1.0})  # the best
    p2 = mgr.save(_tree(2), step=2, metrics={"val_loss": 9.0})  # unworthy
    names = {e["name"] for e in mgr.manifest["entries"]}
    assert "step_00000002" in names  # still in the manifest while it is written
    assert not (tmp_path / "step_00000002").exists()  # not yet renamed into place
    mgr.wait()
    restored, _, _ = mgr.restore(p2)  # fully written despite being unworthy
    assert int(restored["step"]) == 2
    mgr.save(_tree(3), step=3, metrics={"val_loss": 2.0})
    mgr.wait()
    names = {e["name"] for e in mgr.manifest["entries"]}
    assert "step_00000002" not in names  # pruned once out of flight
    assert not (tmp_path / "step_00000002").exists()
    assert "step_00000001" in names


def test_last_and_best_skip_crash_orphaned_manifest_entry(tmp_path):
    mgr = TManager(tmp_path, monitor="val_loss", save_top_k=2)
    state = {"w": torch.arange(4.0)}
    p1 = mgr.save(state, step=1, metrics={"val_loss": 1.0})
    p2 = mgr.save(state, step=2, metrics={"val_loss": 0.5})
    shutil.rmtree(p2)  # the write of step 2 never finished
    assert mgr.last() == p1
    assert mgr.best() == p1
    mgr2 = TManager(tmp_path, monitor="val_loss", save_top_k=2)
    assert mgr2.last() == p1 and mgr2.best() == p1


def test_async_write_error_reaches_wait(tmp_path, monkeypatch):
    from gloria_tpu_torch.training import checkpoints

    def failing_write(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoints, "_write_state", failing_write)
    mgr = TManager(tmp_path, save_top_k=1, async_save=True)
    mgr.save(_tree(1), step=1, metrics={"val_loss": 1.0})
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        mgr.wait()
    assert mgr.last() is None  # the name is in the manifest, its directory is not


# ---- the tokenizer's persistence ------------------------------------------------

@pytest.mark.parametrize("lower", [True, False])
def test_save_vocab_is_byte_equal_to_jax(tmp_path, lower):
    corpus = ["Heart size is normal.", "No focal consolidation; small effusion é."]
    jt = jtok.WordPieceTokenizer.from_corpus(corpus, lower=lower)
    tt = ttok.WordPieceTokenizer.from_corpus(corpus, lower=lower)
    jt.save_vocab(tmp_path / "jax")
    tt.save_vocab(tmp_path / "torch")
    for name in ("vocab.txt", "tokenizer_config.json"):
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    back = ttok.load_saved_tokenizer(tmp_path / "jax")
    assert back.vocab == tt.vocab and back.lower == lower
    assert ttok.load_saved_tokenizer(tmp_path / "missing") is None


# ---- the metric logger ------------------------------------------------------------

LOG_SEQUENCE = [
    ({"loss": 3.5, "lr": 1e-4}, 1, "train"),
    ({"loss": np.float32(2.25), "lr": 1e-4, "grad_norm": 1.5}, 2, "train"),
    ({"train_loss": 3.0, "epoch_time": 0.5}, 2, "epoch"),
    ({"train_loss": 2.0, "epoch_time": 0.4, "val_loss": 2.5}, 4, "epoch"),
    ({"val_loss": None}, 5, "epoch"),
    ({"test_loss": torch.tensor(1.25)}, 4, "test"),
]


def _rows(path):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    time_col = rows[0].index("time")
    return [r[:time_col] + r[time_col + 1 :] for r in rows]


def test_metric_logger_files_match_jax(tmp_path):
    loggers = {"jax": JLogger(tmp_path / "jax"), "torch": TLogger(tmp_path / "torch")}
    for metrics, step, split in LOG_SEQUENCE:
        for name, logger in loggers.items():
            m = dict(metrics)
            if name == "jax":
                m = {k: (float(v) if isinstance(v, torch.Tensor) else v) for k, v in m.items()}
            logger.log(m, step, split)
    for logger in loggers.values():
        logger.log_histogram("weights", np.arange(10.0), step=3)
        logger.close()
    jax_files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == jax_files
    for name in jax_files:
        if name.endswith(".csv"):
            assert _rows(tmp_path / "torch" / name) == _rows(tmp_path / "jax" / name), name
        else:
            assert (tmp_path / "torch" / name).read_text() == (tmp_path / "jax" / name).read_text()
    assert "metrics_epoch.jsonl" in jax_files  # val_loss outside the first header


def test_metric_logger_image_is_fail_soft(tmp_path):
    logger = TLogger(tmp_path)
    logger.log_image("attn", np.zeros((4, 4, 3)), step=1)
    logger.log_image("broken", object(), step=1)  # must not raise
    logger.close()
