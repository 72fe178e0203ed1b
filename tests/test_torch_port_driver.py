"""The port's training loop and driver as a whole: ``python -m
gloria_tpu_torch.run`` against the JAX package's ``run.py``, resume,
preemption, serving a trained checkpoint and the refusals.

Tolerances:
- the whole driver against JAX's (the same tiny synthetic config, dropout 0,
  train transforms that draw nothing, so both loaders give the same batches
  whatever their threads do; SGD at lr 0.01 with the ``step`` scheduler; the
  port from JAX's initial weights through the weights bridge): per-epoch
  ``train_loss`` and ``val_loss``, ``test_loss`` and every logged step's
  loss within ``STEP_RTOL`` = 1e-4 relative (measured ≤ 1.8e-6; the first
  step's loss is bit-equal), the learning rates and the manifest's names
  exactly.  Adam is not used there: its first update is about
  ``lr · sign(g)``, and chained steps at 5e-4 part by 1.5e-4 after one step
  and 1% after four, the ResNet's gradient in train mode not being smooth
  at f32 noise scale (``tests/test_torch_port_train.py``);
- resume on the CPU, at the step level and through the driver: bit for bit
  (the same ops on the same thread count, dropout seeded by seed and step);
- a served checkpoint against the in-memory model: bit for bit.
"""

import csv
import json
import os
import pickle
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

from gloria_tpu_torch import api, builder, run
from gloria_tpu_torch.configs import Config
from gloria_tpu_torch.data.synthetic import make_synthetic_batch
from gloria_tpu_torch.data.tokenizer import WordPieceTokenizer
from gloria_tpu_torch.training.optim import OptState
from gloria_tpu_torch.training.checkpoints import (CheckpointManager, load_checkpoint,
                                                   load_checkpoint_meta, restore_train_state,
                                                   save_checkpoint)
from gloria_tpu_torch.training.trainer import ProfileTrace, Trainer
from gloria_tpu_torch.utils.weights import state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
STEP_RTOL = 1e-4  # as tests/test_torch_port_train.py

PARITY_CFG = {
    "experiment_name": "parity",
    "phase": "pretrain",
    "random_seed": 0,
    "lightning": {
        "trainer": {"max_epochs": 2, "gradient_clip_val": 0.25, "lr": 0.01, "precision": 32},
        "checkpoint_callback": {"monitor": "val_loss", "save_last": True, "mode": "min",
                                "save_top_k": 1},
        "early_stopping_callback": {"monitor": "val_loss", "patience": 10, "mode": "min"},
    },
    "model": {
        "gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0},
        "vision": {"model_name": "resnet_18", "encoder_input_size": 0},
        "text": {"embedding_dim": 32, "last_n_layers": 4, "agg_tokens": True,
                 "aggregate_method": "sum",
                 "bert_config": {"vocab_size": 256, "hidden_size": 32, "num_layers": 1,
                                 "num_heads": 4, "intermediate_size": 64,
                                 "max_position_embeddings": 48, "dropout_rate": 0.0}},
    },
    # no transforms.random_crop: the train transform draws nothing
    "data": {"dataset": "synthetic", "synthetic_size": 16, "text": {"word_num": 24},
             "image": {"imsize": 64}},
    "transforms": {"norm": "half"},
    "train": {"update_interval": 1, "batch_size": 8, "num_workers": 2,
              "optimizer": {"name": "SGD", "weight_decay": "1e-6"},
              "scheduler": {"name": "step", "monitor": "val_loss"}},
}

# runs the JAX package's run.py as __main__ on one CPU device, and pickles
# the variables its builder initialized
_JAX_RUN = """
import pickle, sys
import jax
jax.config.update("jax_platforms", "cpu")
repo, cfg, out, export = sys.argv[1:5]
sys.path.insert(0, repo)
from gloria_tpu import builder
_init = builder.init_gloria
def init_and_export(*a, **kw):
    res = _init(*a, **kw)
    with open(export, "wb") as fh:
        pickle.dump(jax.device_get({"params": res[1].params,
                                    "batch_stats": res[1].batch_stats}), fh)
    return res
builder.init_gloria = init_and_export
sys.argv = ["run.py", "-c", cfg, "--train", "--test", "--output_dir", out]
exec(compile(open(repo + "/run.py").read(), "run.py", "exec"), {"__name__": "__main__"})
"""


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _write_cfg(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(path)


def _run_dir(base: Path) -> Path:
    dirs = [p for p in base.iterdir() if p.is_dir()]
    assert len(dirs) == 1, dirs
    return dirs[0]


def _csv(path: Path) -> list[dict]:
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def _main(tmp_path: Path, name: str, cfg: dict, *flags: str) -> tuple[dict, Path]:
    """One in-process ``run.main`` into ``tmp_path/name``: (its results, its run dir)."""
    out = tmp_path / name
    cfg_path = _write_cfg(tmp_path / f"{name}.yaml", cfg)
    argv = ["-c", cfg_path, "--device", "cpu", "--output_dir", str(out), *flags]
    args = run.get_parser().parse_args(argv)
    c = run.load_config(cfg_path)
    run.apply_overrides(c, args)
    c.output_dir = str(out / "run")
    os.makedirs(c.output_dir)
    run.save_config(c, os.path.join(c.output_dir, "config.yaml"))
    results = run.main(c, args)
    return results, out / "run"


# ---- the whole driver against the JAX package ----------------------------------

def test_driver_matches_jax_run(tmp_path):
    cfg_path = _write_cfg(tmp_path / "cfg.yaml", PARITY_CFG)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    env["GLORIA_COMPILE_CACHE"] = str(tmp_path / "jax_cache")  # run.py's own cache, kept here
    export = tmp_path / "jax_init.pkl"
    proc = subprocess.run([sys.executable, "-c", _JAX_RUN, str(ROOT), cfg_path,
                           str(tmp_path / "jax"), str(export)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]

    with open(export, "rb") as fh:
        init = state_dict_from_jax(pickle.load(fh))
    save_checkpoint(tmp_path / "init", {"model": init})
    assert run.cli(["-c", cfg_path, "--train", "--test", "--device", "cpu",
                    "--output_dir", str(tmp_path / "torch"), "--ckpt",
                    str(tmp_path / "init")]) == 0

    jdir, tdir = _run_dir(tmp_path / "jax"), _run_dir(tmp_path / "torch")
    for name, keys in (("metrics_epoch.csv", ("train_loss", "val_loss")),
                       ("metrics_test.csv", ("test_loss",)),
                       ("metrics_train.csv", ("loss",))):
        jrows, trows = _csv(jdir / name), _csv(tdir / name)
        assert len(trows) == len(jrows) > 0, name
        for jr, tr in zip(jrows, trows):
            assert tr["step"] == jr["step"]
            for k in keys:
                np.testing.assert_allclose(float(tr[k]), float(jr[k]), rtol=STEP_RTOL, atol=0,
                                           err_msg=f"{name} step {jr['step']} {k}")
            if name == "metrics_train.csv":
                assert float(tr["lr"]) == float(jr["lr"])
    lrs = [float(r["lr"]) for r in _csv(tdir / "metrics_train.csv")]
    assert lrs == [0.01, 0.01, 0.01 * 0.8, 0.01 * 0.8]  # the step scheduler moved it
    first, last = (float(r["loss"]) for r in _csv(tdir / "metrics_train.csv")[::3])
    assert first - last > 0.1  # the steps trained
    jman = json.loads((jdir / "ckpt" / "manifest.json").read_text())
    tman = json.loads((tdir / "ckpt" / "manifest.json").read_text())
    assert [e["name"] for e in tman["entries"]] == [e["name"] for e in jman["entries"]]
    assert tman["last"] == jman["last"]
    np.testing.assert_allclose([e["metric"] for e in tman["entries"]],
                               [e["metric"] for e in jman["entries"]], rtol=STEP_RTOL)
    # both best_ckpts files name their own best checkpoint
    for base, d in ((tmp_path / "jax", jdir), (tmp_path / "torch", tdir)):
        best = yaml.safe_load((base / "best_ckpts.yaml").read_text())
        assert Path(best["seed_0"]).relative_to(d) == Path("ckpt") / tman["last"]


# ---- the CLI in a process of its own -----------------------------------------------

def test_cli_trains_and_tests_on_the_cpu(tmp_path):
    cfg = json.loads(json.dumps(PARITY_CFG))
    cfg["transforms"]["random_crop"] = {"crop_size": 48}
    cfg["train"]["optimizer"] = {"name": "Adam", "weight_decay": "1e-6"}
    cfg["train"]["scheduler"] = {"name": "plateau", "monitor": "val_loss"}
    cfg_path = _write_cfg(tmp_path / "cfg.yaml", cfg)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "gloria_tpu_torch.run", "-c", cfg_path,
                           "--train", "--test", "--device", "cpu", "--output_dir",
                           str(tmp_path / "out"), "--limit_batches", "2"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run_dir = _run_dir(tmp_path / "out")
    saved = yaml.safe_load((run_dir / "config.yaml").read_text())
    assert saved["train"] == cfg["train"] and saved["output_dir"] == str(run_dir)
    assert saved["lightning"]["trainer"]["limit_train_batches"] == 2
    epochs = _csv(run_dir / "metrics_epoch.csv")
    assert [r["step"] for r in epochs] == ["2", "4"]
    assert all(np.isfinite(float(r[k])) for r in epochs for k in ("train_loss", "val_loss"))
    manifest = json.loads((run_dir / "ckpt" / "manifest.json").read_text())
    assert manifest["entries"] and manifest["last"]
    best = yaml.safe_load((tmp_path / "out" / "best_ckpts.yaml").read_text())["seed_0"]
    assert (Path(best) / "state.pt").is_file()
    report = json.loads(next(ln for ln in proc.stdout.splitlines()
                             if ln.startswith("[run] "))[len("[run] "):])
    assert report["device"] == "cpu" and report["global_step"] == 4
    assert [s["name"] for s in report["checkpoint_saves"]] == ["step_00000002", "step_00000004"]
    assert "best_ckpt" in proc.stdout and "test_loss" in proc.stdout


# ---- resume ----------------------------------------------------------------------

def _tiny_cfg() -> Config:
    cfg = Config(json.loads(json.dumps(PARITY_CFG)))
    cfg.model.text.bert_config.dropout_rate = 0.1  # resume must restore the dropout stream
    cfg.train.optimizer = {"name": "Adam", "weight_decay": 1e-6}
    return cfg


def test_resume_continues_bit_identically(tmp_path):
    """Restoring weights, BatchNorm statistics, the optimizer state, the
    step and the dropout seed reproduces the uninterrupted steps."""
    cfg = _tiny_cfg()
    raw = make_synthetic_batch(batch_size=4, num_tokens=16, imsize=32, vocab_size=256)
    _, state, step, _ = builder.init_gloria(cfg, raw, seed=0, device="cpu")
    for _ in range(3):
        state, _ = step(state, raw)
    save_checkpoint(tmp_path / "ck", state, cfg)

    losses_a = []
    for _ in range(3):
        state, m = step(state, raw)
        losses_a.append(float(m["loss"]))

    # another seed for the fresh state: everything must come from the checkpoint
    _, fresh, step2, _ = builder.init_gloria(cfg, raw, seed=1, device="cpu")
    payload, saved_cfg = load_checkpoint(tmp_path / "ck")
    assert saved_cfg.to_dict() == cfg.to_dict()
    restore_train_state(fresh, payload, resume=True)
    assert fresh.step == 3 and fresh.seed == 0 and fresh.opt_state.count == 3
    losses_b = []
    for _ in range(3):
        fresh, m = step2(fresh, raw)
        losses_b.append(float(m["loss"]))
    assert losses_a == losses_b
    for (name, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_driver_resume_continues_the_run(tmp_path):
    """A run stopped after epoch 1 and resumed with --resume --ckpt goes on
    with the epoch numbering, global step, scheduler, early stopping and data
    order, and its epoch 2 is the uninterrupted run's bit for bit."""
    _resume_continues_the_run(tmp_path, precision=32)


def test_driver_resume_continues_the_run_at_bf16(tmp_path):
    """The same at ``precision: bf16``: the checkpoints of the bf16 run hold
    f32 parameters and BatchNorm statistics, as JAX's do, the resumed run
    is the uninterrupted one bit for bit, and ``load_gloria`` serves the
    checkpoint with the f32 served forward, bit for bit as a model given
    the same state dict."""
    whole_dir = _resume_continues_the_run(tmp_path, precision="bf16")
    path = whole_dir / "ckpt" / "step_00000004"
    state = load_checkpoint(path)[0]["model"]
    assert all(v.dtype == torch.float32 for v in state.values() if v.is_floating_point())
    assert any(k.endswith("running_var") for k in state)
    served = api.load_gloria(str(path), device="cpu")
    ref = api.GloriaModel(served.cfg, state, tokenizer=served.tokenizer, device="cpu")
    imgs = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)
    txts = served.process_text(["small pleural effusion", "no acute process"])
    np.testing.assert_array_equal(served.get_similarities(imgs, txts, "both"),
                                  ref.get_similarities(imgs, txts, "both"))


def _resume_continues_the_run(tmp_path, precision) -> Path:
    cfg = _tiny_cfg().to_dict()
    cfg["lightning"]["trainer"]["precision"] = precision
    cfg["train"]["scheduler"] = {"name": "plateau", "monitor": "val_loss"}
    whole, whole_dir = _main(tmp_path, "whole", cfg, "--train", "--test")
    cfg_one = json.loads(json.dumps(cfg))
    cfg_one["lightning"]["trainer"]["max_epochs"] = 1
    first, first_dir = _main(tmp_path, "first", cfg_one, "--train")
    last = json.loads((first_dir / "ckpt" / "manifest.json").read_text())["last"]
    resumed, resumed_dir = _main(tmp_path, "resumed", cfg, "--train", "--test", "--resume",
                                "--ckpt", str(first_dir / "ckpt" / last))
    assert first["run"]["global_step"] == 2 and resumed["run"]["global_step"] == 4

    whole_rows = _csv(whole_dir / "metrics_epoch.csv")
    first_rows, resumed_rows = (_csv(d / "metrics_epoch.csv") for d in (first_dir, resumed_dir))
    assert [r["step"] for r in first_rows + resumed_rows] == ["2", "4"]
    for got, ref in ((first_rows[0], whole_rows[0]), (resumed_rows[0], whole_rows[1])):
        for k in ("train_loss", "val_loss", "val_local_loss0", "val_global_loss1"):
            assert got[k] == ref[k], k
    assert resumed["test"] == whole["test"]
    meta = load_checkpoint_meta(Path(resumed["best_ckpt"]).parent / "step_00000004")
    ref_meta = load_checkpoint_meta(whole_dir / "ckpt" / "step_00000004")
    assert meta["trainer_state"] == ref_meta["trainer_state"]
    assert meta["trainer_state"]["epoch"] == 2 and meta["trainer_state"]["scheduler"]["count"] == 2
    assert meta["trainer_state"]["early_stopping"]["best"] == min(
        float(whole_rows[0]["val_loss"]), float(whole_rows[1]["val_loss"]))
    assert whole["run"]["precision"] == resumed["run"]["precision"] == (
        "float32" if precision == 32 else "bfloat16")
    return whole_dir


# ---- preemption ------------------------------------------------------------------

class _PreemptAfter:
    """Stands in for the cluster scheduler: sends ``sig`` to this process
    after batch ``after``."""

    def __init__(self, after: int, sig=signal.SIGTERM):
        self.after, self.sig = after, sig

    def on_train_batch_end(self, trainer, state, metrics, batch, batch_idx):
        if batch_idx == self.after:
            os.kill(os.getpid(), self.sig)

    def on_validation_batch_end(self, *a): ...
    def on_test_batch_end(self, *a): ...
    def on_epoch_end(self, *a): ...


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGUSR1], ids=["sigterm", "sigusr1"])
def test_signal_saves_checkpoint_and_returns(tmp_path, sig):
    cfg = _tiny_cfg()
    cfg.lightning.trainer.max_epochs = 50
    cfg.output_dir = str(tmp_path)
    raw = make_synthetic_batch(batch_size=8, num_tokens=24, imsize=32, vocab_size=256)
    _, state, train_step, eval_step = builder.init_gloria(cfg, raw, device="cpu")
    batches = [raw] * 100
    manager = CheckpointManager(tmp_path / "ckpts", save_top_k=1)
    trainer = Trainer(cfg, train_step, eval_step, checkpoints=manager,
                      callbacks=[_PreemptAfter(after=2, sig=sig)])
    prior = signal.getsignal(sig)
    state = trainer.fit(state, batches)
    assert trainer.interrupted
    assert 3 <= state.step <= 4 and trainer.global_step == state.step
    payload, _, extra = manager.restore(manager.last())
    assert payload["step"] == state.step
    assert extra["metrics"]["interrupted"] == 1.0
    assert extra["trainer_state"]["epoch"] == 0  # the interrupted epoch is not complete
    assert signal.getsignal(sig) is prior
    rows = _csv(tmp_path / "metrics_epoch.csv")
    assert len(rows) == 1 and float(rows[0]["interrupted"]) == 1.0


@pytest.mark.parametrize("key", ["lightning.trainer.accumulate_grad_batches",
                                 "train.steps_per_dispatch"])
def test_trainer_refuses_window_stacking(key):
    cfg = _tiny_cfg()
    cfg.set_path(key, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A1.8"):
        Trainer(cfg, lambda s, b: (s, {}), checkpoints=None)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)

    def step(state, batch):
        return state, {"loss": (x @ x).sum()}

    cfg = _tiny_cfg()
    cfg.output_dir = str(tmp_path)
    cfg.lightning.trainer.max_epochs = 1
    trainer = Trainer(cfg, step, callbacks=[ProfileTrace(tmp_path / "profile", steps=2, skip=1)])
    trainer.fit(SimpleNamespace(opt_state=OptState(lr=0.01)), [{}] * 5)
    trace = json.loads((tmp_path / "profile" / "trace.json").read_text())
    assert trace["traceEvents"]


# ---- serving a trained checkpoint -------------------------------------------------

def test_load_gloria_serves_a_port_checkpoint(tmp_path):
    cfg = _tiny_cfg()
    raw = make_synthetic_batch(batch_size=4, num_tokens=16, imsize=32, vocab_size=256)
    model, state, step, _ = builder.init_gloria(cfg, raw, device="cpu")
    state, _ = step(state, raw)
    tokenizer = WordPieceTokenizer.from_corpus(["no acute cardiopulmonary process",
                                                "small left pleural effusion"])
    manager = CheckpointManager(tmp_path / "ckpt")
    manager.save_tokenizer(tokenizer)
    path = manager.save(state, step=1, metrics={"val_loss": 1.0}, cfg=cfg)

    served = api.load_gloria(path, device="cpu")
    ref = api.GloriaModel(cfg, model.state_dict(), tokenizer=tokenizer, device="cpu")
    assert served.tokenizer.vocab == tokenizer.vocab
    assert served.cfg.to_dict() == cfg.to_dict()
    imgs = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    txts = served.process_text(["small pleural effusion", "no acute process"])
    for kind in ("global", "local", "both"):
        np.testing.assert_array_equal(served.get_similarities(imgs, txts, kind),
                                      ref.get_similarities(imgs, txts, kind))
    # a one-off checkpoint's own tokenizer comes before the manager's
    other = WordPieceTokenizer.from_corpus(["another corpus"])
    save_checkpoint(tmp_path / "ckpt" / "one_off", state, cfg, tokenizer=other)
    assert api.load_gloria(str(tmp_path / "ckpt" / "one_off"),
                           device="cpu").tokenizer.vocab == other.vocab


# ---- refusals ---------------------------------------------------------------------

REFUSALS = [  # (config path → value, CLI flags, ROADMAP.md item)
    ({}, ["--fsdp", "2"], "A7"),
    ({}, ["--tp", "2"], "A7"),
    ({}, ["--multihost"], "A7"),
    ({}, ["--accumulate_grad_batches", "2"], "A1.8"),
    ({}, ["--steps_per_dispatch", "2"], "A1.8"),
    ({}, ["--loss_chunk", "8"], "A1.8"),
    ({}, ["--attention_entropy_loss_weight", "1.0"], "A1.6"),
]


@pytest.mark.parametrize("overrides,flags,item", REFUSALS,
                         ids=[f"{'+'.join(list(o) + f)}" for o, f, _ in REFUSALS])
def test_driver_refuses_unported_options(tmp_path, overrides, flags, item):
    cfg = Config(json.loads(json.dumps(PARITY_CFG)))
    for path, value in overrides.items():
        cfg.set_path(path, value)
    args = run.get_parser().parse_args(["-c", "unused.yaml", "--train", *flags])
    run.apply_overrides(cfg, args)
    cfg.output_dir = str(tmp_path)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        run.main(cfg, args, device="cpu")
    assert not list(tmp_path.iterdir())  # refused before anything was written


PRECISION_AND_NVIS = [  # the options the shipped-configs slice ported: (config path → value, flags)
    ({"lightning.trainer.precision": 16}, []),
    ({"lightning.trainer.precision": "bf16"}, []),
    ({"train.nvis": 8}, []),
    ({"train.nvis": 8}, ["--profile", "2"]),
]


@pytest.mark.parametrize("overrides,flags", PRECISION_AND_NVIS,
                         ids=[f"{'+'.join(list(o) + f)}" for o, f in PRECISION_AND_NVIS])
def test_driver_passes_precision_and_nvis(tmp_path, overrides, flags):
    """Precision 16 / bf16 and ``train.nvis`` pass the refusals: one train
    step runs, at bf16 for the two precisions (the ``[run]`` report), and
    with ``nvis`` it writes its attention plot."""
    cfg = Config(json.loads(json.dumps(PARITY_CFG)))
    for path, value in overrides.items():
        cfg.set_path(path, value)
    cfg.lightning.trainer.max_epochs = 1
    args = run.get_parser().parse_args(["-c", "unused.yaml", "--train", "--limit_batches", "1",
                                        *flags])
    run.apply_overrides(cfg, args)
    cfg.output_dir = str(tmp_path)
    report = run.main(cfg, args, device="cpu")["run"]
    bf16 = "lightning.trainer.precision" in overrides
    assert report["precision"] == ("bfloat16" if bf16 else "float32")
    assert report["global_step"] == 1
    assert sorted(p.name for p in tmp_path.glob("*.png")) == (
        [] if bf16 else ["attention_maps_step1.png"])


GROUNDING_OPTIONS = [  # the options the grounding slice ported: (config path → value, flags)
    ({"lightning.evaluate_localization": {"eval_attn_overlay_mode": "upsample"}}, []),
    ({"lightning.weight_instances_by_localization": {"temp": 0.2}}, []),
    ({}, ["--randomize_reports"]),
    ({}, ["--swap_left_right"]),
    ({}, ["--mask_mode", "word"]),
    ({}, ["--generate_sent"]),
]


@pytest.mark.parametrize("overrides,flags", GROUNDING_OPTIONS,
                         ids=[f"{'+'.join(list(o) + f)}" for o, f in GROUNDING_OPTIONS])
def test_driver_passes_grounding_options(tmp_path, overrides, flags):
    """The localization callbacks and the ImaGenome data ablations pass the
    refusals and reach the ``imagenome`` data module built from the config
    (on a synthetic mirror): a flag sets its dataset's option, a callback
    is built around that module's train loader."""
    from test_torch_port_grounding import write_mirror

    from gloria_tpu_torch.data.data_module import build_data_module
    from gloria_tpu_torch.training.localization import (EvaluateLocalization,
                                                        WeightInstancesByLocalization)

    mirror = write_mirror(tmp_path / "mirror", n_dicoms=10)
    cfg = Config(json.loads(json.dumps(PARITY_CFG)))
    for path, value in {**overrides, "data.dataset": "imagenome",
                        "data.mimic_cxr_download_directory": mirror["mimic"],
                        "data.imagenome_download_directory": mirror["imagenome"]}.items():
        cfg.set_path(path, value)
    args = run.get_parser().parse_args(["-c", "unused.yaml", "--train", *flags])
    run.apply_overrides(cfg, args)
    cfg.output_dir = str(tmp_path / "out")
    run.refuse_unported(cfg, args)  # no error
    dm = build_data_module(cfg, device="cpu")
    ds = dm.dataset("train")
    callbacks, loader = run.localization_callbacks(cfg, dm)
    if flags:
        option = {"--randomize_reports": "randomize_reports", "--swap_left_right": "swap_left_right",
                  "--generate_sent": "generate_sent", "--mask_mode": "text_masker"}[flags[0]]
        assert getattr(ds, option) and not callbacks
        return
    (cb,) = callbacks
    if "lightning.evaluate_localization" in overrides:
        assert isinstance(cb, EvaluateLocalization) and loader is None
        assert cb.save_dir == Path(cfg.output_dir) / "localization"
    else:
        assert isinstance(cb, WeightInstancesByLocalization) and cb.loader is loader
        assert len(cb.scores) == len(ds) == len(loader.dataset)


TASK_OPTIONS = [  # the options the downstream-task slice ported: (config path → value, flags)
    ({"phase": "classification"}, []),
    ({"phase": "segmentation"}, []),
    ({}, ["--train_pct", "0.5"]),
]


@pytest.mark.parametrize("overrides,flags", TASK_OPTIONS,
                         ids=[f"{'+'.join(list(o) + f)}" for o, f in TASK_OPTIONS])
def test_driver_accepts_task_options(overrides, flags):
    """The task phases and ``--train_pct`` pass the refusals; an unknown
    phase is a ValueError, not an unported option."""
    cfg = Config(json.loads(json.dumps(PARITY_CFG)))
    for path, value in overrides.items():
        cfg.set_path(path, value)
    args = run.get_parser().parse_args(["-c", "unused.yaml", "--train", *flags])
    run.apply_overrides(cfg, args)
    run.refuse_unported(cfg, args)  # no error
    if flags:
        assert cfg.data.frac == 0.5
    cfg.phase = "detection"
    with pytest.raises(ValueError, match="unknown phase"):
        run.refuse_unported(cfg, args)


def test_driver_accepts_fused_kernel(tmp_path):
    cfg = Config(json.loads(json.dumps(PARITY_CFG)))
    args = run.get_parser().parse_args(["-c", "unused.yaml", "--fused_kernel"])
    run.apply_overrides(cfg, args)
    assert cfg.model.gloria.fused_kernel is True
    run.refuse_unported(cfg, args)  # no error
