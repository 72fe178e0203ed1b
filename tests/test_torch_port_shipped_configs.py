"""The shipped configs through the port's driver as shipped: precision 16 /
bf16 mapped onto the bf16 model in the pretrain phase (the grounding
configs' too), the task phases in f32 at every precision, the eval path at
bf16, and the training-time attention plots (``train.nvis``), against the
JAX package.

Inputs come from numpy seeds; the weights of the driver runs are JAX's
initial ones, carried over by the weights bridge.  Tolerances:

- (a) ``to_rgb``, ``heatmap_overlay`` and ``build_attention_images``: bit
  for bit (uint8 arrays out of the same cv2 and PIL calls);
- (b) ``AttentionPlotCallback`` on the same metrics and batch: the same
  file names at the same steps and the same PNG bytes;
- (c) the bf16 driver against JAX's ``run.py`` at bf16
  (:data:`PARITY_CFG` with ``precision: bf16`` and ``train.nvis: 2``):
  * its first logged step against JAX's first train step run op by op
    (``jax.disable_jit``) on the same batch from the same weights: the
    global losses within :data:`GLOBAL_LOSS_ULPS` of a bf16 spacing at the
    loss (the loss is taken in f32 from logits of bf16 embeddings; both
    sides round where JAX's source rounds, so only sums taken in another
    order differ, and they move a logit by a few bf16 steps of its own
    size at most; measured 0.19 and 0.11 of a spacing); the local losses
    within JAX's envelope for the bf16 storage of their O(B²)
    intermediates, 0.02 + 0.02·|loss| (``tests/test_gloria_loss.py:
    193-195``), which JAX stores in bf16 and the port keeps in f32
    (``models.gloria_model``; measured 0.0025 and 0.0014);
  * the whole run (the 9 logged losses: 4 steps, 2 × train and val, test)
    against jitted JAX in L2, within :data:`WHOLE_RUN_FACTOR` times JAX's
    own bf16-to-f32 distance over the same vector (see there);
  * the run is bf16: its distance to the port's own f32 run is more than
    :data:`BF16_SHOWS` of that JAX distance;
- (d) precision 16, "16" and "bf16" give a bf16 pretrain model, 32, "32"
  and unset an f32 one; a classification config at bf16 gives the results
  of the same config at 32 bit for bit;
- (e) the grounding path at bf16: every float output of the steps f32,
  the localization metrics finite (AUROC and AP where the label has a box);
- (f) every ``configs/*.yaml`` passes ``run.refuse_unported`` as shipped.
"""

import copy
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from gloria_tpu.configs import Config as JConfig
from gloria_tpu.training import plotting as jplot
from gloria_tpu.utils import viz as jviz
from gloria_tpu_torch import builder, run
from gloria_tpu_torch.configs import Config, load_config
from gloria_tpu_torch.training import plotting as tplot
from gloria_tpu_torch.training.checkpoints import load_checkpoint, save_checkpoint
from gloria_tpu_torch.utils import viz as tviz
from gloria_tpu_torch.utils.weights import state_dict_from_jax
from test_torch_port_driver import _JAX_RUN, PARITY_CFG, _csv, _run_dir, _write_cfg

ROOT = Path(__file__).resolve().parents[1]
GLOBAL_LOSS_ULPS = 0.5
LOCAL_ENVELOPE = (0.02, 0.02)  # absolute, relative: tests/test_gloria_loss.py:193-195
# The whole bf16 run against jitted JAX's, in units of JAX's own distance D
# from its bf16 run to its f32 run over the same 9 losses.  Two causes keep
# the port off jitted JAX, and each is a bf16-against-f32 difference of its
# own, so each may move the run by about D: (1) XLA's CPU compiler fuses
# elementwise chains and drops bf16 roundings that the source (and the
# port, and JAX op by op) keeps, so jitted JAX is a run with fewer
# roundings than either; (2) JAX stores the local loss's O(B²)
# intermediates in bf16 and the port keeps them in f32.  On top of both,
# the port's own rounding noise against JAX's source rounding, which PR 21's
# per-step rule bounds by D again (2 D less the f32 tolerance, there taken
# against the jitted step that already holds cause 1).  So 3 D.  Measured:
# 1.88 D (0.1375 against D = 0.0732).
WHOLE_RUN_FACTOR = 3.0
BF16_SHOWS = 0.25  # measured: the port's bf16-to-f32 distance 0.1087, 1.48 D

# Prepended to tests/test_torch_port_driver.py's _JAX_RUN: the first batch
# the trainer hands JAX's train step is pickled to $GLORIA_FIRST_BATCH.
_CAPTURE_FIRST_BATCH = """
import os, pickle, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
from gloria_tpu import builder as _builder
_init_gloria = _builder.init_gloria
def _capture_first_batch(*a, **kw):
    model, state, train_step, eval_step = _init_gloria(*a, **kw)
    def first_step(state, batch):
        path = os.environ["GLORIA_FIRST_BATCH"]
        if not os.path.exists(path):
            with open(path + ".part", "wb") as fh:
                pickle.dump({k: np.asarray(v) for k, v in batch.items()}, fh)
            os.replace(path + ".part", path)  # after the initial variables' export
        return train_step(state, batch)
    return model, state, first_step, eval_step
_builder.init_gloria = _capture_first_batch
"""

# The losses of JAX's first train step at bf16, op by op: its train-mode
# forward and calc_loss (train_step's loss_fn, gloria_tpu/training/train.py,
# without the gradient, which the step's losses do not depend on) from the
# exported initial variables on the captured batch, once the run has
# written it; its scalars, pickled.
_JAX_FIRST_STEP = """
import os, pickle, sys, time
import numpy as np
import jax
import jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
repo, cfg_path, init, batch_path, out = sys.argv[1:6]
sys.path.insert(0, repo)
from gloria_tpu.builder import build_gloria_model
from gloria_tpu.configs import load_config
from gloria_tpu.models import GLoRIA
cfg = load_config(cfg_path)
model = build_gloria_model(cfg, dtype=jnp.bfloat16)
deadline = time.time() + 600
while not os.path.exists(batch_path) and time.time() < deadline:
    time.sleep(0.2)
with open(batch_path, "rb") as fh:
    batch = {k: jnp.asarray(v) for k, v in pickle.load(fh).items()}
with open(init, "rb") as fh:
    variables = pickle.load(fh)
with jax.disable_jit():
    outs, _ = model.apply(variables, batch, train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
    img_l, img_g, txt_l, txt_g, grid = outs
    _, metrics, _ = model.apply(variables, img_l, img_g, txt_l, txt_g, batch["cap_lens"], grid,
                                None, chunk=0, method=GLoRIA.calc_loss)
with open(out, "wb") as fh:
    pickle.dump({k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}, fh)
"""


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_env(tmp_path: Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["JAX_PLATFORMS"] = "cpu"
    env["GLORIA_COMPILE_CACHE"] = str(tmp_path / "jax_cache")  # run.py's own cache, kept here
    return env | extra


# ---- (a) the attention grid -------------------------------------------------------------

def _grid_inputs(seed: int, kind: str, B: int = 5, W: int = 7, side: int = 4, H: int = 40):
    rng = np.random.RandomState(seed)
    if kind == "uint8":
        imgs = rng.randint(0, 256, (B, H, H, 3)).astype(np.uint8)
    else:  # normalized, as the loader hands them to the model
        imgs = (rng.rand(B, H, H, 3).astype(np.float32) - 0.5) * 2
    attn = rng.dirichlet(np.ones(side * side), (B, W)).reshape(B, W, side, side)
    cap_lens = rng.randint(1, W + 1, B)
    cap_lens[0] = W  # one caption of all W words
    words = [[f"w{i}_{j}" if j % 3 else f"##p{j}" for j in range(int(n))]
             for i, n in enumerate(cap_lens)]
    return imgs, attn.astype(np.float32), words, cap_lens


@pytest.mark.parametrize("kind", ["uint8", "normalized"])
def test_to_rgb_and_heatmap_match_jax(kind):
    imgs, attn, _, _ = _grid_inputs(0, kind)
    for img in (imgs[0], imgs[1][..., 0]):  # colour and grey
        np.testing.assert_array_equal(tviz.to_rgb(img), jviz.to_rgb(img))
    for a in (attn[0, 0], np.random.RandomState(1).rand(40, 40).astype(np.float32)):
        got, want = tviz.heatmap_overlay(imgs[2], a), jviz.heatmap_overlay(imgs[2], a)
        assert got.dtype == want.dtype == np.uint8 and got.shape == (40, 40, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rand_vis", [False, True], ids=["first", "rand_vis"])
@pytest.mark.parametrize("kind", ["uint8", "normalized"])
def test_build_attention_images_matches_jax(kind, rand_vis):
    imgs, attn, words, cap_lens = _grid_inputs(2, kind)
    for nvis in (3, 8):  # fewer samples than the batch, and more
        got = tviz.build_attention_images(imgs, attn, words, cap_lens, nvis=nvis,
                                          rand_vis=rand_vis)
        want = jviz.build_attention_images(imgs, attn, words, cap_lens, nvis=nvis,
                                           rand_vis=rand_vis)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert got.shape[0] == min(nvis, len(imgs)) * (112 + tviz.FONT_MAX)
        np.testing.assert_array_equal(got, want)
        assert got.any()


# ---- (b) the callback ---------------------------------------------------------------------

def _plot_cfg(tmp_path: Path, rand_vis: bool) -> dict:
    return {"output_dir": str(tmp_path),
            "train": {"update_interval": 2, "nvis": 3, "rand_vis": rand_vis}}


def _plot_step(seed: int, B: int = 4, W: int = 6, side: int = 5):
    imgs, attn, words, cap_lens = _grid_inputs(seed, "normalized", B=B, W=W, side=side, H=48)
    metrics = {"loss": np.float32(1.0), "_attn": attn.reshape(B, W, side * side)}
    batch = {"imgs": imgs, "cap_lens": cap_lens, "_words": words}
    port_metrics = {k: torch.from_numpy(np.asarray(v)) for k, v in metrics.items()}
    port_batch = {"imgs": torch.from_numpy(imgs), "cap_lens": torch.from_numpy(cap_lens),
                  "_words": words}
    return (metrics, batch), (port_metrics, port_batch)


@pytest.mark.parametrize("rand_vis", [False, True], ids=["first", "rand_vis"])
def test_attention_plot_callback_matches_jax(tmp_path, rand_vis):
    """Over 5 batches at ``update_interval: 2``: the plots at batches 0, 2
    and 4 under the same names, byte for byte; nothing on the others."""
    jcb = jplot.AttentionPlotCallback(JConfig(_plot_cfg(tmp_path / "jax", rand_vis)))
    tcb = tplot.AttentionPlotCallback(Config(_plot_cfg(tmp_path / "port", rand_vis)))
    for batch_idx in range(5):
        (jm, jb), (tm, tb) = _plot_step(batch_idx)
        trainer = SimpleNamespace(global_step=10 + batch_idx)
        jcb.on_train_batch_end(trainer, None, jm, jb, batch_idx)
        tcb.on_train_batch_end(trainer, None, tm, tb, batch_idx)
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"attention_maps_step{s}.png" for s in (10, 12, 14)]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_attention_plot_callback_raises_where_jax_swallows(tmp_path):
    """A save that fails (the target is a directory): JAX's callback goes on
    in silence, the port's raises (ROADMAP.md §C)."""
    for side in ("jax", "port"):
        (tmp_path / side / "attention_maps_step3.png").mkdir(parents=True)
    (jm, jb), (tm, tb) = _plot_step(0)
    trainer = SimpleNamespace(global_step=3)
    jplot.AttentionPlotCallback(JConfig(_plot_cfg(tmp_path / "jax", False))).on_train_batch_end(
        trainer, None, jm, jb, 0)
    with pytest.raises(OSError):
        tplot.AttentionPlotCallback(Config(_plot_cfg(tmp_path / "port", False))) \
            .on_train_batch_end(trainer, None, tm, tb, 0)


# ---- (c) the bf16 driver against JAX's run.py -------------------------------------------

_RUN_LOSSES = (("metrics_train.csv", "loss"), ("metrics_epoch.csv", "train_loss"),
               ("metrics_epoch.csv", "val_loss"), ("metrics_test.csv", "test_loss"))


def _losses(run_dir: Path) -> np.ndarray:
    """The 9 logged losses of a run: the 4 steps', each epoch's train and
    val loss, the test loss."""
    return np.array([float(r[k]) for name, k in _RUN_LOSSES for r in _csv(run_dir / name)])


def _bf16_ulp(x: float) -> float:
    return float(np.exp2(np.floor(np.log2(abs(x))) - 7))


def test_bf16_driver_matches_jax_run(tmp_path):
    """(c) of the module docstring: the port's driver at bf16 and at f32 from
    JAX's initial weights, beside JAX's ``run.py`` at both and JAX's first
    bf16 step op by op."""
    cfg = copy.deepcopy(PARITY_CFG)
    cfg["train"]["nvis"] = 2
    cfg32 = copy.deepcopy(cfg)
    cfg["lightning"]["trainer"]["precision"] = "bf16"
    paths = {"bf16": _write_cfg(tmp_path / "bf16.yaml", cfg),
             "f32": _write_cfg(tmp_path / "f32.yaml", cfg32)}
    first_batch, export = tmp_path / "first_batch.pkl", tmp_path / "jax_init_bf16.pkl"
    step_out = tmp_path / "jax_first_step.pkl"
    # JAX's runs at bf16 and f32, and its first bf16 step op by op, which
    # waits for the batch that the bf16 run captures, all at once
    commands = {p: [(_CAPTURE_FIRST_BATCH if p == "bf16" else "") + _JAX_RUN, str(ROOT),
                    paths[p], str(tmp_path / f"jax_{p}"), str(tmp_path / f"jax_init_{p}.pkl")]
                for p in paths}
    commands["first step"] = [_JAX_FIRST_STEP, str(ROOT), paths["bf16"], str(export),
                              str(first_batch), str(step_out)]
    procs, logs = {}, {}
    try:
        for name, cmd in commands.items():
            logs[name] = tmp_path / f"{name.replace(' ', '_')}.log"
            with open(logs[name], "w") as log:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-c", *cmd], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                    env=_jax_env(tmp_path / name.replace(" ", "_"),
                                 GLORIA_FIRST_BATCH=str(first_batch)))
        while not first_batch.exists():  # the initial variables are on disk before it
            assert procs["bf16"].poll() is None, logs["bf16"].read_text()[-3000:]
            time.sleep(0.2)
        with open(export, "rb") as fh:
            save_checkpoint(tmp_path / "init", {"model": state_dict_from_jax(pickle.load(fh))})
        for p in paths:
            assert run.cli(["-c", paths[p], "--train", "--test", "--device", "cpu",
                            "--output_dir", str(tmp_path / f"port_{p}"), "--ckpt",
                            str(tmp_path / "init")]) == 0
        for name, proc in procs.items():
            assert proc.wait(timeout=600) == 0, (name, logs[name].read_text()[-3000:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(tmp_path / "jax_init_f32.pkl", "rb") as fh32, open(export, "rb") as fh16:
        init32, init16 = pickle.load(fh32), pickle.load(fh16)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(init32),
                                                     jax.tree_util.tree_leaves(init16)))

    dirs = {side: _run_dir(tmp_path / side) for side in
            ("jax_bf16", "jax_f32", "port_bf16", "port_f32")}
    # the first logged step, against JAX op by op
    with open(step_out, "rb") as fh:
        jax_step = pickle.load(fh)
    first = _csv(dirs["port_bf16"] / "metrics_train.csv")[0]
    for k in ("global_loss0", "global_loss1"):
        gap = abs(float(first[k]) - jax_step[k]) / _bf16_ulp(jax_step[k])
        print(f"step 1 {k}: port {float(first[k]):.6f}, JAX op by op {jax_step[k]:.6f}, "
              f"{gap:.3f} of a bf16 spacing (hold {GLOBAL_LOSS_ULPS})")
        assert gap <= GLOBAL_LOSS_ULPS, k
    for k in ("local_loss0", "local_loss1"):
        gap, bound = abs(float(first[k]) - jax_step[k]), \
            LOCAL_ENVELOPE[0] + LOCAL_ENVELOPE[1] * abs(jax_step[k])
        print(f"step 1 {k}: port {float(first[k]):.6f}, JAX op by op {jax_step[k]:.6f}, "
              f"|diff| {gap:.4f} (hold {bound:.4f})")
        assert gap <= bound, k

    # the whole run, against jitted JAX
    losses = {side: _losses(d) for side, d in dirs.items()}
    assert all(v.shape == (9,) and np.isfinite(v).all() for v in losses.values())
    jax_own = float(np.linalg.norm(losses["jax_bf16"] - losses["jax_f32"]))
    to_jax = float(np.linalg.norm(losses["port_bf16"] - losses["jax_bf16"]))
    port_own = float(np.linalg.norm(losses["port_bf16"] - losses["port_f32"]))
    print(f"whole run: port bf16 to JAX bf16 {to_jax:.4f} = {to_jax / jax_own:.3f} D "
          f"(hold {WHOLE_RUN_FACTOR}); JAX bf16 to f32 D = {jax_own:.4f}; port bf16 to f32 "
          f"{port_own:.4f} = {port_own / jax_own:.3f} D (more than {BF16_SHOWS})")
    assert to_jax <= WHOLE_RUN_FACTOR * jax_own
    assert port_own > BF16_SHOWS * jax_own
    # the f32 runs agree as the f32 parity test holds them
    np.testing.assert_allclose(losses["port_f32"], losses["jax_f32"], rtol=1e-4)

    # the plots: the same names at the same steps, images of the same shape
    from PIL import Image

    pngs = {side: sorted(p.name for p in dirs[side].glob("*.png")) for side in dirs}
    assert pngs["port_bf16"] == pngs["jax_bf16"] == pngs["port_f32"] == pngs["jax_f32"] == [
        f"attention_maps_step{s}.png" for s in (1, 2, 3, 4)]
    for name in pngs["port_bf16"]:
        got = np.asarray(Image.open(dirs["port_bf16"] / name))
        assert got.shape == np.asarray(Image.open(dirs["jax_bf16"] / name)).shape
        assert got.any()
    for p in paths:
        jman = json.loads((dirs[f"jax_{p}"] / "ckpt" / "manifest.json").read_text())
        tman = json.loads((dirs[f"port_{p}"] / "ckpt" / "manifest.json").read_text())
        assert [e["name"] for e in tman["entries"]] == [e["name"] for e in jman["entries"]]
        assert tman["last"] == jman["last"]


# ---- (d) the precision mapping -----------------------------------------------------------

PRECISIONS = [(16, torch.bfloat16), ("16", torch.bfloat16), ("bf16", torch.bfloat16),
              (32, torch.float32), ("32", torch.float32), (None, torch.float32)]


@pytest.mark.parametrize("precision,dtype", PRECISIONS,
                         ids=[f"{type(p).__name__}-{p}" for p, _ in PRECISIONS])
def test_precision_maps_onto_the_pretrain_model(tmp_path, monkeypatch, precision, dtype):
    """The model ``run.main`` builds computes in the mapped dtype with f32
    parameters, and the ``[run]`` report names it; the task phases map to
    f32 at the same precision.  (The bf16 driver's steps are held against
    JAX above.)"""
    cfg = Config(copy.deepcopy(PARITY_CFG))
    if precision is None:
        del cfg.lightning.trainer["precision"]
    else:
        cfg.lightning.trainer.precision = precision
    assert run.compute_dtype(cfg) == dtype
    built = []
    init_gloria = builder.init_gloria

    def capture(*a, **kw):
        res = init_gloria(*a, **kw)
        built.append(res[0])
        return res

    monkeypatch.setattr(builder, "init_gloria", capture)
    cfg.output_dir = str(tmp_path)
    args = run.get_parser().parse_args(["-c", "unused.yaml"])  # build and report only
    report = run.main(cfg, args, device="cpu")["run"]
    (model,) = built
    assert model.dtype == dtype and report["precision"] == str(dtype).removeprefix("torch.")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for phase in ("classification", "segmentation"):
        cfg.phase = phase
        assert run.compute_dtype(cfg) == torch.float32


def test_classification_at_bf16_is_the_f32_run(tmp_path):
    """A classification config at ``precision: bf16`` trains, checkpoints and
    tests bit for bit as at ``precision: 32`` (one batch a split): JAX's
    driver builds the task models with no dtype."""
    from test_torch_port_tasks import _driver_cfg

    results, states = {}, {}
    for precision in ("bf16", 32):
        cfg = _driver_cfg("classification")
        cfg["lightning"]["trainer"]["precision"] = precision
        path = _write_cfg(tmp_path / f"{precision}.yaml", cfg)
        args = run.get_parser().parse_args(["-c", path, "--device", "cpu", "--train", "--test",
                                            "--max_epochs", "1", "--limit_batches", "1"])
        c = load_config(path)
        run.apply_overrides(c, args)
        c.output_dir = str(tmp_path / str(precision))
        os.makedirs(c.output_dir)
        results[precision] = run.main(c, args)
        states[precision] = load_checkpoint(results[precision]["best_ckpt"])[0]["model"]
    assert results["bf16"]["run"]["precision"] == results[32]["run"]["precision"] == "float32"
    assert results["bf16"]["test"] == results[32]["test"]
    assert all(np.isfinite(v) for v in results[32]["test"].values())
    assert states["bf16"].keys() == states[32].keys()
    for k, v in states[32].items():
        assert torch.equal(states["bf16"][k], v), k


# ---- (e) the grounding path at bf16 --------------------------------------------------------

def test_grounding_driver_at_bf16(tmp_path, monkeypatch):
    """A tiny ImaGenome config at ``precision: bf16`` with both localization
    callbacks through the port's driver: it trains, validates and tests; the
    train and eval steps' float outputs (losses, ``_attn``, the sims) are
    f32; each split's ``sentences.csv`` has finite similarities and
    entropies, and a finite AUROC and AP exactly on the rows whose label has
    a box pixel (``data.gold_test`` saves the labels); the checkpoint holds
    f32 parameters and BatchNorm statistics."""
    from test_torch_port_grounding import _driver_cfg, write_mirror

    cfg = _driver_cfg(write_mirror(tmp_path / "mirror"))
    cfg["lightning"]["trainer"]["precision"] = "bf16"
    dtypes = {"train": set(), "eval": set()}
    init_gloria = builder.init_gloria

    def record(*a, **kw):
        model, state, train_step, eval_step = init_gloria(*a, **kw)
        assert model.dtype == torch.bfloat16

        def seen(which, metrics):
            dtypes[which] |= {(k, v.dtype) for k, v in metrics.items()
                              if isinstance(v, torch.Tensor) and v.is_floating_point()}
            return metrics

        def train(s, b):
            s, m = train_step(s, b)
            return s, seen("train", m)

        return model, state, train, lambda s, b: seen("eval", eval_step(s, b))

    monkeypatch.setattr(builder, "init_gloria", record)
    path = _write_cfg(tmp_path / "cfg.yaml", cfg)
    args = run.get_parser().parse_args(["-c", path, "--device", "cpu", "--train", "--test",
                                        "--limit_batches", "1"])
    c = load_config(path)
    run.apply_overrides(c, args)
    c.output_dir = str(tmp_path / "out")
    os.makedirs(c.output_dir)
    out = run.main(c, args)
    assert out["run"]["precision"] == "bfloat16" and out["run"]["global_step"] == 2
    for which in ("train", "eval"):
        names = {k for k, _ in dtypes[which]}
        assert {"loss", "_attn", "_local_sims", "_global_sims"} <= names, which
        assert {d for _, d in dtypes[which]} == {torch.float32}, (which, dtypes[which])
    val = [float(r["val_loss"]) for r in _csv(Path(c.output_dir) / "metrics_epoch.csv")
           if r.get("val_loss")]
    assert len(val) == 2 and np.isfinite(val).all() and np.isfinite(out["test"]["test_loss"])
    for split in ("train", "val", "test"):
        d = Path(c.output_dir) / "localization" / split
        rows = pd.read_csv(d / "sentences.csv")
        boxed = np.array([np.load(d / "label" / f"{sid}.npy").sum() > 0
                          for sid in rows["dicom_sent_id"]])
        assert len(rows) > 0 and boxed.any(), split
        for col in ("local_sims", "global_sims", "attn_entropy"):
            assert np.isfinite(rows[col]).all(), (split, col)
        for col in ("auroc", "avg_precision"):
            np.testing.assert_array_equal(np.isfinite(rows[col]), boxed, err_msg=f"{split} {col}")
    state = load_checkpoint(out["best_ckpt"])[0]["model"]
    assert all(v.dtype == torch.float32 for v in state.values() if v.is_floating_point())
    assert any(k.endswith("running_mean") for k in state)


# ---- (f) the shipped files ---------------------------------------------------------------

SHIPPED = sorted(p.name for p in (ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_config_passes_the_refusals(name):
    """Each shipped config, read by the port's reader with no override, passes
    ``run.refuse_unported``; the pretrain-phase ones (CheXpert and the
    ImaGenome grounding configs) compute in bf16, the task ones in f32."""
    assert len(SHIPPED) == 7
    path = str(ROOT / "configs" / name)
    cfg = load_config(path)
    args = run.get_parser().parse_args(["-c", path, "--train", "--test"])
    run.apply_overrides(cfg, args)
    run.refuse_unported(cfg, args)  # no error
    assert str(cfg.lightning.trainer.precision) == "bf16"
    pretrain = (cfg.phase or "pretrain") == "pretrain"
    assert run.compute_dtype(cfg) == (torch.bfloat16 if pretrain else torch.float32)


def test_shipped_pretrain_config_trains_at_bf16_and_plots(tmp_path, capsys):
    """``python -m gloria_tpu_torch.run -c configs/chexpert_pretrain_config.yaml
    --device cpu`` with only the data, ``bert_type`` and the size set in
    the config (one batch of 4 a split): it trains at bf16 and writes the
    attention plot of its first batch (``train.nvis: 8``,
    ``update_interval: 1000``, as shipped)."""
    cfg = load_config(str(ROOT / "configs" / "chexpert_pretrain_config.yaml"))
    for key, value in {
        "data.dataset": "synthetic", "data.synthetic_size": 4,  # no CheXpert on disk
        "model.text.bert_type": None,  # no downloaded tokenizer: the corpus's vocabulary
        # the size: a tiny model on small images, one batch of 4 a split
        "model.vision.model_name": "resnet_18", "model.text.embedding_dim": 32,
        "model.text.bert_config": {"vocab_size": 256, "hidden_size": 32, "num_layers": 1,
                                   "num_heads": 4, "intermediate_size": 64,
                                   "max_position_embeddings": 48},
        "data.text.word_num": 24, "data.image.imsize": 64,
        "transforms.random_crop.crop_size": 48, "train.batch_size": 4,
        "train.num_workers": 1, "lightning.trainer.max_epochs": 1,
    }.items():
        cfg.set_path(key, value)
    assert cfg.lightning.trainer.precision == "bf16" and cfg.train.nvis == 8
    path = tmp_path / "cfg.yaml"
    path.write_text(json.dumps(cfg.to_dict()))
    assert run.cli(["-c", str(path), "--train", "--device", "cpu",
                    "--output_dir", str(tmp_path / "out")]) == 0
    report = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                             if ln.startswith("[run] "))[len("[run] "):])
    assert report["precision"] == "bfloat16" and report["global_step"] == 1
    run_dir = _run_dir(tmp_path / "out")
    rows = _csv(run_dir / "metrics_epoch.csv")
    assert len(rows) == 1 and np.isfinite(float(rows[0]["train_loss"]))
    assert sorted(p.name for p in run_dir.glob("*.png")) == ["attention_maps_step1.png"]
    saved = load_config(str(run_dir / "config.yaml"))
    assert saved.lightning.trainer.precision == "bf16"
