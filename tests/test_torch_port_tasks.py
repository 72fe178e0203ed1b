"""The downstream tasks of the port against the JAX package: the classifiers
and the U-Net (forward, the weights bridge), the task step with BCE and
MixedLoss, chained Adam steps under ``freeze_cnn``, the freeze flags, the
losses and metrics, and ``python -m gloria_tpu_torch.run`` in the
classification and segmentation phases.

Sizes: ResNet-18 backbones, 64² images (the pretrained classifier upsamples
them to 299², as the reference does), batches of 2-4, f32 (JAX's CPU
products are f32).  Tolerances, each test stating its own:
- forward logits within ``FWD_TOL`` = 1e-4 · max|ref|;
- a step's loss within ``LOSS_RTOL`` = 1e-5 relative, each gradient within
  ``GRAD_L2`` = 1e-4 relative L2 for the classifier (the train-mode ResNet's
  gradients are not smooth at f32 noise scale, so not per entry) and
  ``UNET_GRAD_L2`` = 1e-2 for the U-Net, the BatchNorm running statistics
  within ``STATS_TOL`` = 1e-5.  The U-Net's train-mode gradient is far
  worse conditioned than the classifier's (measured in the port in float64
  at this test's size: a 1e-9 relative change of the input moves a gradient
  by up to 7.5e-6, a 1e-7 change by up to 2.9e-3; its f32 gradient is
  6.0e-3 from its own float64 one), so no f32 implementation, JAX's
  included, holds 1e-4 there; the port is 2.7e-3 from JAX.  The conv biases
  of the ConvBlocks, whose exact gradient is 0 (a train-mode BatchNorm
  follows), are held in absolute norm instead, within 1e-6;
- three chained Adam steps under ``freeze_cnn``: frozen parameters bit-equal
  to their start, each trainable parameter's total update within
  ``UPDATE_L2`` = 1e-4 relative L2 of JAX's;
- losses within 1e-6 relative, AUROC / AUPRC / dice within 1e-6;
- the freeze flags' labels exactly.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from gloria_tpu.configs import Config as JConfig
from gloria_tpu.models.unet import ResnetUNet as JUNet
from gloria_tpu.models.vision_model import ImageClassifier as JImageClassifier
from gloria_tpu.models.vision_model import ImageEncoder as JImageEncoder
from gloria_tpu.ops import segmentation_loss as jloss
from gloria_tpu.training import metrics as jmetrics
from gloria_tpu.training import optim as joptim
from gloria_tpu.training import tasks as jtasks
from gloria_tpu.training.train import create_train_state
from gloria_tpu_torch import api, builder, run
from gloria_tpu_torch.configs import Config
from gloria_tpu_torch.models.gloria_model import GLoRIA as TGLoRIA
from gloria_tpu_torch.models.gloria_model import init_gloria
from gloria_tpu_torch.models.unet import ResnetUNet
from gloria_tpu_torch.models.vision_model import ImageClassifier, PretrainedImageClassifier
from gloria_tpu_torch.ops import segmentation_loss as tloss
from gloria_tpu_torch.training import metrics as tmetrics
from gloria_tpu_torch.training import optim, tasks
from gloria_tpu_torch.training.checkpoints import (extract_subtree, graft_subtree,
                                                   load_checkpoint, save_checkpoint)
from gloria_tpu_torch.utils.logging import MetricLogger
from gloria_tpu_torch.utils.weights import (classifier_state_dict_from_jax, state_dict_from_jax,
                                            unet_state_dict_from_jax)

FWD_TOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_L2 = 1e-4
UNET_GRAD_L2 = 1e-2
STATS_TOL = 1e-5
UPDATE_L2 = 1e-4
METRIC_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, np.float32), jax.device_get(tree))


def _random_stats(tree, rng):
    """Non-identity BatchNorm running statistics, so eval mode reads them."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k == "var":
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        else:
            out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
    return out


def _rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _images(b=2, size=64, seed=0):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(np.float32)


def _task_cfg(loss="BCE", **vision):
    return {"model": {"vision": {"model_name": "resnet_18", "num_targets": 3, **vision}},
            "train": {"loss_fn": {"type": loss, "alpha": 10.0},
                      "optimizer": {"name": "Adam", "weight_decay": 1e-6}},
            "lightning": {"trainer": {"lr": 1e-3}}}


_GLORIA_CFG = {
    "model": {"gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0},
              "vision": {"model_name": "resnet_18"},
              "text": {"embedding_dim": 32, "last_n_layers": 4, "agg_tokens": False,
                       "bert_config": {"vocab_size": 64, "hidden_size": 32, "num_layers": 1,
                                       "num_heads": 4, "intermediate_size": 64,
                                       "max_position_embeddings": 16}}},
}


@pytest.fixture(scope="module")
def gloria_variables():
    """A tiny JAX GLoRIA (ResNet-18, 32-d embedders), its image backbone's
    BatchNorm statistics made non-identity."""
    from gloria_tpu.models import GLoRIA

    B, T = 1, 8
    batch = {"imgs": np.zeros((B, 64, 64, 3), np.float32),
             "caption_ids": np.ones((B, T), np.int32), "attention_mask": np.ones((B, T), np.int32),
             "token_type_ids": np.zeros((B, T), np.int32)}
    v = _np_tree(jax.jit(GLoRIA(JConfig(_GLORIA_CFG)).init)(jax.random.PRNGKey(0), batch))
    v["batch_stats"] = _random_stats(v["batch_stats"], np.random.RandomState(4))
    return v


@pytest.fixture(scope="module")
def jax_models(gloria_variables):
    """(JAX model, variables, port model) for the three task models."""
    rng = np.random.RandomState(5)
    x = jnp.asarray(_images())
    out = {}
    jm = JImageClassifier("resnet_18", num_classes=3, input_size=None)
    v = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    v["batch_stats"] = _random_stats(v["batch_stats"], rng)
    tm = ImageClassifier("resnet_18", num_classes=3, input_size=None)
    tm.load_state_dict(classifier_state_dict_from_jax(v), strict=True)
    out["scratch"] = (jm, v, tm)

    # the JAX task's graft of the GLoRIA encoder, over a head from the seed
    # (the rest of a fresh init is overwritten by the graft)
    jm, patch = jtasks.ClassificationTask.build_model(
        JConfig(_task_cfg(freeze_cnn=True)), gloria_variables=gloria_variables)
    head = {"kernel": (rng.randn(512, 3) * 0.05).astype(np.float32),
            "bias": np.zeros(3, np.float32)}
    v = _np_tree(jtasks.graft_pretrained(
        {"params": {"classifier": head}, "batch_stats": {}}, patch))
    tm = PretrainedImageClassifier("resnet_18", output_dim=32, num_classes=3)
    tm.load_state_dict(classifier_state_dict_from_jax(v), strict=True)
    out["pretrained"] = (jm, v, tm)

    jm = JUNet(model_name="resnet_18")
    v = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(2), x))
    v["batch_stats"] = _random_stats(v["batch_stats"], rng)
    tm = ResnetUNet("resnet_18")
    tm.load_state_dict(unet_state_dict_from_jax(v), strict=True)
    out["unet"] = (jm, v, tm)
    return out


# ---- models and the weights bridge ---------------------------------------------------

@pytest.mark.parametrize("which", ["scratch", "pretrained", "unet"])
def test_eval_forward_matches_jax(jax_models, which):
    """Eval-mode logits within FWD_TOL · max|ref|."""
    jm, v, tm = jax_models[which]
    x = _images(seed=1)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x))(v, x))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= FWD_TOL * np.abs(ref).max()


def test_conv_transpose_bridge_flips_the_kernel():
    """flax ConvTranspose((2, 2), strides=(2, 2)) ≡ nn.ConvTranspose2d only
    with the kernel flipped in both spatial axes (bit-level agreement to
    1e-6; the unflipped kernel is far off)."""
    import flax.linen as fnn

    from gloria_tpu_torch.utils.weights import _conv_transpose

    x = np.random.RandomState(0).randn(1, 3, 3, 4).astype(np.float32)
    layer = fnn.ConvTranspose(5, (2, 2), strides=(2, 2))
    v = layer.init(jax.random.PRNGKey(0), x)
    ref = np.asarray(layer.apply(v, x))
    kernel, bias = np.asarray(v["params"]["kernel"]), np.asarray(v["params"]["bias"])
    conv = torch.nn.ConvTranspose2d(4, 5, 2, stride=2)

    def run(weight):
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(weight))
            conv.bias.copy_(torch.from_numpy(bias))
            return conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    assert np.abs(run(_conv_transpose(kernel)) - ref).max() <= 1e-6
    assert np.abs(run(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))) - ref).max() > 1e-2


def test_unet_channel_plan():
    """≈147 M parameters on ResNet-50: 23.5 M backbone, 75.5 M bridge, 36.7 M
    in up1; the output keeps the input's size."""
    with torch.device("meta"):
        m = ResnetUNet("resnet_50")
    count = lambda mod: sum(p.numel() for p in mod.parameters())
    assert count(m.backbone) == 23_508_032
    assert count(m.bridge_1) + count(m.bridge_2) == 75_509_760
    assert count(m.up1) == 36_707_328 and count(m) == 147_808_641
    assert ResnetUNet("resnet_18")(torch.zeros(1, 64, 64, 3)).shape == (1, 64, 64, 1)


# ---- one task step -------------------------------------------------------------------

def _jax_step(jm, v, x, y, loss_fn):
    def f(params):
        logits, muts = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
        return loss_fn(jnp.squeeze(logits), jnp.squeeze(y)), (logits, muts["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(v["params"])
    return float(loss), np.asarray(logits), _np_tree(grads), _np_tree(stats)


@pytest.mark.parametrize("loss_type", ["BCE", "MixedLoss"])
def test_task_step_matches_jax(jax_models, loss_type):
    """One train step: train-mode logits within FWD_TOL · max|ref|, the loss
    within LOSS_RTOL, every gradient within GRAD_L2 (classifier) or
    UNET_GRAD_L2 (U-Net; its ConvBlocks' conv biases within 1e-6 in norm)
    relative L2, the new BatchNorm statistics within STATS_TOL.  BCE (with
    pos_weight) on the classifier trained from scratch, MixedLoss (α=10) on
    the U-Net."""
    rng = np.random.RandomState(7)
    x = _images(seed=2)
    if loss_type == "BCE":
        cfg = _task_cfg("BCE")
        cfg["train"]["loss_fn"]["class_weights"] = [1.0, 2.0, 0.5]
        jm, v, tm = jax_models["scratch"]
        y = (rng.rand(2, 3) > 0.5).astype(np.float32)
        bridge, tol = classifier_state_dict_from_jax, GRAD_L2
    else:
        cfg = _task_cfg("MixedLoss")
        jm, v, tm = jax_models["unet"]
        y = np.zeros((2, 64, 64), np.float32)
        y[:, 10:30, 20:44] = 1.0
        bridge, tol = unet_state_dict_from_jax, UNET_GRAD_L2
    loss, logits, grads, stats = _jax_step(jm, v, x, y, jtasks.build_loss(JConfig(cfg)))

    tm.load_state_dict(bridge(v), strict=True)
    task = tasks.SupervisedTask(tm, tasks.build_loss(Config(cfg)),
                                optim.make_optimizer(Config(cfg)))
    got_loss, got_logits, got_grads = task.loss_and_grads(
        {"imgs": torch.from_numpy(x), "labels": torch.from_numpy(y)})
    assert np.abs(got_logits.numpy() - logits).max() <= FWD_TOL * np.abs(logits).max()
    assert abs(float(got_loss) - loss) <= LOSS_RTOL * abs(loss)
    ref_grads = bridge({"params": grads, "batch_stats": stats})
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert len(names) == len(got_grads) == len(list(tm.parameters()))
    zero = {n for n in names if n.endswith("conv.bias") and "conv_block" in n or "bridge" in n
            and n.endswith("conv.bias")}
    assert len(zero) == (12 if loss_type == "MixedLoss" else 0)
    worst = max(_rel_l2(g.numpy(), ref_grads[n].numpy())
                for n, g in zip(names, got_grads) if n not in zero)
    assert worst <= tol, worst
    for n, g in zip(names, got_grads):
        if n in zero:
            assert float(g.norm()) <= 1e-6 and float(ref_grads[n].norm()) <= 1e-6, n
    ref_stats = bridge({"params": v["params"], "batch_stats": stats})
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), ref_stats[name].numpy(), rtol=0, atol=STATS_TOL,
                                   err_msg=name)


def test_three_frozen_adam_steps_match_jax(jax_models):
    """freeze_cnn over the pretrained classifier, Adam with a clip (0.01) that
    binds: three chained steps against JAX's ``freeze_wrap``.  Frozen
    backbone parameters bit-equal to their start; each trainable parameter's
    total update (the head and the unused embedders, which move only by the
    coupled decay) within UPDATE_L2 relative L2; each step's loss within
    LOSS_RTOL; the frozen backbone's BatchNorm statistics still move, within
    STATS_TOL of JAX's."""
    jm, v, tm = jax_models["pretrained"]
    cfg = _task_cfg("BCE", freeze_cnn=True)
    rng = np.random.RandomState(8)
    batch = {"imgs": _images(b=4, seed=3), "labels": (rng.rand(4, 3) > 0.5).astype(np.float32)}

    jcfg = JConfig(cfg)
    tx = joptim.make_optimizer(jcfg, grad_clip=0.01)
    labels = joptim.partition_trainable(v["params"], joptim.trainable_predicate(jcfg))
    tx = joptim.freeze_wrap(tx, labels)
    jtask = jtasks.ClassificationTask(jm, jtasks.build_loss(jcfg), tx)
    jstate = create_train_state(jm, v, tx, jax.random.PRNGKey(0))
    jlosses = []
    for _ in range(3):
        jstate, out = jtask.train_step(jstate, {k: jnp.asarray(a) for k, a in batch.items()})
        jlosses.append(float(out["loss"]))
    ref = classifier_state_dict_from_jax(_np_tree(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))

    tcfg = Config(cfg)
    tm.load_state_dict(classifier_state_dict_from_jax(v), strict=True)
    start = {k: t.clone() for k, t in tm.state_dict().items()}
    tx = optim.make_optimizer(tcfg, grad_clip=0.01)
    tx = optim.freeze_wrap(tx, optim.partition_trainable(tm, optim.trainable_predicate(tcfg)))
    task = tasks.ClassificationTask(tm, tasks.build_loss(tcfg), tx)
    state = task.init_state(device="cpu")
    losses = []
    for _ in range(3):
        state, out = task.train_step(state, batch)
        losses.append(float(out["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL, atol=0)

    frozen = {n for n, label in optim.partition_trainable(tm, optim.trainable_predicate(tcfg))
              .items() if label == "frozen"}
    assert frozen and all(n.startswith("img_encoder.model.") for n in frozen)
    assert len(state.opt_state.mu) == len(list(tm.parameters())) - len(frozen)
    for name, p in tm.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), start[name]) and not p.requires_grad, name
        else:
            got = p.detach().numpy() - start[name].numpy()
            want = ref[name].numpy() - start[name].numpy()
            if not np.any(want):  # a zero bias with a zero gradient: no decay either
                assert not np.any(got), name
                continue
            assert _rel_l2(got, want) <= UPDATE_L2, name
    assert np.any(tm.classifier.weight.detach().numpy() != start["classifier.weight"].numpy())
    moved = 0
    for name, buf in tm.named_buffers():
        np.testing.assert_allclose(buf.numpy(), ref[name].numpy(), rtol=0, atol=STATS_TOL,
                                   err_msg=name)
        moved += not torch.equal(buf, start[name])
    assert moved == len(list(tm.named_buffers()))


def test_freeze_mask_clips_over_trainable_gradients_only():
    """The masked optimizer's global norm (guard and clip) sees only the
    trainable gradients: its update equals the unmasked optimizer's on the
    trainable subset alone, exactly."""
    rng = np.random.RandomState(0)
    params = [torch.from_numpy(rng.randn(3, 4).astype(np.float32)) for _ in range(3)]
    grads = [torch.from_numpy(rng.randn(3, 4).astype(np.float32)) * s for s in (1.0, 50.0, 2.0)]
    plain = optim.Optimizer("adam", 1e-3, weight_decay=1e-6, grad_clip=0.5)
    masked = optim.freeze_wrap(plain, {"a": "trainable", "b": "frozen", "c": "trainable"})
    sel_p, sel_g = masked.select(params), masked.select(grads)
    assert [t is p for t, p in zip(sel_p, (params[0], params[2]))] == [True, True]
    got = masked.update(sel_g, masked.init(sel_p), sel_p, optim.global_norm(sel_g))
    want = plain.update(sel_g, plain.init(sel_p), sel_p, optim.global_norm(sel_g))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="mask"):
        masked.select(params[:2])


# ---- the freeze flags ----------------------------------------------------------------

FLAGS = [{}, {"model.text.freeze_bert": True}, {"model.vision.freeze_cnn": True},
         {"model.text.freeze_bert": True, "model.vision.freeze_cnn": True},
         {"model.train_last_local_image_layer": True}, {"model.train_prompt": True},
         {"model.train_last_local_image_layer": True, "model.train_prompt": True}]


def _labels_as_values(params, pred):
    """Each JAX leaf filled with its label (1 trainable, 0 frozen)."""
    labels = joptim.partition_trainable(params, pred)
    return jax.tree_util.tree_map(lambda p, l: np.full(p.shape, float(l == "trainable"),
                                                       np.float32), params, labels)


@pytest.mark.parametrize("flags", FLAGS, ids=["+".join(f) or "none" for f in FLAGS])
def test_trainable_predicate_matches_jax(gloria_variables, jax_models, flags):
    """The port's predicate on its parameter names labels every parameter as
    JAX's does on its paths, on GLoRIA and on the pretrained classifier
    (each JAX leaf carried through the weights bridge as its label)."""
    def cfgs(base):
        jc, tc = JConfig(json.loads(json.dumps(base))), Config(json.loads(json.dumps(base)))
        for path, value in flags.items():
            jc.set_path(path, value)
            tc.set_path(path, value)
        return jc, tc

    jc, tc = cfgs(_GLORIA_CFG)
    v = gloria_variables
    ref = state_dict_from_jax({"params": _labels_as_values(v["params"],
                                                           joptim.trainable_predicate(jc)),
                               "batch_stats": v["batch_stats"]})
    got = optim.partition_trainable(TGLoRIA(tc), optim.trainable_predicate(tc))
    assert set(got) <= set(ref)
    for name, label in got.items():
        assert torch.all(ref[name] == float(label == "trainable")), name

    jc, tc = cfgs(_task_cfg())
    _, cv, tm = jax_models["pretrained"]
    ref = classifier_state_dict_from_jax({"params": _labels_as_values(
        cv["params"], joptim.trainable_predicate(jc)), "batch_stats": cv["batch_stats"]})
    got = optim.partition_trainable(tm, optim.trainable_predicate(tc))
    assert set(got) == {n for n, _ in tm.named_parameters()}
    for name, label in got.items():
        assert torch.all(ref[name] == float(label == "trainable")), name


# ---- losses and metrics --------------------------------------------------------------

def _loss_cases():
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 16, 16) * 3).astype(np.float32)
    target = (rng.rand(3, 16, 16) > 0.7).astype(np.float32)
    target[1] = 0.0  # an empty mask
    pw = np.asarray([0.5, 2.0, 1.5, 1.0], np.float32)
    cls_logits, cls_target = logits[:, 0, :4], target[:, 0, :4]
    return [
        ("dice_coefficient", lambda m, a, b: m.dice_coefficient(a, b), logits, target),
        ("dice_loss_mean", lambda m, a, b: m.dice_loss(a, b), logits, target),
        ("dice_loss_sum", lambda m, a, b: m.dice_loss(a, b, reduction="sum"), logits, target),
        ("dice_loss_none", lambda m, a, b: m.dice_loss(a, b, reduction="none"), logits, target),
        ("focal_loss", lambda m, a, b: m.focal_loss(a, b), logits, target),
        ("mixed_loss", lambda m, a, b: m.mixed_loss(a, b, alpha=10.0), logits, target),
        ("bce", lambda m, a, b: m.bce_with_logits(a, b), cls_logits, cls_target),
        ("bce_pos_weight", lambda m, a, b: m.bce_with_logits(
            a, b, pw if m is jloss else torch.from_numpy(pw)), cls_logits, cls_target),
    ]


@pytest.mark.parametrize("case", _loss_cases(), ids=[c[0] for c in _loss_cases()])
def test_losses_match_jax(case):
    """Every segmentation / classification loss within 1e-6 relative."""
    _, fn, a, b = case
    ref = np.asarray(fn(jloss, jnp.asarray(a), jnp.asarray(b)))
    got = fn(tloss, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_dice_loss_rejects_unknown_reduction():
    with pytest.raises(ValueError, match="reduction"):
        tloss.dice_loss(torch.zeros(1, 2), torch.zeros(1, 2), reduction="max")


@pytest.mark.parametrize("loss_type", ["BCE", "DiceLoss", "FocalLoss", "MixedLoss"])
def test_build_loss_matches_jax(loss_type):
    cfg = {"train": {"loss_fn": {"type": loss_type, "alpha": 3.0, "class_weights": [2.0, 1.0]}}}
    rng = np.random.RandomState(1)
    a, b = rng.randn(4, 2).astype(np.float32), (rng.rand(4, 2) > 0.5).astype(np.float32)
    ref = float(jtasks.build_loss(JConfig(cfg))(jnp.asarray(a), jnp.asarray(b)))
    got = float(tasks.build_loss(Config(cfg))(torch.from_numpy(a), torch.from_numpy(b)))
    assert got == pytest.approx(ref, rel=1e-6)
    with pytest.raises(NotImplementedError):
        tasks.build_loss(Config({"train": {"loss_fn": {"type": "Hinge"}}}))


def _metric_rows():
    rng = np.random.RandomState(2)
    scores = np.round(rng.rand(5, 40), 1).astype(np.float32)  # many ties
    labels = (rng.rand(5, 40) > 0.6).astype(np.float32)
    labels[3] = 0.0  # a single-class row
    labels[4] = 1.0
    return scores, labels


def test_binary_auroc_and_ap_match_jax():
    """Row-batched AUROC / AP, ties included, within METRIC_TOL; a row
    without both classes is NaN in both packages (AP: without a positive)."""
    scores, labels = _metric_rows()
    for jfn, tfn in ((jmetrics.binary_auroc, tmetrics.binary_auroc),
                     (jmetrics.binary_average_precision, tmetrics.binary_average_precision)):
        ref = np.asarray(jfn(jnp.asarray(scores), jnp.asarray(labels)))
        got = tfn(torch.from_numpy(scores), torch.from_numpy(labels)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
        np.testing.assert_allclose(got[~np.isnan(ref)], ref[~np.isnan(ref)], rtol=0,
                                   atol=METRIC_TOL)
    nested = tmetrics.binary_auroc(torch.from_numpy(scores.reshape(5, 2, 20)),
                                   torch.from_numpy(labels.reshape(5, 2, 20)))
    assert nested.shape == (5, 2)


@pytest.mark.parametrize("variant", ["plain", "single_class_columns", "nan_column"])
def test_classification_metrics_match_jax(variant):
    """The mean per-class AUROC / AUPRC against JAX's sklearn-based
    ``classification_metrics`` within METRIC_TOL: ties, the single-class
    deviation (AUROC 0, AP 1.0 or 0.0) and the NaN→0 guard."""
    rng = np.random.RandomState(3)
    prob = np.round(rng.rand(30, 4), 2)
    y = (rng.rand(30, 4) > 0.5).astype(np.float32)
    if variant == "single_class_columns":
        y[:, 1], y[:, 2] = 1.0, 0.0
    if variant == "nan_column":
        prob[5, 3] = np.nan
    ref = jmetrics.classification_metrics(y, prob)
    got = tmetrics.classification_metrics(y, prob)
    assert got["auroc"] == pytest.approx(ref["auroc"], abs=METRIC_TOL)
    assert got["auprc"] == pytest.approx(ref["auprc"], abs=METRIC_TOL)


def test_dice_matches_jax_with_empty_masks():
    """``dice_score`` within METRIC_TOL of JAX's: an empty truth scores 1 with
    an empty prediction and 0 otherwise; the per-sample values averaged over
    batches (the port's validation path) give the same score."""
    rng = np.random.RandomState(4)
    prob = rng.rand(6, 8, 8).astype(np.float32)
    truth = (rng.rand(6, 8, 8) > 0.6).astype(np.float32)
    truth[1] = 0.0
    truth[2], prob[2] = 0.0, 0.1  # empty truth, empty prediction → 1
    ref = jmetrics.dice_score(prob, truth)
    assert tmetrics.dice_score(prob, truth) == pytest.approx(ref, abs=METRIC_TOL)
    per = tmetrics.dice_per_sample(torch.from_numpy(prob), torch.from_numpy(truth)).numpy()
    assert per[1] == 0.0 and per[2] == 1.0
    batched = np.concatenate([tmetrics.dice_per_sample(prob[i:i + 4], truth[i:i + 4]).numpy()
                              for i in (0, 4)])
    assert float(batched.mean()) == pytest.approx(ref, abs=METRIC_TOL)
    assert tmetrics.dice_score(np.zeros((0, 4)), np.zeros((0, 4))) == 0.0


def test_epoch_metrics_match_jax():
    """The tasks' epoch metrics from logits, against JAX's, within METRIC_TOL."""
    rng = np.random.RandomState(5)
    logits, labels = rng.randn(12, 3).astype(np.float32), (rng.rand(12, 3) > 0.5).astype(np.float32)
    ref = jtasks.ClassificationTask.epoch_metrics(None, logits, labels)
    got = tasks.ClassificationTask.epoch_metrics(logits, labels)
    for k in ("auroc", "auprc"):
        assert got[k] == pytest.approx(ref[k], abs=METRIC_TOL)
    one = jtasks.ClassificationTask.epoch_metrics(None, logits[:, 0], labels[:, 0])
    assert tasks.ClassificationTask.epoch_metrics(logits[:, 0], labels[:, 0])["auroc"] == \
        pytest.approx(one["auroc"], abs=METRIC_TOL)
    seg_logits = rng.randn(3, 8, 8, 1).astype(np.float32)
    masks = (rng.rand(3, 8, 8) > 0.5).astype(np.float32)
    ref = jtasks.SegmentationTask.epoch_metrics(None, seg_logits, masks)["dice"]
    assert tasks.SegmentationTask.epoch_metrics(seg_logits, masks)["dice"] == \
        pytest.approx(ref, abs=METRIC_TOL)


# ---- surgery, the API and the segmentation images -----------------------------------

def _port_gloria(seed=0):
    return init_gloria(Config(_GLORIA_CFG), seed=seed)


def test_subtree_surgery():
    sd = {"a.x": 1, "a.y": 2, "b.x": 3}
    assert extract_subtree(sd, "a.") == {"x": 1, "y": 2}
    assert graft_subtree(sd, "a.", {"z": 9}) == {"b.x": 3, "a.z": 9}
    assert graft_subtree(sd, "c.", {"x": 4}) == {**sd, "c.x": 4}
    with pytest.raises(KeyError, match="no entries"):
        extract_subtree(sd, "q.")


@pytest.mark.parametrize("phase", ["classification", "segmentation"])
def test_init_task_grafts_the_encoder(phase):
    """``builder.init_task`` grafts the GLoRIA encoder (every tensor equal,
    BatchNorm statistics included); freeze_cnn freezes the classifier's
    backbone and, as in JAX, nothing of the U-Net's ``backbone.*``."""
    gloria = _port_gloria().state_dict()
    cfg = Config({**_task_cfg(freeze_cnn=True), "phase": phase})
    task, state = builder.init_task(cfg, pretrained=gloria, seed=1, device="cpu")
    sd = state.model.state_dict()
    src, dst = (("img_encoder.", "img_encoder.") if phase == "classification"
                else ("img_encoder.model.", "backbone."))
    sub = extract_subtree(gloria, src)
    for k, v in sub.items():
        assert torch.equal(sd[dst + k], v), k
    frozen = [n for n, p in state.model.named_parameters() if not p.requires_grad]
    if phase == "classification":
        assert frozen and all(n.startswith("img_encoder.model.") for n in frozen)
        assert isinstance(state.model, PretrainedImageClassifier)
    else:
        assert frozen == [] and isinstance(state.model, ResnetUNet)
    cfg.set_path("train.steps_per_dispatch", 2)
    with pytest.raises(ValueError, match="pretrain-only"):
        builder.init_task(cfg, pretrained=gloria, device="cpu")
    with pytest.raises(NotImplementedError, match="A1.8"):
        tasks.SupervisedTask(state.model, tasks.build_loss(cfg), task.optimizer, accum_steps=2)


def test_api_task_models_graft_the_encoder(tmp_path):
    """``load_img_classification_model`` / ``load_img_segmentation_model`` on
    a port checkpoint: the encoder's tensors equal the checkpoint's,
    ``freeze_encoder`` turns its gradients off, and the registry names
    match JAX's."""
    from gloria_tpu import api as japi

    gloria = _port_gloria(seed=2)
    save_checkpoint(tmp_path / "g", {"model": gloria.state_dict()}, Config(_GLORIA_CFG))
    sd = gloria.state_dict()
    cls = api.load_img_classification_model(str(tmp_path / "g"), device="cpu", num_cls=2)
    assert isinstance(cls, PretrainedImageClassifier) and cls.classifier.out_features == 2
    for k, v in extract_subtree(sd, "img_encoder.").items():
        assert torch.equal(cls.state_dict()["img_encoder." + k], v), k
    assert all(not p.requires_grad for p in cls.img_encoder.parameters())
    assert all(p.requires_grad for p in cls.classifier.parameters())
    unfrozen = api.load_img_classification_model(str(tmp_path / "g"), device="cpu",
                                                 freeze_encoder=False)
    assert all(p.requires_grad for p in unfrozen.parameters())
    seg = api.load_img_segmentation_model(str(tmp_path / "g"), device="cpu")
    for k, v in extract_subtree(sd, "img_encoder.model.").items():
        assert torch.equal(seg.state_dict()["backbone." + k], v), k
    assert api.available_segmentation_models() == japi.available_segmentation_models()
    assert cls(torch.zeros(1, 64, 64, 3)).shape == (1, 2)


def test_log_segmentation_samples_writes_the_images(tmp_path):
    logger = MetricLogger(tmp_path)
    trainer = type("T", (), {"logger": logger, "global_step": 3})()
    rng = np.random.RandomState(0)
    batch = {"imgs": torch.from_numpy(rng.randn(2, 16, 16, 3).astype(np.float32)),
             "labels": torch.from_numpy((rng.rand(2, 16, 16) > 0.5).astype(np.float32))}
    metrics = {"loss": np.float32(1.0), "logits": rng.randn(2, 16, 16, 1).astype(np.float32)}
    cb = tasks.LogSegmentationSamples()
    cb.on_validation_batch_end(trainer, None, metrics, batch, 1)  # not the first batch
    assert not list(tmp_path.glob("*.png"))
    cb.on_validation_batch_end(trainer, None, metrics, batch, 0)
    names = sorted(p.name for p in tmp_path.glob("*.png"))
    assert names == [f"{n}_step3.png" for n in ("input_image", "layered", "mask", "pred")]


# ---- the driver ------------------------------------------------------------------------

def _driver_cfg(phase: str) -> dict:
    seg = phase == "segmentation"
    return {
        "experiment_name": phase, "phase": phase, "random_seed": 0,
        "lightning": {
            "trainer": {"max_epochs": 2, "gradient_clip_val": 0.25, "lr": 1e-3, "precision": 32},
            "checkpoint_callback": {"monitor": "val_dice" if seg else "val_loss",
                                    "save_last": True, "mode": "max" if seg else "min",
                                    "save_top_k": 1},
            "early_stopping_callback": {"monitor": "val_loss", "patience": 10, "mode": "min"},
        },
        "model": {"vision": {"model_name": "gloria_resnet18", "freeze_cnn": not seg,
                             "num_targets": 1 if seg else 5}},
        # no random crop: the train transform draws nothing, so a resumed
        # run sees the batches of an uninterrupted one
        "data": {"dataset": "synthetic", "synthetic_size": 4 if seg else 8,
                 "image": {"imsize": 64}},
        "transforms": {"norm": "half"},
        "train": {"batch_size": 2 if seg else 4, "num_workers": 1,
                  "loss_fn": {"type": "MixedLoss", "alpha": 10.0} if seg else {"type": "BCE"},
                  "optimizer": {"name": "Adam", "weight_decay": 1e-6},
                  "scheduler": {"name": "plateau", "monitor": "val_loss"}},
    }


@pytest.fixture(scope="module")
def pretrain_ckpt(tmp_path_factory):
    """A pretrain checkpoint of the port (a GLoRIA's weights)."""
    path = tmp_path_factory.mktemp("pretrain") / "step_00000001"
    save_checkpoint(path, {"model": _port_gloria(seed=5).state_dict()}, Config(_GLORIA_CFG))
    return path


def _main(tmp_path: Path, name: str, cfg: dict, *flags: str):
    """One in-process ``run.main`` into ``tmp_path/name``: (results, run dir)."""
    cfg_path = tmp_path / f"{name}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    args = run.get_parser().parse_args(["-c", str(cfg_path), "--device", "cpu", *flags])
    c = run.load_config(str(cfg_path))
    run.apply_overrides(c, args)
    c.output_dir = str(tmp_path / name)
    os.makedirs(c.output_dir)
    return run.main(c, args), Path(c.output_dir)


def _csv_rows(path: Path) -> list[dict]:
    import csv

    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_driver_classification_grafts_freezes_and_resumes(tmp_path, pretrain_ckpt):
    """``run.main`` in the classification phase from a pretrain checkpoint:
    the frozen encoder's parameters equal the checkpoint's after training
    (its BatchNorm statistics moved), the epoch and test metrics carry
    ``val_auroc`` / ``val_auprc``, ``results.csv`` holds the test results,
    and 1 epoch + ``--resume`` to 2 ends bit-equal to 2 epochs straight."""
    cfg = _driver_cfg("classification")
    full, d = _main(tmp_path, "full", cfg, "--train", "--test", "--ckpt", str(pretrain_ckpt))
    assert full["run"]["phase"] == "classification" and full["run"]["global_step"] == 4
    assert set(full["test"]) == {"test_loss", "val_auroc", "val_auprc"}
    assert all(np.isfinite(v) for v in full["test"].values())
    assert json.loads((d / "results.csv").read_text()) == full["test"]
    epochs = _csv_rows(d / "metrics_epoch.csv")
    assert len(epochs) == 2 and {"val_auroc", "val_auprc", "val_loss"} <= set(epochs[0])
    gloria = load_checkpoint(pretrain_ckpt)[0]["model"]
    trained = load_checkpoint(full["best_ckpt"])[0]
    names = {n for n, _ in PretrainedImageClassifier("resnet_18", 32, 5).named_parameters()}
    for k, v in trained["model"].items():
        if k.startswith("img_encoder.model."):
            assert torch.equal(v, gloria[k]) == (k in names), k  # parameters kept, stats moved
    assert not torch.equal(trained["model"]["classifier.weight"],
                           torch.zeros_like(trained["model"]["classifier.weight"]))

    first, d1 = _main(tmp_path, "b1", cfg, "--train", "--max_epochs", "1", "--ckpt",
                      str(pretrain_ckpt))
    resumed, d2 = _main(tmp_path, "b2", cfg, "--train", "--test", "--resume", "--ckpt",
                        first["best_ckpt"])
    assert resumed["run"]["global_step"] == 4
    assert resumed["test"] == full["test"]
    end = load_checkpoint(resumed["best_ckpt"])[0]
    for k, v in trained["model"].items():
        assert torch.equal(end["model"][k], v), k


def test_driver_segmentation_scores_dice(tmp_path, pretrain_ckpt):
    """``run.main`` in the segmentation phase from a pretrain checkpoint
    (``--train_pct 1.0`` accepted): ``val_dice`` in [0, 1] each epoch and at
    test, the best checkpoint chosen by ``val_dice`` with mode max, the
    first validation sample's images written."""
    cfg = _driver_cfg("segmentation")
    cfg["lightning"]["trainer"]["max_epochs"] = 1
    out, d = _main(tmp_path, "seg", cfg, "--train", "--test", "--ckpt", str(pretrain_ckpt),
                   "--train_pct", "1.0")
    assert out["run"]["phase"] == "segmentation" and out["run"]["global_step"] == 2
    assert set(out["test"]) == {"test_loss", "val_dice"} and 0 <= out["test"]["val_dice"] <= 1
    epochs = _csv_rows(d / "metrics_epoch.csv")
    assert len(epochs) == 1 and 0 <= float(epochs[0]["val_dice"]) <= 1
    manifest = json.loads((d / "ckpt" / "manifest.json").read_text())
    assert manifest["entries"][0]["metric"] == pytest.approx(float(epochs[0]["val_dice"]))
    assert (d / "pred_step2.png").is_file() and (d / "input_image_step2.png").is_file()
    assert not (d / "results.csv").exists()
