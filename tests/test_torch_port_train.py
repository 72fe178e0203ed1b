"""The port's pretrain path against the JAX package: train-mode BatchNorm,
BERT dropout, ``calc_loss``, the optimizer, three whole train steps and the
``batch_stats`` bridge.

Inputs and weights come from numpy seeds or from a JAX init carried over by
the weights bridge.  Tolerances, each against JAX f32 on the CPU:
- BatchNorm output and running statistics: 1e-5 absolute (f32 means over
  a few hundred values, summed in another order); its input gradient
  1e-4 · max|grad| + 1e-6;
- ``calc_loss`` terms: 1e-5 absolute; their gradients 1e-4 · max|grad| + 1e-6
  (``local_matching`` and the port's plain version take the same products in
  another order);
- the optimizer alone, fed the same gradient arrays as optax: 1e-6 absolute
  on the updates (elementwise f32 math in the same order);
- three SGD train steps on ``tests/_tiny.py``'s setup (dropout 0), each
  from JAX's weights: loss and each metric, ``grad_norm`` included,
  1e-4 relative (measured 4.3e-5); the update of each parameter outside the
  ResNet 1e-3 · its max|Δp|, plus a millionth of the step's largest update
  and one f32 spacing of the parameter, for the rounding of ``p + Δp``
  (measured 0.41 of that); the ResNet's updates 3e-2 in relative L2 per
  tensor (measured 1.04e-2); the BatchNorm running statistics 1e-5
  absolute.  The gradient of this random-init ResNet in train mode on noise
  images is not smooth at f32 noise scale: in f64, moving the input by a
  relative 1e-6 moves single weight gradients by up to 13% of their largest
  entry (ReLUs near 0 flip).  XLA's and oneDNN's convolutions sum in another
  order, so single ResNet entries differ by several % of max|g| from the
  same weights, and steps chained from each framework's own weights part
  further (``grad_norm`` by 2.7e-3 after two steps); each step therefore
  starts from JAX's weights.
Adam is not compared after a whole train step: its first update is about
``lr · sign(g)``, so a gradient near 0 can flip sign between the frameworks.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _tiny import tiny_batch, tiny_cfg, tiny_setup
from gloria_tpu.configs import Config
from gloria_tpu.models import GLoRIA
from gloria_tpu.models.norm import SplitBatchNorm
from gloria_tpu.training import optim as jax_optim
from gloria_tpu_torch.configs import Config as TConfig
from gloria_tpu_torch.models.bert import BertConfig, BertModel
from gloria_tpu_torch.models.gloria_model import GLoRIA as TGLoRIA
from gloria_tpu_torch.models.norm import BatchNorm2d
from gloria_tpu_torch.training import optim, train
from gloria_tpu_torch.utils.weights import batch_stats_from_state_dict, state_dict_from_jax

STEP_RTOL = 1e-4
STATS_ATOL = 1e-5
UPDATE_TOL = 1e-3
BACKBONE_UPDATE_L2 = 3e-2
BACKBONE = "img_encoder.model."
# lifts the clipped update (norm lr · 0.25) far above the f32 spacing of the
# parameters, so that the updates compare to 1e-3; JAX takes it through the
# injected hyperparameter, without a new compile
STEP_LR = 10.0


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _grad_close(got, ref, rel=1e-4, floor=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()) + floor)


# ---- BatchNorm -----------------------------------------------------------

def test_batchnorm_train_mode_matches_split_batchnorm():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 5, 5, 6) * 2 + 0.5).astype(np.float32)        # NHWC
    scale, bias = rng.rand(6).astype(np.float32) + 0.5, rng.randn(6).astype(np.float32)
    ra_mean, ra_var = rng.randn(6).astype(np.float32), rng.rand(6).astype(np.float32) + 0.5
    cot = rng.randn(*x.shape).astype(np.float32)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}
    bn = SplitBatchNorm(use_running_average=False)

    def f(xx):
        y, muts = bn.apply(variables, xx, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, muts["batch_stats"])

    (_, (ref_y, ref_stats)), ref_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    m = BatchNorm2d(6)
    m.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                       "running_mean": torch.from_numpy(ra_mean),
                       "running_var": torch.from_numpy(ra_var)})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = m.train()(xt)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), ref_y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), ref_stats["mean"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.running_var.numpy(), ref_stats["var"], rtol=0, atol=1e-5)
    _grad_close(xt.grad.permute(0, 2, 3, 1).numpy(), ref_dx)


def test_batchnorm_eval_mode_is_the_running_affine_bit_for_bit():
    rng = np.random.RandomState(1)
    m = BatchNorm2d(3)
    with torch.no_grad():
        for buf in (m.weight, m.bias, m.running_mean):
            buf.copy_(torch.from_numpy(rng.randn(3).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(rng.rand(3).astype(np.float32) + 0.5))
    x = torch.from_numpy(rng.randn(2, 3, 4, 4).astype(np.float32))
    before = (m.running_mean.clone(), m.running_var.clone())
    with torch.no_grad():
        got = m.eval()(x)
    mul = torch.rsqrt(m.running_var + 1e-5) * m.weight
    ref = (x - m.running_mean[:, None, None]) * mul[:, None, None] + m.bias[:, None, None]
    assert torch.equal(got, ref)
    assert torch.equal(m.running_mean, before[0]) and torch.equal(m.running_var, before[1])


# ---- BERT dropout ----------------------------------------------------------

def test_bert_dropout_draws_from_the_generator():
    cfg = BertConfig(vocab_size=32, hidden_size=16, num_layers=2, num_heads=2,
                     intermediate_size=32, max_position_embeddings=16, dropout_rate=0.1)
    torch.manual_seed(0)
    model = BertModel(cfg).train()
    ids = torch.from_numpy(np.random.RandomState(2).randint(1, 32, (3, 10)))

    def run(seed):
        return model(ids, generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    train_out = run(5).detach()
    with torch.no_grad():
        eval_out = model.eval()(ids)[0]
    assert not torch.equal(eval_out, train_out)
    model.train()
    with pytest.raises(ValueError, match="torch.Generator"):
        model(ids)


# ---- calc_loss ---------------------------------------------------------------

def _loss_cfg(sink: bool, no_attn: bool) -> dict:
    gloria = {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0, "local_loss_weight": 1.0,
              "global_loss_weight": 0.5, "no_attn_vec": sink}
    if no_attn:
        gloria["no_attn_loss_weight"] = 0.3
    return {"model": {"gloria": gloria, "vision": {"model_name": "resnet_18"},
                      "text": {"embedding_dim": 16,
                               "bert_config": {"vocab_size": 32, "hidden_size": 16,
                                               "num_layers": 1, "num_heads": 2,
                                               "intermediate_size": 32,
                                               "max_position_embeddings": 16}}}}


@pytest.mark.parametrize("sink,no_attn", [(False, False), (True, False), (True, True)],
                         ids=["plain", "sink", "sink-no-attn-loss"])
def test_calc_loss_matches_jax(sink, no_attn):
    B, R, W, D = 6, 25, 12, 16
    rng = np.random.RandomState(3)
    img_l, txt_l = rng.randn(B, R, D).astype(np.float32), rng.randn(B, W, D).astype(np.float32)
    img_g, txt_g = rng.randn(B, D).astype(np.float32), rng.randn(B, D).astype(np.float32)
    vec = rng.randn(D).astype(np.float32)
    caps = np.asarray([1, 10, 4, 7, 12, 3], np.int32)
    cfg = _loss_cfg(sink, no_attn)
    jmodel = GLoRIA(Config(cfg))
    params = {"no_attn_vec": jnp.asarray(vec)} if sink else {}

    def jax_loss(il, ig, tl, tg, p):
        loss, metrics, attn = jmodel.apply({"params": p}, il, ig, tl, tg, jnp.asarray(caps),
                                           (5, 5), method=GLoRIA.calc_loss)
        return loss, (metrics, attn)

    (_, (ref_metrics, ref_attn)), ref_grads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        jnp.asarray(img_l), jnp.asarray(img_g), jnp.asarray(txt_l), jnp.asarray(txt_g), params)

    model = TGLoRIA(TConfig(cfg))
    if sink:
        model.no_attn_vec.data.copy_(torch.from_numpy(vec))
    inputs = [torch.from_numpy(a).requires_grad_() for a in (img_l, img_g, txt_l, txt_g)]
    loss, metrics, attn = model.calc_loss(*inputs, torch.from_numpy(caps))
    loss.backward()
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=0, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(ref_attn), rtol=0, atol=1e-5)
    for got, ref in zip(inputs, ref_grads[:4]):
        _grad_close(got.grad.numpy(), ref)
    if sink:
        _grad_close(model.no_attn_vec.grad.numpy(), ref_grads[4]["no_attn_vec"])


def _seg_inputs(B=6, R=36, W=12, D=16, label_hw=(74, 74)):
    """Embeddings, cap_lens (one caption with the [CLS] word only) and
    bbox-union labels (one image without a box)."""
    rng = np.random.RandomState(21)
    emb = [rng.randn(*shape).astype(np.float32)
           for shape in ((B, R, D), (B, D), (B, W, D), (B, D))]
    caps = np.asarray([1, 10, 4, 7, 12, 3], np.int32)[:B]
    labels = np.zeros((B, *label_hw), np.float32)
    for b in range(1, B):
        y, x = rng.randint(0, label_hw[0] // 2), rng.randint(0, label_hw[1] // 2)
        labels[b, y : y + label_hw[0] // 3, x : x + label_hw[1] // 4] = 1.0
    return emb, caps, labels


def _rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


@functools.lru_cache(maxsize=1)
def _seg_variables() -> dict:
    """One JAX init of ``_loss_cfg``'s model with the sink, as numpy; the
    case without the sink drops ``no_attn_vec``."""
    init_batch = {"imgs": np.zeros((1, 32, 32, 3), np.float32),
                  "caption_ids": np.ones((1, 8), np.int32),
                  "attention_mask": np.ones((1, 8), np.int32),
                  "token_type_ids": np.zeros((1, 8), np.int32),
                  "word_assignment": np.eye(8, dtype=np.float32)[None]}
    jmodel = GLoRIA(Config(_loss_cfg(sink=True, no_attn=False)))
    return _np_tree(jax.jit(jmodel.init)(jax.random.PRNGKey(4), init_batch))


@pytest.mark.parametrize("sink", [False, True], ids=["plain", "sink"])
def test_calc_loss_attention_supervision_matches_jax(sink):
    """The attention-supervision term on a 6 × 6 grid resized to 74 × 74
    labels (where a float nearest index would pick another row), from JAX's
    init carried across by ``state_dict_from_jax``: ``attn_seg_loss`` and
    every metric at 1e-5 absolute, the gradients of the four embeddings and
    of the sink in relative L2 at 1e-4."""
    cfg = _loss_cfg(sink, no_attn=sink)
    cfg["model"]["gloria"]["segmentation_loss_weight"] = 0.7
    (img_l, img_g, txt_l, txt_g), caps, labels = _seg_inputs()
    jmodel = GLoRIA(Config(cfg))
    variables = _seg_variables()
    if not sink:
        variables = {**variables, "params": {k: v for k, v in variables["params"].items()
                                             if k != "no_attn_vec"}}

    def jax_loss(il, ig, tl, tg, params):
        loss, metrics, _ = jmodel.apply({**variables, "params": params}, il, ig, tl, tg,
                                        jnp.asarray(caps), (6, 6), jnp.asarray(labels),
                                        method=GLoRIA.calc_loss)
        return loss, metrics

    (_, ref_metrics), ref_grads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3, 4),
                                                     has_aux=True)(
        *(jnp.asarray(a) for a in (img_l, img_g, txt_l, txt_g)), variables["params"])

    model = TGLoRIA(TConfig(cfg))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (img_l, img_g, txt_l, txt_g)]
    loss, metrics, _ = model.calc_loss(*inputs, torch.from_numpy(caps), (6, 6),
                                       torch.from_numpy(labels))
    loss.backward()
    assert set(metrics) == set(ref_metrics) and "attn_seg_loss" in metrics
    assert float(metrics["attn_seg_loss"].detach()) > 0
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=0, atol=1e-5,
                                   err_msg=k)
    for got, ref in zip(inputs, ref_grads[:4]):
        assert _rel_l2(got.grad.numpy(), ref) <= 1e-4
    if sink:
        assert _rel_l2(model.no_attn_vec.grad.numpy(), ref_grads[4]["no_attn_vec"]) <= 1e-4
    with pytest.raises(ValueError, match="grid"):
        model.calc_loss(*inputs, torch.from_numpy(caps),
                        segmentation_labels=torch.from_numpy(labels))


def test_unported_training_options_raise():
    cfg = _loss_cfg(sink=False, no_attn=False)
    model = TGLoRIA(TConfig(cfg))
    opt = optim.make_optimizer(TConfig(cfg))
    for key, value in (("image_transformer", {"num_layers": 1, "num_heads": 2}),
                       ("train_prompt", True)):
        bad = TConfig(cfg)
        bad.model[key] = value
        with pytest.raises(NotImplementedError, match=key):
            train.make_pretrain_steps(TGLoRIA(bad), opt)
    emb = [torch.zeros(2, 4, 16), torch.zeros(2, 16), torch.zeros(2, 3, 16), torch.zeros(2, 16)]
    caps = torch.tensor([2, 3])
    model.cfg.model.gloria.attention_entropy_loss_weight = 1.0
    with pytest.raises(NotImplementedError, match="attention_entropy_loss_weight"):
        model.calc_loss(*emb, caps)
    model.cfg.model.gloria.attention_entropy_loss_weight = None


# ---- the optimizer alone -----------------------------------------------------

OPTIMIZERS = {
    "adam": ({"name": "Adam", "weight_decay": 1e-2}, 0.25),
    "adamw": ({"name": "AdamW", "weight_decay": 1e-2}, None),
    "sgd-momentum": ({"name": "SGD", "weight_decay": 1e-3, "momentum": 0.9}, 1.0),
    "sgd": ({"name": "SGD"}, 0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """Four steps on the same gradient arrays; the second has a NaN, which
    the guard turns into a zero update that still moves the moments."""
    opt_cfg, clip = OPTIMIZERS[name]
    cfg = {"train": {"optimizer": opt_cfg}, "lightning": {"trainer": {"lr": 1e-3}}}
    tx = jax_optim.make_optimizer(Config(cfg), grad_clip=clip)
    port = optim.make_optimizer(TConfig(cfg), grad_clip=clip)
    rng = np.random.RandomState(4)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 3)}
    p_np = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    j_params = {k: jnp.asarray(v) for k, v in p_np.items()}
    j_state = tx.init(j_params)
    t_params = [torch.from_numpy(p_np[k].copy()) for k in sorted(shapes)]
    t_state = port.init(t_params)
    for step in range(4):
        g_np = {k: (rng.randn(*s) * (3.0 if step == 2 else 0.2)).astype(np.float32)
                for k, s in shapes.items()}
        if step == 1:
            g_np["b"][2] = np.nan
        updates, j_state = tx.update({k: jnp.asarray(v) for k, v in g_np.items()}, j_state,
                                     j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, updates)
        t_grads = [torch.from_numpy(g_np[k]) for k in sorted(shapes)]
        t_updates = port.update(t_grads, t_state, t_params, optim.global_norm(t_grads))
        for k, u in zip(sorted(shapes), t_updates):
            np.testing.assert_allclose(u.numpy(), np.asarray(updates[k]), rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {k}")
            if step == 1:
                assert not u.any()
        t_params = [p + u for p, u in zip(t_params, t_updates)]
    assert int(t_state.total_notfinite) == 1
    assert int(optax_notfinite(j_state)) == 1
    for k, p in zip(sorted(shapes), t_params):
        np.testing.assert_allclose(p.numpy(), np.asarray(j_params[k]), rtol=0, atol=1e-6)


def optax_notfinite(state):
    import optax

    return optax.tree_utils.tree_get(state, "total_notfinite")


def test_learning_rate_setters():
    port = optim.make_optimizer(TConfig({"train": {"optimizer": {"name": "Adam"}, "lr": 2e-4}}))
    state = port.init([torch.zeros(3)])
    assert optim.get_learning_rate(state) == 2e-4
    assert optim.get_learning_rate(optim.set_learning_rate(state, 5e-5)) == 5e-5


# ---- whole train steps ---------------------------------------------------------

def _port_from_jax(state):
    variables = {"params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats)}
    cfg = TConfig(tiny_cfg().to_dict())
    model = TGLoRIA(cfg)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt = optim.make_optimizer(cfg, grad_clip=cfg.lightning.trainer.gradient_clip_val)
    return model, opt, train.create_train_state(model, opt, seed=0, device="cpu")


def _state_dict_of(j_state) -> dict:
    return state_dict_from_jax({"params": _np_tree(j_state.params),
                                "batch_stats": _np_tree(j_state.batch_stats)})


def _check_updates(before: dict, got: dict, ref: dict, step: int) -> None:
    """Each parameter's update, the port's (``got − before``) against JAX's
    (``ref − before``), and the running statistics against JAX's."""
    stats = ("running_mean", "running_var")
    delta = {k: (ref[k].double() - before[k].double(), got[k].double() - before[k].double())
             for k in ref if not k.endswith(stats)}
    largest = max(float(want.abs().max()) for want, _ in delta.values())
    assert largest > 0
    for k, (want, have) in delta.items():
        if k.startswith(BACKBONE):
            rel = float((have - want).norm() / want.norm())
            assert rel <= BACKBONE_UPDATE_L2, f"step {step} {k}: relative L2 {rel}"
        else:
            tol = (UPDATE_TOL * float(want.abs().max()) + 1e-6 * largest
                   + torch.from_numpy(np.spacing(before[k].abs().numpy())).double())
            assert bool(((have - want).abs() <= tol).all()), f"step {step} {k}"
    for k in ref:
        if k.endswith(stats):
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=STATS_ATOL,
                                       err_msg=f"step {step} {k}")


def test_three_train_steps_match_jax():
    """SGD on the canonical tiny config, three steps, each from JAX's
    weights: the metrics, every parameter's update and running statistic,
    and the batch_stats the port hands back in the JAX layout."""
    _, j_state, j_step, _ = tiny_setup()
    j_state = j_state.replace(opt_state=jax_optim.set_learning_rate(j_state.opt_state, STEP_LR))
    model, opt, t_state = _port_from_jax(j_state)
    optim.set_learning_rate(t_state.opt_state, STEP_LR)
    t_step, _ = train.make_pretrain_steps(model, opt)
    for step in range(3):
        before = _state_dict_of(j_state)
        model.load_state_dict(before, strict=True)
        batch = tiny_batch(seed=step)
        j_state, j_metrics = j_step(j_state, batch)
        t_state, t_metrics = t_step(t_state, batch)
        assert set(t_metrics) == set(j_metrics)
        for k, v in j_metrics.items():
            np.testing.assert_allclose(float(t_metrics[k]), float(v), rtol=STEP_RTOL, atol=0,
                                       err_msg=f"step {step} {k}")
        _check_updates(before, model.state_dict(), _state_dict_of(j_state), step)
    assert t_state.step == 3
    ref_stats = _np_tree(j_state.batch_stats)
    got_stats = batch_stats_from_state_dict(model.state_dict())
    assert jax.tree_util.tree_structure(got_stats) == jax.tree_util.tree_structure(ref_stats)
    for g, r in zip(jax.tree_util.tree_leaves(got_stats), jax.tree_util.tree_leaves(ref_stats)):
        np.testing.assert_allclose(g, r, rtol=0, atol=STATS_ATOL)


def test_batch_stats_bridge_round_trip_after_a_step():
    """JAX variables → the port, one train step there, its running
    statistics → JAX layout → the port again, bit for bit."""
    _, j_state, _, _ = tiny_setup()
    model, opt, t_state = _port_from_jax(j_state)
    t_step, _ = train.make_pretrain_steps(model, opt)
    before = batch_stats_from_state_dict(model.state_dict())
    t_step(t_state, tiny_batch(seed=5))
    sd = model.state_dict()
    stats = batch_stats_from_state_dict(sd)
    moved = [not np.array_equal(a, b) for a, b in
             zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(before))]
    assert all(moved)
    back = state_dict_from_jax({"params": _np_tree(j_state.params), "batch_stats": stats})
    for k, v in back.items():
        if k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, sd[k]), k


def test_nonfinite_step_is_skipped_whole():
    """A batch whose gradients are not finite moves no parameter and no
    running statistic, and counts one skipped step."""
    _, j_state, _, _ = tiny_setup()
    model, opt, t_state = _port_from_jax(j_state)
    t_step, _ = train.make_pretrain_steps(model, opt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = tiny_batch(seed=6)
    batch["imgs"][0, 0, 0, 0] = np.inf
    t_state, metrics = t_step(t_state, batch)
    assert not np.isfinite(float(metrics["grad_norm"]))
    assert int(metrics["nonfinite_steps"]) == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_mode_resnet_gradient_is_not_smooth_at_f32_noise():
    """Why whole-step gradients are compared by norm here and in relative L2
    on the card: in f64, with the JAX init of ResNet-18 at 64 px, B=8 in
    train mode, moving the input by a relative 1e-7 leaves every weight
    gradient within 1e-4 of its max|g|, but 1e-6 moves one by over 10% of
    its max|g| and 1.1% in relative L2 (ReLUs near 0 flip).  The two
    frameworks' f32 forwards differ by more than that."""
    from gloria_tpu.models.resnet import make_backbone as jax_backbone
    from gloria_tpu_torch.models.resnet import make_backbone
    from gloria_tpu_torch.utils.weights import resnet_state_dict

    x = np.random.RandomState(0).randn(8, 64, 64, 3)
    jm, _, _ = jax_backbone("resnet_18")
    v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32)))
    sd = {k: torch.from_numpy(np.array(a)) for k, a in
          resnet_state_dict(v["params"], v["batch_stats"]).items()}

    def grads(rel):
        model, _, _ = make_backbone("resnet_18")
        model.load_state_dict(sd)
        model = model.double().train()
        xp = x * (1 + rel * np.random.RandomState(3).randn(*x.shape))
        pooled, local = model(torch.from_numpy(xp).permute(0, 3, 1, 2))
        cot = [torch.from_numpy(np.random.RandomState(s).randn(*t.shape)) for s, t in
               ((1, pooled), (2, local))]
        ((pooled * cot[0]).sum() + (local * cot[1]).sum()).backward()
        return {n: p.grad for n, p in model.named_parameters()}

    base = grads(0.0)

    def worst(rel):
        g = grads(rel)
        entry = max(float((g[n] - b).abs().max() / b.abs().max()) for n, b in base.items())
        l2 = max(float((g[n] - b).norm() / b.norm()) for n, b in base.items())
        return entry, l2

    assert worst(1e-7)[0] < 1e-4
    entry, l2 = worst(1e-6)
    assert entry > 0.1 and l2 > 0.005


# ---- the slice as a whole: loader-fed steps ---------------------------------------

LOADER_OVERRIDES = {
    "model.gloria.segmentation_loss_weight": 1.0,
    "data.dataset": "synthetic",
    "data.synthetic_size": 24,
    "data.image.imsize": 64,
    "data.text.word_num": 24,
    "transforms.norm": "half",
    "transforms.random_crop.crop_size": 56,
    "transforms.random_horizontal_flip": 0.5,
    "train.num_workers": 1,
}


def test_three_loader_fed_train_steps_match_jax():
    """Each package's synthetic data module (seeded collates, tokenizer from
    the corpus, one batch built at a time) feeds three SGD steps of the
    tiny model with the attention-supervision loss on, each step from JAX's
    weights: the batches bit for bit, and every metric (``attn_seg_loss``
    and ``grad_norm`` included) at 1e-4 relative."""
    from gloria_tpu.data.collate import device_batch
    from gloria_tpu.data.data_module import build_data_module as jax_data_module
    from gloria_tpu_torch.data.data_module import build_data_module

    _, j_state, j_step, _ = tiny_setup(LOADER_OVERRIDES)
    j_state = j_state.replace(opt_state=jax_optim.set_learning_rate(j_state.opt_state, STEP_LR))
    cfg = TConfig(tiny_cfg(LOADER_OVERRIDES).to_dict())
    model = TGLoRIA(cfg)
    opt = optim.make_optimizer(cfg, grad_clip=cfg.lightning.trainer.gradient_clip_val)
    t_state = train.create_train_state(model, opt, seed=0, device="cpu")
    optim.set_learning_rate(t_state.opt_state, STEP_LR)
    t_step, _ = train.make_pretrain_steps(model, opt)

    j_batches = list(jax_data_module(tiny_cfg(LOADER_OVERRIDES)).loader(
        "train", prefetch=1, process_index=0, process_count=1))
    t_batches = list(build_data_module(cfg, device="cpu").loader("train", prefetch=1))
    assert len(t_batches) == len(j_batches) == 3
    for step, (jb, tb) in enumerate(zip(j_batches, t_batches)):
        assert tb["segmentation_labels"].shape == (8, 56, 56) and tb["segmentation_labels"].any()
        for k, v in device_batch(jb).items():
            assert np.array_equal(tb[k].numpy(), np.asarray(v)), f"step {step} {k}"
        model.load_state_dict(_state_dict_of(j_state), strict=True)
        j_state, j_metrics = j_step(j_state, device_batch(jb))
        t_state, t_metrics = t_step(t_state, tb)
        assert set(t_metrics) == set(j_metrics) and "attn_seg_loss" in t_metrics
        for k, v in j_metrics.items():
            np.testing.assert_allclose(float(t_metrics[k]), float(v), rtol=STEP_RTOL, atol=0,
                                       err_msg=f"step {step} {k}")
    assert t_state.step == 3
