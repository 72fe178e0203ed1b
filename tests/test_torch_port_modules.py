"""Module parity: each ported module against its JAX original on the same
numpy-seeded inputs and the same weights (JAX init → the port's bridge).

Tolerances: 1e-5 absolute for BERT and the text encoder (f32, a few
products); 2e-4 absolute for the resize, whose source coordinates PyTorch
computes in f32 where JAX builds its interpolation matrices in f64 (an
offset of ~1e-5 pixel times the pixel-to-pixel step of N(0, 1) noise);
1e-4 relative-to-scale for the image towers (f32 convolutions summed in
another order by XLA and oneDNN, through up to 16 residual blocks).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gloria_tpu.configs import Config
from gloria_tpu.data import tokenizer as jtok
from gloria_tpu.data import transforms as jtr
from gloria_tpu.models import GLoRIA
from gloria_tpu.models.bert import BertConfig as JBertConfig
from gloria_tpu.models.bert import BertModel as JBertModel
from gloria_tpu.models.resnet import make_backbone as jax_backbone
from gloria_tpu.models.text_model import TextEncoder as JTextEncoder
from gloria_tpu.ops.resize import resize_bilinear as jax_resize
from gloria_tpu_torch.data import tokenizer as ttok
from gloria_tpu_torch.data import transforms as ttr
from gloria_tpu_torch.models.bert import BertConfig, BertModel
from gloria_tpu_torch.models.gloria_model import GLoRIA as TGLoRIA
from gloria_tpu_torch.models.resnet import make_backbone
from gloria_tpu_torch.models.text_model import TextEncoder
from gloria_tpu_torch.ops.resize import resize_bilinear
from gloria_tpu_torch.utils import weights

TOWER_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _random_bn_stats(stats, seed):
    """Non-trivial running stats, so eval-mode BatchNorm is exercised."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if "mean" in node and "var" in node and not isinstance(node["mean"], dict):
            return {"mean": (0.1 * rng.randn(*node["mean"].shape)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, node["var"].shape).astype(np.float32)}
        return {k: walk(v) for k, v in node.items()}

    return walk(stats)


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("src", [224, 48])
def test_resize_matches_jax(src):
    x = np.random.RandomState(src).randn(2, src, src, 3).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x), (299, 299), align_corners=True))
    got = resize_bilinear(torch.from_numpy(x), (299, 299)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-4)


@pytest.mark.parametrize("shape", [(256, 256), (256, 200), (180, 256), (256, 256, 3),
                                   (300, 200), (120, 90)])
def test_letterbox_matches_jax(shape):
    img = (np.random.RandomState(sum(shape)).rand(*shape) * 255).astype(np.uint8)
    ref = jtr.letterbox_resize(img, 256)
    got = ttr.letterbox_resize(img, 256)
    np.testing.assert_array_equal(got, ref)


def test_letterbox_skips_cv2_at_imsize(monkeypatch):
    """An image whose long side is already ``scale`` needs no cv2."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("cv2 is absent")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    img = (np.random.RandomState(5).rand(256, 180) * 255).astype(np.uint8)
    out = ttr.letterbox_resize(img, 256)
    assert out.shape == (256, 256)
    np.testing.assert_array_equal(out[:, 38:218], img)


def test_eval_transform_matches_jax():
    cfg = {"transforms": {"norm": "half", "random_crop": {"crop_size": 224}}}
    img = (np.random.RandomState(6).rand(256, 256) * 255).astype(np.uint8)
    ref = jtr.build_transformation(Config(cfg), split="test")(img)
    got = ttr.build_transformation(Config(cfg), split="test")(img)
    np.testing.assert_array_equal(got, ref)


def test_text_processor_matches_jax():
    corpus = ["mild edema at the left lung base", "no finding", "Small left pleural effusion."]
    prompts = ["mild edema at the left lung base", "1. Small left pleural-effusion. 2. no finding",
               "cardiomegaly", "no finding"]
    ref = jtok.TextProcessor(jtok.WordPieceTokenizer.from_corpus(corpus), num_words=16)(prompts)
    got = ttok.TextProcessor(ttok.WordPieceTokenizer.from_corpus(corpus), num_words=16)(prompts)
    assert got.keys() == ref.keys()
    for k in ref:
        if k == "words":
            assert got[k] == ref[k]
        else:
            np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("name,pixels", [("resnet_18", 64), ("resnet_50", 32),
                                         ("resnet_34", 32), ("resnext_50", 32)])
def test_resnet_matches_jax(name, pixels):
    """BasicBlock (ResNet-18, -34) and Bottleneck (ResNet-50, grouped
    ResNeXt-50) towers: pooled layer4 and the layer3 map."""
    x = np.random.RandomState(7).randn(2, pixels, pixels, 3).astype(np.float32)
    jmodel, _, _ = jax_backbone(name)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    stats = _random_bn_stats(variables["batch_stats"], 8)
    ref_pooled, ref_local = jmodel.apply({"params": variables["params"], "batch_stats": stats},
                                         jnp.asarray(x))
    model, _, _ = make_backbone(name)
    sd = weights.resnet_state_dict(variables["params"], stats)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    model.eval()  # running statistics, as the JAX apply without train=True
    with torch.no_grad():
        pooled, local = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(pooled.numpy(), ref_pooled, TOWER_TOL)
    _close(local.permute(0, 2, 3, 1).numpy(), ref_local, TOWER_TOL)


def _bert_inputs(B=3, T=12, vocab=64, seed=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 7:] = 0
    mask[-1, 3:] = 0
    types = np.zeros((B, T), np.int32)
    types[0, 6:] = 1
    return ids, mask, types


def test_bert_matches_jax():
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               intermediate_size=48, max_position_embeddings=16)
    ids, mask, types = _bert_inputs()
    jmodel = JBertModel(JBertConfig(**cfg))
    params = _np_tree(jmodel.init(jax.random.PRNGKey(1), ids, mask, types))["params"]
    ref = jmodel.apply({"params": params}, ids, mask, types)
    model = BertModel(BertConfig(**cfg))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in weights.bert_state_dict(params).items()},
                          strict=True)
    model.eval()  # no dropout, as the JAX apply's deterministic default
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                    torch.from_numpy(types).long())
    for g, r in zip(got, ref):  # sequence output, pooled, all hidden states
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-5)


TEXT_ENCODER_OPTIONS = {
    "sum-last4-agg": {},
    "mean": {"aggregate_method": "mean"},
    "last1": {"last_n_layers": 1},
    "no-agg-tokens": {"agg_tokens": False},
    "norm": {"norm": True},
}


@pytest.mark.parametrize("option", sorted(TEXT_ENCODER_OPTIONS))
def test_text_encoder_matches_jax(option):
    opts = {"last_n_layers": 4, "aggregate_method": "sum", "norm": False, "agg_tokens": True,
            **TEXT_ENCODER_OPTIONS[option]}
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
               intermediate_size=48, max_position_embeddings=16)
    ids, mask, types = _bert_inputs(T=12)
    W = 10
    assign = np.zeros((3, W, 12), np.float32)
    for b in range(3):
        for t in range(12):
            assign[b, min(t // 2, W - 1), t] = 1.0
    jmodel = JTextEncoder(JBertConfig(**cfg), **opts)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(2), ids, mask, types, assign))["params"]
    ref_w, ref_s = jmodel.apply({"params": params}, ids, mask, types, assign)
    model = TextEncoder(BertConfig(**cfg), **opts)
    sd = {f"model.{k}": torch.from_numpy(np.array(v)) for k, v in weights.bert_state_dict(params["bert"]).items()}
    model.load_state_dict(sd, strict=True)
    model.eval()  # no dropout, as the JAX apply's deterministic default
    with torch.no_grad():
        got_w, got_s = model(torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
                             torch.from_numpy(types).long(), torch.from_numpy(assign))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-5)


GLORIA_OPTIONS = {
    "plain": {},
    "sink-pos-transformer": {"extras": True},
    "model-norm": {"norm": True},
    "input-size-0": {"encoder_input_size": 0},
    "input-size-64": {"encoder_input_size": 64},
}


def _gloria_cfg(extras: bool = False, norm: bool = False,
                encoder_input_size: int | None = None) -> Config:
    model = {
        "gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0, "no_attn_vec": extras},
        "vision": {"model_name": "resnet_18"},
        "text": {"embedding_dim": 32, "last_n_layers": 4, "agg_tokens": True,
                 "aggregate_method": "sum",
                 "bert_config": {"vocab_size": 64, "hidden_size": 32, "num_layers": 2,
                                 "num_heads": 4, "intermediate_size": 48,
                                 "max_position_embeddings": 16}},
    }
    if extras:
        model["image_position_embeddings"] = {"num": 361}
        model["image_transformer"] = {"num_layers": 2, "num_heads": 4}
    if norm:
        model["norm"] = True
    if encoder_input_size is not None:
        model["vision"]["encoder_input_size"] = encoder_input_size
    return Config({"model": model, "transforms": {"norm": "half"}})


@pytest.mark.parametrize("option", list(GLORIA_OPTIONS))
def test_gloria_encoders_match_jax(option):
    """``image_encoder_forward`` on float, uint8 C=3 and uint8 C=1 input, and
    ``text_encoder_forward``; with and without the sink, the 2-D position
    embeddings and the image transformer, the embeddings' L2 norm
    (``model.norm``) and the encoder input size (299 by default, 0: no
    upsampling, 64)."""
    cfg = _gloria_cfg(**GLORIA_OPTIONS[option])
    rng = np.random.RandomState(10)
    ids, mask, types = _bert_inputs(B=2, T=12)
    assign = np.eye(12, dtype=np.float32)[None].repeat(2, 0)
    batch = {"imgs": rng.randn(2, 48, 48, 3).astype(np.float32), "caption_ids": ids,
             "attention_mask": mask, "token_type_ids": types, "word_assignment": assign}
    jmodel = GLoRIA(cfg)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(3), batch))
    variables["batch_stats"] = _random_bn_stats(variables["batch_stats"], 11)
    model = TGLoRIA(cfg)
    model.load_state_dict(weights.state_dict_from_jax(variables), strict=True)
    model.eval()

    u8_rgb = (rng.rand(2, 48, 48, 3) * 255).astype(np.uint8)
    u8_gray = (rng.rand(2, 48, 48, 1) * 255).astype(np.uint8)
    for imgs in (batch["imgs"], u8_rgb, u8_gray):
        ref_l, ref_g, ref_grid = jmodel.apply(variables, jnp.asarray(imgs),
                                              method=GLoRIA.image_encoder_forward)
        with torch.no_grad():
            got_l, got_g, grid = model.image_encoder_forward(torch.from_numpy(imgs))
        assert grid == tuple(ref_grid) == {"input-size-0": (3, 3),
                                           "input-size-64": (4, 4)}.get(option, (19, 19))
        _close(got_l.numpy(), ref_l, TOWER_TOL)
        _close(got_g.numpy(), ref_g, TOWER_TOL)

    ref_w, ref_s = jmodel.apply(variables, ids, mask, types, assign,
                                method=GLoRIA.text_encoder_forward)
    with torch.no_grad():
        got_w, got_s = model.text_encoder_forward(
            torch.from_numpy(ids).long(), torch.from_numpy(mask).long(),
            torch.from_numpy(types).long(), torch.from_numpy(assign))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-5)
