"""Card tests of the port: the CUDA kernels against their plain versions.

This file imports neither JAX nor ``gloria_tpu``, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest`` because the repository's ``tests/conftest.py`` sets JAX
up.)  Without a card every test here skips.  Tolerances against the plain
versions, both sides f32 with TF32 off:
- forward (K1): 1e-3 absolute on log-similarities of magnitude ~1-20; the
  summation order differs, and the kernel's products run on the tensor
  cores at f32 accuracy (3xTF32); it has no atomics, so two calls on the
  same inputs agree bit for bit;
- backward (K2): 1e-3 · max|grad| + 1e-6 per output; the summation order
  differs, and the kernel's products run on the tensor cores at f32
  accuracy (3xTF32: about 2^-21 relative per product); it has no atomics,
  so two calls on the same inputs agree bit for bit;
- the fused bottleneck tail (K3 forward, K4 backward) against its plain
  version, bf16 products with f32 sums on both sides (cuBLAS with
  reduced-precision bf16 reductions off; K3's and K4's wgmma sum in their
  own order): the tolerances of ``fused_bn.tail_errors`` and
  ``fused_bn.grad_errors`` (y3 within one bf16 ulp, at most 1e-3 of its
  entries differing; s1, s2 at 1e-4; dy2 at one ulp of its largest entry;
  dscale, dshift, dW at 1e-3 of their largest: f32 sums in another order,
  which K4's atomics change from call to call).  K3 has no atomics, so two
  calls on the same inputs agree bit for bit;
- the driver (``gloria_tpu_torch.run.main``) at a tiny width: its launch
  counts exactly, and its best checkpoint's similarities on the card
  against the CPU at KERNEL_TOL.
"""

import numpy as np
import pytest
import torch

from gloria_tpu_torch.experiments import fused_bn
from gloria_tpu_torch.ops import gloria_loss as tgl
from gloria_tpu_torch.ops import local_sim

KERNEL_TOL = 1e-3
GRAD_TOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    matmul = torch.backends.cuda.matmul
    saved = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = matmul.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda")
    matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = saved


@pytest.mark.cuda
@pytest.mark.parametrize("agg,convention,T,B,W,S,D", [
    ("max", "eval", 25, 64, 97, 362, 768),   # serving: 5 classes x 5 prompts, sink
    ("max", "eval", 25, 64, 97, 361, 768),   # serving without a sink
    ("sum", "train", 9, 5, 97, 362, 64),
    ("mean", "train", 7, 3, 13, 40, 32),
    ("max", "eval", 136, 130, 97, 362, 64),  # T and B above 128
])
def test_kernel_matches_plain(card, agg, convention, T, B, W, S, D):
    rng = np.random.RandomState(T * 1000 + B)
    caps = rng.randint(0, W - 1, size=T)
    caps[:3] = [0, 1, W - 2]
    words = torch.from_numpy(rng.randn(T, W, D).astype(np.float32)).to(card)
    regions = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(card)
    mask = tgl.make_word_mask(torch.from_numpy(caps).to(card), W, convention)
    before = local_sim.launches
    got = local_sim.local_similarities(words, regions, mask, agg=agg)
    torch.cuda.synchronize()
    assert local_sim.launches == before + 1
    ref = local_sim.local_similarities_plain(words, regions, mask, agg=agg)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= KERNEL_TOL


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(card, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel; it does not call the
    plain version, even when the launch fails."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(local_sim, "local_similarities_plain", forbidden)
    words = torch.randn(2, 5, 8, device=card)
    regions = torch.randn(3, 7, 8, device=card)
    mask = torch.ones(2, 5, device=card)
    out = local_sim.local_similarities(words, regions, mask)
    assert out.shape == (3, 2) and out.is_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("agg,convention,T,B,W,S,D", [
    ("max", "eval", 25, 64, 97, 362, 768),   # serving: 5 classes x 5 prompts, sink
    ("sum", "train", 7, 5, 13, 41, 30),      # D not a multiple of 4: padded operands
])
def test_kernel_is_deterministic(card, agg, convention, T, B, W, S, D):
    """Two calls on the same inputs give the same similarities bit for bit
    (no atomics), one launch each, within tolerance of the plain version."""
    rng = np.random.RandomState(6)
    caps = rng.randint(0, W - 1, size=T)
    caps[:3] = [0, 1, W - 2]
    words = torch.from_numpy(rng.randn(T, W, D).astype(np.float32)).to(card)
    regions = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(card)
    mask = tgl.make_word_mask(torch.from_numpy(caps).to(card), W, convention)
    before = local_sim.launches
    first = local_sim.local_similarities(words, regions, mask, agg=agg)
    second = local_sim.local_similarities(words, regions, mask, agg=agg)
    torch.cuda.synchronize()
    assert local_sim.launches == before + 2
    assert torch.equal(first, second)
    ref = local_sim.local_similarities_plain(words, regions, mask, agg=agg)
    assert float((first - ref).abs().max()) <= KERNEL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_kernel_all_captions_empty(card, agg):
    """No valid word in any text (N = 0): every similarity is log(1e-8), and
    the call still launches once."""
    rng = np.random.RandomState(7)
    words = torch.from_numpy(rng.randn(6, 97, 768).astype(np.float32)).to(card)
    regions = torch.from_numpy(rng.randn(4, 362, 768).astype(np.float32)).to(card)
    mask = torch.zeros(6, 97, dtype=torch.bool, device=card)
    # leave NaN in the allocator's cache, where the wrapper's torch.empty finds it
    stale = torch.full((4, 6), float("nan"), device=card)
    del stale
    before = local_sim.launches
    got = local_sim.local_similarities(words, regions, mask, agg=agg)
    torch.cuda.synchronize()
    assert local_sim.launches == before + 1
    assert got.shape == (4, 6) and bool((got == got[0, 0]).all())
    # logf on the card is within 1 ulp (about 2e-6 here) of the host's log
    assert abs(float(got[0, 0]) - float(np.log(np.float32(1e-8)))) <= 1e-5


def _train_inputs(card, agg_seed, T, B, W, S, D, caps):
    rng = np.random.RandomState(agg_seed)
    words = torch.from_numpy(rng.randn(T, W, D).astype(np.float32)).to(card)
    regions = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(card)
    g = torch.from_numpy(rng.randn(B, T).astype(np.float32)).to(card)
    mask = tgl.make_word_mask(torch.as_tensor(caps).to(card), W, "train")
    return words, regions, mask, g


@pytest.mark.cuda
@pytest.mark.parametrize("agg,T,B,W,S,D", [
    ("sum", 48, 48, 97, 361, 768),    # pretrain shape
    ("sum", 48, 48, 97, 362, 768),    # with the sink
    ("mean", 12, 10, 97, 361, 768),
    ("max", 12, 10, 97, 362, 768),
    ("sum", 136, 130, 97, 362, 64),   # T and B above 128
])
def test_bwd_kernel_matches_plain(card, agg, T, B, W, S, D):
    rng = np.random.RandomState(T + B)
    caps = rng.randint(23, 64, size=T)
    caps[:3] = [0, 1, W - 1]
    words, regions, mask, g = _train_inputs(card, T * 7 + B, T, B, W, S, D, caps)
    before = local_sim.launches_bwd
    dw, dr = local_sim.local_similarities_bwd(words, regions, mask, g, agg=agg)
    torch.cuda.synchronize()
    assert local_sim.launches_bwd == before + 1
    pw, pr = local_sim.local_similarities_bwd_plain(words, regions, mask, g, agg=agg)
    for got, ref in ((dw, pw), (dr, pr)):
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= GRAD_TOL * float(ref.abs().max()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("agg,T,B,W,S,D", [
    ("sum", 48, 48, 97, 361, 768),   # pretrain shape
    ("max", 7, 5, 13, 41, 30),       # D not a multiple of 4: padded operands
])
def test_bwd_kernel_is_deterministic(card, agg, T, B, W, S, D):
    """Two calls on the same inputs give the same dwords and dregions bit for
    bit (no atomics), one launch each, within tolerance of the plain version."""
    rng = np.random.RandomState(5)
    caps = rng.randint(1, W, size=T)
    caps[:2] = [0, W - 1]
    words, regions, mask, g = _train_inputs(card, 17, T, B, W, S, D, caps)
    before = local_sim.launches_bwd
    first = local_sim.local_similarities_bwd(words, regions, mask, g, agg=agg)
    second = local_sim.local_similarities_bwd(words, regions, mask, g, agg=agg)
    torch.cuda.synchronize()
    assert local_sim.launches_bwd == before + 2
    ref = local_sim.local_similarities_bwd_plain(words, regions, mask, g, agg=agg)
    for a, b, exp in zip(first, second, ref):
        assert torch.equal(a, b)
        assert float((a - exp).abs().max()) <= GRAD_TOL * float(exp.abs().max()) + 1e-6


@pytest.mark.cuda
def test_bwd_kernel_all_captions_empty(card):
    """No valid word in any text (N = 0): both gradients are exactly 0, and
    the call still launches once."""
    words, regions, mask, g = _train_inputs(card, 23, 6, 4, 97, 361, 768, [0] * 6)
    # leave NaN in the allocator's cache, where the wrapper's torch.empty finds it
    stale = [torch.full_like(words, float("nan")), torch.full_like(regions, float("nan"))]
    del stale
    before = local_sim.launches_bwd
    dw, dr = local_sim.local_similarities_bwd(words, regions, mask, g)
    torch.cuda.synchronize()
    assert local_sim.launches_bwd == before + 1
    assert dw.shape == words.shape and dr.shape == regions.shape
    assert not dw.any() and not dr.any()


@pytest.mark.cuda
def test_fused_similarities_on_the_card_never_take_the_plain_path(card, monkeypatch):
    """Forward and backward of ``fused_local_similarities`` on CUDA tensors
    launch K1 once and K2 once, and agree with autograd through the plain
    version computed before the plain functions are forbidden."""
    words, regions, mask, g = _train_inputs(card, 3, 6, 5, 13, 41, 32, [12, 1, 0, 5, 9, 3])
    w_ref = words.clone().requires_grad_()
    r_ref = regions.clone().requires_grad_()
    ref = local_sim.local_similarities_plain(w_ref, r_ref, mask)
    (ref * g).sum().backward()

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(local_sim, "local_similarities_plain", forbidden)
    monkeypatch.setattr(local_sim, "local_similarities_bwd_plain", forbidden)
    w = words.clone().requires_grad_()
    r = regions.clone().requires_grad_()
    before = (local_sim.launches, local_sim.launches_bwd)
    sims = local_sim.fused_local_similarities(w, r, mask, 4.0, 5.0, "sum")
    (sims * g).sum().backward()
    torch.cuda.synchronize()
    assert (local_sim.launches, local_sim.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert float((sims - ref).abs().max()) <= KERNEL_TOL
    for got, exp in ((w.grad, w_ref.grad), (r.grad, r_ref.grad)):
        assert float((got - exp).abs().max()) <= GRAD_TOL * float(exp.abs().max()) + 1e-6


def _tail_inputs(card, M, K, N, seed):
    """((y2, scale, shift, w), (gy3, gs1, gs2)) on the card from a numpy seed."""
    rng = np.random.RandomState(seed)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(card).to(dtype)

    args = (dev(rng.randn(M, K), torch.bfloat16), dev(rng.rand(K) + 0.5), dev(rng.randn(K) * 0.2),
            dev(rng.randn(K, N) * 0.1))
    return args, (dev(rng.randn(M, N), torch.bfloat16), dev(rng.randn(N)), dev(rng.randn(N) * 0.1))


def _assert_within(errors):
    assert all(ratio <= 1.0 for _, ratio in errors.values()), errors


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (1, 16, 32), (48, 16, 32), (601, 24, 40), (600, 128, 128), (601, 128, 512),
    (4800, 512, 2048),  # ResNet-50's layer-4 tail at B=48, 299 px
    # K4's tile paths: K = 64 with N = 256 (the fused pass) and N = 512 (the
    # two passes: a 64-wide dz tile, a 64-channel dW warpgroup), M <= 64 (64-row
    # dz tiles), K = 256 (one 256-wide dz tile), K = 512 (two, with a ragged
    # last row tile), and K, N not multiples of 8 (padded by the wrapper)
    (601, 64, 256), (601, 64, 512), (48, 128, 512), (601, 256, 1024), (4801, 512, 2048),
    (300, 20, 36),
])
def test_fused_tail_kernels_match_plain(card, M, K, N):
    args, (gy3, gs1, gs2) = _tail_inputs(card, M, K, N, seed=M + K + N)
    before = (fused_bn.launches_fwd, fused_bn.launches_bwd)
    got = fused_bn.bottleneck_tail_fwd(*args)
    torch.cuda.synchronize()
    _assert_within(fused_bn.tail_errors(got, fused_bn.bottleneck_tail_plain(*args)))
    grads = fused_bn.bottleneck_tail_bwd(*args, got[0], gy3, gs1, gs2)
    torch.cuda.synchronize()
    assert (fused_bn.launches_fwd, fused_bn.launches_bwd) == (before[0] + 1, before[1] + 1)
    ref = fused_bn.bottleneck_tail_bwd_plain(*args, got[0], gy3, gs1, gs2)
    assert all(torch.isfinite(g).all() for g in grads)
    _assert_within(fused_bn.grad_errors(grads, ref))


@pytest.mark.cuda
def test_fused_tail_on_the_card_never_takes_the_plain_path(card, monkeypatch):
    """``bottleneck_tail`` forward and backward on CUDA tensors launch K3
    once and K4 once, and agree with the plain versions computed before
    they are forbidden."""
    args, cots = _tail_inputs(card, 601, 128, 512, seed=11)
    y3_ref = fused_bn.bottleneck_tail_plain(*args)
    grads_ref = fused_bn.bottleneck_tail_bwd_plain(*args, y3_ref[0], *cots)

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fused_bn, "bottleneck_tail_plain", forbidden)
    monkeypatch.setattr(fused_bn, "bottleneck_tail_bwd_plain", forbidden)
    leaves = [a.clone().requires_grad_() for a in args]
    before = (fused_bn.launches_fwd, fused_bn.launches_bwd)
    outs = fused_bn.bottleneck_tail(*leaves)
    torch.autograd.backward(outs, cots)
    torch.cuda.synchronize()
    assert (fused_bn.launches_fwd, fused_bn.launches_bwd) == (before[0] + 1, before[1] + 1)
    _assert_within(fused_bn.tail_errors(outs, y3_ref))
    _assert_within(fused_bn.grad_errors([a.grad for a in leaves], grads_ref))


@pytest.mark.cuda
def test_fused_tail_bwd_zero_channel_gets_exact_zero_gradients(card):
    """A channel whose z are all 0 (y2·scale + shift ≤ 0 on every row) gets
    dy2, dscale and dshift exactly 0 from K4, one launch per call."""
    args, (gy3, gs1, gs2) = _tail_inputs(card, 601, 64, 256, seed=23)
    y2, scale, shift, w = (a.clone() for a in args)
    y2[:, 0] = y2[:, 0].abs()
    scale[0], shift[0] = -scale[0].abs() - 0.5, -shift[0].abs() - 0.1
    y3 = fused_bn.bottleneck_tail_fwd(y2, scale, shift, w)[0]
    before = fused_bn.launches_bwd
    dy2, dscale, dshift, dw = fused_bn.bottleneck_tail_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2)
    torch.cuda.synchronize()
    assert fused_bn.launches_bwd == before + 1
    assert bool((dy2[:, 0] == 0).all()) and float(dscale[0]) == 0.0 and float(dshift[0]) == 0.0
    ref = fused_bn.bottleneck_tail_bwd_plain(y2, scale, shift, w, y3, gy3, gs1, gs2)
    _assert_within(fused_bn.grad_errors((dy2, dscale, dshift, dw), ref))


# K3's launch plans (experiments/fused_bn.py:_fwd_plan) on the card's SMs
FWD_REGIMES = [
    (270000, 64, 256),   # ResNet-50's layer-1 tail: one unit a row tile, 2110 units on 132 blocks
    (17328, 256, 1024),  # layer 3: four 256-column units a row tile; blocks walk several row tiles
    (4801, 512, 2048),   # N groups: blocks start inside row tiles and make z again; ragged last tile
    (129, 640, 64),      # K = 640: ten z column blocks beside a 3-stage ring; 64-column units
    (300, 16, 128),      # one unit a row tile, one chunk of K: each unit adds to the same sums
]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", FWD_REGIMES)
def test_fused_tail_fwd_regimes_match_plain(card, M, K, N):
    args, _ = _tail_inputs(card, M, K, N, seed=M + 2 * K + N)
    before = fused_bn.launches_fwd
    got = fused_bn.bottleneck_tail_fwd(*args)
    torch.cuda.synchronize()
    assert fused_bn.launches_fwd == before + 1
    _assert_within(fused_bn.tail_errors(got, fused_bn.bottleneck_tail_plain(*args)))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", FWD_REGIMES + [(601, 24, 40)])
def test_fused_tail_fwd_is_deterministic(card, M, K, N):
    """Two K3 calls on the same inputs give the same y3, s1 and s2, bit for
    bit (no atomics: every sum in an order the launch plan fixes)."""
    args, _ = _tail_inputs(card, M, K, N, seed=3 * M + K + N)
    first = fused_bn.bottleneck_tail_fwd(*args)
    second = fused_bn.bottleneck_tail_fwd(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("y3", "s1", "s2"), first, second):
        assert torch.equal(a, b), name


# ---- the pretraining data plane and the attention-supervision loss ------------

def _tiny_pretrain_cfg(**data):
    from gloria_tpu_torch.configs import Config

    return Config({
        "model": {"gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0,
                             "segmentation_loss_weight": 1.0},
                  "vision": {"model_name": "resnet_18"},
                  "text": {"embedding_dim": 32, "agg_tokens": True,
                           "bert_config": {"vocab_size": 128, "hidden_size": 32, "num_layers": 2,
                                           "num_heads": 4, "intermediate_size": 64,
                                           "max_position_embeddings": 32,
                                           "dropout_rate": 0.0}}},
        "data": {"dataset": "synthetic", "synthetic_size": 8,
                 "image": {"imsize": 64}, "text": {"word_num": 24}, **data},
        "transforms": {"norm": "half", "random_crop": {"crop_size": 48},
                       "random_horizontal_flip": 0.5},
        "train": {"batch_size": 4, "num_workers": 1},
    })


@pytest.mark.cuda
@pytest.mark.parametrize("device_normalize", [False, True], ids=["f32", "uint8"])
def test_loader_batch_lands_on_the_card(card, device_normalize):
    """A synthetic module's train batch: every array key a tensor on the card
    (ids, masks, cap_lens int64; images f32, or uint8 for device
    normalization; the rest f32); the host keys stay host objects."""
    from gloria_tpu_torch.data.data_module import build_data_module

    cfg = _tiny_pretrain_cfg(device_normalize=device_normalize)
    batch = next(iter(build_data_module(cfg, device=card).train_dataloader()))
    dtypes = {"imgs": torch.uint8 if device_normalize else torch.float32,
              "caption_ids": torch.int64, "attention_mask": torch.int64,
              "token_type_ids": torch.int64, "cap_lens": torch.int64,
              "word_assignment": torch.float32, "segmentation_labels": torch.float32}
    assert {k for k in batch if not k.startswith("_")} == set(dtypes)
    for k, dtype in dtypes.items():
        assert batch[k].device.type == "cuda" and batch[k].dtype == dtype, k
    assert batch["imgs"].shape == (4, 48, 48, 3)
    assert isinstance(batch["_words"], list) and isinstance(batch["_ids"], list)
    assert isinstance(batch["_order"], np.ndarray) and isinstance(batch["_indices"], np.ndarray)


@pytest.mark.cuda
def test_attention_supervised_step_card_matches_cpu(card):
    """One loader batch through ``loss_and_grads`` with the
    attention-supervision loss on (dropout 0), on the card (K1, K2, cuDNN,
    TF32 off) and on the CPU: loss and ``attn_seg_loss`` at 1e-4 relative,
    the gradient norm at 1e-3 relative."""
    import copy

    from gloria_tpu_torch.data.data_module import build_data_module
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.training import optim, train

    cfg = _tiny_pretrain_cfg()
    raw = next(iter(build_data_module(cfg, device="cpu").train_dataloader()))
    cpu_model = init_gloria(cfg, seed=0)
    gpu_model = copy.deepcopy(cpu_model).to(card)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = (local_sim.launches, local_sim.launches_bwd)
        gm, gg = train.loss_and_grads(gpu_model, train.to_device(raw, card))
        torch.cuda.synchronize()
        assert (local_sim.launches, local_sim.launches_bwd) == (before[0] + 1, before[1] + 1)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    cm, cg = train.loss_and_grads(cpu_model, raw)
    for k in ("loss", "attn_seg_loss"):
        assert abs(float(gm[k]) - float(cm[k])) <= 1e-4 * abs(float(cm[k])), k
    assert float(cm["attn_seg_loss"]) > 0
    gn, cn = float(optim.global_norm(gg)), float(optim.global_norm(cg))
    assert abs(gn - cn) <= 1e-3 * cn


DRIVER_CFG = {
    "experiment_name": "card_driver",
    "random_seed": 0,
    "lightning": {
        "trainer": {"max_epochs": 2, "gradient_clip_val": 0.25, "lr": 5e-4, "precision": 32},
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
                                 "max_position_embeddings": 48}},
    },
    "data": {"dataset": "synthetic", "synthetic_size": 16, "text": {"word_num": 24},
             "image": {"imsize": 64}},
    "transforms": {"norm": "half", "random_crop": {"crop_size": 48}},
    "train": {"batch_size": 8, "num_workers": 2,
              "optimizer": {"name": "Adam", "weight_decay": 1e-6},
              "scheduler": {"name": "plateau", "monitor": "val_loss"}},
}


@pytest.mark.cuda
def test_driver_trains_and_serves_on_the_card(card, tmp_path):
    """The driver's ``main`` on the card at a tiny width: one K1 launch a
    train and an eval step, one K2 launch a train step, finite losses; its
    best checkpoint serves the same similarities on the card as on the CPU
    (KERNEL_TOL)."""
    from gloria_tpu_torch import api, run
    from gloria_tpu_torch.configs import Config

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    try:
        cfg = Config(DRIVER_CFG)
        args = run.get_parser().parse_args(["-c", "unused.yaml", "--train", "--test",
                                            "--limit_batches", "2"])
        run.apply_overrides(cfg, args)
        cfg.output_dir = str(tmp_path)
        results = run.main(cfg, args)  # no device: the card
        report = results["run"]
        assert report["global_step"] == 4
        assert report["launches"] == {"local_sim_fwd": 4 + 2 * 2 + 2, "local_sim_bwd": 4}
        assert np.isfinite(results["test"]["test_loss"])
        served = {d: api.load_gloria(results["best_ckpt"], device=d) for d in ("cuda", "cpu")}
        rng = np.random.RandomState(0)
        imgs = rng.rand(3, 48, 48, 3).astype(np.float32)
        txts = served["cpu"].process_text(["small pleural effusion", "no acute process"])
        sims = {d: gm.get_similarities(imgs, txts) for d, gm in served.items()}
        assert np.isfinite(sims["cuda"]).all()
        np.testing.assert_allclose(sims["cuda"], sims["cpu"], rtol=0, atol=KERNEL_TOL)
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


@pytest.mark.cuda
def test_frozen_classification_step_card_matches_cpu(card):
    """One classification task step (the pretrained classifier, ResNet-18 at
    64² upsampled to 299², freeze_cnn, Adam, BCE) on the card (cuDNN, TF32
    off) and on the CPU from the same weights: loss at 1e-4 relative, every
    trainable gradient at 1e-3 relative L2, the frozen backbone bit-equal to
    its start on the card, the BatchNorm statistics at 1e-4."""
    import copy

    from gloria_tpu_torch.configs import Config
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.training import optim, tasks

    cfg = Config({"model": {"vision": {"model_name": "resnet_18", "num_targets": 3,
                                       "freeze_cnn": True}},
                  "train": {"loss_fn": {"type": "BCE"},
                            "optimizer": {"name": "Adam", "weight_decay": 1e-6}},
                  "lightning": {"trainer": {"lr": 1e-3}}})
    gloria = init_gloria(Config({**DRIVER_CFG, "model": {**DRIVER_CFG["model"], "vision": {
        "model_name": "resnet_18"}}}), seed=1).state_dict()
    model, patch = tasks.ClassificationTask.build_model(cfg, gloria, seed=2)
    model.load_state_dict(tasks.graft_pretrained(model.state_dict(), patch))
    rng = np.random.RandomState(3)
    batch = {"imgs": torch.from_numpy(rng.randn(2, 64, 64, 3).astype(np.float32)),
             "labels": torch.from_numpy((rng.rand(2, 3) > 0.5).astype(np.float32))}

    def task_on(device):
        m = copy.deepcopy(model)
        tx = optim.make_optimizer(cfg, grad_clip=0.25)
        tx = optim.freeze_wrap(tx, optim.partition_trainable(m, optim.trainable_predicate(cfg)))
        task = tasks.ClassificationTask(m, tasks.build_loss(cfg), tx)
        return task, task.init_state(device=device)

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        gtask, gstate = task_on(card)
        start = {k: v.clone() for k, v in gtask.model.state_dict().items()}
        gloss, _, ggrads = gtask.loss_and_grads({k: v.to(card) for k, v in batch.items()})
        gstate, _ = gtask.train_step(gstate, batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    ctask, cstate = task_on("cpu")
    closs, _, cgrads = ctask.loss_and_grads(batch)
    ctask.train_step(cstate, batch)
    assert abs(float(gloss) - float(closs)) <= 1e-4 * abs(float(closs))
    for g, c in zip(ggrads, cgrads):
        g, c = g.cpu().double(), c.double()
        assert float((g - c).norm()) <= 1e-3 * max(float(c.norm()), 1e-30)
    cpu_sd = ctask.model.state_dict()
    for name, p in gtask.model.named_parameters():
        if name.startswith("img_encoder.model."):
            assert torch.equal(p.detach(), start[name]), name
    for name, buf in gtask.model.named_buffers():
        np.testing.assert_allclose(buf.cpu().numpy(), cpu_sd[name].numpy(), rtol=0, atol=1e-4,
                                   err_msg=name)
