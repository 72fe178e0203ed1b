#!/usr/bin/env python3
"""Chip smoke test of gloria_tpu_torch, the PyTorch + CUDA port, on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device  — the card's name and power limit (nvidia-smi) and the device
   count; TF32 is switched off for convolutions and matrix products, so the
   whole run is f32 and comparable with the CPU path, and bf16 products sum
   in f32 (no reduced-precision reductions).
2. build   — nvcc builds every kernel (K1, K2 of the serving and training
   paths; K3, K4 of the fused bottleneck tail) from ``gloria_tpu_torch/csrc``
   for sm_90a into ``build/kernels/``, one nvcc process per source, all
   started together.
3. kernel  — each kernel against its plain PyTorch version on probes.  K1
   (forward): the serving shape with and without the no-attention sink, the
   eval and the train word masks, caption lengths 0, 1 and W-2, B, T above
   128, and a batch whose captions are all empty (every entry log(1e-8)).
   K2 (backward): the pretrain shape with and without the sink,
   aggregations sum, mean and max, caption lengths 0, 1 and W-1 under the
   train mask, B, T above 128 at a narrower D, and a batch whose captions
   are all empty (no valid word: both gradients exactly 0).
4. serve   — the full-width model (ResNet-50 + BERT-base, 97 words, 224 px
   crops upsampled to 299², D=768) built from a seed serves zero-shot
   requests through ``InferenceEngine.classify`` (1, 5 and 64 images), a
   ``DynamicBatcher`` and ``serve_http``'s ``POST /classify``; kernel launch
   counts are read around exactly this main-path run.  Its scores are held
   against the same model run on the CPU, where the local similarity is the
   plain version.
5. kernels — K1 again at the inputs the serving path gave it: error against
   the plain version, two calls bitwise equal, median time from CUDA
   events, the plain version's time, its bound at the f32 CUDA-core rate
   and at the 3xTF32 rate its products run at, its device time per pass
   (torch.profiler), its wrapper's time (the CUDA-event time less the
   passes) and its workspace.
6. train   — the same model from seed 0, in train mode with BERT dropout
   0.1 and the pretrain optimizer (Adam 0.5/0.999, coupled decay 1e-6,
   clip 0.25, lr 5e-5), takes one warm-up step and then five
   ``train_step``s on a synthetic batch of 48 pairs (97 tokens, 224² float
   images); the launch counts are read around exactly those five steps.
   Losses finite, every reached parameter and every running statistic
   moved.  Step time and pairs/s from CUDA events, where the step's time
   goes, and K1 and K2 at the inputs a step gave them, each as K1 in
   phase 5: both bounds, device time per pass, workspace, bitwise repeat.
7. card vs CPU — one step's loss, gradient norm and every parameter's
   gradient from the same weights and batch (8 pairs, dropout 0) on the
   card (kernels, cuDNN) and on the CPU (plain versions, oneDNN).
8. loader  — the pretraining data plane feeding the step: the native host
   ingest built with g++ on this host (build time; ms per batch of 48
   uint8 images of 390×320 to the f32 and the u8 224² crop); the same
   model as phase 6 with the attention-supervision loss on (weight 1.0),
   fed by ``build_data_module(cfg, device="cuda").train_dataloader()``
   (synthetic module, 256 px letterbox, 224 crop, 8 batches of 48 an
   epoch, the config's 18 workers): the loader's batches/s alone, one
   warm-up step, then five loader-fed steps, the launch counts read around
   exactly those five; losses finite, ``attn_seg_loss`` > 0; step time and
   pairs/s from the host clock and the time spent waiting on the loader,
   beside five steps of the same model on the last loader batch kept on
   the card and phase 6's resident-batch step.  Then
   one B=8 loader batch (dropout 0; one builder, so the batch does not
   depend on thread timing) through ``loss_and_grads`` on the card and on
   the CPU, held as in phase 7, ``attn_seg_loss`` too, except that the
   tensors outside the ResNet are held in relative L2 (STEP_TEXT_L2_TOL).
9. fused tail — the archived fused bottleneck tail
   (``gloria_tpu_torch.experiments.fused_bn``, which no model path calls):
   hooks on the 16 Bottleneck ``conv2``s of one train-mode forward of the
   ResNet-50 tower (seed 0, the synthetic batch of 48, 299 px) capture each
   block's y2, its bn2 folded over the batch statistics and conv3's kernel;
   ``bottleneck_tail`` + ``autograd.backward`` run K3 and K4 on all 16 with
   cotangents from a seed, the launch counts read around exactly that run.
   Every output is held against the plain version (``fused_bn.tail_errors``
   / ``grad_errors``), on those tails and on probes (M = 1, M = 601, K and N
   narrower than a tile, K = 64 with N = 512 (K4's two passes; the tails at
   K = 64 take its fused pass), a channel whose z are all 0, gs1 = gs2 = 0,
   gy3 = 0).  Per shape, for K3 and for K4: kernel, plain version and
   cuBLAS's products alone, from CUDA events, beside the bound, also with
   the L2 flushed before each call; the device time per kernel
   (torch.profiler); the wrapper's host time a call; the rates against the
   bound's bytes and operations; K3's y3, s1 and s2 bit for bit over two
   calls (it has no atomics); totals over the 16 tails.
10. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import base64
import copy
import io
import json
import statistics
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import wait

import numpy as np

# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
H100_F32_FLOPS = 67e12
H100_BF16_FLOPS = 989e12  # tensor cores
H100_TF32_FLOPS = 495e12  # tensor cores; K2's 3xTF32 products take three per f32 product
H100_HBM_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-3   # f32 both sides, summation order differs; sims are log-values of O(1-20)
SLICE_TOL = 1e-3    # card (CUDA kernel, cuDNN convolutions) vs CPU (plain version, oneDNN)
BATCH_TOL = 1e-3    # one image scored alone vs inside a batch of 64
# K2 vs plain, per output, x its max|grad| (+1e-6): f32 both sides; the
# summation order differs and the kernel's products are 3xTF32 (about 2^-21
# relative per product)
GRAD_TOL = 1e-3
# card vs CPU train step (8 pairs, dropout 0): cuDNN and oneDNN sum the
# convolutions in different orders, and train-mode BatchNorm amplifies that
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_NORM_RTOL = 1e-3
STEP_GRAD_TOL = 1e-3  # per gradient tensor outside the ResNet, x its max|g| (+1e-6)
# The ResNet's gradient in train mode is not smooth at f32 noise scale: ReLUs
# near 0 flip when the forward moves by ~1e-6.  On the CPU in f64
# (ResNet-18, 64 px; tests/test_torch_port_train.py, the "not smooth" test)
# a 1e-6 relative move of the input moves single gradient entries by over
# 10% of max|g|, whole tensors by 1.1% in relative L2.  Card vs CPU (H100,
# 700 W) the worst entry was 12.5% of its tensor's max|g| and the worst
# relative L2 9.2e-3 (layer4.1.bn2.bias), so the backbone is held per tensor
# in relative L2, at about 3x that.
STEP_BACKBONE_L2_TOL = 3e-2
# Phase 8's loader batches, outside the ResNet: the loss's gradient with
# respect to the word features magnifies the <=5e-6 relative card/CPU
# difference of the features about 1000x (BERT alone, given the same
# upstream gradient, agrees to 0.006 of STEP_GRAD_TOL).  Over 13 B=8
# batches (grad_spread.py; H100, 700 W) card against CPU reached 1.8e-3 in
# one tensor's relative L2 and 3.0x STEP_GRAD_TOL x max|g| in one entry;
# the CPU against itself, its image input moved by 1e-6 relative, 1.1e-3
# and 1.9x.  So each tensor is held in relative L2, with the same 1e-6
# floor (x sqrt(n)), at about 3x the card's worst.
STEP_TEXT_L2_TOL = 5e-3
BACKBONE = "img_encoder.model."
TRAIN_BATCH = 48
TRAIN_STEPS = 5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, reps: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` calls, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def cold_ms(fn, reps: int = 5) -> float:
    """Median over ``reps`` of the time of one call of fn alone, from CUDA
    events, with the 50 MB L2 flushed before each: a 256 MB buffer is
    written between the calls, so fn finds its inputs in device memory, as
    inside a backward it would."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for i in range(reps):
        flush.fill_(i & 0xFF)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def device_ms(fn, names: tuple[str, ...], calls: int = 3) -> dict[str, float | None]:
    """Device time per call of fn spent in the kernels whose names contain
    each of ``names``, from torch.profiler's CUDA activity over ``calls``
    calls after a warm-up; None for a name with no device time recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(names, 0.0)
    for event in prof.key_averages():
        us = getattr(event, "device_time_total", None) or getattr(event, "cuda_time_total", 0.0)
        for name in names:
            if name in event.key:
                totals[name] += us / 1e3 / calls
    return {name: (ms or None) for name, ms in totals.items()}


def _ops_bound(ops: float, nbytes: float, peak: float = H100_F32_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = ops / peak, nbytes / H100_HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def local_sim_ops(words, regions, mask) -> tuple[int, int]:
    """(operations, bytes) of the forward at these inputs: the products of
    the cheaper of two routes, counted over the valid words of every
    (image, text) pair; every input read once and the output written once.
    Direct route: raw and the weighted context V, 4·S·D per valid word of
    each pair.  Gram route (the TPU kernel's, and K1's): raw and G·a2 for
    ‖V‖², 2·S·D + 2·S² per valid word of each pair, plus the Gram 2·S²·D
    per image.  Softmax and exp work (under 2% of the operations) is left
    out."""
    T, W, D = words.shape
    B, S, _ = regions.shape
    word_pairs = B * int((mask > 0).sum())  # every image pairs with every text
    ops = min(4 * S * D * word_pairs, (2 * S * D + 2 * S * S) * word_pairs + 2 * S * S * D * B)
    return ops, 4 * (words.numel() + regions.numel() + mask.numel() + B * T)


def local_sim_bound(words, regions, mask) -> tuple[float, str]:
    """Least time for these inputs at the f32 CUDA-core peak."""
    return _ops_bound(*local_sim_ops(words, regions, mask))


def local_sim_bound_3xtf32(words, regions, mask) -> tuple[float, str]:
    """Least time for the same products as K1 does them: each f32 product
    as three TF32 products at the TF32 tensor-core peak, 495/3 = 165
    TFLOP/s of f32-accurate products."""
    ops, nbytes = local_sim_ops(words, regions, mask)
    return _ops_bound(3 * ops, nbytes, H100_TF32_FLOPS)


def local_sim_bwd_ops(words, regions, mask, g) -> tuple[int, int]:
    """(operations, bytes) of the backward at these inputs: the products of
    the cheaper of two routes, counted over the valid words of every (image,
    text) pair; the inputs read once and both gradients written once.
    Direct route (per pair): raw, V, ctx·Vᵀ, the two dregions terms and
    dwords, 12·S·D per valid word of each pair.  Gram route (the TPU
    kernel's, and K2's): raw, G·a2, dG = Σ dcn2·a2a2ᵀ, dregions
    and dwords, 6·S·D + 4·S² per valid word of each pair, plus the Gram and
    (dG + dGᵀ)·ctx, 4·S²·D per image."""
    T, W, D = words.shape
    B, S, _ = regions.shape
    word_pairs = B * int((mask > 0).sum())
    ops = min(12 * S * D * word_pairs, (6 * S * D + 4 * S * S) * word_pairs + 4 * S * S * D * B)
    return ops, 4 * (2 * words.numel() + 2 * regions.numel() + mask.numel() + g.numel())


def local_sim_bwd_bound(words, regions, mask, g) -> tuple[float, str]:
    """Least time for these inputs, as :func:`local_sim_bound`, at the f32
    CUDA-core peak."""
    return _ops_bound(*local_sim_bwd_ops(words, regions, mask, g))


def local_sim_bwd_bound_3xtf32(words, regions, mask, g) -> tuple[float, str]:
    """Least time for the same products as K2 does them: each f32 product
    as three TF32 products (hi·hi, hi·lo, lo·hi) at the TF32 tensor-core
    peak, 495/3 = 165 TFLOP/s of f32-accurate products."""
    ops, nbytes = local_sim_bwd_ops(words, regions, mask, g)
    return _ops_bound(3 * ops, nbytes, H100_TF32_FLOPS)


# K1's passes in launch order, by kernel name (csrc/local_sim_fwd.cu)
K1_PASSES = ("k1w_word_norms", "k1p_gram", "k1p_raw", "k1w_row_softmax", "k1w_col_softmax",
             "k1p_ga2", "k1w_pair_out")
# K2's passes in launch order, by kernel name (csrc/local_sim_bwd.cu)
K2_PASSES = ("k2w_word_norms", "k2p_gram", "k2p_raw", "k2w_row_softmax", "k2w_col_softmax",
             "k2p_ga2", "k2w_pair_stats", "k2w_row_draw", "k2p_dgram", "k2p_dreg_words",
             "k2p_dreg_gram", "k2p_dwords", "k2w_scatter")


def k1_numbers(words, regions, mask, kw: dict, where: str, card: str, iters: int,
               plain_iters: int) -> dict:
    """K1 at one path's inputs: error against the plain version, two calls
    bitwise equal, time (CUDA events), the plain version's time, both
    bounds, device time per pass (torch.profiler), the wrapper's time (the
    CUDA-event time less the passes), the workspace and the extra memory of
    one call (workspace, packing, output)."""
    import torch

    from gloria_tpu_torch.ops import local_sim

    def call():
        return local_sim.local_similarities(words, regions, mask, **kw)

    got, again = call(), call()
    torch.cuda.synchronize()
    ref = local_sim.local_similarities_plain(words, regions, mask, **kw)
    out = {"err": float((got - ref).abs().max())}
    check(out["err"] <= KERNEL_TOL, f"local_sim_fwd vs plain at the {where} inputs: {out['err']}")
    check(torch.equal(got, again), f"local_sim_fwd gives the same bits twice at the {where} inputs")
    del got, again, ref
    out["ms"] = cuda_ms(call, iters)
    out["plain_ms"] = cuda_ms(
        lambda: local_sim.local_similarities_plain(words, regions, mask, **kw), plain_iters)
    out["bound_ms"], out["bound_by"] = local_sim_bound_3xtf32(words, regions, mask)
    out["bound_f32_ms"], _ = local_sim_bound(words, regions, mask)
    out["passes"] = device_ms(call, K1_PASSES)
    passes_ms = sum(v or 0.0 for v in out["passes"].values())
    products = sum(v or 0.0 for k, v in out["passes"].items() if k.startswith("k1p_"))
    out["wrapper_ms"] = out["ms"] - passes_ms
    (T, _, _), (B, S, _), N = words.shape, regions.shape, int((mask > 0).sum())
    out["workspace_bytes"] = 4 * local_sim._library().local_sim_fwd_workspace_floats(B, T, S, N)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    out["extra_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    log(f"[kernels] local_sim_fwd at the {where} inputs: B={B} T={T} W={words.shape[1]} S={S} "
        f"D={words.shape[2]}, {N} valid words; max_abs_err={out['err']:.3e}, bitwise equal over "
        f"two calls; kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms (not a "
        f"yardstick), bound {out['bound_ms']:.4f} ms at the 3xTF32 rate ({out['bound_by']}), "
        f"{out['bound_f32_ms']:.4f} ms at the f32 CUDA-core rate; workspace "
        f"{out['workspace_bytes'] / 1e9:.3f} GB, one call's extra memory {out['extra_gb']:.3f} GB; "
        f"no single PyTorch call computes this function [{card}]")
    log(f"[kernels] local_sim_fwd per pass at the {where} inputs (torch.profiler device time, "
        f"ms): " + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not recorded"
                             for k, v in out["passes"].items())
        + f"; products {products:.4f}, elementwise {passes_ms - products:.4f}, all passes "
        f"{passes_ms:.4f}, wrapper (packing, the read of N, launch gaps) {out['wrapper_ms']:.4f} "
        f"[{card}]")
    return out


def grad_err(got, ref) -> tuple[float, float]:
    """(max abs error, its tolerance GRAD_TOL * max|ref| + 1e-6)."""
    return float((got - ref).abs().max()), GRAD_TOL * float(ref.abs().max()) + 1e-6


def smoke_config():
    """configs/chexpert_pretrain_config.yaml's model at full width."""
    from gloria_tpu_torch.configs import Config

    return Config({
        "model": {
            "gloria": {"temp1": 4.0, "temp2": 5.0, "temp3": 10.0},
            "vision": {"model_name": "resnet_50"},
            "text": {"last_n_layers": 4, "aggregate_method": "sum", "norm": False,
                     "embedding_dim": 768, "agg_tokens": True,
                     "bert_config": {"vocab_size": 28996, "hidden_size": 768, "num_layers": 12,
                                     "num_heads": 12, "intermediate_size": 3072}},
        },
        "data": {"text": {"word_num": 97}, "image": {"imsize": 256}},
        "transforms": {"norm": "half", "random_crop": {"crop_size": 224}},
    })


def phase_kernel_probes() -> float:
    """Phase 3; returns the largest error against the plain version."""
    import torch

    from gloria_tpu_torch.ops import gloria_loss, local_sim

    rng = np.random.RandomState(0)
    worst = 0.0
    probes = [  # name, agg, convention, B, T, W, S, D
        ("serving, sink", "max", "eval", 64, 25, 97, 362, 768),
        ("serving, no sink", "max", "eval", 64, 25, 97, 361, 768),
        ("train mask", "sum", "train", 64, 25, 97, 362, 768),
        ("mean", "mean", "train", 8, 12, 97, 361, 768),
        ("B, T > 128", "max", "eval", 130, 136, 97, 362, 768),
    ]
    for name, agg, convention, B, T, W, S, D in probes:
        caps = rng.randint(2, W - 2, size=T)
        caps[:3] = [0, 1, W - 2]
        words = torch.from_numpy(rng.randn(T, W, D).astype(np.float32)).cuda()
        regions = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).cuda()
        mask = gloria_loss.make_word_mask(torch.from_numpy(caps).cuda(), W, convention)
        got = local_sim.local_similarities(words, regions, mask, agg=agg)
        torch.cuda.synchronize()
        ref = local_sim.local_similarities_plain(words, regions, mask, agg=agg)
        check(bool(torch.isfinite(got).all()), f"kernel output finite ({name})")
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        log(f"[kernel] local_sim_fwd {name}: B={B} T={T} W={W} S={S} D={D} agg={agg} "
            f"max_abs_err={err:.3e} (tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL, f"local_sim_fwd vs plain ({name}): {err} > {KERNEL_TOL}")
        del words, regions, mask, got, ref
        torch.cuda.empty_cache()
    words = torch.from_numpy(rng.randn(6, 97, 768).astype(np.float32)).cuda()
    regions = torch.from_numpy(rng.randn(4, 362, 768).astype(np.float32)).cuda()
    mask = torch.zeros(6, 97, dtype=torch.bool, device="cuda")
    before = local_sim.launches
    got = local_sim.local_similarities(words, regions, mask, agg="max")
    torch.cuda.synchronize()
    check(local_sim.launches == before + 1, "all captions empty: one local_sim_fwd launch")
    err = float((got - float(np.log(np.float32(1e-8)))).abs().max())
    worst = max(worst, err)
    log(f"[kernel] local_sim_fwd all captions empty: B=4 T=6 W=97 S=362 D=768, every entry "
        f"log(1e-8) within {err:.3e} (tol {KERNEL_TOL})")
    check(err <= KERNEL_TOL, "all captions empty: every similarity log(1e-8)")
    return worst


def pretrain_config(dropout: float):
    """configs/chexpert_pretrain_config.yaml at full width: the model, BERT's
    dropout, the optimizer and the clip."""
    cfg = smoke_config()
    cfg.model.text.bert_config.dropout_rate = dropout
    cfg.train = {"batch_size": TRAIN_BATCH, "optimizer": {"name": "Adam", "weight_decay": 1e-6}}
    cfg.lightning = {"trainer": {"lr": 5e-5, "gradient_clip_val": 0.25}}
    return cfg


def phase_bwd_probes() -> tuple[float, float]:
    """Phase 3, K2; returns the largest error against the plain version and
    the largest error / tolerance ratio."""
    import torch

    from gloria_tpu_torch.ops import gloria_loss, local_sim

    rng = np.random.RandomState(1)
    worst = worst_ratio = 0.0
    probes = [  # name, agg, B, T, W, S, D
        ("pretrain shape", "sum", 48, 48, 97, 361, 768),
        ("pretrain shape, sink", "sum", 48, 48, 97, 362, 768),
        ("mean", "mean", 48, 48, 97, 361, 768),
        ("max, sink", "max", 48, 48, 97, 362, 768),
        ("B, T > 128", "sum", 130, 136, 97, 362, 64),
        ("all captions empty", "sum", 48, 48, 97, 361, 768),
    ]
    for name, agg, B, T, W, S, D in probes:
        caps = rng.randint(23, 64, size=T)  # the synthetic batch's cap_len range
        caps[:3] = [0, 1, W - 1]
        if name == "all captions empty":
            caps[:] = 0
        words = torch.from_numpy(rng.randn(T, W, D).astype(np.float32)).cuda()
        regions = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).cuda()
        g = torch.from_numpy(rng.randn(B, T).astype(np.float32)).cuda()
        mask = gloria_loss.make_word_mask(torch.from_numpy(caps).cuda(), W, "train")
        dw, dr = local_sim.local_similarities_bwd(words, regions, mask, g, agg=agg)
        torch.cuda.synchronize()
        pw, pr = local_sim.local_similarities_bwd_plain(words, regions, mask, g, agg=agg)
        check(bool(torch.isfinite(dw).all() and torch.isfinite(dr).all()),
              f"local_sim_bwd output finite ({name})")
        (ew, tw), (er, tr) = grad_err(dw, pw), grad_err(dr, pr)
        worst = max(worst, ew, er)
        worst_ratio = max(worst_ratio, ew / tw, er / tr)
        log(f"[kernel] local_sim_bwd {name}: B={B} T={T} W={W} S={S} D={D} agg={agg} "
            f"dwords max_abs_err={ew:.3e} (tol {tw:.3e}), dregions max_abs_err={er:.3e} "
            f"(tol {tr:.3e})")
        check(ew <= tw and er <= tr, f"local_sim_bwd vs plain ({name})")
        if name == "all captions empty":
            check(not bool(dw.any() or dr.any()), "no valid word: both gradients exactly 0")
        del words, regions, g, mask, dw, dr, pw, pr
        torch.cuda.empty_cache()
    return worst, worst_ratio


def phase_train(card: str) -> dict:
    """Phase 6: the pretrain step at full width; returns its numbers."""
    import torch

    from gloria_tpu_torch.data.synthetic import make_synthetic_batch
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.models.norm import BatchNorm2d
    from gloria_tpu_torch.ops import gloria_loss, local_sim
    from gloria_tpu_torch.training import optim, train

    cfg = pretrain_config(dropout=0.1)
    t0 = time.perf_counter()
    model = init_gloria(cfg, seed=0)
    model.img_encoder.to(memory_format=torch.channels_last)
    opt = optim.make_optimizer(cfg, grad_clip=cfg.lightning.trainer.gradient_clip_val)
    state = train.create_train_state(model, opt, seed=0, device="cuda")
    train_step, _ = train.make_pretrain_steps(model, opt)
    raw = make_synthetic_batch(batch_size=TRAIN_BATCH, num_tokens=97, imsize=224,
                               vocab_size=28996, seed=0)
    batch = train.to_device(raw, torch.device("cuda"))
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {}
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm2d):
            stats[f"{name}.running_mean"], stats[f"{name}.running_var"] = m.running_mean, m.running_var
    stats0 = {n: b.clone() for n, b in stats.items()}
    state, _ = train_step(state, batch)  # warm-up: cuDNN autotuning, allocator
    torch.cuda.synchronize()
    log(f"[train] {cfg.model.vision.model_name} + BERT 12x768 (dropout 0.1), batch "
        f"{TRAIN_BATCH} x 97 tokens, 224 px float images upsampled to 299; Adam, clip 0.25; "
        f"init + warm-up step {time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics = []
    local_sim.launches = local_sim.launches_bwd = 0  # ---- train path starts --------
    start.record()
    for _ in range(TRAIN_STEPS):
        state, m = train_step(state, batch)
        metrics.append(m)
    end.record()
    torch.cuda.synchronize()
    launches = (local_sim.launches, local_sim.launches_bwd)  # ---- train path ends --
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        log(f"[train] step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
        check(all(np.isfinite(v) for v in vals.values()), f"train step {i + 1}: metrics finite")
        check(vals["nonfinite_steps"] == 0, f"train step {i + 1}: no step skipped")
    log(f"[train] launches over the {TRAIN_STEPS} steps: local_sim_fwd {launches[0]}, "
        f"local_sim_bwd {launches[1]}")
    check(launches == (TRAIN_STEPS, TRAIN_STEPS), "one K1 and one K2 launch per train step")
    unmoved = [n for n, p in model.named_parameters()
               if torch.equal(p, params0[n]) and not n.startswith("text_encoder.model.pooler.")]
    check(not unmoved, f"every parameter the loss reaches moved; unmoved: {unmoved[:5]}")
    still = [n for n, b in stats.items() if torch.equal(b, stats0[n])]
    check(not still, f"every BatchNorm running statistic moved; unmoved: {still[:5]}")
    del params0, stats0
    log(f"[train] step {step_ms:.2f} ms, {TRAIN_BATCH / step_ms * 1e3:.1f} pairs/s, peak "
        f"{peak_gb:.2f} GB allocated (CUDA events over {TRAIN_STEPS} steps) [{card}]")

    # one more step, recording the inputs the step gives the two kernels (through
    # the helpers LocalSimilarities calls, which hand the forward's packed
    # words to the backward)
    seen = {}
    fwd, bwd = local_sim._similarities, local_sim._similarities_bwd

    def record_fwd(words, regions, mask, temp1, temp2, agg):
        seen["fwd"] = (words, regions, mask, {"temp1": temp1, "temp2": temp2, "agg": agg})
        return fwd(words, regions, mask, temp1, temp2, agg)

    def record_bwd(words, regions, mask, g, temp1, temp2, agg, packed=None):
        seen["bwd"] = (words, regions, mask, g, {"temp1": temp1, "temp2": temp2, "agg": agg})
        seen["bwd_packed"] = packed is not None
        return bwd(words, regions, mask, g, temp1, temp2, agg, packed=packed)

    local_sim._similarities, local_sim._similarities_bwd = record_fwd, record_bwd
    try:
        state, _ = train_step(state, batch)
    finally:
        local_sim._similarities, local_sim._similarities_bwd = fwd, bwd
    torch.cuda.synchronize()

    check(seen["bwd_packed"], "the backward reads the forward's packed words: one packing a step")
    out = {"step_ms": step_ms, "launches": launches, "peak_gb": peak_gb}
    words, regions, mask, kw = seen["fwd"]
    valid = int(mask.sum())
    out["k1"] = k1_numbers(words, regions, mask, kw, "train step's", card, 5, 2)
    words, regions, mask, g, kw = seen["bwd"]
    dw, dr = local_sim.local_similarities_bwd(words, regions, mask, g, **kw)
    pw, pr = local_sim.local_similarities_bwd_plain(words, regions, mask, g, **kw)
    (ew, tw), (er, tr) = grad_err(dw, pw), grad_err(dr, pr)
    check(ew <= tw and er <= tr, "local_sim_bwd vs plain at the train step's inputs")
    out["k2_err"], out["k2_ratio"] = max(ew, er), max(ew / tw, er / tr)
    del dw, dr, pw, pr
    out["k2_ms"] = cuda_ms(lambda: local_sim.local_similarities_bwd(words, regions, mask, g, **kw),
                           5)
    out["k2_plain_ms"] = cuda_ms(
        lambda: local_sim.local_similarities_bwd_plain(words, regions, mask, g, **kw), 2)
    out["k2_bound_f32_ms"], _ = local_sim_bwd_bound(words, regions, mask, g)
    out["k2_bound_ms"], out["k2_bound_by"] = local_sim_bwd_bound_3xtf32(words, regions, mask, g)
    first = local_sim.local_similarities_bwd(words, regions, mask, g, **kw)
    again = local_sim.local_similarities_bwd(words, regions, mask, g, **kw)
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          "local_sim_bwd gives the same bits twice")
    del first, again
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    local_sim.local_similarities_bwd(words, regions, mask, g, **kw)
    torch.cuda.synchronize()
    out["k2_extra_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    passes = device_ms(lambda: local_sim.local_similarities_bwd(words, regions, mask, g, **kw),
                       K2_PASSES)
    out["k2_passes"] = passes
    log(f"[kernels] local_sim_bwd at the train step's inputs: {valid} valid words x "
        f"{regions.shape[0]} images; dwords max_abs_err={ew:.3e} (tol {tw:.3e}), dregions "
        f"max_abs_err={er:.3e} (tol {tr:.3e}), bitwise equal over two calls; kernel "
        f"{out['k2_ms']:.4f} ms, plain {out['k2_plain_ms']:.4f} ms, bound "
        f"{out['k2_bound_ms']:.4f} ms at the 3xTF32 rate ({out['k2_bound_by']}), "
        f"{out['k2_bound_f32_ms']:.4f} ms at the f32 CUDA-core rate; outputs, workspace and "
        f"packing {out['k2_extra_gb']:.3f} GB [{card}]")
    products = sum(v or 0.0 for k, v in passes.items() if k.startswith("k2p_"))
    passes_ms = sum(v or 0.0 for v in passes.values())
    log("[kernels] local_sim_bwd per pass (torch.profiler device time, ms): " + ", ".join(
        f"{k} {v:.4f}" if v is not None else f"{k} not recorded" for k, v in passes.items())
        + f"; products {products:.4f}, elementwise {passes_ms - products:.4f}, all passes "
        f"{passes_ms:.4f} [{card}]")
    del seen

    # where a step's time goes: each part timed on its own, CUDA events
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.train()
    imgs, caps = batch["imgs"], batch["cap_lens"]
    parts = {
        "image tower fwd": lambda: model.image_encoder_forward(imgs),
        "text tower fwd": lambda: model.text_encoder_forward(
            batch["caption_ids"], batch["attention_mask"], batch["token_type_ids"],
            batch["word_assignment"], gen),
        "forward + calc_loss": lambda: model.calc_loss(*model(batch, gen)[:4], caps),
        "forward + calc_loss + backward": lambda: train.loss_and_grads(model, batch, gen),
    }
    out["parts"] = {name: cuda_ms(fn, 2, reps=3) for name, fn in parts.items()}
    out["parts"]["whole train step"] = step_ms
    log("[train] where a step goes (ms, each part timed alone): " + ", ".join(
        f"{k} {v:.2f}" for k, v in out["parts"].items()) + f"; K1 {out['k1']['ms']:.2f}, "
        f"K2 {out['k2_ms']:.2f} [{card}]")
    del model, state, batch, opt
    torch.cuda.empty_cache()
    return out


def compare_card_cpu(gpu: tuple, cpu: tuple, names: list[str], what: str, seconds: float,
                     keys: tuple[str, ...] = ("loss",), rest_l2_tol: float | None = None) -> None:
    """One step's metrics ``keys`` (relative, STEP_LOSS_RTOL), gradient norm
    and every parameter's gradient, card against CPU: the ResNet's tensors
    in relative L2; each tensor outside it by max|diff| / (STEP_GRAD_TOL
    max|g| + 1e-6), or, where ``rest_l2_tol`` is given, in relative L2 with
    the same 1e-6 floor, ||diff|| / (||g|| + 1e-6 sqrt(n)), against it."""
    from gloria_tpu_torch.training import optim

    (gm, gg), (cm, cg) = gpu, cpu
    errs = {k: abs(float(gm[k]) - float(cm[k])) / abs(float(cm[k])) for k in keys}
    gn, cn = float(optim.global_norm(gg)), float(optim.global_norm(cg))
    norm_err = abs(gn - cn) / cn
    rows = []  # (max|diff| / tolerance, relative L2, max|diff|, max|g|, name, floored rel L2)
    for name, a, b in zip(names, gg, cg):
        d = a.cpu() - b
        diff, scale = float(d.abs().max()), float(b.abs().max())
        rel_l2 = float(d.norm() / b.norm()) if scale else 0.0
        floored = float(d.norm()) / (float(b.norm()) + 1e-6 * b.numel() ** 0.5)
        rows.append((diff / (STEP_GRAD_TOL * scale + 1e-6), rel_l2, diff, scale, name, floored))
    backbone = sorted((r for r in rows if r[4].startswith(BACKBONE)), key=lambda r: -r[1])
    rest = sorted((r for r in rows if not r[4].startswith(BACKBONE)), reverse=True)
    log(f"[{what}] one step ({seconds:.1f} s): " + "; ".join(
        f"{k} {float(gm[k]):.6f} vs {float(cm[k]):.6f} (rel {errs[k]:.2e}, tol {STEP_LOSS_RTOL})"
        for k in keys) + f"; grad_norm {gn:.5f} vs {cn:.5f} (rel {norm_err:.2e}, tol "
        f"{STEP_GRAD_NORM_RTOL})")
    if rest_l2_tol is None:
        log(f"[{what}] {len(rest)} tensors outside the ResNet, worst by max|diff| / "
            f"({STEP_GRAD_TOL} max|g| + 1e-6), tol 1:")
    else:
        log(f"[{what}] {len(rest)} tensors outside the ResNet, worst by ||diff|| / (||g|| + "
            f"1e-6 sqrt(n)), tol {rest_l2_tol}; worst max|diff| / ({STEP_GRAD_TOL} max|g| + "
            f"1e-6) {rest[0][0]:.3f}:")
        rest.sort(key=lambda r: -r[5])
    for ratio, rel_l2, diff, scale, name, floored in rest[:3]:
        log(f"[{what}]   {name}: max|diff| {diff:.3e}, max|g| {scale:.3e}, ratio {ratio:.3f}, "
            f"relative L2 {rel_l2:.2e}, floored {floored:.2e}")
    log(f"[{what}] {len(backbone)} ResNet tensors, worst by relative L2 (tol "
        f"{STEP_BACKBONE_L2_TOL}); worst max|diff| / max|g| "
        f"{max(r[2] / max(r[3], 1e-30) for r in backbone):.2e}:")
    for ratio, rel_l2, diff, scale, name, _ in backbone[:3]:
        log(f"[{what}]   {name}: relative L2 {rel_l2:.2e}, max|diff| {diff:.3e}, max|g| "
            f"{scale:.3e}")
    for k in keys:
        check(errs[k] <= STEP_LOSS_RTOL, f"{what}: card {k} agrees with the CPU's")
    check(norm_err <= STEP_GRAD_NORM_RTOL, f"{what}: card grad_norm agrees with the CPU's")
    if rest_l2_tol is None:
        check(rest[0][0] <= 1.0, f"{what}: every gradient outside the ResNet agrees with the CPU's")
    else:
        check(rest[0][5] <= rest_l2_tol,
              f"{what}: every gradient outside the ResNet agrees with the CPU's in relative L2")
    check(backbone[0][1] <= STEP_BACKBONE_L2_TOL,
          f"{what}: every ResNet gradient agrees with the CPU's")


def phase_card_vs_cpu() -> None:
    """Phase 7: one step's loss, gradient norm and every gradient, card vs CPU."""
    import torch

    from gloria_tpu_torch.data.synthetic import make_synthetic_batch
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.training import train

    cfg = pretrain_config(dropout=0.0)
    cpu_model = init_gloria(cfg, seed=0)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    raw = make_synthetic_batch(batch_size=8, num_tokens=97, imsize=224, vocab_size=28996, seed=1)
    t0 = time.perf_counter()
    gpu = train.loss_and_grads(gpu_model, train.to_device(raw, torch.device("cuda")))
    cpu = train.loss_and_grads(cpu_model, train.to_device(raw, torch.device("cpu")))
    compare_card_cpu(gpu, cpu, [n for n, _ in cpu_model.named_parameters()],
                     "card vs cpu", time.perf_counter() - t0)


def loader_config(batch_size: int, dropout: float):
    """Phase 8's run: the pretrain config with the attention-supervision loss
    (weight 1.0, as configs/imagenome_attn_finetune_config.yaml sets it), fed
    by the synthetic data module at 256 px, 8 batches an epoch, with the
    config's 18 workers."""
    cfg = pretrain_config(dropout)
    cfg.model.gloria.segmentation_loss_weight = 1.0
    cfg.data.dataset = "synthetic"
    cfg.data.synthetic_size = 8 * batch_size
    cfg.train.batch_size = batch_size
    cfg.train.num_workers = 18
    return cfg


def native_ingest_numbers(card: str) -> dict:
    """The native library's build time on this host, and its ms per batch
    for 48 uint8 images of 390 × 320 (CheXpert's downsampled size) to the
    [48, 224, 224, 3] f32 crop and to the [48, 224, 224, 1] u8 crop."""
    import os

    from gloria_tpu_torch.data import native

    t0 = time.perf_counter()
    built = native.load()
    out = {"build_s": built.seconds, "load_s": time.perf_counter() - t0}
    rng = np.random.RandomState(2)
    imgs = [(rng.rand(390, 320) * 255).astype(np.uint8) for _ in range(TRAIN_BATCH)]
    tops, lefts = rng.randint(0, 33, TRAIN_BATCH), rng.randint(0, 33, TRAIN_BATCH)
    flips = rng.randint(0, 2, TRAIN_BATCH)
    calls = {
        "f32": lambda: native.letterbox_crop_normalize_batch(imgs, 256, 224, tops, lefts, flips),
        "u8": lambda: native.letterbox_crop_u8_batch(imgs, 256, 224, tops, lefts, flips),
    }
    for name, fn in calls.items():
        y = fn()
        check(y.shape == (TRAIN_BATCH, 224, 224, 3 if name == "f32" else 1),
              f"native ingest {name}: output shape")
        times = []
        for _ in range(7):
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
        out[f"{name}_ms"] = statistics.median(times) * 1e3
    log(f"[loader] native ingest on this host ({os.cpu_count()} CPUs, {os.cpu_count()} threads "
        f"a call): g++ build {out['build_s']:.2f} s (load {out['load_s']:.2f} s); "
        f"{TRAIN_BATCH} uint8 images of 390x320 -> [{TRAIN_BATCH}, 224, 224, 3] f32 "
        f"{out['f32_ms']:.2f} ms a batch, -> [{TRAIN_BATCH}, 224, 224, 1] u8 {out['u8_ms']:.2f} ms "
        f"a batch (host clock, median of 7) [{card}]")
    return out


def phase_loader(card: str, resident_step_ms: float) -> dict:
    """Phase 8: the pretraining data plane feeding the full-width step."""
    import os

    import torch

    from gloria_tpu_torch.data.data_module import build_data_module
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.ops import local_sim
    from gloria_tpu_torch.training import optim, train

    t_phase = time.perf_counter()
    out = {"native": native_ingest_numbers(card)}
    cfg = loader_config(TRAIN_BATCH, dropout=0.1)
    t0 = time.perf_counter()
    module = build_data_module(cfg, device="cuda")
    loader = module.train_dataloader()
    out["builders"] = loader.builders
    batches, t_first = 0, None
    t = time.perf_counter()
    for batch in loader:  # the loader alone: one epoch, each batch moved to the card
        batches += 1
        t_first = t_first or time.perf_counter() - t
    torch.cuda.synchronize()
    out["loader_s"] = time.perf_counter() - t
    out["loader_batches_per_s"] = batches / out["loader_s"]
    out["loader_steady_batches_per_s"] = (batches - 1) / (out["loader_s"] - t_first)
    check(batches == len(loader) == 8, "the loader gives 8 batches an epoch")
    labels = batch["segmentation_labels"]
    check(labels.shape == (TRAIN_BATCH, 224, 224) and labels.is_cuda and bool(labels.any()),
          "segmentation_labels on the card at the crop size")
    check(batch["imgs"].shape == (TRAIN_BATCH, 224, 224, 3) and batch["imgs"].is_cuda,
          "images on the card")
    valid_words = int(batch["cap_lens"].sum() - TRAIN_BATCH)
    log(f"[loader] synthetic module, {TRAIN_BATCH} pairs a batch, 256 px letterbox, 224 crop: "
        f"{batches} batches in {out['loader_s']:.3f} s, {out['loader_batches_per_s']:.2f} "
        f"batches/s ({out['loader_batches_per_s'] * TRAIN_BATCH:.1f} pairs/s), first batch after "
        f"{t_first:.3f} s, {out['loader_steady_batches_per_s']:.2f} batches/s after it; "
        f"{loader.builders} builder threads, os.cpu_count() {os.cpu_count()}; "
        f"last batch {valid_words} valid words [{card}]")

    model = init_gloria(cfg, seed=0)
    model.img_encoder.to(memory_format=torch.channels_last)
    opt = optim.make_optimizer(cfg, grad_clip=cfg.lightning.trainer.gradient_clip_val)
    state = train.create_train_state(model, opt, seed=0, device="cuda")
    train_step, _ = train.make_pretrain_steps(model, opt)
    it = iter(loader)
    state, _ = train_step(state, next(it))  # warm-up
    torch.cuda.synchronize()
    log(f"[loader] model, module and warm-up step {time.perf_counter() - t0:.1f} s")
    metrics, wait = [], 0.0
    local_sim.launches = local_sim.launches_bwd = 0  # ---- loader-fed path starts ----
    t = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        t_next = time.perf_counter()
        batch = next(it)
        wait += time.perf_counter() - t_next
        state, m = train_step(state, batch)
        metrics.append(m)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t) / TRAIN_STEPS * 1e3
    out["launches"] = (local_sim.launches, local_sim.launches_bwd)  # -- path ends ----
    out["wait_ms"] = wait / TRAIN_STEPS * 1e3
    del it
    # the same model and config on the last loader batch, kept on the card
    t = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, _ = train_step(state, batch)
    torch.cuda.synchronize()
    out["resident_step_ms"] = (time.perf_counter() - t) / TRAIN_STEPS * 1e3
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        log(f"[loader] step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
        check(all(np.isfinite(v) for v in vals.values()), f"loader-fed step {i + 1}: finite")
        check(vals["attn_seg_loss"] > 0, f"loader-fed step {i + 1}: attn_seg_loss > 0")
        check(vals["nonfinite_steps"] == 0, f"loader-fed step {i + 1}: no step skipped")
    log(f"[loader] launches over the {TRAIN_STEPS} loader-fed steps: local_sim_fwd "
        f"{out['launches'][0]}, local_sim_bwd {out['launches'][1]}")
    check(out["launches"] == (TRAIN_STEPS, TRAIN_STEPS),
          "one K1 and one K2 launch per loader-fed step")
    log(f"[loader] loader-fed step {out['step_ms']:.2f} ms, "
        f"{TRAIN_BATCH / out['step_ms'] * 1e3:.1f} pairs/s (host clock over {TRAIN_STEPS} steps, "
        f"synchronized at the end; {out['wait_ms']:.2f} ms a step in next(loader), the card "
        f"copy included); the same steps on the last loader batch kept on the card "
        f"{out['resident_step_ms']:.2f} ms, {TRAIN_BATCH / out['resident_step_ms'] * 1e3:.1f} "
        f"pairs/s (host clock); phase 6's step on a resident batch {resident_step_ms:.2f} ms, "
        f"{TRAIN_BATCH / resident_step_ms * 1e3:.1f} pairs/s (CUDA events; another batch: "
        f"no attention supervision, 2160 valid words) [{card}]")
    del model, state, opt, loader, module, batch, metrics
    torch.cuda.empty_cache()

    # card vs CPU on one B=8 loader batch, dropout 0, attention supervision on
    small = loader_config(8, dropout=0.0)
    small.train.num_workers = 1  # one builder: the batch does not depend on thread timing
    raw = next(iter(build_data_module(small, device="cpu").loader("train", prefetch=1)))
    cpu_model = init_gloria(small, seed=0)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    t = time.perf_counter()
    gpu = train.loss_and_grads(gpu_model, train.to_device(raw, torch.device("cuda")))
    cpu = train.loss_and_grads(cpu_model, raw)
    compare_card_cpu(gpu, cpu, [n for n, _ in cpu_model.named_parameters()],
                     "loader card vs cpu", time.perf_counter() - t, ("loss", "attn_seg_loss"),
                     rest_l2_tol=STEP_TEXT_L2_TOL)
    del gpu_model, cpu_model, gpu, cpu
    torch.cuda.empty_cache()
    log(f"[loader] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def tail_work(M: int, K: int, N: int) -> tuple[tuple[int, int], tuple[int, int]]:
    """(operations, bytes) of K3 and of K4 at one tail shape, each input read
    once and each output written once: K3 2·M·K·N operations; y2, scale,
    shift and w read, y3, s1 and s2 written.  K4 4·M·K·N; y2, scale, shift,
    w, y3, gy3, gs1 and gs2 read, dy2, dscale, dshift and dW written."""
    fwd = (2 * M * K * N, 2 * M * K + 8 * K + 4 * K * N + 2 * M * N + 8 * N)
    bwd = (4 * M * K * N, 2 * M * K + 8 * K + 4 * K * N + 4 * M * N + 8 * N
           + 2 * M * K + 8 * K + 4 * K * N)
    return fwd, bwd


def tail_bounds(M: int, K: int, N: int) -> tuple[tuple[float, str], tuple[float, str]]:
    """Least times of K3 and K4 at one tail shape (:func:`tail_work`), bf16
    operations at the tensor-core peak against the bytes at the HBM rate."""
    fwd, bwd = tail_work(M, K, N)
    return _ops_bound(*fwd, H100_BF16_FLOPS), _ops_bound(*bwd, H100_BF16_FLOPS)


def capture_tails() -> list[tuple]:
    """The 16 bottleneck tails of one train-mode forward of the full-width
    ResNet-50 image tower on the synthetic batch of 48 (224 px upsampled to
    299²): for each block, (name, y2, scale, shift, w) with y2 = conv2's
    output [B·H·W, K] in bf16, scale / shift bn2 folded over that output's
    batch statistics (as ``models/norm.py`` takes them), and w = conv3's
    kernel [K, N].  Hooks on the blocks' conv2 read them; the model code is
    not changed."""
    import torch

    from gloria_tpu_torch.data.synthetic import make_synthetic_batch
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.models.resnet import Bottleneck
    from gloria_tpu_torch.training import train

    model = init_gloria(pretrain_config(dropout=0.1), seed=0).cuda().train()
    model.img_encoder.to(memory_format=torch.channels_last)
    raw = make_synthetic_batch(batch_size=TRAIN_BATCH, num_tokens=97, imsize=224,
                               vocab_size=28996, seed=0)
    imgs = train.to_device(raw, torch.device("cuda"))["imgs"]
    tails, hooks = [], []

    def hook(name, block, _module, _inputs, out):
        xf = out.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
        scale = torch.rsqrt(var + block.bn2.eps) * block.bn2.weight
        shift = block.bn2.bias - mean * scale
        y2 = out.permute(0, 2, 3, 1).reshape(-1, out.shape[1]).to(torch.bfloat16).contiguous()
        w = block.conv3.weight[:, :, 0, 0].t().contiguous()
        tails.append((name, y2, scale.contiguous(), shift.contiguous(), w))

    for name, block in model.img_encoder.model.named_modules():
        if isinstance(block, Bottleneck):
            hooks.append(block.conv2.register_forward_hook(
                lambda m, i, o, name=name, block=block: hook(name, block, m, i, o)))
    try:
        with torch.no_grad():
            model.image_encoder_forward(imgs)
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    del model, imgs
    torch.cuda.empty_cache()
    return tails


# K3's and K4's kernels, by the pass each runs: torch.profiler's device time is read per name
K3_PASSES = {"prep": "fused_bn_prep", "main": "fused_bn_fwd_main", "stats": "fused_bn_fwd_stats"}
K4_PASSES = {"prep": "fused_bn_prep", "dz": "fused_bn_bwd_dz", "dW": "fused_bn_bwd_dw",
             "fused": "fused_bn_bwd_fused"}


def bitwise_repeat(fn) -> tuple[bool, ...]:
    """Whether two calls of fn give the same bits, output by output."""
    import torch

    first, second = fn(), fn()
    torch.cuda.synchronize()
    return tuple(bool(torch.equal(a, b)) for a, b in zip(first, second))


def phase_fused_tail(card: str) -> dict:
    """Phase 9: K3 and K4 on the 16 bottleneck tails of one ResNet-50 train
    step, held against the plain version, probed at edge shapes, and timed
    per shape against the plain version, cuBLAS's products alone and the
    bound."""
    import torch

    from gloria_tpu_torch.experiments import fused_bn

    t0 = time.perf_counter()
    tails = capture_tails()
    check(len(tails) == 16, f"16 bottleneck tails captured, got {len(tails)}")
    rng = np.random.RandomState(4)
    gen = torch.Generator(device="cuda")
    cots = []
    for _, y2, _, _, w in tails:
        M, N = y2.shape[0], w.shape[1]
        gen.manual_seed(int(rng.randint(2 ** 31)))  # gy3 drawn on the card, in bulk
        gy3 = torch.randn(M, N, generator=gen, device="cuda").to(torch.bfloat16)
        gs1 = torch.from_numpy(rng.randn(N).astype(np.float32)).cuda()
        gs2 = torch.from_numpy((rng.randn(N) * 0.1).astype(np.float32)).cuda()
        cots.append((gy3, gs1, gs2))
    leaves = [[t.clone().requires_grad_() for t in tail[1:]] for tail in tails]
    torch.cuda.synchronize()
    layers = {}  # layer -> (M, K, N, count of its tails)
    for name, y2, _, _, w in tails:
        layer = name.split(".")[0]
        M, K, N, n = layers.get(layer, (*y2.shape, w.shape[1], 0))
        layers[layer] = (M, K, N, n + 1)
    log(f"[fused tail] captured {len(tails)} tails from one train-mode ResNet-50 forward at "
        f"B={TRAIN_BATCH}, 299 px: " + ", ".join(
            f"{layer} M={M} K={K} N={N} x{n}" for layer, (M, K, N, n) in layers.items())
        + f" ({time.perf_counter() - t0:.1f} s)")

    outs = []
    fused_bn.launches_fwd = fused_bn.launches_bwd = 0  # ---- fused-tail path starts ----
    for lv, cot in zip(leaves, cots):
        y3, s1, s2 = fused_bn.bottleneck_tail(*lv)
        torch.autograd.backward((y3, s1, s2), cot)
        outs.append((y3.detach(), s1.detach(), s2.detach()))
    torch.cuda.synchronize()
    launches = (fused_bn.launches_fwd, fused_bn.launches_bwd)  # ---- path ends ----
    log(f"[fused tail] launches over the 16 tails: fused_bn_fwd {launches[0]}, "
        f"fused_bn_bwd {launches[1]}")
    check(launches == (16, 16), "one K3 and one K4 launch per tail")

    worst = {"fwd": [0.0, 0.0], "bwd": [0.0, 0.0]}

    def hold(kind, what, errors):
        bad = {k: v for k, v in errors.items() if not v[1] <= 1.0}
        for k, (err, ratio) in errors.items():
            if k != "y3 differing":
                worst[kind][0] = max(worst[kind][0], err)
            worst[kind][1] = max(worst[kind][1], ratio)
        check(not bad, f"{what}: {bad}")
        name, (_, ratio) = max(errors.items(), key=lambda kv: kv[1][1])
        return f"{ratio:.3f} ({name})"

    for (name, y2, scale, shift, w), lv, out, cot in zip(tails, leaves, outs, cots):
        args = (y2, scale, shift, w)
        rf = hold("fwd", f"K3 vs plain on {name}",
                  fused_bn.tail_errors(out, fused_bn.bottleneck_tail_plain(*args)))
        ref = fused_bn.bottleneck_tail_bwd_plain(*args, out[0], *cot)
        rb = hold("bwd", f"K4 vs plain on {name}",
                  fused_bn.grad_errors([t.grad for t in lv], ref))
        log(f"[fused tail] {name}: M={y2.shape[0]} K={y2.shape[1]} N={w.shape[1]}; worst "
            f"error / tolerance K3 {rf}, K4 {rb}")
        del ref
    del leaves, outs

    # probes: edge shapes from a numpy seed, and edge values on captured tails
    prng = np.random.RandomState(5)

    def dev(a, dtype=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda().to(dtype)

    def probe(name, args, cot):
        got = fused_bn.bottleneck_tail_fwd(*args)
        torch.cuda.synchronize()
        rf = hold("fwd", f"K3 probe {name}",
                  fused_bn.tail_errors(got, fused_bn.bottleneck_tail_plain(*args)))
        grads = fused_bn.bottleneck_tail_bwd(*args, got[0], *cot)
        torch.cuda.synchronize()
        ref = fused_bn.bottleneck_tail_bwd_plain(*args, got[0], *cot)
        rb = hold("bwd", f"K4 probe {name}", fused_bn.grad_errors(grads, ref))
        M, K = args[0].shape
        log(f"[fused tail] probe {name}: M={M} K={K} N={args[3].shape[1]}; worst error / "
            f"tolerance K3 {rf}, K4 {rb}")
        return got, grads

    for name, M, K, N in (("M = 1", 1, 64, 256), ("M = 601", 601, 128, 512),
                          ("K = 16, N = 32", 300, 16, 32), ("K = 24, N = 40", 601, 24, 40),
                          ("K = 64, N = 512", 4801, 64, 512)):
        args = (dev(prng.randn(M, K), torch.bfloat16), dev(prng.rand(K) + 0.5),
                dev(prng.randn(K) * 0.2), dev(prng.randn(K, N) * 0.1))
        probe(name, args, (dev(prng.randn(M, N), torch.bfloat16), dev(prng.randn(N)),
                           dev(prng.randn(N) * 0.1)))
    i = next(i for i, tail in enumerate(tails) if tail[0] == "layer2.0")
    _, y2, scale, shift, w = tails[i]
    gy3, gs1, gs2 = cots[i]
    y2z, scz, shz = y2.clone(), scale.clone(), shift.clone()
    y2z[:, 0] = y2z[:, 0].abs()
    scz[0], shz[0] = -scz[0].abs() - 0.5, -shz[0].abs() - 0.1  # every z of channel 0 is 0
    _, (dy2, dsc, dsh, _) = probe("channel 0 all zero (layer2.0)", (y2z, scz, shz, w),
                                  (gy3, gs1, gs2))
    check(bool((dy2[:, 0] == 0).all()) and float(dsc[0]) == 0.0 and float(dsh[0]) == 0.0,
          "a channel with every z zero gets zero gradients")
    probe("gs1 = gs2 = 0 (layer2.0)", (y2, scale, shift, w),
          (gy3, torch.zeros_like(gs1), torch.zeros_like(gs2)))
    probe("gy3 = 0 (layer2.0)", (y2, scale, shift, w), (torch.zeros_like(gy3), gs1, gs2))
    del y2z, scz, shz

    # time per shape: the first tail of each shape stands for its repeats
    shapes = []
    for i, (name, y2, scale, shift, w) in enumerate(tails):
        if not name.endswith(".0"):
            continue
        M, K = y2.shape
        N = w.shape[1]
        args = (y2, scale, shift, w)
        gy3, gs1, gs2 = cots[i]
        y3 = fused_bn.bottleneck_tail_fwd(*args)[0]
        z_bf = torch.relu(y2.float() * scale + shift).to(torch.bfloat16)
        w_bf = w.to(torch.bfloat16)
        g_bf = (gy3.float() + gs1 + 2.0 * y3.float() * gs2).to(torch.bfloat16)
        (fb, fby), (bb, bby) = tail_bounds(M, K, N)
        calls = {  # key -> (kernel, plain version, cuBLAS's products alone)
            "fwd": (lambda: fused_bn.bottleneck_tail_fwd(*args),
                    lambda: fused_bn.bottleneck_tail_plain(*args),
                    lambda: torch.matmul(z_bf, w_bf)),
            "bwd": (lambda: fused_bn.bottleneck_tail_bwd(*args, y3, gy3, gs1, gs2),
                    lambda: fused_bn.bottleneck_tail_bwd_plain(*args, y3, gy3, gs1, gs2),
                    lambda: (torch.matmul(g_bf, w_bf.t()), torch.matmul(z_bf.t(), g_bf))),
        }
        row = {"layer": name.split(".")[0], "M": M, "K": K, "N": N,
               "tails": layers[name.split(".")[0]][3],
               "fwd_bound_ms": fb, "fwd_bound_by": fby, "bwd_bound_ms": bb, "bwd_bound_by": bby}
        for key, (kernel, plain, library) in calls.items():
            row[f"{key}_ms"] = cuda_ms(kernel, 10)
            row[f"{key}_plain_ms"] = cuda_ms(plain, 10)
            row[f"{key}_library_ms"] = cuda_ms(library, 10)
            # the same three calls with the L2 flushed before each, as a step finds them
            row[f"{key}_ms_cold"] = cold_ms(kernel)
            row[f"{key}_plain_ms_cold"] = cold_ms(plain)
            row[f"{key}_library_ms_cold"] = cold_ms(library)
            # the wrapper's host time a call, back to back (checks, plan, outputs, launches)
            torch.cuda.synchronize()
            t_host = time.perf_counter()
            for _ in range(20):
                kernel()
            row[f"{key}_host_ms"] = (time.perf_counter() - t_host) / 20 * 1e3
            torch.cuda.synchronize()
            names = K3_PASSES if key == "fwd" else K4_PASSES
            passes = device_ms(kernel, tuple(names.values()))
            row[f"{key}_passes_ms"] = {p: passes[k] for p, k in names.items()}
        # K3 twice on the same inputs: y3, s1 and s2 bit for bit
        row["fwd_bitwise"] = dict(zip(("y3", "s1", "s2"), bitwise_repeat(calls["fwd"][0])))
        shapes.append(row)
        log(f"[fused tail] {row['layer']} M={M} K={K} N={N} (x{row['tails']}), ms per tail: "
            f"K3 {row['fwd_ms']:.4f}, plain {row['fwd_plain_ms']:.4f}, cuBLAS product alone "
            f"{row['fwd_library_ms']:.4f}, bound {fb:.4f} ({fby}); K4 {row['bwd_ms']:.4f}, plain "
            f"{row['bwd_plain_ms']:.4f}, cuBLAS products alone {row['bwd_library_ms']:.4f}, "
            f"bound {bb:.4f} ({bby}) [{card}]")
        for key, what in (("fwd", "K3"), ("bwd", "K4")):
            ops, nbytes = tail_work(M, K, N)[0 if key == "fwd" else 1]
            rates = ", ".join(
                f"{when} {nbytes / row[col] / 1e6:.0f} GB/s, {ops / row[col] / 1e9:.1f} TFLOP/s"
                for when, col in (("warm", f"{key}_ms"), ("cold", f"{key}_ms_cold")))
            log(f"[fused tail] {row['layer']} {what} with the L2 flushed before each call: "
                f"{row[f'{key}_ms_cold']:.4f} ms, plain {row[f'{key}_plain_ms_cold']:.4f}, cuBLAS "
                f"alone {row[f'{key}_library_ms_cold']:.4f}; its wrapper's host time a call "
                f"{row[f'{key}_host_ms']:.4f} ms; {what}'s kernels (torch.profiler device time, "
                f"warm): " + ", ".join(f"{p} {v}" for p, v in row[f"{key}_passes_ms"].items())
                + f"; {what} against its {nbytes / 1e6:.0f} MB and {ops / 1e9:.2f} GFLOP: "
                f"{rates} [{card}]")
        log(f"[fused tail] {row['layer']} K3 bitwise equal over two calls: "
            + ", ".join(f"{k} {v}" for k, v in row["fwd_bitwise"].items()))
        del z_bf, w_bf, g_bf, y3

    out = {"launches": launches, "shapes": shapes, "worst": worst}
    for key, names in (("fwd", K3_PASSES), ("bwd", K4_PASSES)):
        for col in ("ms", "plain_ms", "library_ms", "bound_ms", "ms_cold", "plain_ms_cold",
                    "library_ms_cold", "host_ms"):
            out[f"{key}_{col}"] = sum(r["tails"] * r[f"{key}_{col}"] for r in shapes)
        by_bytes = sum(r["tails"] * r[f"{key}_bound_ms"] for r in shapes
                       if r[f"{key}_bound_by"] == "bytes")
        out[f"{key}_bound_by"] = "bytes" if 2 * by_bytes >= out[f"{key}_bound_ms"] else "operations"
        out[f"{key}_passes_ms"] = {p: sum(r["tails"] * (r[f"{key}_passes_ms"][p] or 0.0)
                                          for r in shapes) for p in names}
    out["fwd_bitwise"] = all(all(r["fwd_bitwise"].values()) for r in shapes)
    log(f"[fused tail] over the 16 tails of one step (ms): K3 {out['fwd_ms']:.4f}, plain "
        f"{out['fwd_plain_ms']:.4f}, cuBLAS product alone {out['fwd_library_ms']:.4f}, bound "
        f"{out['fwd_bound_ms']:.4f}; K4 {out['bwd_ms']:.4f}, plain {out['bwd_plain_ms']:.4f}, "
        f"cuBLAS products alone {out['bwd_library_ms']:.4f}, bound {out['bwd_bound_ms']:.4f}; "
        f"worst error / tolerance K3 {worst['fwd'][1]:.3f}, K4 {worst['bwd'][1]:.3f}; phase "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    for key, what in (("fwd", "K3"), ("bwd", "K4")):
        log(f"[fused tail] {what} over the 16 tails with the L2 flushed before each call (ms): "
            f"{out[f'{key}_ms_cold']:.4f}, plain {out[f'{key}_plain_ms_cold']:.4f}, cuBLAS alone "
            f"{out[f'{key}_library_ms_cold']:.4f}; wrapper host time {out[f'{key}_host_ms']:.4f}; "
            f"{what}'s kernels (warm): "
            + ", ".join(f"{p} {v:.4f}" for p, v in out[f"{key}_passes_ms"].items()) + f" [{card}]")
    log(f"[fused tail] K3 bitwise equal over two calls at every tail shape: {out['fwd_bitwise']}")
    check(out["fwd_bitwise"], "K3's y3, s1 and s2 repeat bit for bit (no atomics)")
    del tails, cots
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from gloria_tpu_torch import api
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.ops import gloria_loss, local_sim
    from gloria_tpu_torch.serving import DynamicBatcher, InferenceEngine, serve_http
    from gloria_tpu_torch.utils import cuda_build
    from gloria_tpu_torch.data.tokenizer import WordPieceTokenizer

    t_start = time.perf_counter()
    # ---- 1. device --------------------------------------------------------
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16 products (the fused tail's plain version) sum in f32, as its kernels do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    log(card)
    log(f"[device] {kind}, {count} device(s), torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False (f32 throughout), "
        f"allow_bf16_reduced_precision_reduction=False")

    # ---- 2. build ---------------------------------------------------------
    built = cuda_build.build(["local_sim_fwd", "local_sim_bwd", "fused_bn_fwd", "fused_bn_bwd"])
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {b.seconds:.1f} s -> {b.path.name}; " + " | ".join(ptxas))

    # ---- 3. kernel probes ---------------------------------------------------
    worst_err = phase_kernel_probes()
    bwd_err, bwd_ratio = phase_bwd_probes()

    # ---- 4. slice: the main path at full width ----------------------------
    cfg = smoke_config()
    classes = api.generate_chexpert_class_prompts()
    tokenizer = WordPieceTokenizer.from_corpus([p for ps in classes.values() for p in ps])
    t0 = time.perf_counter()
    state = init_gloria(cfg, seed=0).state_dict()
    gm = api.GloriaModel(cfg, state, tokenizer=tokenizer, device="cuda")
    engine = InferenceEngine(gm, classes, max_batch=64)
    engine.warmup()
    torch.cuda.synchronize()
    bert = cfg.model.text.bert_config
    log(f"[slice] {cfg.model.vision.model_name} + BERT {bert.num_layers}x{bert.hidden_size}, "
        f"word_num {cfg.data.text.word_num}, imsize {gm.imsize}, crop {gm.crop_size}; "
        f"{len(classes)} classes x 5 prompts; init + set_classes + warmup of 7 buckets "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.RandomState(1)
    imgs = (rng.rand(64, 224, 224, 3) * 255).astype(np.uint8)
    raws = [(rng.rand(256, 256) * 255).astype(np.uint8) for _ in range(4)]
    latency: dict[int, float] = {}
    results: dict[int, np.ndarray] = {}

    local_sim.launches = 0  # ---- main path starts --------------------------
    for n in (1, 5, 64):
        times = []
        for _ in range(5):
            t = time.perf_counter()
            results[n] = engine.classify(imgs[:n])  # ends in a device→host copy
            times.append(time.perf_counter() - t)
        latency[n] = statistics.median(times)
    batcher = DynamicBatcher(engine, max_wait_ms=5.0)
    server = serve_http(engine, host="127.0.0.1", port=0, batcher=batcher)
    try:
        requests = [imgs[i : i + k] for i, k in ((0, 1), (1, 2), (3, 1), (4, 4), (8, 3), (11, 1))]
        futs = [batcher.submit(r) for r in requests]
        _, not_done = wait(futs, timeout=120)
        check(not not_done, "DynamicBatcher resolved every request")
        batched = [f.result() for f in futs]
        port = server.server_address[1]
        http_scores = []
        for k in (1, 2, 4):
            buf = io.BytesIO()
            np.save(buf, np.stack(raws[:k]))
            body = json.dumps({"arrays_b64": base64.b64encode(buf.getvalue()).decode()}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/classify", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                check(r.status == 200, "POST /classify answered 200")
                http_scores.append(np.asarray(json.loads(r.read())["scores"]))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    torch.cuda.synchronize()
    main_path_launches = local_sim.launches  # ---- main path ends ----------
    log(f"[slice] local_sim.launches on the main path: {main_path_launches}")
    check(main_path_launches > 0, "the main path launched local_sim_fwd")

    n_classes = len(classes)
    for n, arr in results.items():
        check(arr.shape == (n, n_classes) and bool(np.isfinite(arr).all()),
              f"classify({n}) scores finite with shape [{n}, {n_classes}]")
    batch_err = float(np.abs(results[64][:5] - results[5]).max())
    batch_err = max(batch_err, float(np.abs(results[64][:1] - results[1]).max()))
    log(f"[slice] row vs batch: max_abs_diff={batch_err:.3e} (tol {BATCH_TOL})")
    check(batch_err <= BATCH_TOL, "a row does not depend on its batch")
    direct = engine.classify(imgs[:12])
    for r, got, (i, k) in zip(requests, batched, ((0, 1), (1, 2), (3, 1), (4, 4), (8, 3), (11, 1))):
        check(got.shape == (k, n_classes), "batcher result shape")
        check(float(np.abs(got - direct[i : i + k]).max()) <= BATCH_TOL, "batcher == direct classify")
    http_direct = engine.classify(engine.process_img_uint8(raws))
    for k, got in zip((1, 2, 4), http_scores):
        check(got.shape == (k, n_classes) and bool(np.isfinite(got).all()), "HTTP scores shape")
        check(float(np.abs(got - http_direct[:k]).max()) <= BATCH_TOL, "HTTP == direct classify")
    check(stats["requests"].get("/classify") == 3 and not stats["errors"], "/stats counts")
    check(health["ok"] and health["classes"] == list(classes), "/healthz")

    # the same model and prompts on the CPU, where the local score is the plain version
    cpu_engine = InferenceEngine(api.GloriaModel(cfg, state, tokenizer=tokenizer, device="cpu"),
                                 classes, max_batch=64)
    cpu_scores = cpu_engine.classify(imgs[:2])
    slice_err = float(np.abs(cpu_scores - results[5][:2]).max())
    log(f"[slice] card vs CPU (plain local similarity) on 2 images: max_abs_diff={slice_err:.3e} "
        f"(tol {SLICE_TOL})")
    check(slice_err <= SLICE_TOL, "card scores agree with the CPU path")
    del cpu_engine
    for n in (1, 5, 64):
        log(f"[slice] classify({n}): {latency[n] * 1e3:.2f} ms per request, "
            f"{n / latency[n]:.1f} images/s  [{card}]")
    lat = stats["latency"]["/classify"]
    log(f"[slice] POST /classify via DynamicBatcher: p50 {lat['p50_ms']} ms, max {lat['max_ms']} ms "
        f"over {lat['n']} requests [{card}]")

    # ---- 5. kernels at the main path's inputs -----------------------------
    with torch.inference_mode():
        padded = torch.from_numpy(imgs).cuda()
        tower_ms = cuda_ms(lambda: gm.encode_images(padded), iters=3)
        img_l, _ = gm.encode_images(padded)
        words = engine._txt_l
        mask = gloria_loss.make_word_mask(engine._caps, words.shape[1], "eval")
        regions = img_l.contiguous()
        s1 = k1_numbers(words, regions, mask, {"agg": "max"}, "main path's", card, 20, 3)
        worst_err = max(worst_err, s1["err"])
        classify_ms = cuda_ms(lambda: engine.classify(imgs), iters=3)
    log(f"[kernels] where classify(64) goes: {classify_ms:.2f} ms in all, image tower "
        f"{tower_ms:.2f} ms, local_sim_fwd {s1['ms']:.3f} ms [{card}]")
    del engine, gm, padded, img_l, words, regions, mask
    torch.cuda.empty_cache()

    # ---- 6. train: the pretrain step at full width -------------------------
    tr = phase_train(card)
    worst_err = max(worst_err, tr["k1"]["err"])
    bwd_err, bwd_ratio = max(bwd_err, tr["k2_err"]), max(bwd_ratio, tr["k2_ratio"])

    # ---- 7. card vs CPU: one step's gradients -------------------------------
    phase_card_vs_cpu()

    # ---- 8. loader: the data plane feeding the step, attention supervision on
    ld = phase_loader(card, tr["step_ms"])

    # ---- 9. fused tail: K3 and K4 on a ResNet-50 step's 16 bottleneck tails
    ft = phase_fused_tail(card)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # ---- 10. result lines -------------------------------------------------
    log(card)
    log(json.dumps({"kernels": [{
        "name": "local_sim_fwd", "route": "cuda",
        "source": "gloria_tpu_torch/csrc/local_sim_fwd.cu",
        "replaces": "gloria_tpu/ops/pallas/local_sim.py:126",
        "launches": main_path_launches + tr["launches"][0] + ld["launches"][0],
        "launches_by_path": {"serve": main_path_launches, "train": tr["launches"][0],
                             "loader_train": ld["launches"][0]},
        "max_abs_err": worst_err, "ms": s1["ms"], "plain_ms": s1["plain_ms"],
        "bound_ms": s1["bound_ms"], "bound_by": s1["bound_by"],
        "bound_rate": "3xTF32: 495/3 TFLOP/s of f32 products",
        "bound_f32_ms": s1["bound_f32_ms"], "library_ms": None, "passes_ms": s1["passes"],
        "wrapper_ms": s1["wrapper_ms"], "workspace_bytes": s1["workspace_bytes"],
    } | {f"train_{k}": tr["k1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "bound_f32_ms", "wrapper_ms", "workspace_bytes")}
      | {"train_passes_ms": tr["k1"]["passes"]}, {
        "name": "local_sim_bwd", "route": "cuda",
        "source": "gloria_tpu_torch/csrc/local_sim_bwd.cu",
        "replaces": "gloria_tpu/ops/pallas/local_sim.py:164",
        "launches": tr["launches"][1] + ld["launches"][1],
        "launches_by_path": {"train": tr["launches"][1], "loader_train": ld["launches"][1]},
        "max_abs_err": bwd_err, "max_err_over_tol": bwd_ratio, "ms": tr["k2_ms"],
        "plain_ms": tr["k2_plain_ms"], "bound_ms": tr["k2_bound_ms"],
        "bound_by": tr["k2_bound_by"], "bound_rate": "3xTF32: 495/3 TFLOP/s of f32 products",
        "bound_f32_ms": tr["k2_bound_f32_ms"], "library_ms": None,
        "passes_ms": tr["k2_passes"],
    }] + [{
        "name": f"fused_bn_{key}", "route": "cuda",
        "source": f"gloria_tpu_torch/csrc/fused_bn_{key}.cu",
        "replaces": f"scripts/experiments/fused_bn.py:{line}",
        "launches": launches, "launches_by_path": {"fused_tail": launches},
        "max_abs_err": ft["worst"][key][0], "max_err_over_tol": ft["worst"][key][1],
        "ms": ft[f"{key}_ms"], "plain_ms": ft[f"{key}_plain_ms"],
        "bound_ms": ft[f"{key}_bound_ms"], "bound_by": ft[f"{key}_bound_by"],
        "library_ms": ft[f"{key}_library_ms"],
    } | {col: ft[f"{key}_{col}"] for col in ("ms_cold", "plain_ms_cold", "library_ms_cold",
                                               "passes_ms", "host_ms")} | {
        "library_call": "torch.matmul of the bf16 operands, the product"
                        + ("s" if key == "bwd" else "") + " alone (cuBLAS)",
        "over": "the 16 bottleneck tails of one ResNet-50 train step at B=48, 299 px",
        "by_shape": [{k: r[k] for k in ("layer", "M", "K", "N", "tails")}
                     | {k.removeprefix(f"{key}_"): r[k] for k in r if k.startswith(f"{key}_")}
                     for r in ft["shapes"]],
    } for key, line, launches in (("fwd", 94, ft["launches"][0]),
                                  ("bwd", 124, ft["launches"][1]))]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
