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
10. driver — ``configs/chexpert_pretrain_config.yaml``, read by the port's
   own config reader, at full width with the overrides set in code and
   printed (``data.dataset: synthetic`` with 96 items a split, so that
   ``--limit_batches 2`` gives two batches of 48, and the vocabulary from
   the corpus as in phase 8; ``precision: 32``; ``train.nvis: null``;
   ``max_epochs: 2``; wandb disabled through the environment), written
   with ``save_config``
   into a temporary directory (its free space printed first; deleted at the
   end), trained by ``python -m gloria_tpu_torch.run`` in subprocesses: run
   A ``--train --test`` for 2 epochs; run B ``--train`` for 1 epoch, then
   ``--train --test --resume --ckpt <B's last>`` to 2.  Checks: two epoch
   rows with finite train and val losses in A and in B, a finite test loss,
   the resumed epoch's numbering, global step (4), scheduler and early
   stopping state, the manifest and ``best_ckpts.yaml``, the K1 and K2
   launches inside run A (its train steps plus its val and test eval steps,
   and its train steps), and ``load_gloria(<A's best>)`` serving five images
   on the card and on the CPU within phase 4's tolerance.  Each run's wall
   time and its split, pairs/s inside ``Trainer.fit``, each checkpoint
   save's seconds and GB, and ``load_gloria``'s seconds.
   The best checkpoint of run A is kept for phase 11.
11. tasks  — the downstream tasks at full width from phase 10's best
   checkpoint, every kernel count set to 0 before and read after (the path
   launches none): ``configs/chexpert_classification_config.yaml``
   (``gloria_resnet50``, 5 targets, 224 crops upsampled to 299², the encoder
   frozen, BCE) and ``configs/pneumothorax_segmentation_config.yaml`` (the
   U-Net on ResNet-50 at 512², MixedLoss α=10, all trainable), each read by
   the port's config reader with the overrides printed (``data.dataset:
   synthetic``, two batches a split; ``precision: 32``; ``max_epochs: 1``;
   wandb off and no hub through the environment).  For each: one train step
   on the card and on the CPU from the same grafted weights at B=2 (loss and
   per-tensor relative L2 of the gradients, TASK_LOSS_RTOL / TASK_GRAD_L2);
   the train step at the config's batch (64, 8) on the card, median of 5
   after a warm-up from CUDA events, images/s, peak memory, the checkpoint
   size reckoned, and where the step goes (forward, backward, optimizer); ``python -m gloria_tpu_torch.run -c <config> --ckpt <phase
   10's best> --train --test --limit_batches 2``: one epoch, finite
   ``val_auroc`` / ``val_dice``, the frozen encoder's parameters equal to
   the checkpoint's after training, the checkpoint's size on disk as
   reckoned, no kernel launch reported.
12. grounding — the ImaGenome grounding path at full width from phase 10's
   best checkpoint, on a synthetic MIMIC-CXR / ImaGenome mirror written in
   a temporary directory in the JAX package's layout (3 × 10 images of 512²
   uint8 in the image cache, 10 silver objects and 6 sentences of 6-30
   words each, many naming left or right; the split tables, the test split
   the gold set with its gold table):
   ``configs/imagenome_attn_finetune_config.yaml`` read by the port's
   config reader with the overrides printed (``precision: 32``, ``bert_type: null``, the mirror's two
   directories, ``max_epochs: 1``).  In this process: the imagenome data
   module's first train batch of 30 through the train step with
   ``return_attn`` (finite, ``attn_seg_loss`` > 0), K1 and K2 at the inputs
   it gave them, as in phase 6; one K1 and one K2 launch a step with and
   without ``return_attn``; both steps' times (CUDA events, median of 5
   after a warm-up, twice each); ``EvaluateLocalization.evaluate_batch`` on
   that batch (host clock, rows only and with the curves and artifacts);
   ``train.attention_outputs`` alone (what ``return_attn`` adds); one B=8
   batch through the step on the card and on the CPU (dropout 0, seed 0's
   weights, whose attention is not uniform; phase 10's saturate the word
   softmax, so every word but one attends evenly): losses, ``_attn``, ``_local_sims``, ``_global_sims``
   and every localization metric within GROUNDING_* tolerances.  Then
   ``python -m gloria_tpu_torch.run --limit_batches 2``: the finetune
   config ``--train --test --ckpt <phase 10's best>`` (one epoch, every
   train step's loss finite and ``attn_seg_loss`` > 0), and
   ``configs/imagenome_pretrain_val_config.yaml --test --ckpt <its best>``,
   plainly and with ``--swap_left_right``:
   ``localization/<split>/sentences.csv`` for train, val and test (test only in the val runs) with
   its rows, its five artifact folders, AUROC finite exactly on the rows
   whose label has a box; the swapped run's sentences differ; the plain
   val run reproduces the finetune run's test rows; the K1 and K2 launches
   inside each run (K1 a train and an eval step, K2 a train step); each
   run's wall time and split; the phase's seconds.
13. bf16 step — phase 6's model (seed 0, the same weights) built with
   ``init_gloria(cfg, dtype=torch.bfloat16)``: the towers compute in bf16
   on f32 parameters, the local loss in f32.  Phase 6's batch of 48 (the
   same seed), one warm-up step, then five ``train_step``s timed with CUDA
   events, the launch counts read around exactly those five: one K1 and
   one K2 launch a step, their words and regions f32 forward and backward;
   losses and grad_norm finite; every parameter and running statistic
   still f32 after the steps.  Step time, pairs/s, peak memory and the
   forward / backward / optimizer split beside phase 6's f32 figures.
   Then one B=8 step (dropout 0, phase 7's batch) in bf16 on the card and
   on the CPU, and in f32 on the CPU: the loss, grad_norm and every
   gradient (in L2) of the card's bf16 step held to the CPU's bf16 step
   within twice the CPU's own bf16-to-f32 distance in the same measure
   plus phase 7's tolerance (BF16_SPREAD); both distances printed.
14. one ``{"kernels": [...]}`` line (``launches_by_path`` with ``tasks``,
   ``grounding`` and ``bf16_train`` entries for every kernel, K1 and K2
   also with their ``grounding_*`` numbers), then the ``{"ok": true, ...}``
   line.
"""

from __future__ import annotations

import base64
import copy
import csv
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import wait
from pathlib import Path

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
# Phase 13, card bf16 vs CPU bf16 (B=8, dropout 0): both round where the
# policy says, each from its own f32 sums, so each carries its own bf16
# rounding error.  If the card's bf16 result is no further from the f32
# result than the CPU's is (d), the triangle inequality puts the two bf16
# results within 2 d of each other (+ the f32 tolerance between the
# devices).  A bound of 1 d failed on the card (H100, 700 W): the query
# and key biases of the attention, whose exact gradient is 0, are rounding
# noise, and two draws of that noise lie ~sqrt(2) d apart (max|diff| up to
# 2.09 d, 1.57 of that bound), as did one LayerNorm weight (1.12).
BF16_SPREAD = 2.0
BACKBONE = "img_encoder.model."
TRAIN_BATCH = 48
TRAIN_STEPS = 5
ROOT = Path(__file__).resolve().parent
DRIVER_CONFIG = "configs/chexpert_pretrain_config.yaml"
DRIVER_BATCHES = 2  # --limit_batches: train, val and test batches an epoch
DRIVER_TIMEOUT_S = 300
# the config's WandbLogger mirror stays off and nothing looks for a hub:
# the machine that runs this has no network
DRIVER_ENV = {"WANDB_MODE": "disabled", "HF_HUB_OFFLINE": "1"}
# phase 11: the downstream tasks' shipped configs, their batches and image sizes
TASK_CONFIGS = {"classification": "configs/chexpert_classification_config.yaml",
                "segmentation": "configs/pneumothorax_segmentation_config.yaml"}
TASK_CHECK_BATCH = 2  # card vs CPU
TASK_STEPS = 5        # timed steps at the config's batch, after one warm-up
# card vs CPU on one task step.  Classification: the backbone is frozen, so
# only the head's (and the unused embedders') gradients exist, smooth
# functions of the pooled features, which agree to ~1e-6 relative.
# Segmentation: every U-Net parameter trains, and the train-mode gradient is
# badly conditioned (tests/test_torch_port_tasks.py: at ResNet-18, 64 px, a
# 1e-9 relative move of the input moves a gradient by 7.5e-6 relative L2 in
# float64, and the f32 gradient sits 6.0e-3 from the float64 one), so its
# tensors are held at 5e-2 relative L2, and the ConvBlocks' conv biases,
# whose exact gradient is 0 (a train-mode BatchNorm follows), in norm at
# 1e-4 of the whole gradient's.
TASK_LOSS_RTOL = {"classification": 1e-4, "segmentation": 1e-3}
TASK_GRAD_L2 = {"classification": 1e-3, "segmentation": 5e-2}
# phase 12: the ImaGenome grounding configs on a synthetic mirror written here
GROUNDING_CONFIGS = {"finetune": "configs/imagenome_attn_finetune_config.yaml",
                     "val": "configs/imagenome_pretrain_val_config.yaml"}
GROUNDING_DICOMS = 10    # images a split, each with GROUNDING_SENTENCES sentences:
GROUNDING_SENTENCES = 6  # 60 a split, two batches of the configs' 30
GROUNDING_CHECK_BATCH = 8
GROUNDING_BBOXES = (  # Chest ImaGenome's anatomical locations
    "right lung", "right upper lung zone", "right mid lung zone", "right lower lung zone",
    "right hilar structures", "right apical zone", "right costophrenic angle",
    "right hemidiaphragm", "left lung", "left upper lung zone", "left mid lung zone",
    "left lower lung zone", "left hilar structures", "left apical zone",
    "left costophrenic angle", "left hemidiaphragm", "cardiac silhouette", "mediastinum",
    "trachea", "aortic arch")
GROUNDING_CONDITIONS = ("lung opacity", "pleural effusion", "atelectasis", "pneumothorax",
                        "consolidation", "pulmonary edema/hazy opacity", "vascular congestion",
                        "enlarged cardiac silhouette", "pneumonia", "lung lesion")
GROUNDING_WORDS = ("mild", "moderate", "small", "new", "stable", "unchanged", "subtle", "patchy",
                   "increased", "decreased", "likely", "compared", "to", "the", "prior", "study",
                   "again", "seen", "with", "minimal", "interval", "change", "since", "yesterday")
# card vs CPU on one grounding train step (B=8, dropout 0, the same weights):
# the attention is a softmax of train-mode features that differ by ~1e-6
# relative (phase 8); the similarities are log-values of O(1-20).  The
# localization metrics take the two attentions through the same overlay:
# AUROC and AP move with the ranks of near-equal pixels, and the top-k
# family by 1/k (k = 2508 at 5% of 224²) for each pixel that crosses its
# threshold.
# Measured (H100, 700 W): _attn 3.98e-5, _local_sims 3.31e-6, AUROC
# 3.72e-5, the top-k family 1.30e-4.
GROUNDING_ATTN_TOL = 1e-4
GROUNDING_SIMS_TOL = 1e-3
GROUNDING_METRIC_TOL = {"auroc": 1e-3, "avg_precision": 1e-3, "attn_entropy": 1e-4,
                        "no_attn_weight": 1e-4}
GROUNDING_TOPK_TOL = 1e-2


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


def k2_numbers(words, regions, mask, g, kw: dict, where: str, card: str) -> dict:
    """K2 at one path's inputs, as :func:`k1_numbers`: error against the
    plain version (and error / tolerance), two calls bitwise equal, time
    (CUDA events), the plain version's time, both bounds, the extra memory
    of one call and the device time per pass (torch.profiler)."""
    import torch

    from gloria_tpu_torch.ops import local_sim

    def call():
        return local_sim.local_similarities_bwd(words, regions, mask, g, **kw)

    dw, dr = call()
    pw, pr = local_sim.local_similarities_bwd_plain(words, regions, mask, g, **kw)
    (ew, tw), (er, tr) = grad_err(dw, pw), grad_err(dr, pr)
    check(ew <= tw and er <= tr, f"local_sim_bwd vs plain at the {where} inputs")
    out = {"err": max(ew, er), "ratio": max(ew / tw, er / tr)}
    again = call()
    check(torch.equal(dw, again[0]) and torch.equal(dr, again[1]),
          f"local_sim_bwd gives the same bits twice at the {where} inputs")
    del dw, dr, pw, pr, again
    out["ms"] = cuda_ms(call, 5)
    out["plain_ms"] = cuda_ms(
        lambda: local_sim.local_similarities_bwd_plain(words, regions, mask, g, **kw), 2)
    out["bound_f32_ms"], _ = local_sim_bwd_bound(words, regions, mask, g)
    out["bound_ms"], out["bound_by"] = local_sim_bwd_bound_3xtf32(words, regions, mask, g)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    out["extra_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    out["passes"] = passes = device_ms(call, K2_PASSES)
    log(f"[kernels] local_sim_bwd at the {where} inputs: {int(mask.sum())} valid words x "
        f"{regions.shape[0]} images; dwords max_abs_err={ew:.3e} (tol {tw:.3e}), dregions "
        f"max_abs_err={er:.3e} (tol {tr:.3e}), bitwise equal over two calls; kernel "
        f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound "
        f"{out['bound_ms']:.4f} ms at the 3xTF32 rate ({out['bound_by']}), "
        f"{out['bound_f32_ms']:.4f} ms at the f32 CUDA-core rate; outputs, workspace and "
        f"packing {out['extra_gb']:.3f} GB [{card}]")
    products = sum(v or 0.0 for k, v in passes.items() if k.startswith("k2p_"))
    passes_ms = sum(v or 0.0 for v in passes.values())
    log(f"[kernels] local_sim_bwd per pass at the {where} inputs (torch.profiler device time, "
        f"ms): " + ", ".join(f"{k} {v:.4f}" if v is not None else f"{k} not recorded"
                             for k, v in passes.items())
        + f"; products {products:.4f}, elementwise {passes_ms - products:.4f}, all passes "
        f"{passes_ms:.4f} [{card}]")
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
    out["k1"] = k1_numbers(words, regions, mask, kw, "train step's", card, 5, 2)
    k2 = k2_numbers(*seen["bwd"], "train step's", card)
    out.update({f"k2_{k}": v for k, v in k2.items()})
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


def compare_bf16_card_cpu(card: tuple, cpu: tuple, cpu_f32: tuple, names: list[str],
                          seconds: float) -> None:
    """Phase 13's held comparison: the card's bf16 step (metrics, gradients)
    against the CPU's bf16 step.  Each distance is bounded by BF16_SPREAD
    times the CPU's own bf16-to-f32 distance in the same measure plus phase
    7's f32 tolerance: loss and grad_norm by |diff| (+ STEP_LOSS_RTOL /
    STEP_GRAD_NORM_RTOL relative); every gradient in L2 (+
    STEP_BACKBONE_L2_TOL ||g|| for the ResNet's, STEP_GRAD_TOL ||g|| for the
    others, + 1e-6 sqrt(n))."""
    from gloria_tpu_torch.training import optim

    (gm, gg), (cm, cg), (fm, fg) = card, cpu, cpu_f32
    rows = []  # (distance / bound, what, card-vs-CPU bf16, CPU bf16-vs-f32, bound)

    def hold(what: str, d_card: float, d_ref: float, tol: float) -> None:
        bound = BF16_SPREAD * d_ref + tol
        rows.append((d_card / bound, what, d_card, d_ref, bound))

    loss = float(cm["loss"])
    hold("loss", abs(float(gm["loss"]) - loss), abs(loss - float(fm["loss"])),
         STEP_LOSS_RTOL * abs(loss))
    norms = [float(optim.global_norm(g)) for g in (gg, cg, fg)]
    hold("grad_norm", abs(norms[0] - norms[1]), abs(norms[1] - norms[2]),
         STEP_GRAD_NORM_RTOL * norms[1])
    for name, a, b, f in zip(names, gg, cg, fg):
        rel = STEP_BACKBONE_L2_TOL if name.startswith(BACKBONE) else STEP_GRAD_TOL
        hold(name, float((a.cpu() - b).norm()), float((b - f).norm()),
             rel * float(b.norm()) + 1e-6 * b.numel() ** 0.5)
    rows.sort(reverse=True)
    log(f"[bf16 card vs cpu] one B=8 step ({seconds:.1f} s): loss {float(gm['loss']):.6f} "
        f"(card bf16) vs {loss:.6f} (CPU bf16) vs {float(fm['loss']):.6f} (CPU f32); "
        f"grad_norm {norms[0]:.5f} vs {norms[1]:.5f} vs {norms[2]:.5f}")
    log(f"[bf16 card vs cpu] {len(rows)} quantities; the worst by card-vs-CPU-bf16 distance / "
        f"({BF16_SPREAD} x the CPU's bf16-vs-f32 distance + phase 7's tolerance), gradients in "
        "L2:")
    for ratio, what, d_card, d_ref, bound in rows[:6]:
        log(f"[bf16 card vs cpu]   {what}: card vs CPU bf16 {d_card:.3e}, CPU bf16 vs f32 "
            f"{d_ref:.3e}, bound {bound:.3e}, ratio {ratio:.3f}")
    once = max((d_card / (bound - (BF16_SPREAD - 1) * d_ref), what)
               for _, what, d_card, d_ref, bound in rows)
    log(f"[bf16 card vs cpu] with 1 x the CPU's distance instead of {BF16_SPREAD}, the worst "
        f"ratio would be {once[0]:.3f} ({once[1]})")
    for ratio, what, *_ in rows:
        check(ratio <= 1.0, f"bf16 card vs cpu: {what} within {BF16_SPREAD} x the CPU's "
                            "bf16-vs-f32 distance + phase 7's tolerance")


def phase_bf16(card: str, f32: dict) -> dict:
    """Phase 13: the pretrain step with the towers in bf16; returns its
    numbers.  ``f32`` is phase 6's result, printed beside them."""
    import torch

    from gloria_tpu_torch.data.synthetic import make_synthetic_batch
    from gloria_tpu_torch.experiments import fused_bn
    from gloria_tpu_torch.models.gloria_model import init_gloria
    from gloria_tpu_torch.models.norm import BatchNorm2d
    from gloria_tpu_torch.ops import local_sim
    from gloria_tpu_torch.training import optim, train

    bf16, f32_dtype = torch.bfloat16, torch.float32
    t_phase = time.perf_counter()
    cfg = pretrain_config(dropout=0.1)
    model = init_gloria(cfg, seed=0, dtype=bf16)
    model.img_encoder.to(memory_format=torch.channels_last)
    opt = optim.make_optimizer(cfg, grad_clip=cfg.lightning.trainer.gradient_clip_val)
    state = train.create_train_state(model, opt, seed=0, device="cuda")
    train_step, _ = train.make_pretrain_steps(model, opt)
    raw = make_synthetic_batch(batch_size=TRAIN_BATCH, num_tokens=97, imsize=224,
                               vocab_size=28996, seed=0)
    batch = train.to_device(raw, torch.device("cuda"))
    state, _ = train_step(state, batch)  # warm-up
    torch.cuda.synchronize()

    # the operands the local-similarity route receives, recorded by dtype only
    operands = set()
    fwd, bwd = local_sim._similarities, local_sim._similarities_bwd

    def record_fwd(words, regions, *args, **kw):
        operands.add(("fwd", words.dtype, regions.dtype))
        return fwd(words, regions, *args, **kw)

    def record_bwd(words, regions, mask, g, *args, **kw):
        operands.add(("bwd", words.dtype, regions.dtype, g.dtype))
        return bwd(words, regions, mask, g, *args, **kw)

    local_sim._similarities, local_sim._similarities_bwd = record_fwd, record_bwd
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics = []
    try:
        local_sim.launches = local_sim.launches_bwd = 0  # ---- bf16 train path starts ----
        fused_bn.launches_fwd = fused_bn.launches_bwd = 0  # the path runs neither
        start.record()
        for _ in range(TRAIN_STEPS):
            state, m = train_step(state, batch)
            metrics.append(m)
        end.record()
        torch.cuda.synchronize()
        launches = (local_sim.launches, local_sim.launches_bwd)  # ---- bf16 train path ends
        fused_launches = {"fwd": fused_bn.launches_fwd, "bwd": fused_bn.launches_bwd}
    finally:
        local_sim._similarities, local_sim._similarities_bwd = fwd, bwd
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        log(f"[bf16] step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in vals.items()))
        check(all(np.isfinite(v) for v in vals.values()), f"bf16 step {i + 1}: metrics finite")
        check(vals["nonfinite_steps"] == 0, f"bf16 step {i + 1}: no step skipped")
    log(f"[bf16] launches over the {TRAIN_STEPS} steps: local_sim_fwd {launches[0]}, "
        f"local_sim_bwd {launches[1]}; operands {sorted(map(str, operands))}")
    check(launches == (TRAIN_STEPS, TRAIN_STEPS), "bf16: one K1 and one K2 launch per train step")
    check(operands == {("fwd", f32_dtype, f32_dtype), ("bwd", f32_dtype, f32_dtype, f32_dtype)},
          "bf16: K1 and K2 receive f32 words and regions")
    check(all(p.dtype == f32_dtype for p in model.parameters()), "bf16: parameters stay f32")
    check(all(b.dtype == f32_dtype for m in model.modules() if isinstance(m, BatchNorm2d)
              for b in (m.running_mean, m.running_var)), "bf16: BatchNorm statistics stay f32")

    gen = torch.Generator(device="cuda").manual_seed(0)
    model.train()
    imgs, caps = batch["imgs"], batch["cap_lens"]
    parts = {  # as phase 6 times them
        "image tower fwd": lambda: model.image_encoder_forward(imgs),
        "text tower fwd": lambda: model.text_encoder_forward(
            batch["caption_ids"], batch["attention_mask"], batch["token_type_ids"],
            batch["word_assignment"], gen),
        "forward + calc_loss": lambda: model.calc_loss(*model(batch, gen)[:4], caps),
        "forward + calc_loss + backward": lambda: train.loss_and_grads(model, batch, gen),
    }
    parts = {name: cuda_ms(fn, 2, reps=3) for name, fn in parts.items()}

    def split_of(p: dict, step: float) -> dict:
        fl, flb = p["forward + calc_loss"], p["forward + calc_loss + backward"]
        return {"image tower fwd": p["image tower fwd"], "text tower fwd": p["text tower fwd"],
                "forward + calc_loss": fl, "backward": flb - fl,
                "optimizer and the rest": step - flb}

    split, f32_split = split_of(parts, step_ms), split_of(f32["parts"], f32["step_ms"])
    log(f"[bf16] step {step_ms:.2f} ms, {TRAIN_BATCH / step_ms * 1e3:.1f} pairs/s, peak "
        f"{peak_gb:.2f} GB allocated; phase 6 (f32, this process) {f32['step_ms']:.2f} ms, "
        f"{TRAIN_BATCH / f32['step_ms'] * 1e3:.1f} pairs/s, peak {f32['peak_gb']:.2f} GB "
        f"(CUDA events over {TRAIN_STEPS} steps) [{card}]")
    log("[bf16] where a step goes, bf16 vs f32 (ms; the towers, forward and backward each "
        "timed alone, the rest is the step less both): " + ", ".join(f"{k} {v:.2f} vs {f32_split[k]:.2f}"
                                               for k, v in split.items()) + f" [{card}]")
    out = {"step_ms": step_ms, "peak_gb": peak_gb, "launches": launches, "split": split,
           "fused_launches": fused_launches}
    del model, state, batch, opt, metrics
    torch.cuda.empty_cache()

    # one B=8 step: card bf16 against CPU bf16, bounded by CPU bf16 against CPU f32
    t0 = time.perf_counter()
    cfg0 = pretrain_config(dropout=0.0)
    raw = make_synthetic_batch(batch_size=8, num_tokens=97, imsize=224, vocab_size=28996, seed=1)
    cpu_batch = train.to_device(raw, torch.device("cpu"))
    cpu_model = init_gloria(cfg0, seed=0, dtype=bf16)
    gpu_model = copy.deepcopy(cpu_model).cuda()
    card_step = train.loss_and_grads(gpu_model, train.to_device(raw, torch.device("cuda")))
    torch.cuda.synchronize()
    del gpu_model
    t_cpu = time.perf_counter()
    cpu_step = train.loss_and_grads(cpu_model, cpu_batch)
    cpu_bf16_s = time.perf_counter() - t_cpu
    names = [n for n, _ in cpu_model.named_parameters()]
    del cpu_model
    t_cpu = time.perf_counter()
    cpu_f32 = train.loss_and_grads(init_gloria(cfg0, seed=0), cpu_batch)
    log(f"[bf16 card vs cpu] CPU steps at B=8: bf16 {cpu_bf16_s:.1f} s, f32 "
        f"{time.perf_counter() - t_cpu:.1f} s")
    compare_bf16_card_cpu(card_step, cpu_step, cpu_f32, names, time.perf_counter() - t0)
    del card_step, cpu_step, cpu_f32
    torch.cuda.empty_cache()
    log(f"[bf16] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


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


def driver_config():
    """Phase 10's config: the shipped pretrain config with the overrides the
    card's run needs, each returned for printing."""
    from gloria_tpu_torch.configs import load_config

    cfg = load_config(str(ROOT / DRIVER_CONFIG))
    overrides = {
        "data.dataset": "synthetic",  # the repository holds no CheXpert data
        "data.synthetic_size": DRIVER_BATCHES * TRAIN_BATCH,  # two batches of 48 a split
        # the vocabulary as phase 8 makes it, from the corpus: with a bert_type
        # the tokenizer first imports transformers (23 s on the card's host)
        # to look for a cached Bio_ClinicalBERT vocabulary, which is not there
        "model.text.bert_type": None,
        "lightning.trainer.precision": 32,  # bf16 is ROADMAP.md A1.2
        "train.nvis": None,  # training-time attention plots are A6
        "lightning.trainer.max_epochs": 2,
    }
    for path, value in overrides.items():
        cfg.set_path(path, value)
    return cfg, overrides


def checkpoint_bytes(cfg) -> tuple[int, int]:
    """(parameters, bytes of a training checkpoint reckoned from the model:
    f32 weights, BatchNorm statistics and Adam's two moments)."""
    import torch

    from gloria_tpu_torch.models.gloria_model import GLoRIA

    with torch.device("meta"):
        model = GLoRIA(cfg)
    params = sum(p.numel() for p in model.parameters())
    buffers = sum(t.numel() for t in model.state_dict().values()) - params
    return params, 4 * (3 * params + buffers)


def run_driver(cfg_path: Path, out: Path, *flags: str) -> dict:
    """``python -m gloria_tpu_torch.run`` in a subprocess; its run directory,
    report, results line and wall time."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gloria_tpu_torch.run", "-c", str(cfg_path), "--output_dir",
         str(out), "--limit_batches", str(DRIVER_BATCHES), *flags],
        cwd=ROOT, env=os.environ | DRIVER_ENV, capture_output=True, text=True,
        timeout=DRIVER_TIMEOUT_S)
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-6000:])
    check(proc.returncode == 0, f"python -m gloria_tpu_torch.run {' '.join(flags)} exited "
                                f"{proc.returncode}")
    lines = proc.stdout.splitlines()
    report = json.loads(next(ln for ln in lines if ln.startswith("[run] "))[len("[run] "):])
    (run_dir,) = [p for p in out.iterdir() if p.is_dir()]
    epochs = []
    if (run_dir / "metrics_epoch.csv").exists():  # a --test run trains no epoch
        with open(run_dir / "metrics_epoch.csv", newline="") as fh:
            epochs = list(csv.DictReader(fh))
    return {"wall_s": wall, "report": report, "dir": run_dir, "epochs": epochs,
            "stdout": proc.stdout}


def log_run(name: str, r: dict, card: str, tag: str = "driver", batch: int = TRAIN_BATCH) -> None:
    sec = r["report"]["seconds"]
    start = r["wall_s"] - sec["main"]
    log(f"[{tag}] run {name}: {r['wall_s']:.1f} s wall = process start, imports and exit "
        f"{start:.1f} + CUDA init {sec['device_init']:.1f} + data module "
        f"{sec['data_module']:.1f} + model build {sec['model_build']:.1f} + fit "
        f"{sec.get('fit', 0.0):.1f} + test {sec.get('test', 0.0):.1f} s [{card}]")
    for row in r["epochs"]:
        pairs = DRIVER_BATCHES * batch
        log(f"[{tag}] run {name} epoch at step {row['step']}: train_loss "
            f"{float(row['train_loss']):.5f}, val_loss {float(row['val_loss']):.5f}; "
            f"{pairs} pairs in {float(row['epoch_time']):.3f} s inside Trainer.fit, "
            f"{pairs / float(row['epoch_time']):.1f} pairs/s (host clock over the train "
            f"batches, read at the epoch's end) [{card}]")
    for save in r["report"]["checkpoint_saves"]:
        log(f"[{tag}] run {name} checkpoint {save['name']}: {save['gb']:.3f} GB, copy to the "
            f"host {save['copy_s']:.2f} s, write {save['write_s']:.2f} s [{card}]")


def phase_driver(card: str, keep: Path) -> dict:
    """Phase 10: the port's driver trains the full-width pretrain config
    on the card, resumes, tests, and serves its best checkpoint, which it
    then moves into ``keep`` for phase 11 (``out["best"]``)."""
    import torch

    from gloria_tpu_torch import api
    from gloria_tpu_torch.configs import loads_config, save_config
    from gloria_tpu_torch.serving import InferenceEngine
    from gloria_tpu_torch.training.checkpoints import load_checkpoint_meta

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg, overrides = driver_config()
    log(f"[driver] {DRIVER_CONFIG} read by gloria_tpu_torch.configs.load_config; overrides: "
        + ", ".join(f"{k}={v!r}" for k, v in overrides.items())
        + "; the driver's environment adds " + ", ".join(f"{k}={v}" for k, v in DRIVER_ENV.items()))
    params, ckpt_bytes = checkpoint_bytes(cfg)
    work = Path(tempfile.mkdtemp(prefix="gloria_smoke_driver_"))
    try:
        free = shutil.disk_usage(work).free
        # run A's two checkpoints stay until A is served; then its best one
        # stays (for phase 11) while B's two come
        need = 3 * ckpt_bytes + (64 << 20)
        log(f"[driver] temporary directory {work}: {free / 1e9:.1f} GB free; a training "
            f"checkpoint of {params} parameters reckons to {ckpt_bytes / 1e9:.3f} GB "
            f"(f32 weights and BatchNorm statistics, Adam's two moments); {need / 1e9:.2f} GB "
            "needed at once")
        check(free >= need, f"{need / 1e9:.2f} GB free in {work} for the driver's checkpoints "
                            f"(found {free / 1e9:.2f} GB)")
        cfg_path = work / "config.yaml"
        save_config(cfg, str(cfg_path))
        out: dict = {}

        # ---- run A: --train --test, 2 epochs
        a = run_driver(cfg_path, work / "A", "--train", "--test")
        log_run("A", a, card)
        check(len(a["epochs"]) == 2, "run A logged 2 epoch rows")
        for row in a["epochs"]:
            check(all(np.isfinite(float(row[k])) for k in ("train_loss", "val_loss")),
                  f"run A epoch at step {row['step']}: finite train and val losses")
        with open(a["dir"] / "metrics_test.csv", newline="") as fh:
            test_loss = float(next(csv.DictReader(fh))["test_loss"])
        check(np.isfinite(test_loss), "run A: finite test_loss")
        steps = a["report"]["global_step"]
        check(steps == 2 * DRIVER_BATCHES, f"run A: global_step {steps} == 4")
        eval_steps = 2 * DRIVER_BATCHES + DRIVER_BATCHES  # val in each epoch, then test
        launches = a["report"]["launches"]
        log(f"[driver] run A launches: local_sim_fwd {launches['local_sim_fwd']} ({steps} train "
            f"steps + {eval_steps} val and test eval steps), local_sim_bwd "
            f"{launches['local_sim_bwd']} ({steps} train steps); test_loss {test_loss:.5f}")
        check(launches == {"local_sim_fwd": steps + eval_steps, "local_sim_bwd": steps},
              "run A: one K1 launch a train and an eval step, one K2 launch a train step")
        out["launches"] = (launches["local_sim_fwd"], launches["local_sim_bwd"])
        manifest = json.loads((a["dir"] / "ckpt" / "manifest.json").read_text())
        check(len(manifest["entries"]) == 2 and manifest["last"] == "step_00000004",
              "run A: manifest with both epochs' entries and last")
        best = loads_config((work / "A" / "best_ckpts.yaml").read_text()).seed_0
        check(best is not None and (Path(best) / "state.pt").is_file(),
              "best_ckpts.yaml names a checkpoint that exists")
        size = (Path(best) / "state.pt").stat().st_size
        log(f"[driver] best checkpoint {Path(best).name}: state.pt {size / 1e9:.3f} GB on disk "
            f"(reckoned {ckpt_bytes / 1e9:.3f} GB)")
        check(abs(size - ckpt_bytes) < 0.01 * ckpt_bytes, "checkpoint size as reckoned")

        # ---- serve A's best checkpoint, on the card and on the CPU
        classes = api.generate_chexpert_class_prompts()
        imgs = (np.random.RandomState(3).rand(5, 224, 224, 3) * 255).astype(np.uint8)
        scores, load_s = {}, {}
        for device in ("cuda", "cpu"):
            t = time.perf_counter()
            gm = api.load_gloria(best, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            load_s[device] = time.perf_counter() - t
            scores[device] = InferenceEngine(gm, classes).classify(imgs)
            del gm
        torch.cuda.empty_cache()
        err = float(np.abs(scores["cuda"] - scores["cpu"]).max())
        log(f"[driver] load_gloria({Path(best).name}): {load_s['cuda']:.2f} s onto the card, "
            f"{load_s['cpu']:.2f} s onto the CPU [{card}]; zero-shot scores of 5 images, card vs "
            f"CPU: max_abs_diff={err:.3e} (tol {SLICE_TOL})")
        check(scores["cuda"].shape == (5, len(classes)) and bool(np.isfinite(scores["cuda"]).all()),
              "served scores finite with shape [5, classes]")
        check(err <= SLICE_TOL, "a checkpoint written on the card serves the same on the CPU")
        out["load_s"] = load_s
        out["best"] = keep / Path(best).name
        shutil.move(best, out["best"])
        shutil.rmtree(work / "A")

        # ---- run B: --train 1 epoch, then --resume to 2 with --test
        b1 = run_driver(cfg_path, work / "B1", "--train", "--max_epochs", "1")
        log_run("B (epoch 1)", b1, card)
        b1_last = b1["dir"] / "ckpt" / json.loads(
            (b1["dir"] / "ckpt" / "manifest.json").read_text())["last"]
        b2 = run_driver(cfg_path, work / "B2", "--train", "--test", "--resume", "--ckpt",
                        str(b1_last))
        log_run("B (resumed)", b2, card)
        rows = b1["epochs"] + b2["epochs"]
        check([r["step"] for r in rows] == ["2", "4"], "run B's epochs at steps 2 and 4")
        for row in rows:
            check(all(np.isfinite(float(row[k])) for k in ("train_loss", "val_loss")),
                  f"run B epoch at step {row['step']}: finite train and val losses")
        check(b2["report"]["global_step"] == 4, "the resumed run ends at global_step 4")
        state = load_checkpoint_meta(b2["dir"] / "ckpt" / "step_00000004")["trainer_state"]
        val = [float(r["val_loss"]) for r in rows]
        log(f"[driver] run B resumed from {b1_last.name}: trainer_state {json.dumps(state)}")
        check(state["epoch"] == 2 and state["global_step"] == 4, "resumed epoch numbering")
        check(state["scheduler"]["count"] == 2, "the scheduler's state carried over")
        check(state["early_stopping"]["best"] == min(val)
              and state["early_stopping"]["bad_epochs"] == int(val[1] >= val[0]),
              "early stopping's state carried over")
        out["runs"] = {"A": a, "B1": b1, "B2": b2}
        out["test_loss"] = test_loss
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[driver] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return out


def task_config(phase: str):
    """Phase 11's config of ``phase``: the shipped config with the overrides
    the card's run needs, each returned for printing."""
    from gloria_tpu_torch.configs import load_config

    cfg = load_config(str(ROOT / TASK_CONFIGS[phase]))
    overrides = {
        "data.dataset": "synthetic",  # the repository holds no CheXpert or SIIM data
        # two batches a split at the config's batch size
        "data.synthetic_size": DRIVER_BATCHES * int(cfg.train.batch_size),
        "lightning.trainer.precision": 32,  # bf16 is ROADMAP.md A1.2
        "lightning.trainer.max_epochs": 1,
    }
    for path, value in overrides.items():
        cfg.set_path(path, value)
    return cfg, overrides


def task_batch(phase: str, cfg, n: int, seed: int) -> dict:
    """``n`` images at the size the task's model sees (the crop, or the
    segmentation size) and labels: random multi-label targets, or a
    rectangle mask."""
    import torch

    rng = np.random.RandomState(seed)
    if phase == "classification":
        size = int(cfg.transforms.random_crop.crop_size)
        labels = (rng.rand(n, int(cfg.model.vision.num_targets)) > 0.5).astype(np.float32)
    else:
        size = int(cfg.data.image.imsize)
        labels = np.zeros((n, size, size), np.float32)
        labels[:, size // 4 : size // 2, size // 3 : 2 * size // 3] = 1.0
    return {"imgs": torch.from_numpy(rng.randn(n, size, size, 3).astype(np.float32)),
            "labels": torch.from_numpy(labels)}


def task_checkpoint_bytes(model, optimizer) -> tuple[int, int, int]:
    """(parameters, trainable parameters, bytes of a training checkpoint:
    f32 weights, BatchNorm statistics and Adam's two moments of the
    trainable parameters)."""
    params = sum(p.numel() for p in model.parameters())
    trainable = sum(p.numel() for p in optimizer.select(list(model.parameters())))
    buffers = sum(t.numel() for t in model.state_dict().values()) - params
    return params, trainable, 4 * (params + buffers + 2 * trainable)


def phase_tasks(card: str, pretrain_ckpt: Path, driver_s: float) -> dict:
    """Phase 11: the downstream tasks at full width.  For each task: one
    train step card vs CPU at B=2, the step at the config's batch (CUDA
    events, peak memory), and ``python -m gloria_tpu_torch.run`` on the
    shipped config from phase 10's best checkpoint."""
    import torch

    from gloria_tpu_torch import builder
    from gloria_tpu_torch.configs import save_config
    from gloria_tpu_torch.experiments import fused_bn
    from gloria_tpu_torch.ops import local_sim
    from gloria_tpu_torch.training.checkpoints import load_checkpoint

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    gloria = load_checkpoint(pretrain_ckpt)[0]["model"]
    log(f"[tasks] the pretrained encoder: {pretrain_ckpt.name} of phase 10 ({len(gloria)} "
        "tensors)")
    # ---- the task path starts: every kernel count at 0
    local_sim.launches = local_sim.launches_bwd = 0
    fused_bn.launches_fwd = fused_bn.launches_bwd = 0
    out: dict = {}
    work = Path(tempfile.mkdtemp(prefix="gloria_smoke_tasks_"))
    try:
        for phase in ("classification", "segmentation"):
            cfg, overrides = task_config(phase)
            log(f"[tasks] {TASK_CONFIGS[phase]} read by gloria_tpu_torch.configs.load_config; "
                "overrides: " + ", ".join(f"{k}={v!r}" for k, v in overrides.items())
                + "; the driver's environment adds "
                + ", ".join(f"{k}={v}" for k, v in DRIVER_ENV.items()))
            r: dict = {}

            # ---- card vs CPU: one step from the same weights
            t = time.perf_counter()
            batch = task_batch(phase, cfg, TASK_CHECK_BATCH, seed=11)
            grads, losses = {}, {}
            for device in ("cpu", "cuda"):
                task, _ = builder.init_task(cfg, pretrained=gloria, seed=0, device=device)
                names = [n for n, p in task.model.named_parameters() if p.requires_grad]
                b = {k: v.to(device) for k, v in batch.items()}
                loss, logits, g = task.loss_and_grads(b)
                check(bool(torch.isfinite(logits).all()), f"{phase} {device}: finite logits")
                losses[device] = float(loss)
                grads[device] = [x.detach().double().cpu() for x in g]
                del task, b, loss, logits, g
            torch.cuda.empty_cache()
            zero = {n for n in names if ("conv_block" in n or "bridge" in n)
                    and n.endswith("conv.bias")}
            total = float(torch.linalg.vector_norm(torch.stack([x.norm() for x in grads["cpu"]])))
            l2 = {n: float((gg - gc).norm() / gc.norm().clamp_min(1e-30))
                  for n, gg, gc in zip(names, grads["cuda"], grads["cpu"]) if n not in zero}
            zero_norm = max([float(gg.norm()) for n, gg in zip(names, grads["cuda"])
                             if n in zero] + [0.0])
            worst = max(l2, key=l2.get)
            loss_err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
            log(f"[tasks] {phase} card vs CPU at B={TASK_CHECK_BATCH} "
                f"({time.perf_counter() - t:.1f} s): loss {losses['cuda']:.6f} vs "
                f"{losses['cpu']:.6f}, relative {loss_err:.2e} (tol {TASK_LOSS_RTOL[phase]}); "
                f"{len(names)} trainable tensors, worst relative L2 {l2[worst]:.2e} ({worst}; "
                f"tol {TASK_GRAD_L2[phase]}); conv biases ahead of a BatchNorm: "
                f"{len(zero)}, largest gradient norm {zero_norm:.2e} against the whole "
                f"gradient's {total:.2e}")
            check(loss_err <= TASK_LOSS_RTOL[phase], f"{phase}: loss card vs CPU")
            check(l2[worst] <= TASK_GRAD_L2[phase], f"{phase}: gradients card vs CPU")
            check(zero_norm <= 1e-4 * total, f"{phase}: zero-gradient conv biases")
            r["card_vs_cpu"] = {"loss_rel": loss_err, "grad_l2": l2[worst], "worst": worst}
            del grads

            # ---- the step at the config's batch, on the card
            bs = int(cfg.train.batch_size)
            task, state = builder.init_task(cfg, pretrained=gloria, seed=0, device="cuda")
            task.model.to(memory_format=torch.channels_last)
            params, trainable, ckpt_bytes = task_checkpoint_bytes(task.model, task.optimizer)
            batch = {k: v.cuda() for k, v in task_batch(phase, cfg, bs, seed=12).items()}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, m = task.train_step(state, batch)  # warm-up
            ms = []
            for _ in range(TASK_STEPS):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = task.train_step(state, batch)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            check(bool(torch.isfinite(m["loss"])), f"{phase}: finite loss at B={bs}")
            peak = torch.cuda.max_memory_allocated()
            step_ms = statistics.median(ms)

            def forward():  # the step's train-mode forward and loss, graph built
                task.model.train()
                return task._loss(task.model(batch["imgs"]), batch["labels"])

            fwd_ms = cuda_ms(forward, iters=1)
            fwd_bwd_ms = cuda_ms(lambda: task.loss_and_grads(batch), iters=1)
            log(f"[tasks] {phase} where the step at B={bs} goes (each part timed alone, CUDA "
                f"events, median of 5): forward and loss {fwd_ms:.2f} ms, backward "
                f"{fwd_bwd_ms - fwd_ms:.2f} ms, the optimizer update (the step less both) "
                f"{step_ms - fwd_bwd_ms:.2f} ms [{card}]")
            log(f"[tasks] {phase} train step at B={bs} ({cfg.model.vision.model_name}, "
                f"{tuple(batch['imgs'].shape[1:3])} px"
                + (", upsampled to 299" if phase == "classification" else "")
                + f", {params} parameters, {trainable} trainable): median of {TASK_STEPS} "
                f"{step_ms:.2f} ms (CUDA events; all {', '.join(f'{x:.2f}' for x in ms)}), "
                f"{bs / step_ms * 1e3:.1f} images/s, peak memory {peak / 2**30:.2f} GiB; a "
                f"training checkpoint reckons to {ckpt_bytes / 1e9:.3f} GB [{card}]")
            r.update(step_ms=step_ms, images_per_s=bs / step_ms * 1e3, peak_gib=peak / 2**30,
                     params=params, trainable=trainable, ckpt_bytes=ckpt_bytes,
                     forward_ms=fwd_ms, backward_ms=fwd_bwd_ms - fwd_ms)
            del task, state, batch, m
            torch.cuda.empty_cache()

            # ---- the driver on the shipped config
            cfg_path = work / f"{phase}.yaml"
            save_config(cfg, str(cfg_path))
            d = run_driver(cfg_path, work / phase, "--train", "--test", "--ckpt",
                           str(pretrain_ckpt))
            sec = d["report"]["seconds"]
            row = d["epochs"][0]
            metric = "val_auroc" if phase == "classification" else "val_dice"
            log(f"[tasks] {phase} driver: {d['wall_s']:.1f} s wall = process start, imports "
                f"and exit {d['wall_s'] - sec['main']:.1f} + data module "
                f"{sec['data_module']:.1f} + model build and graft {sec['model_build']:.1f} + "
                f"fit {sec.get('fit', 0.0):.1f} + test {sec.get('test', 0.0):.1f} s; epoch: "
                f"train_loss {float(row['train_loss']):.5f}, val_loss "
                f"{float(row['val_loss']):.5f}, {metric} {float(row[metric]):.5f}; "
                f"{DRIVER_BATCHES * bs} images in {float(row['epoch_time']):.3f} s inside "
                f"Trainer.fit [{card}]")
            check(len(d["epochs"]) == 1 and d["report"]["global_step"] == DRIVER_BATCHES,
                  f"{phase} driver: one epoch of {DRIVER_BATCHES} steps")
            check(all(np.isfinite(float(row[k])) for k in ("train_loss", "val_loss", metric)),
                  f"{phase} driver: finite train_loss, val_loss and {metric}")
            test = d["stdout"].splitlines()[-1]
            check(metric in test, f"{phase} driver: {metric} in the test results")
            check(d["report"]["launches"] == {"local_sim_fwd": 0, "local_sim_bwd": 0},
                  f"{phase} driver: no local-similarity kernel on the task path")
            best = json.loads((d["dir"] / "ckpt" / "manifest.json").read_text())["last"]
            trained = load_checkpoint(d["dir"] / "ckpt" / best)[0]["model"]
            size = (d["dir"] / "ckpt" / best / "state.pt").stat().st_size
            saves = d["report"]["checkpoint_saves"]
            log(f"[tasks] {phase} checkpoint {best}: state.pt {size / 1e9:.3f} GB on disk "
                f"(reckoned {ckpt_bytes / 1e9:.3f} GB); save: copy to the host "
                f"{saves[0]['copy_s']:.2f} s, write {saves[0]['write_s']:.2f} s [{card}]")
            check(abs(size - ckpt_bytes) < 0.01 * ckpt_bytes, f"{phase}: checkpoint size")
            if phase == "classification":
                frozen = [k for k in trained if k.startswith(BACKBONE)
                          and not k.endswith(("running_mean", "running_var"))]
                same = all(torch.equal(trained[k], gloria[k]) for k in frozen)
                log(f"[tasks] classification: {len(frozen)} frozen encoder parameters equal to "
                    f"the pretrain checkpoint's after training: {same}")
                check(bool(frozen) and same, "the frozen encoder kept the checkpoint's weights")
            else:
                check(0.0 <= float(row[metric]) <= 1.0, "val_dice in [0, 1]")
            r["driver"] = {"wall_s": d["wall_s"], "seconds": sec, metric: float(row[metric]),
                           "ckpt_gb": size / 1e9}
            shutil.rmtree(work / phase)
            out[phase] = r
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.synchronize()
    out["launches"] = {  # ---- the task path ends: its in-process kernel counts
        "local_sim_fwd": local_sim.launches, "local_sim_bwd": local_sim.launches_bwd,
        "fused_bn_fwd": fused_bn.launches_fwd, "fused_bn_bwd": fused_bn.launches_bwd}
    log(f"[tasks] kernel launches on the task path (this process; each driver run reported "
        f"0 local-similarity launches): {json.dumps(out['launches'])}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[tasks] phase {out['seconds']:.1f} s, beside phase 10's {driver_s:.1f} s [{card}]")
    return out


def write_grounding_mirror(root: Path, seed: int = 0) -> dict:
    """A synthetic MIMIC-CXR / Chest ImaGenome mirror in the JAX package's
    layout (``tests/test_mimic.py``), for phase 12: per image a 512² uint8
    array in the image cache (the size the JAX ingest caches), a report and
    a silver scene graph of 10 objects (boxes inside the image; the
    patient's left on the image's right) and GROUNDING_SENTENCES sentences
    of 6-30 words on 1-3 of them; the split tables (GROUNDING_DICOMS images
    each for train, valid and test; the test split is also the gold set,
    ``images_to_avoid.csv``) and the gold table of the test images' boxes.
    Returns the two mirror directories and counts for the log."""
    import pandas as pd

    from gloria_tpu_torch.data.mimic import GOLD_OBJECTS_FILE, ImaGenomeFiler, MimicCxrFiler

    rng = np.random.RandomState(seed)
    filer = MimicCxrFiler(str(root / "mimic-cxr"))
    imagenome = ImaGenomeFiler(str(root / "chest-imagenome"))
    records, gold_rows, words = [], [], []
    for i in range(3 * GROUNDING_DICOMS):
        dicom = f"{i:08d}-smoke"
        rec = {"subject_id": 10000000 + i // 2, "study_id": 50000000 + i, "dicom_id": dicom}
        records.append(rec)
        path = Path(filer.image_cache_path(dicom))
        path.parent.mkdir(parents=True, exist_ok=True)
        np.save(path, rng.randint(0, 256, (512, 512)).astype(np.uint8))
        objects = []
        for name in rng.choice(GROUNDING_BBOXES, 10, replace=False):
            base = 256 if name.startswith("left") else 0 if name.startswith("right") else 128
            x1, y1 = base + int(rng.randint(0, 120)), int(rng.randint(20, 300))
            x2 = min(511, x1 + int(rng.randint(40, 200)))
            y2 = min(511, y1 + int(rng.randint(40, 200)))
            objects.append({"object_id": f"{dicom}_{name}", "bbox_name": str(name),
                            "original_x1": x1, "original_y1": y1,
                            "original_x2": x2, "original_y2": y2})
        attributes = {o["object_id"]: {"object_id": o["object_id"], "phrase_IDs": [],
                                       "phrases": [], "attributes": []} for o in objects}
        sentences = []
        for k in range(GROUNDING_SENTENCES):
            on = [objects[j] for j in rng.choice(len(objects), rng.randint(1, 4), replace=False)]
            conds = list(rng.choice(GROUNDING_CONDITIONS, rng.randint(1, 3), replace=False))
            text = (["There", "is"] + list(rng.choice(GROUNDING_WORDS[:10], rng.randint(1, 3)))
                    + [" and ".join(conds), "in", "the", " and the ".join(o["bbox_name"] for o in on)])
            text = " ".join(text).split()
            target = int(rng.randint(6, 31))
            text += list(rng.choice(GROUNDING_WORDS, max(0, target - len(text))))
            words.append(len(text))
            text = " ".join(text) + "."
            sentences.append(text)
            for o in on:
                context = str(rng.choice(["yes", "yes", "no"]))
                a = attributes[o["object_id"]]
                a["phrase_IDs"].append(f"{dicom}_s{k}")
                a["phrases"].append(text)
                a["attributes"].append([f"anatomicalfinding|{context}|{c}" for c in conds])
                gold_rows.append({"image_id": f"{dicom}.dcm", "bbox": o["bbox_name"],
                                  "coord_original": "({}, {}, {}, {})".format(
                                      o["original_x1"], o["original_y1"], o["original_x2"],
                                      o["original_y2"]),
                                  "row_id": 1000 * i + k, "sentence": text,
                                  "label_name": conds[0], "context": context})
        sg = Path(imagenome.get_silver_scene_graph_json_file(dicom))
        sg.parent.mkdir(parents=True, exist_ok=True)
        sg.write_text(json.dumps({"objects": objects, "attributes": list(attributes.values())}))
        report = Path(filer.get_full_path(filer.report_relpath(rec["subject_id"], rec["study_id"])))
        report.parent.mkdir(parents=True, exist_ok=True)
        report.write_text("FINDINGS: " + " ".join(sentences))
    df = pd.DataFrame(records)
    splits = Path(imagenome.get_full_path("silver_dataset/splits"))
    splits.mkdir(parents=True, exist_ok=True)
    n = GROUNDING_DICOMS
    for k, name in enumerate(("train", "valid", "test")):
        df.iloc[k * n : (k + 1) * n].to_csv(splits / f"{name}.csv", index=False)
    df.iloc[2 * n :].to_csv(splits / "images_to_avoid.csv", index=False)
    gold = pd.DataFrame([r for r in gold_rows if r["image_id"][:-4] in set(df.iloc[2 * n :].dicom_id)])
    Path(imagenome.get_full_path("gold_dataset")).mkdir(parents=True, exist_ok=True)
    gold.to_csv(imagenome.get_full_path(f"gold_dataset/{GOLD_OBJECTS_FILE}"), sep="\t", index=False)
    return {"mimic": str(root / "mimic-cxr"), "imagenome": str(root / "chest-imagenome"),
            "words": (min(words), max(words)), "gold_rows": len(gold)}


def grounding_config(name: str, mirror: dict):
    """Phase 12's config ``name`` (``finetune``, ``val``): the shipped config
    with the overrides the card's run needs, each returned for printing."""
    from gloria_tpu_torch.configs import load_config

    cfg = load_config(str(ROOT / GROUNDING_CONFIGS[name]))
    overrides = {
        "lightning.trainer.precision": 32,  # bf16 is ROADMAP.md A1.2
        # the vocabulary from the corpus, as phases 8 and 10 make it
        "model.text.bert_type": None,
        # the synthetic mirror: the repository holds no MIMIC-CXR or ImaGenome data
        "data.mimic_cxr_download_directory": mirror["mimic"],
        "data.imagenome_download_directory": mirror["imagenome"],
    }
    if name == "finetune":
        overrides["lightning.trainer.max_epochs"] = 1
    for path, value in overrides.items():
        cfg.set_path(path, value)
    return cfg, overrides


def check_localization(run_dir: Path, splits: dict, what: str) -> dict:
    """Each split's ``localization/<split>/sentences.csv`` with its expected
    row count, its five artifact folders with one file a row, and a finite
    AUROC exactly on the rows whose label has a box pixel; returns the
    tables."""
    import pandas as pd

    tables = {}
    for split, rows in splits.items():
        d = run_dir / "localization" / split
        check((d / "sentences.csv").is_file(), f"{what}: localization/{split}/sentences.csv")
        df = pd.read_csv(d / "sentences.csv")
        check(len(df) == rows, f"{what} {split}: {len(df)} sentence rows, {rows} expected")
        for folder in ("attn", "image", "label", "roc_curve", "pr_curve"):
            check(len(list((d / folder).iterdir())) == rows, f"{what} {split}: {folder}/ complete")
        boxed = np.asarray([np.load(d / "label" / f"{sid}.npy").sum() > 0
                            for sid in df["dicom_sent_id"]])
        check(bool((np.isfinite(df["auroc"].to_numpy()) == boxed).all()),
              f"{what} {split}: AUROC finite exactly where the label has a box")
        check(bool(boxed.any()), f"{what} {split}: some labels have a box")
        tables[split] = df
    return tables


def phase_grounding(card: str, pretrain_ckpt: Path) -> dict:
    """Phase 12: the ImaGenome grounding path at full width from phase 10's
    best checkpoint: its train step's K1 and K2 inputs, the step with and
    without ``return_attn``, ``EvaluateLocalization.evaluate_batch``, one
    B=8 step card vs CPU, then ``python -m gloria_tpu_torch.run`` on both
    imagenome configs."""
    import torch

    from gloria_tpu_torch import builder
    from gloria_tpu_torch.configs import Config, loads_config, save_config
    from gloria_tpu_torch.data.data_module import build_data_module
    from gloria_tpu_torch.experiments import fused_bn
    from gloria_tpu_torch.ops import gloria_loss, local_sim
    from gloria_tpu_torch.training import train
    from gloria_tpu_torch.training.checkpoints import load_checkpoint
    from gloria_tpu_torch.training.localization import (EvaluateLocalization,
                                                        batch_localization_metrics,
                                                        sentence_attention)
    from gloria_tpu_torch.utils.viz import get_attn_overlay

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    fused_bn.launches_fwd = fused_bn.launches_bwd = 0  # this phase runs neither
    out: dict = {}
    work = Path(tempfile.mkdtemp(prefix="gloria_smoke_grounding_"))
    try:
        t = time.perf_counter()
        mirror = write_grounding_mirror(work / "mirror")
        log(f"[grounding] synthetic MIMIC-CXR / ImaGenome mirror in {work}: "
            f"{GROUNDING_DICOMS} images a split (512² uint8), 10 silver objects and "
            f"{GROUNDING_SENTENCES} sentences each ({mirror['words'][0]}-{mirror['words'][1]} "
            f"words), {mirror['gold_rows']} gold rows; written in {time.perf_counter() - t:.1f} s")
        cfg, overrides = grounding_config("finetune", mirror)
        log(f"[grounding] {GROUNDING_CONFIGS['finetune']} read by gloria_tpu_torch.configs."
            "load_config; overrides: " + ", ".join(f"{k}={v!r}" for k, v in overrides.items()))
        batch_size = int(cfg.train.batch_size)

        # ---- in-process: the full-width train step on a mirror batch
        weights = load_checkpoint(pretrain_ckpt)[0]["model"]
        t = time.perf_counter()
        module = build_data_module(cfg, device="cuda")
        it = iter(module.train_dataloader())
        batch = next(it)
        del it
        log(f"[grounding] imagenome data module (vocabulary from the corpus) and one train "
            f"batch of {batch_size} on the card: {time.perf_counter() - t:.1f} s")
        model = builder.build_gloria_model(cfg, seed=0)
        model.load_state_dict(weights, strict=True)
        model.img_encoder.to(memory_format=torch.channels_last)
        tx = builder.build_optimizer(cfg, model)
        state = train.create_train_state(model, tx, seed=0, device="cuda")
        attn_step, _ = train.make_pretrain_steps(model, tx, return_attn=True)
        plain_step, _ = train.make_pretrain_steps(model, tx)
        seen = {}
        fwd, bwd = local_sim._similarities, local_sim._similarities_bwd

        def record_fwd(words, regions, mask, temp1, temp2, agg):
            seen["fwd"] = (words, regions, mask, {"temp1": temp1, "temp2": temp2, "agg": agg})
            return fwd(words, regions, mask, temp1, temp2, agg)

        def record_bwd(words, regions, mask, g, temp1, temp2, agg, packed=None):
            seen["bwd"] = (words, regions, mask, g, {"temp1": temp1, "temp2": temp2, "agg": agg})
            return bwd(words, regions, mask, g, temp1, temp2, agg, packed=packed)

        local_sim._similarities, local_sim._similarities_bwd = record_fwd, record_bwd
        try:
            state, m = attn_step(state, batch)
        finally:
            local_sim._similarities, local_sim._similarities_bwd = fwd, bwd
        torch.cuda.synchronize()
        (B, W, R), side = m["_attn"].shape, int(round(m["_attn"].shape[2] ** 0.5))
        check((B, W, R) == (batch_size, int(cfg.data.text.word_num), side * side),
              f"_attn {B} x {W} x {R}: a batch's texts by words by the regions' square grid")
        check(all(bool(torch.isfinite(m[k]).all()) for k in m), "grounding step: finite outputs")
        check(float(m["attn_seg_loss"]) > 0, "grounding step: attn_seg_loss > 0")
        words, regions, mask, _ = seen["fwd"]
        log(f"[grounding] train step at B={B}: {int(mask.sum())} valid words over {B} texts "
            f"(cap_len {int(batch['cap_lens'].min())}-{int(batch['cap_lens'].max())}), "
            f"loss {float(m['loss']):.5f}, attn_seg_loss {float(m['attn_seg_loss']):.5f}")
        out["k1"] = k1_numbers(*seen["fwd"], "grounding train step's", card, 5, 2)
        out["k2"] = k2_numbers(*seen["bwd"], "grounding train step's", card)
        del seen, words, regions, mask

        launches = {}
        for name, step in (("return_attn", attn_step), ("plain", plain_step)):
            local_sim.launches = local_sim.launches_bwd = 0
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            launches[name] = (local_sim.launches, local_sim.launches_bwd)
        check(launches["return_attn"] == launches["plain"] == (1, 1),
              f"one K1 and one K2 launch a step, with and without return_attn: {launches}")
        step_ms = {}
        for name, step in (("return_attn", attn_step), ("plain", plain_step),
                           ("return_attn again", attn_step), ("plain again", plain_step)):
            step_ms[name] = cuda_ms(lambda: step(state, batch), 1)
        out["step_ms"] = step_ms
        log(f"[grounding] train step at B={B} (median of 5 after a warm-up, CUDA events): "
            + ", ".join(f"{k} {v:.2f} ms ({B / v * 1e3:.1f} pairs/s)" for k, v in step_ms.items())
            + f" [{card}]")

        # what return_attn adds to a step, timed alone on one train-mode forward
        with torch.no_grad():
            model.train()
            img_l, img_g, txt_l, txt_g, grid = model(batch, generator=torch.Generator(
                device="cuda").manual_seed(0))
            _, _, attn = model.calc_loss(img_l, img_g, txt_l, txt_g, batch["cap_lens"], grid,
                                         batch["segmentation_labels"])
            out["attention_outputs_ms"] = cuda_ms(lambda: train.attention_outputs(
                model, batch, img_l, img_g, txt_l, txt_g, attn), 5)
            del img_l, img_g, txt_l, txt_g, attn
        log(f"[grounding] train.attention_outputs alone (what return_attn adds: the aligned "
            f"eval-path attention for _local_sims, the global diagonal, detaching _attn): "
            f"{out['attention_outputs_ms']:.3f} ms (CUDA events) [{card}]")

        state, m = attn_step(state, batch)
        attn = m["_attn"]
        valid = gloria_loss.make_word_mask(batch["cap_lens"], W, "train")
        rows = attn[valid]
        even = float(((rows.amax(-1) - rows.amin(-1)) < 1e-6).float().mean())
        log(f"[grounding] phase 10's weights on the mirror: the valid words' attention spans "
            f"{float(rows.min()):.3e}-{float(rows.max()):.3e} (uniform {1 / R:.3e}); "
            f"{even:.1%} of the valid words attend evenly to every region")
        del rows
        sims = {"local": m["_local_sims"], "global": m["_global_sims"]}
        eval_ms = {}
        for full in (False, True):
            cb = EvaluateLocalization(cfg, save_full_data=full)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                means = cb.evaluate_batch(m["_attn"], batch, sims=sims, split="train")
                times.append((time.perf_counter() - t) * 1e3)
            eval_ms["with curves and artifacts" if full else "rows only"] = statistics.median(times)
            check(np.isfinite(means["auroc"]), "evaluate_batch: finite mean AUROC")
        out["evaluate_ms"] = eval_ms
        log(f"[grounding] EvaluateLocalization.evaluate_batch on {B} sentences (host clock, "
            f"median of 5; overlays and curves on the host, metrics on the card): "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in eval_ms.items()) + f" [{card}]")
        del model, state, tx, attn_step, plain_step, m, attn, valid, sims, batch, module
        torch.cuda.empty_cache()

        # ---- card vs CPU: one B=8 batch, dropout 0, the same weights: seed 0's,
        # whose attention is not uniform (each word peaks on a region)
        small = Config(cfg.to_dict())
        small.train.batch_size, small.train.num_workers = GROUNDING_CHECK_BATCH, 1
        small.set_path("model.text.bert_config.dropout_rate", 0.0)
        raw = next(iter(build_data_module(small, device="cpu").loader("train", prefetch=1)))
        cpu_model = builder.build_gloria_model(small, seed=0)
        gpu_model = copy.deepcopy(cpu_model).cuda()
        t = time.perf_counter()
        got = {"cuda": train.loss_and_grads(gpu_model, train.to_device(raw, torch.device("cuda")),
                                            return_attn=True)[0],
               "cpu": train.loss_and_grads(cpu_model, raw, return_attn=True)[0]}
        seconds = time.perf_counter() - t
        labels = raw["segmentation_labels"]
        metrics = {}
        for device, mm in got.items():
            grid = sentence_attention(mm["_attn"], raw["cap_lens"], (side, side))
            overlays = np.stack([get_attn_overlay(g, tuple(labels.shape[1:3])) for g in grid])
            metrics[device] = batch_localization_metrics(overlays, labels.to(device), grid)
        errs = {k: abs(float(got["cuda"][k]) - float(got["cpu"][k])) / abs(float(got["cpu"][k]))
                for k in ("loss", "attn_seg_loss")}
        diffs = {k: float((got["cuda"][k].cpu() - got["cpu"][k]).abs().max())
                 for k in ("_attn", "_local_sims", "_global_sims")}
        metric_diffs = {k: float(np.nanmax(np.abs(metrics["cuda"][k] - metrics["cpu"][k]), initial=0))
                        for k in metrics["cpu"]}
        same_nan = all(np.array_equal(np.isnan(metrics["cuda"][k]), np.isnan(metrics["cpu"][k]))
                       for k in metrics["cpu"])
        valid = gloria_loss.make_word_mask(raw["cap_lens"], W, "train")
        peak = float(got["cpu"]["_attn"][valid].max())
        log(f"[grounding] card vs CPU, one B={GROUNDING_CHECK_BATCH} mirror batch through the "
            f"train step with return_attn (dropout 0, seed 0's weights, the valid words' "
            f"attention up to {peak:.4f} against a uniform {1 / R:.3e}; {seconds:.1f} s): "
            + ", ".join(f"{k} relative {v:.2e}" for k, v in errs.items())
            + f" (tol {STEP_LOSS_RTOL}); max_abs_diff _attn {diffs['_attn']:.3e} (tol "
            f"{GROUNDING_ATTN_TOL}), _local_sims {diffs['_local_sims']:.3e}, _global_sims "
            f"{diffs['_global_sims']:.3e} (tol {GROUNDING_SIMS_TOL}); localization metrics "
            "max_abs_diff " + ", ".join(f"{k} {v:.3e}" for k, v in metric_diffs.items())
            + f" (tol {GROUNDING_METRIC_TOL}, top-k {GROUNDING_TOPK_TOL})")
        check(all(v <= STEP_LOSS_RTOL for v in errs.values()), "grounding losses card vs CPU")
        check(diffs["_attn"] <= GROUNDING_ATTN_TOL, "grounding _attn card vs CPU")
        check(max(diffs["_local_sims"], diffs["_global_sims"]) <= GROUNDING_SIMS_TOL,
              "grounding per-pair similarities card vs CPU")
        check(same_nan, "the same rows without a box, card and CPU")
        check(peak > 2 / R, "card vs CPU on an attention that is not uniform")
        for k, v in metric_diffs.items():
            check(v <= GROUNDING_METRIC_TOL.get(k, GROUNDING_TOPK_TOL),
                  f"localization metric {k} card vs CPU")
        out["card_vs_cpu"] = {"rel": errs, "max_abs": diffs, "metrics": metric_diffs}
        del gpu_model, cpu_model, got, raw, weights, valid
        torch.cuda.empty_cache()

        # ---- the driver on both configs
        free = shutil.disk_usage(work).free
        need = checkpoint_bytes(cfg)[1] + (512 << 20)
        check(free >= need, f"{need / 1e9:.2f} GB free in {work} (found {free / 1e9:.2f} GB)")
        val_cfg, val_overrides = grounding_config("val", mirror)
        log(f"[grounding] {GROUNDING_CONFIGS['val']}: overrides "
            + ", ".join(f"{k}={v!r}" for k, v in val_overrides.items()))
        save_config(cfg, str(work / "finetune.yaml"))
        save_config(val_cfg, str(work / "val.yaml"))
        runs = {"finetune": run_driver(work / "finetune.yaml", work / "finetune", "--train",
                                       "--test", "--ckpt", str(pretrain_ckpt))}
        best = loads_config((work / "finetune" / "best_ckpts.yaml").read_text()).seed_0
        check(best is not None and (Path(best) / "state.pt").is_file(),
              "the finetune run's best_ckpts.yaml names a checkpoint")
        runs["val"] = run_driver(work / "val.yaml", work / "val", "--test", "--ckpt", best)
        runs["val --swap_left_right"] = run_driver(work / "val.yaml", work / "swap", "--test",
                                                   "--ckpt", best, "--swap_left_right")
        for name, r in runs.items():
            log_run(name, r, card, tag="grounding", batch=batch_size)
        ft = runs["finetune"]
        check(len(ft["epochs"]) == 1 and all(np.isfinite(float(ft["epochs"][0][k]))
                                             for k in ("train_loss", "val_loss")),
              "finetune: one epoch with finite train and val losses")
        # the train metrics go to metrics_train.jsonl every update_interval (1000)
        # steps, so the first step's; the epoch row holds the mean loss
        steps = [json.loads(ln) for ln in open(ft["dir"] / "metrics_train.jsonl")]
        steps = [r for r in steps if "loss" in r]
        epoch = {k: float(v) for k, v in ft["epochs"][0].items() if k.startswith("val_")}
        log(f"[grounding] finetune logged train steps: " + "; ".join(
            f"step {r['step']} loss {r['loss']:.5f}, attn_seg_loss {r['attn_seg_loss']:.5f}"
            for r in steps) + "; epoch: " + ", ".join(f"{k} {v:.5f}" for k, v in epoch.items()))
        check(bool(steps) and all(np.isfinite(r["loss"]) and r["attn_seg_loss"] > 0
                                  for r in steps), "finetune: finite loss, attn_seg_loss > 0")
        check(all(np.isfinite(v) for v in epoch.values()) and epoch["val_attn_seg_loss"] > 0,
              "finetune: finite validation losses, val_attn_seg_loss > 0")
        rows = DRIVER_BATCHES * batch_size
        tables = {"finetune": check_localization(ft["dir"], {"train": batch_size, "val": rows,
                                                             "test": rows}, "finetune")}
        for name in ("val", "val --swap_left_right"):
            tables[name] = check_localization(runs[name]["dir"], {"test": rows}, name)
        expected = {"finetune": (3 * DRIVER_BATCHES, DRIVER_BATCHES), "val": (DRIVER_BATCHES, 0),
                    "val --swap_left_right": (DRIVER_BATCHES, 0)}
        for name, r in runs.items():
            got_l = r["report"]["launches"]
            log(f"[grounding] run {name} launches: local_sim_fwd {got_l['local_sim_fwd']}, "
                f"local_sim_bwd {got_l['local_sim_bwd']}")
            check((got_l["local_sim_fwd"], got_l["local_sim_bwd"]) == expected[name],
                  f"{name}: one K1 launch a train and an eval step, one K2 launch a train step")
        plain, swapped = tables["val"]["test"], tables["val --swap_left_right"]["test"]
        differ = int((plain["sentence"] != swapped["sentence"]).sum())
        sided = int(plain["sentence"].str.contains("left|right").sum())
        log(f"[grounding] --swap_left_right: {differ} of {len(plain)} test sentences differ from "
            f"the plain run's ({sided} name left or right); mean AUROC plain "
            f"{np.nanmean(plain['auroc']):.4f}, swapped {np.nanmean(swapped['auroc']):.4f}")
        check(differ > 0 and differ >= sided, "the swapped run's sentences differ")
        ref = tables["finetune"]["test"]
        again = {k: float(np.nanmax(np.abs(plain[k] - ref[k]), initial=0))
                 for k in ("auroc", "local_sims", "global_sims")}
        log(f"[grounding] the val config on the finetune run's checkpoint against that run's own "
            f"test rows: max_abs_diff " + ", ".join(f"{k} {v:.3e}" for k, v in again.items()))
        check(list(plain["dicom_sent_id"]) == list(ref["dicom_sent_id"])
              and max(again.values()) <= 1e-3, "the val config reproduces the finetune test rows")
        out["launches"] = tuple(sum(r["report"]["launches"][k] for r in runs.values())
                                for k in ("local_sim_fwd", "local_sim_bwd"))
        out["runs"] = {name: {"wall_s": r["wall_s"], "seconds": r["report"]["seconds"]}
                       for name, r in runs.items()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["fused_launches"] = {"fwd": fused_bn.launches_fwd, "bwd": fused_bn.launches_bwd}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[grounding] launches on the grounding path (its three driver runs): local_sim_fwd "
        f"{out['launches'][0]}, local_sim_bwd {out['launches'][1]}; fused_bn_fwd / bwd in this "
        f"process {out['fused_launches']['fwd']} / {out['fused_launches']['bwd']}")
    log(f"[grounding] phase {out['seconds']:.1f} s [{card}]")
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

    keep = Path(tempfile.mkdtemp(prefix="gloria_smoke_pretrained_"))
    try:
        # ---- 10. driver: python -m gloria_tpu_torch.run at full width -------
        t10 = time.perf_counter()
        dr = phase_driver(card, keep)

        # ---- 11. tasks: classification and segmentation from phase 10's best
        tk = phase_tasks(card, dr["best"], time.perf_counter() - t10)

        # ---- 12. grounding: the ImaGenome configs from phase 10's best
        gr = phase_grounding(card, dr["best"])
        worst_err = max(worst_err, gr["k1"]["err"])
        bwd_err, bwd_ratio = max(bwd_err, gr["k2"]["err"]), max(bwd_ratio, gr["k2"]["ratio"])
    finally:
        shutil.rmtree(keep, ignore_errors=True)

    # ---- 13. bf16 step: the pretrain step with the towers in bf16 ------------
    bf = phase_bf16(card, tr)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # ---- 14. result lines -------------------------------------------------
    log(card)
    log(json.dumps({"kernels": [{
        "name": "local_sim_fwd", "route": "cuda",
        "source": "gloria_tpu_torch/csrc/local_sim_fwd.cu",
        "replaces": "gloria_tpu/ops/pallas/local_sim.py:126",
        "launches": main_path_launches + tr["launches"][0] + ld["launches"][0]
        + dr["launches"][0] + gr["launches"][0] + bf["launches"][0],
        "launches_by_path": {"serve": main_path_launches, "train": tr["launches"][0],
                             "loader_train": ld["launches"][0], "driver": dr["launches"][0],
                             "tasks": tk["launches"]["local_sim_fwd"],
                             "grounding": gr["launches"][0], "bf16_train": bf["launches"][0]},
        "max_abs_err": worst_err, "ms": s1["ms"], "plain_ms": s1["plain_ms"],
        "bound_ms": s1["bound_ms"], "bound_by": s1["bound_by"],
        "bound_rate": "3xTF32: 495/3 TFLOP/s of f32 products",
        "bound_f32_ms": s1["bound_f32_ms"], "library_ms": None, "passes_ms": s1["passes"],
        "wrapper_ms": s1["wrapper_ms"], "workspace_bytes": s1["workspace_bytes"],
    } | {f"train_{k}": tr["k1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "bound_f32_ms", "wrapper_ms", "workspace_bytes")}
      | {"train_passes_ms": tr["k1"]["passes"]}
      | {f"grounding_{k}": gr["k1"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "bound_f32_ms", "wrapper_ms",
                                                  "workspace_bytes")}
      | {"grounding_passes_ms": gr["k1"]["passes"]}, {
        "name": "local_sim_bwd", "route": "cuda",
        "source": "gloria_tpu_torch/csrc/local_sim_bwd.cu",
        "replaces": "gloria_tpu/ops/pallas/local_sim.py:164",
        "launches": tr["launches"][1] + ld["launches"][1] + dr["launches"][1]
        + gr["launches"][1] + bf["launches"][1],
        "launches_by_path": {"train": tr["launches"][1], "loader_train": ld["launches"][1],
                             "driver": dr["launches"][1],
                             "tasks": tk["launches"]["local_sim_bwd"],
                             "grounding": gr["launches"][1], "bf16_train": bf["launches"][1]},
        "max_abs_err": bwd_err, "max_err_over_tol": bwd_ratio, "ms": tr["k2_ms"],
        "plain_ms": tr["k2_plain_ms"], "bound_ms": tr["k2_bound_ms"],
        "bound_by": tr["k2_bound_by"], "bound_rate": "3xTF32: 495/3 TFLOP/s of f32 products",
        "bound_f32_ms": tr["k2_bound_f32_ms"], "library_ms": None,
        "passes_ms": tr["k2_passes"],
    } | {f"grounding_{k}": gr["k2"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "bound_f32_ms", "passes")}] + [{
        "name": f"fused_bn_{key}", "route": "cuda",
        "source": f"gloria_tpu_torch/csrc/fused_bn_{key}.cu",
        "replaces": f"scripts/experiments/fused_bn.py:{line}",
        "launches": launches,
        "launches_by_path": {"fused_tail": launches, "tasks": tk["launches"][f"fused_bn_{key}"],
                             "grounding": gr["fused_launches"][key],
                             "bf16_train": bf["fused_launches"][key]},
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
