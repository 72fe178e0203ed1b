#!/usr/bin/env python3
"""Chip smoke test of gloria_tpu_torch, the PyTorch + CUDA port, on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. device  — the card's name and power limit (nvidia-smi) and the device
   count; TF32 is switched off for convolutions and matrix products, so the
   whole run is f32 and comparable with the CPU path.
2. build   — nvcc builds every kernel of the serving path from
   ``gloria_tpu_torch/csrc`` for sm_90a into ``build/kernels/``.
3. kernel  — each kernel against its plain PyTorch version on probes: the
   serving shape with and without the no-attention sink, the eval and the
   train word masks, caption lengths 0, 1 and W-2, and B, T above 128.
4. slice   — the full-width model (ResNet-50 + BERT-base, 97 words, 224 px
   crops upsampled to 299², D=768) built from a seed serves zero-shot
   requests through ``InferenceEngine.classify`` (1, 5 and 64 images), a
   ``DynamicBatcher`` and ``serve_http``'s ``POST /classify``; kernel launch
   counts are read around exactly this main-path run.  Its scores are held
   against the same model run on the CPU, where the local similarity is the
   plain version.
5. kernels — each kernel again at the inputs the main path gave it: error
   against the plain version, median time from CUDA events, the plain
   version's time, and the bound computed from those inputs.
6. one ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import base64
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
H100_HBM_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-3   # f32 both sides, summation order differs; sims are log-values of O(1-20)
SLICE_TOL = 1e-3    # card (CUDA kernel, cuDNN convolutions) vs CPU (plain version, oneDNN)
BATCH_TOL = 1e-3    # one image scored alone vs inside a batch of 64


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


def local_sim_bound(words, regions, mask) -> tuple[float, str]:
    """Least time for these inputs: the two products the kernel must do
    (region·word logits, then the attention-weighted context), counted over
    the valid words only, at the f32 peak; against every input read once and
    the output written once at the HBM rate.  Softmax and exp work (under 2%
    of the operations) is left out."""
    T, W, D = words.shape
    B, S, _ = regions.shape
    valid = int((mask > 0).sum())
    ops = 2 * 2 * B * S * D * valid
    nbytes = 4 * (words.numel() + regions.numel() + mask.numel() + B * T)
    t_ops, t_bytes = ops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


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
    return worst


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
    log(card)
    log(f"[device] {kind}, {count} device(s), torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"cudnn.allow_tf32=False, cuda.matmul.allow_tf32=False (f32 throughout)")

    # ---- 2. build ---------------------------------------------------------
    built = cuda_build.build(["local_sim_fwd"])
    for name, b in built.items():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {b.seconds:.1f} s -> {b.path.name}; " + " | ".join(ptxas))

    # ---- 3. kernel probes ---------------------------------------------------
    worst_err = phase_kernel_probes()

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
        got = local_sim.local_similarities(words, regions, mask, agg="max")
        ref = local_sim.local_similarities_plain(words, regions, mask, agg="max")
        err = float((got - ref).abs().max())
        check(err <= KERNEL_TOL, f"local_sim_fwd vs plain at the main path's inputs: {err}")
        worst_err = max(worst_err, err)
        k_ms = cuda_ms(lambda: local_sim.local_similarities(words, regions, mask, agg="max"), iters=20)
        p_ms = cuda_ms(lambda: local_sim.local_similarities_plain(words, regions, mask, agg="max"),
                       iters=3)
        bound_ms, bound_by = local_sim_bound(words, regions, mask)
        classify_ms = cuda_ms(lambda: engine.classify(imgs), iters=3)
    valid = int(mask.sum())
    log(f"[kernels] local_sim_fwd at the main path's inputs: B={regions.shape[0]} T={words.shape[0]} "
        f"W={words.shape[1]} S={regions.shape[1]} D={words.shape[2]}, {valid} valid words; "
        f"max_abs_err={err:.3e}; kernel {k_ms:.4f} ms, plain version {p_ms:.4f} ms "
        f"(not a yardstick), bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call "
        f"computes this function [{card}]")
    log(f"[kernels] where classify(64) goes: {classify_ms:.2f} ms in all, image tower "
        f"{tower_ms:.2f} ms, local_sim_fwd {k_ms:.3f} ms [{card}]")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # ---- 6. result lines --------------------------------------------------
    log(card)
    log(json.dumps({"kernels": [{
        "name": "local_sim_fwd", "route": "cuda",
        "source": "gloria_tpu_torch/csrc/local_sim_fwd.cu",
        "replaces": "gloria_tpu/ops/pallas/local_sim.py:126",
        "launches": main_path_launches, "max_abs_err": worst_err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
