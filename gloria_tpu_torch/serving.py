"""Inference serving: shape-bucketed, dynamically batched zero-shot.

Port of ``gloria_tpu.serving`` without the mesh and retrieval parts:

- **Shape buckets.** Every image batch is padded to the next power-of-two
  bucket (≤ ``max_batch``), so the device only ever sees
  ``log2(max_batch)+1`` batch shapes; ``warmup()`` runs each once ahead of
  traffic.  The static shapes are what a later CUDA-graph capture needs.
- **Encode once, score per class.** ``set_classes`` tokenizes and encodes
  every class's prompts once; a request runs the image tower once and one
  scoring pass over all prompts.  The local part of the score is the CUDA
  kernel :mod:`gloria_tpu_torch.ops.local_sim` (one launch per chunk of at
  most ``max_batch`` images).
- **Device-side normalization.** Clients send uint8 pixels; the model
  normalizes them on the device in f32.
- **Dynamic batching.** ``DynamicBatcher`` coalesces concurrent requests up
  to ``max_batch`` or ``max_wait_ms`` and resolves
  ``concurrent.futures.Future``s.
- **Stdlib HTTP front end.** ``serve_http`` exposes ``POST /classify``
  (JSON ``{"paths": [...]}`` or ``{"arrays_b64": ...}``), ``GET /healthz``
  and ``GET /stats``.

Run it with ``python -m gloria_tpu_torch.serving --ckpt <file.ckpt>``.
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from .api import EVAL_TEMP1, EVAL_TEMP2, GloriaModel, generate_chexpert_class_prompts
from .data.transforms import center_crop, letterbox_resize, to_rgb
from .models.precision import require_float32
from .ops import gloria_loss


class ServingStats:
    """Thread-safe request accounting for the ``/stats`` endpoint.

    Latencies keep a bounded window (the last ``window`` samples per
    endpoint), so a long-lived server reports recent percentiles."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._window = window
        self.started = time.time()
        self.requests: Counter = Counter()
        self.errors: Counter = Counter()
        self.images = 0
        self._latency: dict[str, deque] = {}

    def record(self, endpoint: str, seconds: float, images: int = 0, error: bool = False) -> None:
        with self._lock:
            self.requests[endpoint] += 1
            self.images += images
            if error:
                self.errors[endpoint] += 1
            else:  # errors fail fast; mixing them in would skew the tail
                self._latency.setdefault(endpoint, deque(maxlen=self._window)).append(seconds)

    def snapshot(self) -> dict:
        with self._lock:
            latency = {}
            for ep, window in self._latency.items():
                ms = np.asarray(window, np.float64) * 1e3
                latency[ep] = {
                    "n": int(ms.size),
                    "p50_ms": round(float(np.percentile(ms, 50)), 3),
                    "p90_ms": round(float(np.percentile(ms, 90)), 3),
                    "p99_ms": round(float(np.percentile(ms, 99)), 3),
                    "max_ms": round(float(ms.max()), 3),
                }
            return {
                "uptime_s": round(time.time() - self.started, 3),
                "requests": dict(self.requests),
                "errors": dict(self.errors),
                "images": self.images,
                "latency": latency,
            }


def _next_bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class InferenceEngine:
    """Zero-shot scoring over a loaded :class:`GloriaModel`."""

    def __init__(self, model: GloriaModel, classes: dict | None = None, max_batch: int = 64):
        require_float32(model.model, "the served forward", "A1.2b")
        self.model = model
        self.max_batch = max_batch
        self._class_names: list[str] = []
        if classes is not None:
            self.set_classes(classes)

    # -- class prompt cache --------------------------------------------------
    def set_classes(self, cls_txt_mapping: dict) -> None:
        """Tokenize + encode each class's prompts once and stack them."""
        stacked_l, stacked_g, stacked_caps, class_ids = [], [], [], []
        for ci, prompts in enumerate(cls_txt_mapping.values()):
            txt = self.model.process_text(list(prompts))
            txt_l, txt_g = self.model.encode_text(txt)
            stacked_l.append(txt_l)
            stacked_g.append(txt_g)
            stacked_caps.append(np.asarray(txt["cap_lens"]))
            class_ids.extend([ci] * txt_l.shape[0])
        device = self.model.device
        self._txt_l = torch.cat(stacked_l).contiguous()
        self._txt_g = torch.cat(stacked_g)
        self._caps = torch.as_tensor(np.concatenate(stacked_caps), dtype=torch.long, device=device)
        # [P_total, C]: 0 where the prompt belongs to the class, -inf elsewhere,
        # so the per-class max over prompts is one masked reduction
        bias = np.full((len(class_ids), len(cls_txt_mapping)), -np.inf, np.float32)
        bias[np.arange(len(class_ids)), class_ids] = 0.0
        self._class_bias = torch.as_tensor(bias, device=device)
        self._class_names = list(cls_txt_mapping.keys())

    @property
    def class_names(self) -> list[str]:
        return list(self._class_names)

    # -- device programs -----------------------------------------------------
    def _bucket(self, n: int) -> int:
        return _next_bucket(n, self.max_batch)

    def _padded(self, imgs: np.ndarray) -> torch.Tensor:
        n = imgs.shape[0]
        bucket = self._bucket(n)
        if bucket != n:
            imgs = np.concatenate([imgs, np.zeros((bucket - n,) + imgs.shape[1:], imgs.dtype)])
        return torch.from_numpy(np.ascontiguousarray(imgs)).to(self.model.device)

    def encode_images(self, imgs: np.ndarray):
        """[B, H, W, 3] float32 or uint8 → (img_emb_l [B, R, D], img_emb_g [B, D]),
        padded to the bucket on the device and stripped on return."""
        imgs = np.asarray(imgs)
        n = imgs.shape[0]
        if n > self.max_batch:
            parts = [self.encode_images(imgs[i : i + self.max_batch])
                     for i in range(0, n, self.max_batch)]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
        emb_l, emb_g = self.model.encode_images(self._padded(imgs))
        return emb_l[:n], emb_g[:n]

    def warmup(self, imsize: int | None = None, float32: bool = False) -> None:
        """Run every bucket once ahead of traffic (uint8 input; ``float32=True``
        also runs float input)."""
        if imsize is None:
            imsize = self.model.crop_size or self.model.imsize
        sizes = []
        b = 1
        while b < self.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch)  # the cap is a bucket even if not a power of two
        for b in sizes:
            for dtype in (np.uint8,) + ((np.float32,) if float32 else ()):
                x = np.zeros((b, imsize, imsize, 3), dtype)
                if self._class_names:
                    self.classify(x)
                else:
                    self.encode_images(x)

    # -- scoring -------------------------------------------------------------
    @torch.inference_mode()
    def _score(self, imgs: np.ndarray) -> np.ndarray:
        """One bucket: image tower + local/global similarities + per-class max."""
        n = imgs.shape[0]
        img_l, img_g = self.model.encode_images(self._padded(imgs))
        local = gloria_loss.local_similarities_eval(
            img_l, self._txt_l, self._caps, temp1=EVAL_TEMP1, temp2=EVAL_TEMP2,
            sink=self.model.model.no_attn_vec)
        glob = gloria_loss.global_similarities(img_g, self._txt_g)
        sims = (local + glob) / 2.0                                   # [B, P_total]
        scores = (sims[:, :, None] + self._class_bias[None]).amax(dim=1)  # [B, C]
        return scores[:n].cpu().numpy()

    def classify(self, imgs: np.ndarray, z_normalize: bool = False) -> np.ndarray:
        """[B, H, W, 3] processed images → [B, C] class scores
        (max-over-prompts mean of local and global similarity; z-norm across
        the batch is opt-in — it is degenerate for single-image requests)."""
        if not self._class_names:
            raise RuntimeError("no classes set — call set_classes() first")
        imgs = np.asarray(imgs)
        n = imgs.shape[0]
        arr = np.concatenate([self._score(imgs[i : i + self.max_batch])
                              for i in range(0, max(n, 1), self.max_batch)])
        if z_normalize and arr.shape[0] > 1:
            arr = (arr - arr.mean(axis=0)) / arr.std(axis=0)
        return arr

    def process_img_uint8(self, paths_or_arrays) -> np.ndarray:
        """Host letterbox + crop, kept uint8; ToTensor + Normalize happen on
        the device.  cv2 is needed only to read paths and to resize arrays
        whose long side is not ``imsize``."""
        imsize, crop = self.model.imsize, self.model.crop_size
        if isinstance(paths_or_arrays, (str, Path, np.ndarray)):
            paths_or_arrays = [paths_or_arrays]
        out = []
        for p in paths_or_arrays:
            if isinstance(p, (str, Path)):
                import cv2

                x = cv2.imread(str(p), 0)
            else:
                x = np.asarray(p)
            x = to_rgb(letterbox_resize(x, imsize))
            if crop and crop != imsize:
                x = center_crop(x, crop)
            out.append(x)
        return np.stack(out).astype(np.uint8)

    def classify_paths(self, paths: Sequence[str], **kw) -> np.ndarray:
        return self.classify(self.process_img_uint8(list(paths)), **kw)


class DynamicBatcher:
    """Coalesces concurrent single/short requests into bucket-sized device
    batches; callers receive Futures of their per-image score rows."""

    def __init__(self, engine: InferenceEngine, max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, imgs: np.ndarray) -> Future:
        """imgs [N, H, W, 3] → Future resolving to [N, C] scores."""
        if self._stop.is_set():
            raise RuntimeError("DynamicBatcher is closed")
        fut: Future = Future()
        self._q.put((np.asarray(imgs), fut))
        return fut

    def queue_depth(self) -> int:
        return self._q.qsize()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)
        # fail any requests still queued rather than stranding their callers
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("DynamicBatcher closed"))

    def _worker(self) -> None:
        held = None  # a request incompatible with the previous batch starts the next one
        while not self._stop.is_set():
            if held is not None:
                first, held = held, None
            else:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
            batch = [first]
            # only coalesce requests of one dtype and one per-image shape
            key = (first[0].shape[1:], first[0].dtype)
            total = first[0].shape[0]
            deadline = time.monotonic() + self.max_wait
            while total < self.engine.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if (item[0].shape[1:], item[0].dtype) == key:
                    batch.append(item)
                    total += item[0].shape[0]
                else:
                    held = item
                    break
            try:
                scores = self.engine.classify(np.concatenate([b[0] for b in batch]))
                off = 0
                for arr, fut in batch:
                    fut.set_result(scores[off : off + arr.shape[0]])
                    off += arr.shape[0]
            except Exception as e:  # propagate to callers, keep the worker alive
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
        if held is not None and not held[1].done():
            held[1].set_exception(RuntimeError("DynamicBatcher closed"))


def serve_http(engine: InferenceEngine, host: str = "127.0.0.1", port: int = 8000,
               batcher: DynamicBatcher | None = None, paths_root: str | None = None):
    """Start a ThreadingHTTPServer with POST /classify, GET /healthz and
    GET /stats; returns it (call ``.shutdown()`` then ``.server_close()``).

    Request JSON: ``{"paths": [...]}`` (files the server reads) or
    ``{"arrays_b64": "<base64 .npy of [N, H, W] uint8>"}``.  ``paths`` reads
    files as the server process: with ``paths_root`` every path must resolve
    under it (403 otherwise); without it, ``paths`` is accepted only from
    loopback clients."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    root = str(Path(paths_root).resolve()) if paths_root else None
    stats = ServingStats()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "classes": engine.class_names})
            elif self.path == "/stats":
                payload = stats.snapshot()
                payload["max_batch"] = engine.max_batch
                if batcher is not None:
                    payload["batcher_queue_depth"] = batcher.queue_depth()
                self._json(200, payload)
            else:
                self._json(404, {"error": "unknown path"})

        def _inputs(self, req):
            """Request JSON → (raw inputs, error response or None)."""
            if "paths" in req:
                paths = [str(p) for p in req["paths"]]
                if root is not None:
                    resolved = [str(Path(p).resolve()) for p in paths]
                    if not all(r == root or r.startswith(root + "/") for r in resolved):
                        return None, (403, {"error": "path outside --paths-root"})
                    paths = resolved
                elif self.client_address[0] not in ("127.0.0.1", "::1"):
                    return None, (403, {"error": "'paths' is loopback-only without "
                                                 "paths_root; send 'arrays_b64'"})
                return paths, None
            if "arrays_b64" in req:
                raw = np.load(io.BytesIO(base64.b64decode(req["arrays_b64"])), allow_pickle=False)
                return list(raw), None
            return None, (400, {"error": "need 'paths' or 'arrays_b64'"})

        def do_POST(self):
            if self.path != "/classify":
                return self._json(404, {"error": "unknown path"})
            t0 = time.perf_counter()
            n_inputs = 0
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                inputs, err = self._inputs(req)
                if err is not None:
                    stats.record(self.path, time.perf_counter() - t0, error=True)
                    return self._json(*err)
                n_inputs = len(inputs)
                imgs = engine.process_img_uint8(inputs)
                if batcher is not None:
                    scores = batcher.submit(imgs).result(timeout=60)
                else:
                    scores = engine.classify(imgs)
                stats.record(self.path, time.perf_counter() - t0, n_inputs)
                self._json(200, {"classes": engine.class_names,
                                 "scores": np.asarray(scores).tolist()})
            except Exception as e:  # the server keeps running; the client gets the error
                stats.record(self.path, time.perf_counter() - t0, n_inputs, error=True)
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    server = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None) -> int:
    import argparse

    from .api import load_gloria

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="reference-format .ckpt")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    ap.add_argument("--classes-json", default=None,
                    help="JSON file {class: [prompts]}; default: CheXpert grammar")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--paths-root", default=None,
                    help="restrict 'paths' requests to files under this dir "
                         "(without it, 'paths' is loopback-only)")
    args = ap.parse_args(argv)

    model = load_gloria(args.ckpt, device=args.device)
    if args.classes_json:
        with open(args.classes_json) as fh:
            classes = json.load(fh)
    else:
        classes = generate_chexpert_class_prompts()
    engine = InferenceEngine(model, classes, max_batch=args.max_batch)
    if not args.no_warmup:
        engine.warmup()
    batcher = DynamicBatcher(engine, max_wait_ms=args.max_wait_ms)
    server = serve_http(engine, args.host, args.port, batcher=batcher, paths_root=args.paths_root)
    print(f"serving on http://{args.host}:{args.port} "
          f"(classes: {', '.join(engine.class_names)})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
