"""Fused pairwise word-region similarity: CUDA kernel wrapper + plain version.

Port of ``gloria_tpu/ops/pallas/local_sim.py``'s forward.  For words
``[T, W, D]``, regions ``[B, S, D]`` (sink, if any, already prepended as
region 0) and a word mask ``[T, W]`` it returns the similarities ``[B, T]``
(rows = images): the double softmax (words per region, then ×temp1 regions
per word), the cosine of each word against its attention-weighted context,
and log of the sum / max / mean of ``exp(temp2 · cos)`` over valid words.

- On a CUDA tensor :func:`local_similarities` launches the hand-written
  kernel ``gloria_tpu_torch/csrc/local_sim_fwd.cu`` (built with nvcc for
  sm_90a on first use, bound with ctypes) or raises.  It never falls back.
- On a CPU tensor it runs :func:`local_similarities_plain`, the same
  function in plain PyTorch (a port of ``gloria_loss.local_matching``'s
  math, unchunked).  The CPU tests and ``chip_smoke.py``'s comparison use
  it; on a card nothing else does.
- ``launches`` counts kernel launches, and only those.
- Forward only: an input that requires grad raises.  The backward kernel
  and its ``autograd.Function`` come with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

EPS = 1e-8
AGGREGATIONS = {"sum": 0, "max": 1, "mean": 2}
# a1 ∈ [0, 1] bounds the region-softmax logits, so the kernel needs no running
# max; beyond this |temp1| its exp(temp1·a1 − max(temp1, 0)) could underflow
MAX_ABS_TEMP1 = 80.0

launches = 0
_launch_lock = threading.Lock()


def _check(words, regions, word_mask, temp1, agg):
    if agg not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {agg!r}; choose from {sorted(AGGREGATIONS)}")
    if abs(float(temp1)) > MAX_ABS_TEMP1:
        raise ValueError(f"|temp1| must be <= {MAX_ABS_TEMP1}, got {temp1}")
    tensors = {"words": words, "regions": regions, "word_mask": word_mask}
    for name, x in tensors.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
        if x.requires_grad:
            raise ValueError(f"{name} requires grad: local_similarities is forward-only")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != words.device:
            raise ValueError(f"{name} is on {x.device}, words on {words.device}")
    if words.dtype != torch.float32 or regions.dtype != torch.float32:
        raise TypeError(f"words and regions must be float32, got {words.dtype} and {regions.dtype}")
    if word_mask.dtype not in (torch.bool, torch.float32):
        raise TypeError(f"word_mask must be bool or float32, got {word_mask.dtype}")
    if words.dim() != 3 or regions.dim() != 3 or word_mask.dim() != 2:
        raise ValueError("expected words [T, W, D], regions [B, S, D], word_mask [T, W]; got "
                         f"{tuple(words.shape)}, {tuple(regions.shape)}, {tuple(word_mask.shape)}")
    if regions.shape[2] != words.shape[2] or tuple(word_mask.shape) != tuple(words.shape[:2]):
        raise ValueError("shape mismatch: words [T, W, D], regions [B, S, D], word_mask [T, W]; got "
                         f"{tuple(words.shape)}, {tuple(regions.shape)}, {tuple(word_mask.shape)}")
    if regions.shape[1] == 0:
        raise ValueError("regions must hold at least one region")


def local_similarities(words: torch.Tensor, regions: torch.Tensor, word_mask: torch.Tensor, *,
                       temp1: float = 4.0, temp2: float = 5.0, agg: str = "sum") -> torch.Tensor:
    """Similarities [B, T] f32.  CUDA tensors → the kernel; CPU tensors →
    the plain version."""
    _check(words, regions, word_mask, temp1, agg)
    if words.device.type == "cpu":
        return local_similarities_plain(words, regions, word_mask, temp1=temp1, temp2=temp2, agg=agg)
    if words.device.type != "cuda":
        raise ValueError(f"local_similarities runs on cuda or cpu tensors, got {words.device}")
    return _launch(words, regions, word_mask, float(temp1), float(temp2), agg)


@functools.cache
def _library():
    from ..utils.cuda_build import build

    lib = build(["local_sim_fwd"])["local_sim_fwd"].lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.local_sim_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, f, f, i, p]
    lib.local_sim_fwd.restype = i
    lib.local_sim_error_string.argtypes = [i]
    lib.local_sim_error_string.restype = ctypes.c_char_p
    return lib


def _launch(words, regions, word_mask, temp1, temp2, agg):
    global launches
    T, W, D = words.shape
    B, S, _ = regions.shape
    out = torch.empty((B, T), dtype=torch.float32, device=words.device)
    if B == 0 or T == 0:
        return out
    mask = word_mask.float() if word_mask.dtype == torch.bool else word_mask
    # the kernel sizes its shared-memory buffer by the largest count of valid
    # words over the texts: one device→host read per call
    nw_cap = int((mask > 0).sum(dim=1).max())
    lib = _library()
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.local_sim_fwd(words.data_ptr(), regions.data_ptr(), mask.data_ptr(),
                               out.data_ptr(), B, T, S, W, D, nw_cap, temp1, temp2,
                               AGGREGATIONS[agg], stream)
    if rc != 0:
        raise RuntimeError(f"local_sim_fwd launch failed: {lib.local_sim_error_string(rc).decode()}")
    with _launch_lock:
        launches += 1
    return out


def local_similarities_plain(words: torch.Tensor, regions: torch.Tensor, word_mask: torch.Tensor,
                             *, temp1: float = 4.0, temp2: float = 5.0,
                             agg: str = "sum") -> torch.Tensor:
    """The same function in plain PyTorch; materializes the [T, B, S, W]
    pairwise tensors (the weighted-context norm goes through the region
    Gram matrix, ``‖a2ᵀC‖² = a2ᵀ G a2``)."""
    words = words.float()
    ctx = regions.float()
    mask = word_mask if word_mask.dtype == torch.bool else word_mask > 0
    gram = ctx @ ctx.transpose(1, 2)                                  # [B, S, S]
    wn = words.square().sum(-1).clamp_min(1e-12).sqrt()               # [T, W]
    raw = torch.einsum("bsd,twd->tbsw", ctx, words)                   # [T, B, S, W]
    m = mask[:, None, None, :]
    a1 = torch.softmax(raw.masked_fill(~m, torch.finfo(torch.float32).min), dim=-1)
    a1 = a1.masked_fill(~m, 0.0)
    a2 = torch.softmax(temp1 * a1.transpose(2, 3), dim=-1)            # [T, B, W, S]
    dot = (a2 * raw.transpose(2, 3)).sum(-1)                          # [T, B, W]
    cn2 = ((a2 @ gram) * a2).sum(-1)                                  # [T, B, W]
    denom = (wn[:, None, :] * cn2.clamp_min(1e-12).sqrt()).clamp_min(EPS)
    valid = mask[:, None, :]
    row_sim = torch.where(valid, dot / denom, 0.0)
    e = torch.where(valid, torch.exp(temp2 * row_sim), 0.0)
    if agg == "sum":
        sims = e.sum(-1)
    elif agg == "mean":
        sims = e.sum(-1) / mask.sum(-1).clamp_min(1)[:, None]
    elif agg == "max":
        sims = e.amax(-1)
    else:
        raise ValueError(f"unknown aggregation {agg!r}")
    return sims.clamp_min(EPS).log().T.contiguous()                   # [B, T]
