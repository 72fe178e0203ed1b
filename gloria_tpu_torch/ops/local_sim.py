"""Fused pairwise word-region similarity: CUDA kernel wrappers + plain versions.

Port of ``gloria_tpu/ops/pallas/local_sim.py`` (forward and backward).  For words
``[T, W, D]``, regions ``[B, S, D]`` (sink, if any, already prepended as
region 0) and a word mask ``[T, W]`` it returns the similarities ``[B, T]``
(rows = images): the double softmax (words per region, then ×temp1 regions
per word), the cosine of each word against its attention-weighted context,
and log of the sum / max / mean of ``exp(temp2 · cos)`` over valid words.

- On a CUDA tensor :func:`local_similarities` launches the hand-written
  kernel ``gloria_tpu_torch/csrc/local_sim_fwd.cu`` (built with nvcc for
  sm_90a on first use, bound with ctypes) or raises.  It never falls back.
  The wrapper packs the valid words of all texts into one matrix first
  (:func:`_pack_words`), and the kernel runs the TPU kernel's Gram route as
  dense passes over the images: tensor-core products at f32 accuracy
  (``csrc/tf32x3_mma.cuh``) and elementwise passes, with no atomics.
- On a CPU tensor it runs :func:`local_similarities_plain`, the same
  function in plain PyTorch (a port of ``gloria_loss.local_matching``'s
  math, unchunked).  The CPU tests and ``chip_smoke.py``'s comparison use
  it; on a card nothing else does.
- ``launches`` counts kernel launches, and only those.
- :func:`local_similarities` is forward-only: an input that requires grad
  raises.  :func:`fused_local_similarities` is the differentiable form, a
  :class:`LocalSimilarities` ``autograd.Function``: the forward kernel, and
  :func:`local_similarities_bwd` as its backward.  That wrapper launches
  ``csrc/local_sim_bwd.cu`` on a CUDA tensor (counted in ``launches_bwd``,
  one per call) or runs :func:`local_similarities_bwd_plain` on a CPU
  tensor.  It runs the same forward passes (``csrc/local_sim_fwd_passes.cuh``,
  shared by the two kernels) and then the backward's, over the same packed
  words: a train step packs once, in the forward, and hands the packing to
  the backward.  Neither kernel has atomics, so each result is the same bit
  for bit from call to call.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

EPS = 1e-8
AGGREGATIONS = {"sum": 0, "max": 1, "mean": 2}
# a1 ∈ [0, 1] bounds the region-softmax logits, so the kernel needs no running
# max; beyond this |temp1| its exp(temp1·a1 − max(temp1, 0)) could underflow
MAX_ABS_TEMP1 = 80.0

launches = 0
launches_bwd = 0
_launch_lock = threading.Lock()
# output tile of the backward's products (csrc/tf32x3_mma.cuh)
BWD_TILE = 128


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
            raise ValueError(f"{name} requires grad: local_similarities is forward-only; "
                             "fused_local_similarities is differentiable")
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


class _Packed(NamedTuple):
    """The valid words of all texts as packed columns, on the card: what
    both kernels read (:func:`_pack_words`)."""
    cols: torch.Tensor        # [N] int64, the flat index t * W + w of each valid word
    text_start: torch.Tensor  # [T + 1] int32, text t owns columns text_start[t]:text_start[t + 1]
    wc: torch.Tensor          # [N, dp] f32, those words' rows, 16-byte aligned


def local_similarities(words: torch.Tensor, regions: torch.Tensor, word_mask: torch.Tensor, *,
                       temp1: float = 4.0, temp2: float = 5.0, agg: str = "sum") -> torch.Tensor:
    """Similarities [B, T] f32.  CUDA tensors → the kernel; CPU tensors →
    the plain version."""
    return _similarities(words, regions, word_mask, float(temp1), float(temp2), agg)[0]


def _similarities(words, regions, word_mask, temp1, temp2, agg):
    """:func:`local_similarities`, and the packed words the kernel read
    (None on the CPU), for the backward to reuse."""
    _check(words, regions, word_mask, temp1, agg)
    if words.device.type == "cpu":
        return local_similarities_plain(words, regions, word_mask, temp1=temp1, temp2=temp2,
                                        agg=agg), None
    if words.device.type != "cuda":
        raise ValueError(f"local_similarities runs on cuda or cpu tensors, got {words.device}")
    packed = _pack_words(words, word_mask)
    return _launch(words, regions, packed, temp1, temp2, agg), packed


def local_similarities_bwd(words: torch.Tensor, regions: torch.Tensor, word_mask: torch.Tensor,
                           g: torch.Tensor, *, temp1: float = 4.0, temp2: float = 5.0,
                           agg: str = "sum") -> tuple[torch.Tensor, torch.Tensor]:
    """The backward of :func:`local_similarities`: ``g = dL/dsims [B, T]`` →
    ``(dwords [T, W, D], dregions [B, S, D])`` f32.  CUDA tensors → the
    kernel; CPU tensors → the plain version."""
    return _similarities_bwd(words, regions, word_mask, g, float(temp1), float(temp2), agg)


def _similarities_bwd(words, regions, word_mask, g, temp1, temp2, agg, packed=None):
    """:func:`local_similarities_bwd`; on the card it reads ``packed``, the
    forward's packed words of these words and mask, or packs them itself."""
    _check(words, regions, word_mask, temp1, agg)
    B, T = regions.shape[0], words.shape[0]
    if not isinstance(g, torch.Tensor) or g.dtype != torch.float32 or not g.is_contiguous():
        raise TypeError("g must be a contiguous float32 torch.Tensor")
    if tuple(g.shape) != (B, T) or g.device != words.device:
        raise ValueError(f"g must be [B, T] = {(B, T)} on {words.device}, got "
                         f"{tuple(g.shape)} on {g.device}")
    if words.device.type == "cpu":
        return local_similarities_bwd_plain(words, regions, word_mask, g, temp1=temp1,
                                            temp2=temp2, agg=agg)
    if words.device.type != "cuda":
        raise ValueError(f"local_similarities_bwd runs on cuda or cpu tensors, got {words.device}")
    if packed is None:
        packed = _pack_words(words, word_mask)
    return _launch_bwd(words, regions, g, packed, temp1, temp2, agg)


class LocalSimilarities(torch.autograd.Function):
    """Differentiable similarities [B, T]: :func:`local_similarities` forward,
    :func:`local_similarities_bwd` backward.  Gradients flow to words and
    regions in their own shapes and dtypes; the mask gets none.  On the card
    the forward's packed words go to the backward, so a step packs once."""

    @staticmethod
    def forward(ctx, words, regions, word_mask, temp1, temp2, agg):
        w = words.detach().float().contiguous()
        r = regions.detach().float().contiguous()
        m = word_mask.detach().contiguous()
        ctx.save_for_backward(w, r, m)
        ctx.opts = (temp1, temp2, agg)
        ctx.dtypes = (words.dtype, regions.dtype)
        sims, ctx.packed = _similarities(w, r, m, temp1, temp2, agg)
        return sims

    @staticmethod
    def backward(ctx, g):
        w, r, m = ctx.saved_tensors
        dw, dr = _similarities_bwd(w, r, m, g.float().contiguous(), *ctx.opts,
                                   packed=ctx.packed)
        return dw.to(ctx.dtypes[0]), dr.to(ctx.dtypes[1]), None, None, None, None


def fused_local_similarities(words: torch.Tensor, regions: torch.Tensor, word_mask: torch.Tensor,
                             temp1: float = 4.0, temp2: float = 5.0,
                             agg: str = "sum") -> torch.Tensor:
    """Differentiable similarities [B, T] (rows = images) of words [T, W, D]
    and regions [B, S, D] (sink already prepended) under word_mask [T, W]."""
    return LocalSimilarities.apply(words, regions, word_mask, float(temp1), float(temp2), agg)


@functools.cache
def _library():
    from ..utils.cuda_build import build

    lib = build(["local_sim_fwd"])["local_sim_fwd"].lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.local_sim_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, f, i, p]
    lib.local_sim_fwd.restype = i
    lib.local_sim_fwd_workspace_floats.argtypes = [i, i, i, i]
    lib.local_sim_fwd_workspace_floats.restype = ctypes.c_size_t
    lib.local_sim_error_string.argtypes = [i]
    lib.local_sim_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_bwd():
    from ..utils.cuda_build import build

    lib = build(["local_sim_bwd"])["local_sim_bwd"].lib
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.local_sim_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
    lib.local_sim_bwd.restype = i
    lib.local_sim_bwd_workspace_floats.argtypes = [i, i, i, i, i, i]
    lib.local_sim_bwd_workspace_floats.restype = ctypes.c_size_t
    lib.local_sim_bwd_error_string.argtypes = [i]
    lib.local_sim_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch(words, regions, packed, temp1, temp2, agg):
    global launches
    T, _, D = words.shape
    B, S, _ = regions.shape
    out = torch.empty((B, T), dtype=torch.float32, device=words.device)
    if B == 0 or T == 0:
        return out
    N, dp = packed.cols.numel(), _row_floats(D)
    ctx = _aligned(regions, B * S, D, dp)
    lib = _library()
    work = torch.empty(lib.local_sim_fwd_workspace_floats(B, T, S, N), dtype=torch.float32,
                       device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.local_sim_fwd(ctx.data_ptr(), packed.wc.data_ptr(),
                               packed.text_start.data_ptr(), out.data_ptr(), work.data_ptr(), B,
                               T, S, D, dp, N, temp1, temp2, AGGREGATIONS[agg], stream)
    if rc != 0:
        raise RuntimeError(f"local_sim_fwd launch failed: {lib.local_sim_error_string(rc).decode()}")
    with _launch_lock:
        launches += 1
    return out


def _pack_columns(word_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The valid words of all texts as packed columns, text by text.

    Returns ``cols`` [N] int64, the flat index ``t * W + w`` of each valid
    word (so its text is ``cols // W`` and its word ``cols % W``);
    ``col_text`` [N] int32, its text; and ``text_start`` [T + 1] int32, the
    first column of each text (text t owns ``text_start[t]:text_start[t + 1]``).
    N is read to the host once (``nonzero``)."""
    valid = word_mask > 0
    T, W = valid.shape
    cols = valid.reshape(-1).nonzero().squeeze(1)
    text_start = torch.zeros(T + 1, dtype=torch.int32, device=valid.device)
    text_start[1:] = valid.sum(dim=1).cumsum(0)
    return cols, (cols // max(W, 1)).to(torch.int32), text_start


def _row_floats(D: int) -> int:
    """Floats per packed row: D rounded up to a multiple of 4 (16 bytes)."""
    return -(-D // 4) * 4


def _pack_words(words: torch.Tensor, word_mask: torch.Tensor) -> _Packed:
    """The valid words' rows of ``words`` [T, W, D] under ``word_mask``,
    packed text by text (:func:`_pack_columns`), as the kernels read them:
    one ``nonzero`` (N read to the host) and one ``index_select``."""
    T, W, D = words.shape
    cols, _, text_start = _pack_columns(word_mask)
    wc = words.reshape(T * W, D).index_select(0, cols)
    return _Packed(cols, text_start, _aligned(wc, cols.numel(), D, _row_floats(D)))


def _aligned(x: torch.Tensor, rows: int, cols: int, width: int) -> torch.Tensor:
    """x viewed as [rows, cols] with rows padded to ``width`` floats and a
    16-byte aligned start, as the products read it; x itself when it is
    already so."""
    if width == cols and x.data_ptr() % 16 == 0:
        return x
    out = torch.zeros((rows, width), dtype=torch.float32, device=x.device)
    out[:, :cols] = x.reshape(rows, cols)
    return out


def _dwords_splits(B: int, N: int, D: int, sms: int) -> tuple[int, int]:
    """(splits, images per split) for the dwords product, whose contraction
    runs over all images: enough image ranges that its tiles fill two waves
    of the card's SMs, each range's partial sum added in order afterwards."""
    tiles = -(-N // BWD_TILE) * -(-D // BWD_TILE)
    per = -(-B // min(B, max(1, -(-2 * sms // max(tiles, 1)))))
    return -(-B // per), per


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_bwd(words, regions, g, packed, temp1, temp2, agg):
    global launches_bwd
    T, W, D = words.shape
    B, S, _ = regions.shape
    # every element of both is written by the kernels
    dwords = torch.empty_like(words)
    dregions = torch.empty_like(regions)
    if B == 0 or T == 0:
        return dwords.zero_(), dregions.zero_()
    N, dp = packed.cols.numel(), _row_floats(D)
    ctx = _aligned(regions, B * S, D, dp)
    col_of = torch.full((T * W,), -1, dtype=torch.int32, device=words.device)
    col_of[packed.cols] = torch.arange(N, dtype=torch.int32, device=words.device)
    splits, per = _dwords_splits(B, N, D, _sm_count(words.device))
    lib = _library_bwd()
    work = torch.empty(lib.local_sim_bwd_workspace_floats(B, T, S, D, N, splits),
                       dtype=torch.float32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream(words.device).cuda_stream
        rc = lib.local_sim_bwd(ctx.data_ptr(), packed.wc.data_ptr(), words.data_ptr(),
                               packed.text_start.data_ptr(), col_of.data_ptr(), g.data_ptr(),
                               dwords.data_ptr(), dregions.data_ptr(), work.data_ptr(), B, T, S,
                               W, D, dp, N, splits, per, temp1, temp2, AGGREGATIONS[agg], stream)
    if rc != 0:
        raise RuntimeError(
            f"local_sim_bwd launch failed: {lib.local_sim_bwd_error_string(rc).decode()}")
    with _launch_lock:
        launches_bwd += 1
    return dwords, dregions


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


def local_similarities_bwd_plain(words: torch.Tensor, regions: torch.Tensor,
                                 word_mask: torch.Tensor, g: torch.Tensor, *, temp1: float = 4.0,
                                 temp2: float = 5.0,
                                 agg: str = "sum") -> tuple[torch.Tensor, torch.Tensor]:
    """The backward in plain PyTorch: autograd through
    :func:`local_similarities_plain` with upstream ``g`` [B, T]."""
    with torch.enable_grad():
        w = words.detach().float().requires_grad_()
        r = regions.detach().float().requires_grad_()
        sims = local_similarities_plain(w, r, word_mask, temp1=temp1, temp2=temp2, agg=agg)
        dw, dr = torch.autograd.grad(sims, (w, r), grad_outputs=g.float())
    return dw, dr
