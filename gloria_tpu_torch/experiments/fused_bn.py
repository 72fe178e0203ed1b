"""ARCHIVED EXPERIMENT: the fused bottleneck tail (bn2-apply + relu + the 1×1
conv3 + bn3's batch sums), port of ``scripts/experiments/fused_bn.py``.

No model path calls this op.  The JAX package took it out of its ResNet in
its round 4: on the TPU v5e image tower it lost 56% end to end against
XLA's own fusion (``docs/DESIGN.md``, "Round-3 roofline + the fused-BN
experiment"), and it only applies in train mode, since eval-mode BatchNorm
is a frozen affine that folds into the convolutions.  The port keeps it, as
the JAX package does, with its kernels and tests, so that the same question
can be asked of an H100 (``chip_smoke.py`` runs it on the 16 bottleneck
tails of a ResNet-50 train-mode forward).

Per bottleneck block the unfused chain is ``z = relu(bn2(y2))``,
``y3 = conv3(z)`` (a 1×1 convolution: an [M, K] × [K, N] product over the
M = B·H·W pixels), then bn3's batch statistics of y3: three more passes over
device memory.  The op computes the whole tail in one pass:

    z  = bf16(relu(y2 · scale + shift))      (scale, shift: bn2 folded)
    y3 = bf16(z @ bf16(w))                   f32 accumulation
    s1 = Σ_rows f32(y3),  s2 = Σ_rows f32(y3)²

and its backward (``G = bf16(gy3 + gs1 + 2·y3·gs2)``; ``dz = G @ bf16(w)ᵀ``;
``dy2 = bf16(dz · [a > 0] · scale)``; ``dscale``, ``dshift`` the row sums of
``dz · [a > 0] · y2`` and ``dz · [a > 0]``; ``dW = bf16(z)ᵀ @ G``; dz,
dscale, dshift and dW in f32).

- Layouts are the JAX op's: y2 [M, K] bf16, scale/shift [K] f32, w [K, N]
  f32, so a ``conv3.weight`` [N, K, 1, 1] is passed as
  ``weight[:, :, 0, 0].t().contiguous()``.
- :func:`bottleneck_tail` is the public, differentiable entry (a
  :class:`BottleneckTail` ``autograd.Function``).  The device decides the
  route; there is no ``impl`` argument.  On CUDA tensors the forward launches
  ``csrc/fused_bn_fwd.cu`` (K3) and the backward ``csrc/fused_bn_bwd.cu``
  (K4), both built with nvcc for sm_90a on first use and bound with ctypes,
  or raise: they never fall back.  On CPU tensors the plain PyTorch versions
  :func:`bottleneck_tail_plain` and :func:`bottleneck_tail_bwd_plain` run;
  on a card nothing else calls them but the comparisons.
- ``launches_fwd`` and ``launches_bwd`` count kernel launches, and only
  those (one K4 call launches its two passes and counts once).
- :func:`tail_errors` and :func:`grad_errors` hold outputs against a
  reference at the op's stated tolerances; the tests and ``chip_smoke.py``
  use them for the plain version against JAX and the kernels against the
  plain version.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

launches_fwd = 0
launches_bwd = 0
_launch_lock = threading.Lock()

# Tolerances.  y3: each entry within one bf16 ulp of the reference, and at
# most 1e-3 of the entries differing at all (f32 sums in another order can
# round to the neighbouring bf16 value).  s1 per channel within 1e-4 of
# sum_rows |y3|, s2 within 1e-4 of s2 (f32 sums in another order).  dy2
# within one bf16 ulp of its largest entry (:func:`bf16_ulp`, 2⁻⁸ to 2⁻⁷ of
# it: a sum in another order can round an entry to the neighbouring bf16
# value); dscale, dshift and dW, f32 sums that the kernel adds with
# atomics, within 1e-3 of their largest entry.  Each bound carries a floor
# of 1e-6.
Y3_ULP = 2.0 ** -7
Y3_MAX_DIFFERING = 1e-3
STAT_TOL = 1e-4
GRAD_TOL = 1e-3


def _check_tensor(name, x, dtype, shape, device):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, y2 on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(y2, scale, shift, w) -> tuple[int, int, int]:
    """Raises on a wrong type, dtype, shape, device or layout; returns (M, K, N)."""
    if not isinstance(y2, torch.Tensor) or y2.dim() != 2:
        raise ValueError("y2 must be a 2-D torch.Tensor [M, K]")
    if not isinstance(w, torch.Tensor) or w.dim() != 2:
        raise ValueError("w must be a 2-D torch.Tensor [K, N]")
    (M, K), N = y2.shape, w.shape[1]
    dev = y2.device
    _check_tensor("y2", y2, torch.bfloat16, (M, K), dev)
    _check_tensor("scale", scale, torch.float32, (K,), dev)
    _check_tensor("shift", shift, torch.float32, (K,), dev)
    _check_tensor("w", w, torch.float32, (K, N), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused tail runs on cuda or cpu tensors, got {dev}")
    return M, K, N


def _check_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2) -> tuple[int, int, int]:
    M, K, N = _check(y2, scale, shift, w)
    _check_tensor("y3", y3, torch.bfloat16, (M, N), y2.device)
    _check_tensor("gy3", gy3, torch.bfloat16, (M, N), y2.device)
    _check_tensor("gs1", gs1, torch.float32, (N,), y2.device)
    _check_tensor("gs2", gs2, torch.float32, (N,), y2.device)
    return M, K, N


def _worst(x: torch.Tensor) -> float:
    """max of x, with NaN counted as +inf so that it fails every bound."""
    return float(x.nan_to_num(nan=float("inf")).max()) if x.numel() else 0.0


def tail_errors(got, ref, y3_slack=0.0) -> dict[str, tuple[float, float]]:
    """For the forward's outputs (y3, s1, s2) against a reference: output →
    (max |got − ref|, max |got − ref| / tolerance), and ``"y3 differing"`` →
    (share of y3 entries that differ, that share / 1e-3).  A ratio above 1
    fails.  ``y3_slack`` [M, N] widens y3's bound entry by entry, for a
    reference that rounds z elsewhere."""
    (y3, s1, s2), (r3, r1, r2) = ([t.detach().float() for t in ts] for ts in (got, ref))
    for name, a, b in zip(("y3", "s1", "s2"), (y3, s1, s2), (r3, r1, r2)):
        if a.shape != b.shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)} against {tuple(b.shape)}")
    d3, d1, d2 = (y3 - r3).abs(), (s1 - r1).abs(), (s2 - r2).abs()
    share = float((d3 != 0).float().mean()) if d3.numel() else 0.0
    return {
        "y3": (_worst(d3), _worst(d3 / (Y3_ULP * r3.abs() + 1e-6 + (1 + Y3_ULP) * y3_slack))),
        "y3 differing": (share, share / Y3_MAX_DIFFERING),
        "s1": (_worst(d1), _worst(d1 / (STAT_TOL * r3.abs().sum(0) + 1e-6))),
        "s2": (_worst(d2), _worst(d2 / (STAT_TOL * r2 + 1e-6))),
    }


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x|: 2^(⌊log2 |x|⌋ − 7), 2⁻⁸ to 2⁻⁷ of |x|."""
    return math.ldexp(1.0, math.frexp(abs(x))[1] - 8) if x else 0.0


def grad_errors(got, ref) -> dict[str, tuple[float, float]]:
    """For (dy2, dscale, dshift, dw) against a reference: gradient → (max
    |got − ref|, that / tolerance), the tolerance one bf16 ulp of max|ref|
    for dy2 and 1e-3 · max|ref| for the others, each + 1e-6.  A ratio above
    1 fails."""
    out = {}
    for name, a, b in zip(("dy2", "dscale", "dshift", "dw"), got, ref):
        a, b = a.detach().float(), b.detach().float()
        if a.shape != b.shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)} against {tuple(b.shape)}")
        err, scale = _worst((a - b).abs()), _worst(b.abs())
        tol = bf16_ulp(scale) if name == "dy2" else GRAD_TOL * scale
        out[name] = (err, err / (tol + 1e-6))
    return out


def bottleneck_tail_plain(y2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                          w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward in plain PyTorch (``bottleneck_tail_reference``): the
    unfused chain of elementwise passes, a bf16 product and two reductions."""
    z = torch.relu(y2.float() * scale + shift)
    y3 = z.to(torch.bfloat16) @ w.to(torch.bfloat16)  # f32 accumulation, bf16 result
    y3f = y3.float()
    return y3, y3f.sum(0), (y3f * y3f).sum(0)


def bottleneck_tail_bwd_plain(y2, scale, shift, w, y3, gy3, gs1, gs2):
    """The backward in plain PyTorch (the reference branch of the JAX op's
    ``_tail_bwd``) → (dy2 in y2's dtype, dscale, dshift, dw f32).  The two
    products take bf16 values as f32: their products are exact there, and
    the sums stay f32 as the JAX op's ``preferred_element_type`` keeps them
    (a bf16 @ bf16 product would round them to bf16)."""
    y2f = y2.float()
    g = gy3.float() + gs1 + 2.0 * y3.float() * gs2
    g_bf = g.to(torch.bfloat16).float()
    dz = g_bf @ w.to(torch.bfloat16).float().T
    a = y2f * scale + shift
    dzm = dz * (a > 0).float()
    dy2 = (dzm * scale).to(y2.dtype)
    dw = torch.relu(a).to(torch.bfloat16).float().T @ g_bf
    return dy2, (dzm * y2f).sum(0), dzm.sum(0), dw


def bottleneck_tail_fwd(y2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                        w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y3 [M, N] bf16, s1 [N] f32, s2 [N] f32).  CUDA tensors → K3; CPU
    tensors → the plain version.  Not differentiable: see :func:`bottleneck_tail`."""
    M, K, N = _check(y2, scale, shift, w)
    if y2.device.type == "cpu":
        return bottleneck_tail_plain(y2, scale, shift, w)
    return _launch_fwd(y2, scale, shift, w, M, K, N)


def bottleneck_tail_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2):
    """The backward of :func:`bottleneck_tail_fwd` for its inputs, its ``y3``
    and the cotangents gy3 [M, N] bf16, gs1/gs2 [N] f32 → (dy2 [M, K] bf16,
    dscale [K], dshift [K], dw [K, N] f32).  CUDA tensors → K4; CPU tensors →
    the plain version."""
    M, K, N = _check_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2)
    if y2.device.type == "cpu":
        return bottleneck_tail_bwd_plain(y2, scale, shift, w, y3, gy3, gs1, gs2)
    return _launch_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2, M, K, N)


class BottleneckTail(torch.autograd.Function):
    """Differentiable (y3, s1, s2) of (y2, scale, shift, w):
    :func:`bottleneck_tail_fwd` forward, :func:`bottleneck_tail_bwd` backward.
    Saves (y2, scale, shift, w, y3), as the JAX op's VJP does; a cotangent
    that autograd hands over as None counts as zeros."""

    @staticmethod
    def forward(ctx, y2, scale, shift, w):
        args = [x.detach() for x in (y2, scale, shift, w)]
        y3, s1, s2 = bottleneck_tail_fwd(*args)
        ctx.save_for_backward(*args, y3)
        return y3, s1, s2

    @staticmethod
    def backward(ctx, gy3, gs1, gs2):
        y2, scale, shift, w, y3 = ctx.saved_tensors
        N = w.shape[1]
        gy3 = (torch.zeros_like(y3) if gy3 is None
               else gy3.to(torch.bfloat16).contiguous())
        gs1, gs2 = (torch.zeros(N, dtype=torch.float32, device=y2.device) if g is None
                    else g.float().contiguous() for g in (gs1, gs2))
        return bottleneck_tail_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2)


def bottleneck_tail(y2: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """relu(y2·scale + shift) @ w in bf16 with f32 sums, and the per-channel
    sum and sum of squares of the bf16 result: y2 [M, K] bf16, scale/shift
    [K] f32 (folded bn2), w [K, N] f32 (the 1×1 conv3 kernel) → (y3 [M, N]
    bf16, s1 [N] f32, s2 [N] f32), differentiable in all four inputs."""
    _check(y2, scale, shift, w)
    return BottleneckTail.apply(y2, scale, shift, w)


@functools.cache
def _library_fwd():
    from ..utils.cuda_build import build

    lib = build(["fused_bn_fwd"])["fused_bn_fwd"].lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_bn_fwd.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, i, i, p]
    lib.fused_bn_fwd.restype = i
    lib.fused_bn_fwd_error_string.argtypes = [i]
    lib.fused_bn_fwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library_bwd():
    from ..utils.cuda_build import build

    lib = build(["fused_bn_bwd"])["fused_bn_bwd"].lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_bn_bwd.argtypes = [p] * 12 + [ctypes.c_longlong, i, i, p]
    lib.fused_bn_bwd.restype = i
    lib.fused_bn_bwd_error_string.argtypes = [i]
    lib.fused_bn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch_fwd(y2, scale, shift, w, M, K, N):
    global launches_fwd
    lib = _library_fwd()
    y3 = torch.empty((M, N), dtype=torch.bfloat16, device=y2.device)
    # the kernel adds each row tile's sums into zeroed statistics with atomics
    s1 = torch.zeros(N, dtype=torch.float32, device=y2.device)
    s2 = torch.zeros(N, dtype=torch.float32, device=y2.device)
    if M == 0 or K == 0 or N == 0:
        return y3.zero_(), s1, s2
    with torch.cuda.device(y2.device):
        stream = torch.cuda.current_stream(y2.device).cuda_stream
        rc = lib.fused_bn_fwd(y2.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
                              y3.data_ptr(), s1.data_ptr(), s2.data_ptr(), M, K, N, stream)
    if rc != 0:
        raise RuntimeError(f"fused_bn_fwd launch failed: {lib.fused_bn_fwd_error_string(rc).decode()}")
    with _launch_lock:
        launches_fwd += 1
    return y3, s1, s2


def _launch_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2, M, K, N):
    global launches_bwd
    lib = _library_bwd()
    dev = y2.device
    dy2 = torch.empty((M, K), dtype=torch.bfloat16, device=dev)
    # dscale, dshift and dw are sums over row tiles, added with atomics
    dscale = torch.zeros(K, dtype=torch.float32, device=dev)
    dshift = torch.zeros(K, dtype=torch.float32, device=dev)
    dw = torch.zeros((K, N), dtype=torch.float32, device=dev)
    if M == 0 or K == 0 or N == 0:
        return dy2.zero_(), dscale, dshift, dw
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bn_bwd(y2.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
                              y3.data_ptr(), gy3.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
                              dy2.data_ptr(), dscale.data_ptr(), dshift.data_ptr(), dw.data_ptr(),
                              M, K, N, stream)
    if rc != 0:
        raise RuntimeError(f"fused_bn_bwd launch failed: {lib.fused_bn_bwd_error_string(rc).decode()}")
    with _launch_lock:
        launches_bwd += 1
    return dy2, dscale, dshift, dw
