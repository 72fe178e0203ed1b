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
- K3 runs ``fused_bn_prep`` (bf16(w) into a workspace), then the main pass
  (persistent blocks over units of 128 rows by a chunk of N; z made once
  per row tile and block and kept in shared memory over all of K while
  bf16(w) streams through a ring, wgmma, y3 stored 16 bytes a lane, the
  column sums of the rounded y3 added per warpgroup into rows of partial
  sums) and the stats pass (the partial sums added in row order): no
  atomics, so two calls give the same bits.  Its units, grid and stages
  come from :func:`_fwd_plan`.
- K4 runs ``fused_bn_prep`` (bf16(w) into a workspace, the summed
  outputs zeroed), then the dz pass (dz = G·bf16(w)ᵀ per row tile, then
  dy2, dscale, dshift) and the dW pass (dW = zᵀ·G over M split across one
  wave of blocks), or where K ≤ 64 and N ≤ 256 one fused pass that takes
  both products from each staged G tile; all on wgmma fed by TMA through a
  ring of shared-memory stages.  Their tiles, splits and stages come from
  :func:`_bwd_plan`, computed here so that the CPU tests check it.  For
  both kernels K and N that are not multiples of 8 are padded with zeros
  for the call.
- ``launches_fwd`` and ``launches_bwd`` count kernel launches, and only
  those (a K3 call launches three kernels, a K4 call two or three, and
  each call counts once).
- :func:`tail_errors` and :func:`grad_errors` hold outputs against a
  reference at the op's stated tolerances; the tests and ``chip_smoke.py``
  use them for the plain version against JAX and the kernels against the
  plain version.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math
import threading

import torch

from ..ops import local_sim

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
    lib.fused_bn_fwd.argtypes = [p] * 7 + [ctypes.c_longlong] + [i] * 5 + [p]
    lib.fused_bn_fwd.restype = i
    lib.fused_bn_fwd_error_string.argtypes = [i]
    lib.fused_bn_fwd_error_string.restype = ctypes.c_char_p
    return lib


# The kernels' shared-memory limit (227 KB a block on an H100), their
# deepest ring and the rows of M in one stage of K4's dW pass, as in
# csrc/fused_bn_tail.cuh and csrc/fused_bn_bwd.cu.
_SMEM_LIMIT = 232448
_MAX_STAGES = 8
_DW_ROWS = 32
_ATOM = 1024          # the ring's alignment slack
_ROW_BYTES = 128      # one row of a 64-column block of bf16 values
_BARRIER_BYTES = 2 * _MAX_STAGES * 8
# K3's units are 128 rows (two consumer warpgroups of 64); a ring stage
# holds a box of y2 (128 rows x 64 channels) or a chunk of bf16(w), 16 KB
# either way; each of the 8 consumer warps has 2 KB of epilogue scratch
# (csrc/fused_bn_fwd.cu)
_FWD_ROWS = 128
_FWD_STAGE = _FWD_ROWS * _ROW_BYTES
_FWD_SCRATCH = 8 * 2048


def _fwd_smem(k_blocks: int, stages: int) -> int:
    """csrc/fused_bn_fwd.cu:fwd_smem: the ring, z (k_blocks column blocks of
    128 rows), the warps' scratch, the barriers."""
    return (_ATOM + stages * _FWD_STAGE + k_blocks * _FWD_ROWS * _ROW_BYTES + _FWD_SCRATCH
            + _BARRIER_BYTES)


@dataclasses.dataclass(frozen=True)
class _FwdPlan:
    """K3's launch plan for (M, K, N), K and N multiples of 8.

    A unit is a tile of 128 rows by a chunk of ``width`` columns of N: unit
    u is (row tile u // n_chunks, chunk u % n_chunks).  Block b of ``grid``
    takes the units [b·units // grid, (b + 1)·units // grid) in order, and
    makes z over all of K (``k_blocks`` column blocks of 64 channels) where
    one of them starts a row tile, or is its first; bf16(w) streams in
    chunks of ``depth`` rows of K by ``width`` columns.  Each block's two
    warpgroups add their units' column sums into a row of partial sums of
    their own: row 2b + g of the ``2·grid`` rows, which the stats kernel
    adds in row order."""
    M: int
    K: int
    N: int
    width: int
    depth: int
    k_blocks: int
    n_chunks: int
    row_tiles: int
    units: int
    grid: int
    stages: int
    workspace_bytes: int  # bf16(w) 2·K·N, then 2·grid rows of 2·N f32 partial sums

    def units_of(self, block: int) -> range:
        return range(block * self.units // self.grid, (block + 1) * self.units // self.grid)


@functools.lru_cache(maxsize=64)
def _fwd_plan(M: int, K: int, N: int, sms: int) -> _FwdPlan:
    """Unit width, grid, stages and workspace of K3 at (M, K, N), K and N
    multiples of 8, on a card with ``sms`` SMs (one block each: z and the
    ring take most of an SM's shared memory).  The width is a wgmma's: 256
    columns where N ≥ 256, else 64 or 128; a staged chunk of bf16(w) is 16
    KB (32 rows of K at width 256, else 64).  z of a row tile stays in
    shared memory while the block's units walk its chunks of N, so a row
    tile's z is made once per block that reaches it; the ring takes as
    many stages as fit beside it (3 to 8), which bounds K at 640."""
    width = _width(N)
    k_blocks = -(-K // 64)
    stages = min(_MAX_STAGES, (_SMEM_LIMIT - _fwd_smem(k_blocks, 0)) // _FWD_STAGE)
    if stages < 3:
        raise ValueError(f"the fused tail's forward kernel takes K <= 640 channels, got K = {K}")
    n_chunks, row_tiles = -(-N // width), -(-M // _FWD_ROWS)
    units = row_tiles * n_chunks
    grid = min(sms, units)
    return _FwdPlan(M, K, N, width, 32 if width == 256 else 64, k_blocks, n_chunks, row_tiles,
                    units, grid, stages, 2 * K * N + 2 * grid * 2 * N * 4)


@dataclasses.dataclass(frozen=True)
class _BwdPlan:
    """K4's launch plan for (M, K, N), K and N multiples of 8.

    dz pass: tiles of ``dz_rows`` rows × ``dz_cols`` columns of K; tile t is
    (row tile t // dz_k_tiles, K tile t % dz_k_tiles); block b of
    ``dz_grid`` takes tiles b, b + dz_grid, ...  dW pass: tiles of
    ``dw_cols`` channels × ``dw_width`` columns of N; unit u is (tile u //
    dw_chunks, rows [32·(u % dw_chunks), +32)), tile = (K tile tile //
    dw_n_tiles, N tile tile % dw_n_tiles); block b of ``dw_grid`` takes the
    units [b·dw_units // dw_grid, (b + 1)·dw_units // dw_grid).  ``fused``
    (K ≤ 64, N ≤ 256): one pass on the dz pass's tiles, grid and stages also
    sums dW (all of it, dw_cols × dw_width) over each block's rows; the dW
    pass's units, grid and stages are then 0."""
    M: int
    K: int
    N: int
    fused: bool
    dz_rows: int
    dz_cols: int
    dz_k_tiles: int
    dz_tiles: int
    dz_grid: int
    dz_stages: int
    dw_cols: int
    dw_width: int
    dw_n_tiles: int
    dw_chunks: int
    dw_units: int
    dw_grid: int
    dw_stages: int
    workspace_bytes: int  # bf16(w): 2·K·N

    def dz_tiles_of(self, block: int) -> range:
        return range(block, self.dz_tiles, self.dz_grid)

    def dw_units_of(self, block: int) -> range:
        return range(block * self.dw_units // self.dw_grid,
                     (block + 1) * self.dw_units // self.dw_grid)


def _width(n: int) -> int:
    """The tile width for n columns: 64, 128 or 256 (a wgmma's widths)."""
    return 64 if n <= 64 else 128 if n <= 128 else 256


@functools.lru_cache(maxsize=64)
def _bwd_plan(M: int, K: int, N: int, sms: int) -> _BwdPlan:
    """Tile widths, row tiles, M splits, stages and workspace of K4 at (M,
    K, N), K and N multiples of 8, on a card with ``sms`` SMs (one block
    each: the rings take most of an SM's shared memory).

    Where K ≤ 64 and N ≤ 256 (ResNet-50's layer 1), one fused pass: tiles of
    64 rows × the 64 channels, each block summing dW over its rows in
    registers, so every input is read once.  Else two passes.  dz pass: a
    tile spans all of K up to 256 columns (y3 and gy3 are then read once per
    row), else 256-wide K tiles, and 128 rows (two consumer warpgroups,
    which hide each other's latency, even where 64-row tiles would fill
    more SMs; 64 when M ≤ 64).  The grid is a multiple of the K tiles, so a
    block keeps one K tile.  dW pass: tiles of
    64 channels (K ≤ 64) or 128, by up to 256 columns of N; the (tile,
    32-row chunk) units split evenly over min(sms, units) blocks.  Each ring
    takes as many stages as fit."""
    dz_cols, dw_width = _width(K), _width(N)
    if K <= 64 and N <= 256:
        tiles = -(-M // 64)
        # the ring's stages: y3, gy3, bf16(w), y2 (64 rows x 64 columns each)
        # and the gs1 / gs2 slices; z, scale and shift, column sums, barriers
        stage = 4 * 64 * _ROW_BYTES + 8 * 64
        fixed = _ATOM + 64 * _ROW_BYTES + 8 * 64 + 4 * 8 * 64 + _BARRIER_BYTES
        return _BwdPlan(M, K, N, True, 64, 64, 1, tiles, min(sms, tiles),
                        min(_MAX_STAGES, (_SMEM_LIMIT - fixed) // stage),
                        64, dw_width, 1, 0, 0, 0, 0, 2 * K * N)
    k_tiles = -(-K // dz_cols)
    fill = max(k_tiles, sms // k_tiles * k_tiles)
    dz_rows = 64 if M <= 64 else 128
    dz_tiles = -(-M // dz_rows) * k_tiles
    dz_stage = (2 * dz_rows + dz_cols) * _ROW_BYTES + 8 * 64  # + its slices of gs1, gs2
    dz_fixed = _ATOM + 8 * dz_cols + dz_rows // 16 * 8 * dz_cols + _BARRIER_BYTES
    dw_cols = 64 if K <= 64 else 128
    dw_n_tiles, dw_chunks = -(-N // dw_width), -(-M // _DW_ROWS)
    dw_units = -(-K // dw_cols) * dw_n_tiles * dw_chunks
    # + its slices of scale, shift, gs1 and gs2
    dw_stage = (dw_cols + 2 * dw_width) * _DW_ROWS * 2 + 8 * (dw_cols + dw_width)
    return _BwdPlan(
        M, K, N, False, dz_rows, dz_cols, k_tiles, dz_tiles, min(dz_tiles, fill),
        min(_MAX_STAGES, (_SMEM_LIMIT - dz_fixed) // dz_stage),
        dw_cols, dw_width, dw_n_tiles, dw_chunks, dw_units, min(sms, dw_units),
        min(_MAX_STAGES, (_SMEM_LIMIT - _ATOM - _BARRIER_BYTES) // dw_stage),
        2 * K * N)


@functools.cache
def _library_bwd():
    from ..utils.cuda_build import build

    lib = build(["fused_bn_bwd"])["fused_bn_bwd"].lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_bn_bwd.argtypes = [p] * 13 + [ctypes.c_longlong, i, i] + [i] * 9 + [p]
    lib.fused_bn_bwd.restype = i
    lib.fused_bn_bwd_error_string.argtypes = [i]
    lib.fused_bn_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _launch_fwd(y2, scale, shift, w, M, K, N):
    global launches_fwd
    lib = _library_fwd()
    dev = y2.device
    if M == 0 or K == 0 or N == 0:
        return (torch.zeros((M, N), dtype=torch.bfloat16, device=dev),
                *(torch.zeros(N, dtype=torch.float32, device=dev) for _ in range(2)))
    # TMA reads rows whose stride is a multiple of 16 bytes from 16-byte
    # boundaries: K and N go up to multiples of 8, the added channels and
    # columns zero (their z and y3 are then 0), and the outputs are cut back
    Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8
    ins = (_padded(y2, (M, Kp)), _padded(scale, (Kp,)), _padded(shift, (Kp,)), _padded(w, (Kp, Np)))
    plan = _fwd_plan(M, Kp, Np, local_sim._sm_count(dev))
    # every output element is written by the kernels: y3 by the main pass,
    # stats (s1, s2) by the stats pass; the workspace holds bf16(w) and the
    # partial sums, each written before it is read
    y3 = torch.empty((M, Np), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((2, Np), dtype=torch.float32, device=dev)
    ws = torch.empty(plan.workspace_bytes, dtype=torch.uint8, device=dev)
    # the kernels launch on the current device: switch only when y2 lies elsewhere
    same = dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bn_fwd(*(x.data_ptr() for x in ins), y3.data_ptr(), stats.data_ptr(), ws.data_ptr(), M, Kp, Np,
                              plan.width, plan.grid, plan.stages, stream)
    if rc != 0:
        raise RuntimeError(f"fused_bn_fwd launch failed: {lib.fused_bn_fwd_error_string(rc).decode()}")
    with _launch_lock:
        launches_fwd += 1
    s1, s2 = stats.unbind()
    if Np != N:
        return y3[:, :N].contiguous(), s1[:N].contiguous(), s2[:N].contiguous()
    return y3, s1, s2


def _padded(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """x in a zeroed tensor of ``shape`` (x's own shape or wider) that starts
    on a 16-byte boundary, as TMA reads it; x itself when it already does."""
    if tuple(x.shape) == shape and x.data_ptr() % 16 == 0:
        return x
    out = x.new_zeros(shape)
    out[tuple(slice(0, n) for n in x.shape)] = x
    return out


def _launch_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2, M, K, N):
    global launches_bwd
    lib = _library_bwd()
    dev = y2.device
    if M == 0 or K == 0 or N == 0:
        return (torch.zeros((M, K), dtype=torch.bfloat16, device=dev),
                *(torch.zeros(K, dtype=torch.float32, device=dev) for _ in range(2)),
                torch.zeros((K, N), dtype=torch.float32, device=dev))
    # TMA reads rows whose stride is a multiple of 16 bytes: K and N go up to
    # multiples of 8, the added channels and columns zero (their z, G and
    # gradients are then 0), and the outputs are cut back
    Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8
    y2p, y3p, gy3p = _padded(y2, (M, Kp)), _padded(y3, (M, Np)), _padded(gy3, (M, Np))
    scale_p, shift_p, wp = _padded(scale, (Kp,)), _padded(shift, (Kp,)), _padded(w, (Kp, Np))
    gs1p, gs2p = _padded(gs1, (Np,)), _padded(gs2, (Np,))
    plan = _bwd_plan(M, Kp, Np, local_sim._sm_count(dev))
    # every output element is written by the kernels: dy2 by the dz pass;
    # dscale, dshift and dw (one allocation) are zeroed by the prep kernel,
    # then summed into
    dy2 = torch.empty((M, Kp), dtype=torch.bfloat16, device=dev)
    sums = torch.empty(2 * Kp + Kp * Np, dtype=torch.float32, device=dev)
    dscale, dshift, dw = sums[:Kp], sums[Kp:2 * Kp], sums[2 * Kp:].view(Kp, Np)
    wb = torch.empty(plan.workspace_bytes // 2, dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_bn_bwd(
            y2p.data_ptr(), scale_p.data_ptr(), shift_p.data_ptr(), wp.data_ptr(),
            y3p.data_ptr(), gy3p.data_ptr(), gs1p.data_ptr(), gs2p.data_ptr(),
            dy2.data_ptr(), dscale.data_ptr(), dshift.data_ptr(), dw.data_ptr(), wb.data_ptr(),
            M, Kp, Np, plan.fused, plan.dz_rows, plan.dz_cols, plan.dz_grid, plan.dz_stages,
            plan.dw_cols, plan.dw_width, plan.dw_grid, plan.dw_stages, stream)
    if rc != 0:
        raise RuntimeError(f"fused_bn_bwd launch failed: {lib.fused_bn_bwd_error_string(rc).decode()}")
    with _launch_lock:
        launches_bwd += 1
    if (Kp, Np) != (K, N):
        dy2, dscale, dshift = dy2[:, :K].contiguous(), dscale[:K].contiguous(), dshift[:K].contiguous()
        dw = dw[:K, :N].contiguous()
    return dy2, dscale, dshift, dw
