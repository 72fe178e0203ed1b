"""K4's launch plan and the algebra of its two passes, on the CPU.

The card kernel (``csrc/fused_bn_bwd.cu``) cannot run here, so this file
checks what surrounds it and what it computes:
- ``fused_bn._bwd_plan``: at ResNet-50's four tail shapes and at edge
  shapes, every row, K column and N column is covered exactly once by each
  pass, the dW pass's M splits fill one wave of 132 SMs at the tail shapes,
  the rings fit in shared memory with at least 3 stages, and the workspace
  is bf16(w);
- ``_mirror_bwd_tiles``: the prep, dz and dW passes in plain PyTorch over
  the plan's tiles, chunks and M splits, in the kernels' grouping (products
  as f32 sums of bf16 values, a block's column sums added once), held
  against ``bottleneck_tail_bwd_plain`` and against the JAX op's Pallas
  backward in interpret mode with ``fused_bn.grad_errors`` (dy2 within one
  bf16 ulp of its largest entry, dscale, dshift and dW within 1e-3 of their
  largest: f32 sums in another order).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gloria_tpu_torch.experiments import fused_bn

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132
TAIL_SHAPES = [(270000, 64, 256), (69312, 128, 512), (17328, 256, 1024), (4800, 512, 2048)]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _jax_op():
    spec = importlib.util.spec_from_file_location(
        "_jax_fused_bn_reference_bwd", ROOT / "scripts" / "experiments" / "fused_bn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _aligned(n: int) -> int:
    return -(-n // 8) * 8


def _smem_dz(plan) -> int:
    """csrc/fused_bn_bwd.cu:dz_smem: the ring with its gs1 / gs2 slices, the
    K tile's scale and shift, the warps' column sums, the barriers."""
    stage = (2 * plan.dz_rows + plan.dz_cols) * fused_bn._ROW_BYTES + 8 * 64
    return (fused_bn._ATOM + plan.dz_stages * stage + 8 * plan.dz_cols
            + plan.dz_rows // 16 * 8 * plan.dz_cols + fused_bn._BARRIER_BYTES)


def _smem_fused(plan) -> int:
    """csrc/fused_bn_bwd.cu:fused_smem: the ring (y3, gy3, bf16(w), y2 and
    the gs1 / gs2 slices), z, scale and shift, column sums, barriers."""
    return (fused_bn._ATOM + plan.dz_stages * (4 * 64 * fused_bn._ROW_BYTES + 8 * 64)
            + 64 * fused_bn._ROW_BYTES + 8 * 64 + 4 * 8 * 64 + fused_bn._BARRIER_BYTES)


def _smem_dw(plan) -> int:
    """csrc/fused_bn_bwd.cu:dw_smem: the ring with its scale, shift, gs1 and
    gs2 slices, the barriers."""
    stage = ((plan.dw_cols + 2 * plan.dw_width) * fused_bn._DW_ROWS * 2
             + 8 * (plan.dw_cols + plan.dw_width))
    return fused_bn._ATOM + fused_bn._BARRIER_BYTES + plan.dw_stages * stage


@pytest.mark.parametrize("m,k,n", TAIL_SHAPES + [(1, 64, 256), (601, 128, 512), (601, 16, 32),
                                                  (601, 24, 40), (300, 20, 36), (601, 64, 512)])
@pytest.mark.parametrize("sms", [H100_SMS, 7])
def test_bwd_plan_covers_every_entry_once(m, k, n, sms):
    K, N = _aligned(k), _aligned(n)  # the wrapper's padding
    plan = fused_bn._bwd_plan(m, K, N, sms)
    assert plan.workspace_bytes == 2 * K * N
    assert plan.fused == (K <= 64 and N <= 256)
    assert 3 <= plan.dz_stages <= fused_bn._MAX_STAGES
    assert plan.dz_rows in (64, 128) and plan.dz_cols in (64, 128, 256)
    assert plan.dw_cols in (64, 128) and plan.dw_width in (64, 128, 256)
    if plan.fused:  # one pass: 64-row tiles of all 64 channels; each block's dW spans K x N
        assert _smem_fused(plan) <= fused_bn._SMEM_LIMIT
        assert (plan.dz_rows, plan.dz_cols, plan.dz_k_tiles) == (64, 64, 1)
        assert plan.dw_width >= N and plan.dw_grid == plan.dw_units == plan.dw_stages == 0
    else:  # the kernels are built for 64 channels by 256 columns only, beside 128 channels
        assert plan.dw_cols == 128 or plan.dw_width == 256
        assert _smem_dz(plan) <= fused_bn._SMEM_LIMIT
        assert 3 <= plan.dw_stages <= fused_bn._MAX_STAGES and _smem_dw(plan) <= fused_bn._SMEM_LIMIT

    # dz pass: the tiles partition rows x K columns; each tile runs over all of N
    assert plan.dz_grid % plan.dz_k_tiles == 0
    assert plan.dz_k_tiles <= plan.dz_grid <= min(max(sms, plan.dz_k_tiles), plan.dz_tiles)
    rows = np.zeros(m, np.int64)
    cols = np.zeros((-(-m // plan.dz_rows), K), np.int64)
    for b in range(plan.dz_grid):
        for t in plan.dz_tiles_of(b):
            rt, kt = divmod(t, plan.dz_k_tiles)
            assert kt == b % plan.dz_k_tiles  # a block keeps one K tile
            cols[rt, kt * plan.dz_cols:(kt + 1) * plan.dz_cols] += 1
            if kt == 0:
                rows[rt * plan.dz_rows:(rt + 1) * plan.dz_rows] += 1
    assert (rows == 1).all() and (cols == 1).all()
    assert -(-N // 64) * 64 >= N
    if plan.fused:
        return

    # dW pass: the blocks' unit ranges partition the units; the tiles
    # partition K x N; each tile's chunks cover every row once
    units = [u for b in range(plan.dw_grid) for u in plan.dw_units_of(b)]
    assert units == list(range(plan.dw_units))
    assert plan.dw_grid == min(sms, plan.dw_units)
    tiles = plan.dw_units // plan.dw_chunks
    kn = np.zeros((K, N), np.int64)
    for tile in range(tiles):
        kt, nt = divmod(tile, plan.dw_n_tiles)
        kn[kt * plan.dw_cols:(kt + 1) * plan.dw_cols, nt * plan.dw_width:(nt + 1) * plan.dw_width] += 1
    assert (kn == 1).all()
    per_tile = np.zeros((tiles, m), np.int64)
    for u in units:
        tile, chunk = divmod(u, plan.dw_chunks)
        per_tile[tile, chunk * fused_bn._DW_ROWS:(chunk + 1) * fused_bn._DW_ROWS] += 1
    assert (per_tile == 1).all()


@pytest.mark.parametrize("m,k,n", TAIL_SHAPES)
def test_bwd_plan_fills_the_card_at_the_tail_shapes(m, k, n):
    """The tiles follow the tail: layer 1 (K = 64, N = 256) takes the fused
    pass on every SM; elsewhere the dz pass reads y3 and gy3 once per row
    while K ≤ 256, and the dW pass's splits fill one wave."""
    plan = fused_bn._bwd_plan(m, k, n, H100_SMS)
    assert plan.fused == (k == 64)
    assert plan.dz_k_tiles == (1 if k <= 256 else k // 256)
    assert plan.dz_cols == min(k, 256)  # no padded columns at K = 64, 128, 256
    assert plan.dw_width == 256 and plan.dw_cols == min(k, 128)
    if plan.fused:
        assert plan.dz_grid == H100_SMS and plan.dz_rows == 64
    else:
        assert plan.dz_grid == min(H100_SMS // plan.dz_k_tiles * plan.dz_k_tiles, plan.dz_tiles)
        assert plan.dz_rows == 128 and plan.dw_grid == H100_SMS


def _padded(x, shape):
    out = x.new_zeros(shape)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def _mirror_bwd_tiles(plan, y2, scale, shift, w, y3, gy3, gs1, gs2):
    """The kernels' passes in plain PyTorch at the plan's (padded) K and N,
    over its tiles, 64-column chunks of N, 32-row chunks of M and splits (or
    the fused pass's blocks); products are f32 sums of bf16 values → (dy2,
    dscale, dshift, dw) cut back to the inputs' K and N."""
    M, K, N = plan.M, plan.K, plan.N
    k_in, n_in = w.shape
    y2, y3, gy3 = _padded(y2, (M, K)), _padded(y3, (M, N)), _padded(gy3, (M, N))
    scale, shift, w = _padded(scale, (K,)), _padded(shift, (K,)), _padded(w, (K, N))
    gs1, gs2 = _padded(gs1, (N,)), _padded(gs2, (N,))
    wb = w.to(torch.bfloat16).float()  # the prep kernel
    dy2 = torch.zeros((M, K), dtype=torch.bfloat16)
    dscale, dshift, dw = torch.zeros(K), torch.zeros(K), torch.zeros((K, N))

    def cot(r0, r1, n0, n1):  # G = bf16(gy3 + gs1 + 2·y3·gs2)
        g = (gy3[r0:r1, n0:n1].float() + gs1[n0:n1]) + (2.0 * y3[r0:r1, n0:n1].float()) * gs2[n0:n1]
        return g.to(torch.bfloat16).float()

    # dz pass: per block, its tiles, each a sum over N in 64-column chunks
    for b in range(plan.dz_grid):
        k0 = b % plan.dz_k_tiles * plan.dz_cols
        k1 = min(K, k0 + plan.dz_cols)
        sums = torch.zeros(2, k1 - k0)
        for t in plan.dz_tiles_of(b):
            r0 = t // plan.dz_k_tiles * plan.dz_rows
            r1 = min(M, r0 + plan.dz_rows)
            dz = torch.zeros(r1 - r0, k1 - k0)
            for n0 in range(0, N, 64):
                n1 = min(N, n0 + 64)
                dz += cot(r0, r1, n0, n1) @ wb[k0:k1, n0:n1].T
            y = y2[r0:r1, k0:k1].float()
            dzm = dz * ((y * scale[k0:k1] + shift[k0:k1]) > 0).float()
            dy2[r0:r1, k0:k1] = (dzm * scale[k0:k1]).to(torch.bfloat16)
            sums += torch.stack([(dzm * y).sum(0), dzm.sum(0)])
        dscale[k0:k1] += sums[0]
        dshift[k0:k1] += sums[1]

    if plan.fused:  # dW summed over each block's tiles, chunk by chunk, added once
        for b in range(plan.dz_grid):
            part = torch.zeros(K, N)
            for t in plan.dz_tiles_of(b):
                r0, r1 = t * 64, min(M, t * 64 + 64)
                z = torch.relu(y2[r0:r1].float() * scale + shift).to(torch.bfloat16).float()
                for n0 in range(0, N, 64):
                    n1 = min(N, n0 + 64)
                    part[:, n0:n1] += z.T @ cot(r0, r1, n0, n1)
            dw += part
        return (dy2[:, :k_in].contiguous(), dscale[:k_in], dshift[:k_in],
                dw[:k_in, :n_in].contiguous())

    # dW pass: per block, its units in order; a tile's partial sum is added
    # where the block's units leave it
    rows = fused_bn._DW_ROWS
    for b in range(plan.dw_grid):
        mine = plan.dw_units_of(b)
        for u in mine:
            tile, chunk = divmod(u, plan.dw_chunks)
            kt, nt = divmod(tile, plan.dw_n_tiles)
            c0, n0, m0 = kt * plan.dw_cols, nt * plan.dw_width, chunk * rows
            c1, n1, m1 = min(K, c0 + plan.dw_cols), min(N, n0 + plan.dw_width), min(M, m0 + rows)
            if u == mine.start or chunk == 0:
                part = torch.zeros(c1 - c0, n1 - n0)
            a = y2[m0:m1, c0:c1].float() * scale[c0:c1] + shift[c0:c1]
            part += torch.relu(a).to(torch.bfloat16).float().T @ cot(m0, m1, n0, n1)
            if chunk == plan.dw_chunks - 1 or u == mine.stop - 1:
                dw[c0:c1, n0:n1] += part
    return (dy2[:, :k_in].contiguous(), dscale[:k_in], dshift[:k_in],
            dw[:k_in, :n_in].contiguous())


def _inputs(m, k, n, seed):
    """(y2, scale, shift, w), y3 from the plain forward, (gy3, gs1, gs2): CPU
    tensors from a numpy seed."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    args = (t(rng.randn(m, k)).to(torch.bfloat16), t(rng.rand(k) + 0.5), t(rng.randn(k) * 0.2),
            t(rng.randn(k, n) * 0.1))
    cots = (t(rng.randn(m, n)).to(torch.bfloat16), t(rng.randn(n)), t(rng.randn(n) * 0.1))
    return args, fused_bn.bottleneck_tail_plain(*args)[0], cots


def _assert_within(errors):
    assert all(ratio <= 1.0 for _, ratio in errors.values()), errors


MIRROR_SHAPES = [(1, 16, 32), (48, 16, 32), (600, 128, 128), (601, 24, 40),  # test_torch_port_fused_bn.SHAPES
                 (601, 64, 256), (601, 128, 512), (601, 256, 1024), (601, 512, 2048),
                 (601, 64, 512), (48, 128, 512)]  # the two passes at K = 64; 64-row dz tiles


@pytest.mark.parametrize("sms", [H100_SMS, 5])
@pytest.mark.parametrize("m,k,n", MIRROR_SHAPES)
def test_mirror_matches_the_plain_backward(m, k, n, sms):
    """At 5 SMs a block walks several tiles and its M split crosses tile
    boundaries, so the paths where partial sums are carried and added run."""
    args, y3, cots = _inputs(m, k, n, seed=m + 3 * k + n)
    plan = fused_bn._bwd_plan(m, _aligned(k), _aligned(n), sms)
    got = _mirror_bwd_tiles(plan, *args, y3, *cots)
    ref = fused_bn.bottleneck_tail_bwd_plain(*args, y3, *cots)
    assert got[0].dtype == torch.bfloat16 and all(g.dtype == torch.float32 for g in got[1:])
    _assert_within(fused_bn.grad_errors(got, ref))


def test_mirror_zero_channel_gets_exact_zero_gradients():
    """A channel whose z are all 0 (a ≤ 0 everywhere) gets dy2, dscale and
    dshift exactly 0, as the kernels' mask gives them."""
    args, y3, cots = _inputs(601, 64, 256, seed=9)
    y2, scale, shift, w = (a.clone() for a in args)
    y2[:, 0] = y2[:, 0].abs()
    scale[0], shift[0] = -scale[0].abs() - 0.5, -shift[0].abs() - 0.1
    plan = fused_bn._bwd_plan(601, 64, 256, H100_SMS)
    dy2, dscale, dshift, _ = _mirror_bwd_tiles(plan, y2, scale, shift, w, y3, *cots)
    assert bool((dy2[:, 0] == 0).all()) and float(dscale[0]) == 0.0 and float(dshift[0]) == 0.0


def test_mirror_matches_the_pallas_backward_in_interpret_mode():
    """The mirror against the JAX op's ``_bwd_pallas`` (interpret mode) on
    the same bf16 inputs and y3, at K and N that the wrapper pads."""
    m, k, n = 601, 24, 40
    args, y3, cots = _inputs(m, k, n, seed=21)
    plan = fused_bn._bwd_plan(m, _aligned(k), _aligned(n), H100_SMS)
    got = _mirror_bwd_tiles(plan, *args, y3, *cots)
    bf = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)
    f32 = lambda t: jnp.asarray(t.numpy())
    y2, scale, shift, w = args
    ref = _jax_op()._bwd_pallas(bf(y2), f32(scale), f32(shift), f32(w), bf(y3), bf(cots[0]),
                                f32(cots[1]), f32(cots[2]), interpret=True)
    _assert_within(fused_bn.grad_errors(
        got, [torch.from_numpy(np.array(r, np.float32)) for r in ref]))


@pytest.mark.parametrize("shape,x_shape,aligned_start", [
    ((24,), (20,), True), ((601, 40), (601, 40), False), ((601, 40), (601, 36), True)])
def test_padded_copies_only_what_tma_cannot_read(shape, x_shape, aligned_start):
    """``_padded`` returns the tensor itself when its shape is the padded
    one and it starts on a 16-byte boundary; else a zeroed copy."""
    base = torch.arange(int(np.prod(x_shape)) + 1, dtype=torch.float32)
    x = (base[:-1] if aligned_start else base[1:]).reshape(x_shape)
    out = fused_bn._padded(x, shape)
    assert tuple(out.shape) == shape and out.data_ptr() % 16 == 0
    inside = tuple(slice(0, s) for s in x_shape)
    assert torch.equal(out[inside], x)
    rest = torch.ones(shape, dtype=torch.bool)
    rest[inside] = False
    assert bool((out[rest] == 0).all())
    assert (out is x) == (shape == x_shape and x.data_ptr() % 16 == 0)
