"""K3's launch plan and the algebra of its passes, on the CPU.

The card kernel (``csrc/fused_bn_fwd.cu``) cannot run here, so this file
checks what surrounds it and what it computes:
- ``fused_bn._fwd_plan``: at ResNet-50's four tail shapes and at edge
  shapes, for 132 SMs and 5, the blocks' unit ranges cover each row and
  each N column exactly once, every SM works at the tail shapes, the ring
  fits in shared memory with at least 3 stages, z is made once per row
  tile and block, and the workspace is bf16(w) and the partial sums;
- ``_mirror_fwd_tiles``: the prep, main and stats passes in plain PyTorch
  over the plan's units (z over all of K, rows past M zero; products as f32
  sums of bf16 values over the staged chunks of K; y3 rounded to bf16; the
  column sums of the rounded y3 per warp, per warpgroup in warp order, into
  each warpgroup's row of partial sums; the rows added as the stats pass
  adds them), held with ``fused_bn.tail_errors`` against
  ``bottleneck_tail_plain`` and against the JAX op's Pallas forward in
  interpret mode, and its s1, s2 against float64 sums of its own y3.
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
# tests/test_torch_port_cuda.py's card cases (M, K, N)
EDGE_SHAPES = [(1, 16, 32), (48, 16, 32), (601, 24, 40), (600, 128, 128), (601, 128, 512),
               (601, 64, 256), (601, 64, 512), (48, 128, 512), (601, 256, 1024),
               (4801, 512, 2048), (300, 20, 36)]
ROWS = fused_bn._FWD_ROWS


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _jax_op():
    spec = importlib.util.spec_from_file_location(
        "_jax_fused_bn_reference_fwd", ROOT / "scripts" / "experiments" / "fused_bn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _aligned(n: int) -> int:
    return -(-n // 8) * 8


@pytest.mark.parametrize("m,k,n", TAIL_SHAPES + EDGE_SHAPES)
@pytest.mark.parametrize("sms", [H100_SMS, 5])
def test_fwd_plan_covers_every_entry_once(m, k, n, sms):
    K, N = _aligned(k), _aligned(n)  # the wrapper's padding
    plan = fused_bn._fwd_plan(m, K, N, sms)
    assert (plan.M, plan.K, plan.N) == (m, K, N)
    assert plan.width in (64, 128, 256) and plan.width == fused_bn._width(N)
    assert plan.depth * plan.width * 2 <= fused_bn._FWD_STAGE and plan.depth in (32, 64)
    assert plan.k_blocks * 64 >= K > (plan.k_blocks - 1) * 64
    assert 3 <= plan.stages <= fused_bn._MAX_STAGES
    assert fused_bn._fwd_smem(plan.k_blocks, plan.stages) <= fused_bn._SMEM_LIMIT
    assert (plan.stages == fused_bn._MAX_STAGES
            or fused_bn._fwd_smem(plan.k_blocks, plan.stages + 1) > fused_bn._SMEM_LIMIT)
    assert plan.grid == min(sms, plan.units)
    assert plan.workspace_bytes == 2 * K * N + 2 * plan.grid * 2 * N * 4

    # the blocks' ranges partition the units, each block has one at least
    units = [u for b in range(plan.grid) for u in plan.units_of(b)]
    assert units == list(range(plan.units))
    assert all(len(plan.units_of(b)) >= 1 for b in range(plan.grid))
    # the units cover every row once per chunk of N, every column once per row
    cover = np.zeros((plan.row_tiles * ROWS, plan.n_chunks * plan.width), np.int64)
    builds = 0
    for b in range(plan.grid):
        mine = plan.units_of(b)
        for u in mine:
            rt, nc = divmod(u, plan.n_chunks)
            cover[rt * ROWS:(rt + 1) * ROWS, nc * plan.width:(nc + 1) * plan.width] += 1
            builds += u == mine.start or nc == 0
    assert (cover == 1).all() and plan.row_tiles * ROWS >= m > (plan.row_tiles - 1) * ROWS
    assert plan.n_chunks * plan.width >= N > (plan.n_chunks - 1) * plan.width
    # z is made once per row tile and block that reaches it
    assert plan.row_tiles <= builds <= plan.row_tiles + plan.grid - 1


@pytest.mark.parametrize("m,k,n", TAIL_SHAPES)
def test_fwd_plan_fills_the_card_at_the_tail_shapes(m, k, n):
    """Every SM gets units; 256-column units; the ring keeps 5 stages at
    least beside z (8 up to K = 256)."""
    plan = fused_bn._fwd_plan(m, k, n, H100_SMS)
    assert plan.grid == H100_SMS and plan.width == 256 and plan.depth == 32
    assert plan.stages == (8 if k <= 256 else 5)


def test_fwd_plan_refuses_k_beyond_shared_memory():
    assert fused_bn._fwd_plan(129, 640, 64, H100_SMS).stages == 3
    with pytest.raises(ValueError, match="K <= 640"):
        fused_bn._fwd_plan(129, 648, 64, H100_SMS)


def _padded(x, shape):
    out = x.new_zeros(shape)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def _mirror_fwd_tiles(plan, y2, scale, shift, w):
    """The kernels' passes in plain PyTorch at the plan's (padded) K and N,
    over its units → (y3, s1, s2) cut back to the inputs' M and N.  Rows
    past M and columns past K and N arrive as zeros (TMA's fill)."""
    M, K, N = plan.M, plan.K, plan.N
    n_in = w.shape[1]
    y2 = _padded(y2, (plan.row_tiles * ROWS, K))
    scale, shift = _padded(scale, (K,)), _padded(shift, (K,))
    wb = _padded(w, (K, plan.n_chunks * plan.width)).to(torch.bfloat16).float()  # the prep pass
    y3 = torch.zeros((plan.row_tiles * ROWS, N), dtype=torch.bfloat16)
    part = torch.zeros((2 * plan.grid, 2, N))

    for b in range(plan.grid):  # the main pass, block by block
        mine = plan.units_of(b)
        for u in mine:
            rt, nc = divmod(u, plan.n_chunks)
            r0, c0 = rt * ROWS, nc * plan.width
            if u == mine.start or nc == 0:  # z of the row tile, over all of K
                z = torch.relu(y2[r0:r0 + ROWS].float() * scale + shift)
                z[max(0, M - r0):] = 0.0  # rows past M
                z = z.to(torch.bfloat16).float()
            acc = torch.zeros(ROWS, plan.width)
            for k0 in range(0, K, plan.depth):  # the staged chunks of bf16(w)
                acc += z[:, k0:k0 + plan.depth] @ wb[k0:k0 + plan.depth, c0:c0 + plan.width]
            tile = acc.to(torch.bfloat16)
            cols = min(plan.width, N - c0)
            y3[r0:r0 + ROWS, c0:c0 + cols] = tile[:, :cols]
            f = tile.float()[:, :cols]
            for g in range(2):  # each warpgroup: its 4 warps of 16 rows, added in warp order
                rows = f[64 * g:64 * g + 64]
                for stat, v in enumerate((rows, rows * rows)):
                    w0, w1, w2, w3 = (v[16 * i:16 * i + 16].sum(0) for i in range(4))
                    part[2 * b + g, stat, c0:c0 + cols] += ((w0 + w1) + w2) + w3

    # the stats pass: 32 groups of rows, each added in row order, then the groups in order
    n_rows = 2 * plan.grid
    groups = []
    for i in range(32):
        acc = torch.zeros(2, N)
        for r in range(i * n_rows // 32, (i + 1) * n_rows // 32):
            acc += part[r]
        groups.append(acc)
    stats = groups[0]
    for acc in groups[1:]:
        stats = stats + acc
    return y3[:M, :n_in].contiguous(), stats[0, :n_in], stats[1, :n_in]


def _inputs(m, k, n, seed):
    """(y2, scale, shift, w): CPU tensors from a numpy seed."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (t(rng.randn(m, k)).to(torch.bfloat16), t(rng.rand(k) + 0.5), t(rng.randn(k) * 0.2),
            t(rng.randn(k, n) * 0.1))


def _assert_within(errors):
    assert all(ratio <= 1.0 for _, ratio in errors.values()), errors


# the plan's regimes: one unit a row tile (N ≤ 256) or several; at 5 SMs a
# block walks several row tiles and reuses z across their chunks, at 132 a
# block's units start inside a row tile, which it then makes z for again;
# ragged last row tiles; K and N the wrapper pads; K over one z column block
MIRROR_SHAPES = [(1, 16, 32), (48, 16, 32), (600, 128, 128), (601, 24, 40), (300, 20, 36),
                 (601, 64, 256), (601, 128, 512), (601, 256, 1024), (601, 512, 2048),
                 (1201, 512, 2048), (601, 64, 512), (48, 128, 512)]


@pytest.mark.parametrize("sms", [H100_SMS, 5])
@pytest.mark.parametrize("m,k,n", MIRROR_SHAPES)
def test_mirror_matches_the_plain_forward(m, k, n, sms):
    args = _inputs(m, k, n, seed=m + 3 * k + n)
    plan = fused_bn._fwd_plan(m, _aligned(k), _aligned(n), sms)
    got = _mirror_fwd_tiles(plan, *args)
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    _assert_within(fused_bn.tail_errors(got, fused_bn.bottleneck_tail_plain(*args)))


# s1 and s2 against float64 sums of the y3 they come with: the mirror adds
# f32 values in a tree no deeper than about 70 sums (4 rows a lane, 4 lanes,
# 4 warps, a block's units, then the stats pass's rows and groups), so each
# sum is within 70·2⁻²⁴ ≈ 4.2e-6 of Σ|·| of its terms; 5e-6 of it, + 1e-6.
SUM_TOL = 5e-6


@pytest.mark.parametrize("sms", [H100_SMS, 5])
@pytest.mark.parametrize("m,k,n", [(601, 64, 256), (1201, 512, 2048), (300, 20, 36)])
def test_mirror_statistics_are_those_of_its_rounded_y3(m, k, n, sms):
    args = _inputs(m, k, n, seed=7 * m + k + n)
    plan = fused_bn._fwd_plan(m, _aligned(k), _aligned(n), sms)
    y3, s1, s2 = _mirror_fwd_tiles(plan, *args)
    f = y3.double()
    for got, terms in ((s1, f), (s2, f * f)):
        err = (got.double() - terms.sum(0)).abs()
        assert bool((err <= SUM_TOL * terms.abs().sum(0) + 1e-6).all()), float(err.max())


def test_mirror_matches_the_pallas_forward_in_interpret_mode():
    """The mirror against the JAX op's ``_fwd_pallas`` (interpret mode) on
    the same bf16 inputs, at K and N that the wrapper pads, with y3 allowed
    the share of z entries that the interpreter's fma rounds elsewhere
    (tests/test_torch_port_fused_bn.py:fma_share)."""
    m, k, n = 601, 24, 40
    args = _inputs(m, k, n, seed=21)
    plan = fused_bn._fwd_plan(m, _aligned(k), _aligned(n), H100_SMS)
    got = _mirror_fwd_tiles(plan, *args)
    y2, scale, shift, w = args
    ref = _jax_op()._fwd_pallas(jnp.asarray(y2.float().numpy(), jnp.bfloat16),
                                jnp.asarray(scale.numpy()), jnp.asarray(shift.numpy()),
                                jnp.asarray(w.numpy()), interpret=True)
    y2f, sc, sh = y2.float().numpy(), scale.numpy(), shift.numpy()
    a_fma = (y2f.astype(np.float64) * sc + sh).astype(np.float32)
    a_mul_add = (y2f * sc).astype(np.float32) + sh
    bf = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float()
    slack = (bf(np.maximum(a_fma, 0)) - bf(np.maximum(a_mul_add, 0))).abs() @ bf(w.numpy()).abs()
    _assert_within(fused_bn.tail_errors(
        got, [torch.from_numpy(np.array(r, np.float32)) for r in ref], slack))
