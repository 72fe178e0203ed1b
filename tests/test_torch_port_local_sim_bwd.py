"""The port's local-similarity backward (K2's plain version) and its
``autograd.Function`` against the JAX package.

Inputs come from numpy seeds and go through both packages.  Tolerances:
- against autograd of ``local_matching`` at precision="highest" (f32 both
  sides, only the summation order differs): 1e-4 · max|grad| + 1e-6;
- against the Pallas backward ``_sims_bwd_impl`` in interpret mode
  (``jax.grad`` of ``fused_local_similarities``): 3% of max|grad| + 1e-4,
  the bf16-operand tolerance of ``tests/test_pallas_local_sim.py``;
- ``LocalSimilarities`` on CPU tensors against autograd through the plain
  version: the same arithmetic, so 1e-6 · max|grad|.
The CUDA kernel itself is compared with the plain version on the card in
``tests/test_torch_port_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gloria_tpu.ops import gloria_loss as gl
from gloria_tpu.ops.pallas.local_sim import fused_local_similarities as pallas_fused
from gloria_tpu_torch.ops import gloria_loss as tgl
from gloria_tpu_torch.ops import local_sim

GRAD_TOL = 1e-4
BF16_GRAD_TOL = 3e-2


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, T, B, W, R, D, cap_lens):
    rng = np.random.RandomState(seed)
    words = rng.randn(T, W, D).astype(np.float32)
    regions = rng.randn(B, R, D).astype(np.float32)
    sink = rng.randn(D).astype(np.float32)
    g = rng.randn(B, T).astype(np.float32)
    return words, regions, sink, g, np.asarray(cap_lens, np.int32)


def _assert_grad_close(got, ref, rel, floor):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()) + floor)


CASES = [
    # (agg, with sink, T, B, W, R, D, cap_lens): cap_len 1 and W - 2 in each
    ("sum", False, 5, 4, 13, 25, 32, [1, 11, 6, 3, 9]),
    ("sum", True, 4, 6, 10, 16, 24, [8, 1, 5, 2]),
    ("mean", False, 6, 3, 12, 20, 16, [10, 1, 4, 7, 2, 5]),
    ("mean", True, 3, 2, 97, 40, 8, [95, 1, 30]),
    ("max", False, 4, 5, 9, 18, 16, [7, 1, 3, 5]),
    ("max", True, 5, 3, 11, 22, 24, [9, 1, 4, 6, 2]),
]


@pytest.mark.parametrize("agg,with_sink,T,B,W,R,D,cap_lens", CASES)
def test_plain_bwd_matches_local_matching_grads(agg, with_sink, T, B, W, R, D, cap_lens):
    words, regions, sink, g, caps = _inputs(0, T, B, W, R, D, cap_lens)
    mask = gl.make_word_mask(jnp.asarray(caps), W, "train")

    def sims(w, r, s):
        return gl.local_matching(w, r, mask, temp1=4.0, temp2=5.0, agg=agg,
                                 sink=s if with_sink else None, chunk=0, need_diag_attn=False,
                                 precision="highest").similarities

    _, vjp = jax.vjp(sims, jnp.asarray(words), jnp.asarray(regions), jnp.asarray(sink))
    ref_w, ref_r, ref_s = vjp(jnp.asarray(g))

    ctx = torch.from_numpy(regions)
    if with_sink:
        ctx = tgl.prepend_sink(ctx, torch.from_numpy(sink)).contiguous()
    dw, dctx = local_sim.local_similarities_bwd_plain(
        torch.from_numpy(words), ctx, torch.from_numpy(np.array(mask)), torch.from_numpy(g),
        agg=agg)
    _assert_grad_close(dw.numpy(), ref_w, GRAD_TOL, 1e-6)
    if with_sink:
        _assert_grad_close(dctx[:, 1:].numpy(), ref_r, GRAD_TOL, 1e-6)
        _assert_grad_close(dctx[:, 0].sum(0).numpy(), ref_s, GRAD_TOL, 1e-6)
    else:
        _assert_grad_close(dctx.numpy(), ref_r, GRAD_TOL, 1e-6)


def _argmax_margin(words, regions, mask, temp1=4.0, temp2=5.0):
    """Smallest ratio, over the (image, text) pairs, of the largest
    exp(temp2 · cos) over the valid words to the second largest."""
    ratios = []
    for t in range(words.shape[0]):
        w = torch.from_numpy(words[t])[None].expand(regions.shape[0], -1, -1)
        m = mask[t][None].expand(regions.shape[0], -1)
        ctx, _ = tgl.attention_fn(w, torch.from_numpy(regions), temp1, word_mask=m)
        cos = torch.nn.functional.cosine_similarity(w, ctx, dim=-1, eps=1e-8)
        e = torch.where(m, torch.exp(temp2 * cos), 0.0).sort(dim=-1, descending=True).values
        ratios.append(e[:, 0] / e[:, 1])
    return float(torch.cat(ratios).min())


@pytest.mark.parametrize("agg,T,B,W,S,D,cap_lens", [
    ("sum", 5, 3, 13, 26, 32, [11, 1, 4, 7, 2]),   # S = 25 regions + the sink
    ("mean", 10, 6, 13, 22, 32, [11, 1, 4, 7, 2, 9, 3, 5, 8, 6]),
    ("max", 10, 6, 13, 22, 32, [11, 1, 4, 7, 2, 9, 3, 5, 8, 6]),
])
def test_plain_bwd_matches_pallas_interpret(agg, T, B, W, S, D, cap_lens):
    rng = np.random.RandomState(0)
    words = rng.randn(T, W, D).astype(np.float32)
    regions = rng.randn(B, S, D).astype(np.float32)
    g = rng.randn(B, T).astype(np.float32)
    mask = gl.make_word_mask(jnp.asarray(np.asarray(cap_lens, np.int32)), W, "train")
    if agg == "max":
        # the max's gradient falls on one word per pair, and the Pallas forward
        # rounds its operands to bf16 (2^-9 relative, a few 1e-3 on temp2 · cos):
        # at a near-tie it may pick another word, a difference no tolerance
        # covers.  These inputs keep the top two words of every pair with more
        # than one valid word at least 2% apart in exp(temp2 · cos).
        multi = np.asarray(cap_lens) > 1
        assert _argmax_margin(words[multi], regions, torch.from_numpy(np.array(mask))[multi]) > 1.02

    def loss(w, r):
        return jnp.sum(pallas_fused(w, r, mask, 4.0, 5.0, agg, 8, 8, True) * g)

    ref_w, ref_r = jax.grad(loss, argnums=(0, 1))(jnp.asarray(words), jnp.asarray(regions))
    dw, dr = local_sim.local_similarities_bwd_plain(
        torch.from_numpy(words), torch.from_numpy(regions), torch.from_numpy(np.array(mask)),
        torch.from_numpy(g), agg=agg)
    _assert_grad_close(dw.numpy(), ref_w, BF16_GRAD_TOL, 1e-4)
    _assert_grad_close(dr.numpy(), ref_r, BF16_GRAD_TOL, 1e-4)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_function_on_cpu_equals_autograd_through_plain(agg):
    """``fused_local_similarities`` on CPU tensors: the plain forward and
    backward, no kernel launch, gradients in the caller's shapes even for a
    non-contiguous words view; the mask gets no gradient."""
    words, regions, _, g, caps = _inputs(2, 4, 3, 11, 19, 16, [9, 1, 5, 3])
    mask = tgl.make_word_mask(torch.from_numpy(caps), 11, "train")
    g = torch.from_numpy(g)

    # words arrive as a transposed view, as a [B, D, W] tensor's swapaxes would
    w_store = torch.from_numpy(words).transpose(1, 2).contiguous().requires_grad_()
    r_fused = torch.from_numpy(regions).requires_grad_()
    before = (local_sim.launches, local_sim.launches_bwd)
    sims = local_sim.fused_local_similarities(w_store.transpose(1, 2), r_fused, mask, 4.0, 5.0, agg)
    (sims * g).sum().backward()
    assert (local_sim.launches, local_sim.launches_bwd) == before

    w_ref = torch.from_numpy(words).requires_grad_()
    r_ref = torch.from_numpy(regions).requires_grad_()
    ref = local_sim.local_similarities_plain(w_ref, r_ref, mask, agg=agg)
    (ref * g).sum().backward()
    np.testing.assert_array_equal(sims.detach().numpy(), ref.detach().numpy())
    assert w_store.grad.shape == w_store.shape
    _assert_grad_close(w_store.grad.transpose(1, 2).numpy(), w_ref.grad.numpy(), 1e-6, 0.0)
    _assert_grad_close(r_fused.grad.numpy(), r_ref.grad.numpy(), 1e-6, 0.0)


def test_bwd_wrapper_rejects_bad_inputs():
    w = torch.zeros(2, 5, 8)
    r = torch.zeros(3, 7, 8)
    m = torch.ones(2, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"g must be \[B, T\]"):
        local_sim.local_similarities_bwd(w, r, m, torch.zeros(2, 3))
    with pytest.raises(TypeError, match="float32"):
        local_sim.local_similarities_bwd(w, r, m, torch.zeros(3, 2, dtype=torch.float64))
    with pytest.raises(TypeError, match="contiguous"):
        local_sim.local_similarities_bwd(w, r, m, torch.zeros(2, 3).T)
    with pytest.raises(ValueError, match="aggregation"):
        local_sim.local_similarities_bwd(w, r, m, torch.zeros(3, 2), agg="median")


# ---- the card kernel's algorithm, pass by pass, on the CPU --------------------
#
# ``csrc/local_sim_bwd.cu`` packs the valid words into columns and runs the
# TPU kernel's Gram route as dense passes over the images.  ``_mirror_bwd``
# repeats those passes in plain PyTorch, in the kernel's order and with its
# algebra (the segment softmax per text, the column sums over regions, the
# identity c = Σ_s a2·da2 = ddot·dot + 2·dcn2·cn2, dG folded as one symmetric
# product), so an error in that algebra shows here, before any card run.
# Tolerances: MIRROR_TOL · max|grad| against the plain version (f32 both
# sides, only the summation order differs).  Against the Pallas backward in interpret mode, which
# rounds its operands and several intermediates to bf16 (``_pad_operands``,
# the bf16 products of ``_bwd_kernel``), 1e-5 cannot hold: there the tests
# above hold the plain version at BF16_GRAD_TOL, and so does the mirror.

MIRROR_TOL = 1e-5
EPS = local_sim.EPS


def _mirror_bwd(words, regions, mask, g, *, temp1=4.0, temp2=5.0, agg="sum"):
    T, W, D = words.shape
    B, S, _ = regions.shape
    cols, col_text, text_start = local_sim._pack_columns(mask)
    N = cols.numel()
    assert int(text_start[-1]) == N
    if N == 0:
        return torch.zeros_like(words), torch.zeros_like(regions)
    seg = col_text.long()
    wc = words.reshape(T * W, D)[cols]                                # packed columns [N, D]
    ctx = regions
    wn = wc.square().sum(-1).clamp_min(1e-12).sqrt()                  # k2w_word_norms
    gram = ctx @ ctx.transpose(1, 2)                                  # k2p_gram [B, S, S]
    raw = ctx @ wc.T                                                  # k2p_raw [B, S, N]
    # k2w_row_softmax: per segment max and 1/sum, e2 = exp(temp1·a1 − max(temp1, 0))
    segs = seg.expand(B, S, N)
    row_m = torch.full((B, S, T), -torch.inf).scatter_reduce(2, segs, raw, "amax")
    ex = torch.exp(raw - row_m.gather(2, segs))
    row_iz = 1.0 / torch.zeros(B, S, T).index_add(2, seg, ex)
    a1 = ex * row_iz.gather(2, segs)
    e2 = torch.exp(temp1 * a1 - max(temp1, 0.0))
    a2 = e2 / e2.sum(1, keepdim=True)                                 # k2w_col_softmax
    dot = (a2 * raw).sum(1)                                           # [B, N]
    ga2 = gram @ a2                                                   # k2p_ga2
    # k2w_pair_stats
    cn2 = (a2 * ga2).sum(1)
    cn = cn2.clamp_min(1e-12).sqrt()
    den = (wn * cn).clamp_min(EPS)
    e = torch.exp(temp2 * (dot / den))
    if agg == "max":
        emax = torch.zeros(B, T).scatter_reduce(1, seg.expand(B, N), e, "amax")
        hit = (e == emax[:, seg]).float()
        hits = torch.zeros(B, T).index_add(1, seg, hit).clamp_min(1.0)
        p = hit / hits[:, seg]
    else:
        p = e / torch.zeros(B, T).index_add(1, seg, e).clamp_min(EPS)[:, seg]
    drow = g[:, seg] * temp2 * p
    ddot = drow / den
    dden = -drow * dot / (den * den)
    dcn2x2 = 2.0 * (dden * wn / (2.0 * cn))
    cc = ddot * dot + dcn2x2 * cn2
    dwn = dden * cn
    # k2w_row_draw
    u = a1 * temp1 * a2 * (ddot[:, None] * raw + dcn2x2[:, None] * ga2 - cc[:, None])
    rs = torch.zeros(B, S, T).index_add(2, seg, u)
    draw = u - a1 * rs.gather(2, segs) + ddot[:, None] * a2
    wa2 = dcn2x2[:, None] * a2
    dgram = wa2 @ a2.transpose(1, 2)                                  # k2p_dgram
    dregions = draw @ wc + dgram @ ctx                                # k2p_dreg_words, _gram
    part = torch.einsum("bsn,bsd->nd", draw, ctx)                     # k2p_dwords
    dwc = part + (dwn.sum(0) / wn.clamp_min(1e-12))[:, None] * wc     # k2w_scatter
    dwords = torch.zeros(T * W, D).index_copy(0, cols, dwc).reshape(T, W, D)
    return dwords, dregions



@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.float32])
def test_pack_columns(mask_dtype):
    W = 7
    caps = [0, 1, W - 1, 3, 0]
    mask = tgl.make_word_mask(torch.tensor(caps), W, "train").to(mask_dtype)
    cols, col_text, text_start = local_sim._pack_columns(mask)
    valid = np.asarray(mask) > 0
    expect = [t * W + w for t in range(len(caps)) for w in range(W) if valid[t, w]]
    assert cols.dtype == torch.int64 and cols.tolist() == expect
    assert col_text.dtype == torch.int32 and col_text.tolist() == [c // W for c in expect]
    counts = valid.sum(1)
    assert counts.tolist() == [0, 1, W - 1, 3, 0]
    assert text_start.dtype == torch.int32
    assert text_start.tolist() == [0, *np.cumsum(counts).tolist()]
    for t in range(len(caps)):  # text t owns text_start[t]:text_start[t + 1], its words in order
        own = cols[text_start[t]:text_start[t + 1]]
        assert (own // W == t).all() and (own % W).tolist() == np.flatnonzero(valid[t]).tolist()


def test_pack_columns_all_empty():
    cols, col_text, text_start = local_sim._pack_columns(torch.zeros(4, 9, dtype=torch.bool))
    assert cols.numel() == 0 and col_text.numel() == 0
    assert text_start.tolist() == [0] * 5


@pytest.mark.parametrize("B,N,D,sms", [(48, 2160, 768, 132), (130, 5850, 64, 132), (1, 3, 8, 132),
                                       (5, 4000, 768, 132), (7, 1, 1, 1)])
def test_dwords_splits_cover_every_image_once(B, N, D, sms):
    splits, per = local_sim._dwords_splits(B, N, D, sms)
    assert 1 <= splits <= B and per >= 1
    assert (splits - 1) * per < B <= splits * per  # the last range holds 1..per images


MIRROR_CASES = [
    # (agg, with sink, T, B, W, R, D, cap_lens): cap_len 0, 1 and W - 1 in each
    ("sum", False, 5, 4, 13, 25, 32, [1, 12, 0, 3, 9]),
    ("sum", True, 4, 6, 10, 16, 24, [9, 1, 0, 2]),
    ("mean", False, 6, 3, 12, 20, 16, [11, 1, 0, 7, 2, 5]),
    ("mean", True, 3, 2, 15, 40, 8, [14, 1, 0]),
    ("max", False, 4, 5, 9, 18, 16, [8, 1, 0, 5]),
    ("max", True, 5, 3, 11, 22, 24, [10, 1, 4, 0, 2]),
]


@pytest.mark.parametrize("agg,with_sink,T,B,W,R,D,cap_lens", MIRROR_CASES)
def test_kernel_algorithm_matches_plain(agg, with_sink, T, B, W, R, D, cap_lens):
    """The mirror against the plain version (autograd through the plain
    forward), which ``test_plain_bwd_matches_local_matching_grads`` holds
    against JAX's ``local_matching`` at precision="highest"."""
    words, regions, sink, g, caps = _inputs(3, T, B, W, R, D, cap_lens)
    mask = tgl.make_word_mask(torch.from_numpy(caps), W, "train")
    ctx = torch.from_numpy(regions)
    if with_sink:
        ctx = tgl.prepend_sink(ctx, torch.from_numpy(sink)).contiguous()
    tw, tg = torch.from_numpy(words), torch.from_numpy(g)
    dw, dctx = _mirror_bwd(tw, ctx, mask, tg, agg=agg)
    pw, pctx = local_sim.local_similarities_bwd_plain(tw, ctx, mask, tg, agg=agg)
    _assert_grad_close(dw.numpy(), pw.numpy(), MIRROR_TOL, 0.0)
    _assert_grad_close(dctx.numpy(), pctx.numpy(), MIRROR_TOL, 0.0)


@pytest.mark.parametrize("agg,T,B,W,S,D,cap_lens", [
    ("sum", 5, 3, 13, 26, 32, [11, 1, 4, 7, 2]),   # S = 25 regions + the sink
    ("mean", 10, 6, 13, 22, 32, [11, 1, 4, 7, 2, 9, 3, 5, 8, 6]),
    ("max", 10, 6, 13, 22, 32, [11, 1, 4, 7, 2, 9, 3, 5, 8, 6]),
])
def test_kernel_algorithm_matches_pallas_interpret(agg, T, B, W, S, D, cap_lens):
    """The inputs of ``test_plain_bwd_matches_pallas_interpret`` (its argmax
    margin holds for them), through the mirror."""
    rng = np.random.RandomState(0)
    words = rng.randn(T, W, D).astype(np.float32)
    regions = rng.randn(B, S, D).astype(np.float32)
    g = rng.randn(B, T).astype(np.float32)
    mask = gl.make_word_mask(jnp.asarray(np.asarray(cap_lens, np.int32)), W, "train")

    def loss(w, r):
        return jnp.sum(pallas_fused(w, r, mask, 4.0, 5.0, agg, 8, 8, True) * g)

    ref_w, ref_r = jax.grad(loss, argnums=(0, 1))(jnp.asarray(words), jnp.asarray(regions))
    dw, dr = _mirror_bwd(torch.from_numpy(words), torch.from_numpy(regions),
                         torch.from_numpy(np.array(mask)), torch.from_numpy(g), agg=agg)
    _assert_grad_close(dw.numpy(), ref_w, BF16_GRAD_TOL, 1e-4)
    _assert_grad_close(dr.numpy(), ref_r, BF16_GRAD_TOL, 1e-4)


@pytest.mark.parametrize("agg", ["sum", "max"])
def test_all_captions_empty_gives_zero_gradients(agg):
    """N = 0: the similarities are log(1e-8) whatever the inputs, so both
    gradients are 0, in the mirror and through the wrapper on the CPU."""
    words, regions, _, g, _ = _inputs(4, 3, 2, 6, 9, 8, [0, 0, 0])
    mask = torch.zeros(3, 6, dtype=torch.bool)
    args = (torch.from_numpy(words), torch.from_numpy(regions), mask, torch.from_numpy(g))
    for dw, dr in (_mirror_bwd(*args, agg=agg), local_sim.local_similarities_bwd(*args, agg=agg)):
        assert dw.shape == (3, 6, 8) and dr.shape == (2, 9, 8)
        assert not dw.any() and not dr.any()
