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
