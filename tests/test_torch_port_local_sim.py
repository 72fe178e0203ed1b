"""The port's local-similarity wrapper and plain version against the JAX package.

Inputs come from numpy seeds and go through both packages.  Tolerances:
- against ``local_matching`` at precision="highest" (f32 both sides, only
  the summation order differs): 1e-4 absolute;
- against the Pallas kernel in interpret mode: 2e-2, the bf16-operand
  tolerance of ``tests/test_pallas_local_sim.py``;
- the CUDA kernel's passes mirrored in plain PyTorch (``_mirror_fwd``)
  against the plain version: 1e-5 absolute.
The CUDA kernel itself is compared with the plain version on the card in
``tests/test_torch_port_cuda.py``.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gloria_tpu.ops import gloria_loss as gl
from gloria_tpu.ops.pallas.local_sim import pallas_local_similarities
from gloria_tpu_torch.ops import gloria_loss as tgl
from gloria_tpu_torch.ops import local_sim

F32_TOL = 1e-4
BF16_TOL = 2e-2


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
    return words, regions, sink, np.asarray(cap_lens, np.int32)


def _jax_matching(words, regions, mask, agg, sink):
    return np.asarray(gl.local_matching(
        jnp.asarray(words), jnp.asarray(regions), mask, temp1=4.0, temp2=5.0, agg=agg,
        sink=None if sink is None else jnp.asarray(sink), chunk=0, need_diag_attn=False,
        precision="highest").similarities)


def _port_plain(words, regions, mask, agg, sink):
    ctx = torch.from_numpy(regions)
    if sink is not None:
        ctx = tgl.prepend_sink(ctx, torch.from_numpy(sink))
    return local_sim.local_similarities(
        torch.from_numpy(words), ctx.contiguous(), torch.from_numpy(np.array(mask)),
        temp1=4.0, temp2=5.0, agg=agg).numpy()


CASES = [
    # (agg, convention, with sink, T, B, W, R, D, cap_lens)
    ("max", "eval", False, 5, 7, 13, 25, 32, [3, 0, 1, 11, 6]),
    ("max", "eval", True, 4, 3, 13, 25, 16, [11, 1, 0, 5]),
    ("sum", "train", True, 4, 6, 10, 16, 24, [8, 1, 0, 5]),
    ("sum", "train", False, 3, 2, 97, 361, 8, [95, 1, 0]),
    ("mean", "train", False, 6, 4, 12, 20, 16, [10, 1, 0, 4, 7, 2]),
    ("mean", "eval", True, 2, 5, 97, 361, 8, [95, 40]),
]


@pytest.mark.parametrize("agg,convention,with_sink,T,B,W,R,D,cap_lens", CASES)
def test_plain_matches_local_matching_highest(agg, convention, with_sink, T, B, W, R, D, cap_lens):
    words, regions, sink, caps = _inputs(0, T, B, W, R, D, cap_lens)
    sink = sink if with_sink else None
    mask = gl.make_word_mask(jnp.asarray(caps), W, convention)
    ref = _jax_matching(words, regions, mask, agg, sink)
    got = _port_plain(words, regions, mask, agg, sink)
    assert got.shape == (B, T) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("agg,convention,T,B,W,S,D,cap_lens", [
    ("max", "eval", 3, 2, 97, 362, 8, [95, 1, 0]),
    ("sum", "train", 5, 3, 13, 26, 32, [11, 1, 0, 4, 7]),
])
def test_plain_matches_pallas_interpret(agg, convention, T, B, W, S, D, cap_lens):
    """S is the region count with the sink already prepended (361 + 1)."""
    words, regions, _, caps = _inputs(1, T, B, W, S, D, cap_lens)
    mask = gl.make_word_mask(jnp.asarray(caps), W, convention)
    ref = np.asarray(pallas_local_similarities(
        jnp.asarray(words), jnp.asarray(regions), mask, temp1=4.0, temp2=5.0, agg=agg,
        interpret=True))
    got = _port_plain(words, regions, mask, agg, None)
    np.testing.assert_allclose(got, ref, rtol=0, atol=BF16_TOL)


def test_eval_entry_matches_jax_eval():
    """``local_similarities_eval`` (eval mask, max, sink) on the CPU ≡ JAX's."""
    words, regions, sink, caps = _inputs(2, 6, 4, 16, 30, 24, [14, 1, 0, 3, 9, 15])
    ref = np.asarray(gl.local_similarities_eval(
        jnp.asarray(regions), jnp.asarray(words), jnp.asarray(caps), sink=jnp.asarray(sink)))
    before = local_sim.launches
    got = tgl.local_similarities_eval(
        torch.from_numpy(regions), torch.from_numpy(words), torch.from_numpy(caps),
        sink=torch.from_numpy(sink)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=F32_TOL)
    assert local_sim.launches == before  # the CPU path launches no kernel


def test_empty_word_rows_give_log_eps_not_nan():
    words, regions, _, caps = _inputs(3, 3, 2, 9, 11, 8, [0, 0, 0])
    mask = torch.zeros(3, 9, dtype=torch.bool)
    for agg in ("sum", "max", "mean"):
        got = local_sim.local_similarities(torch.from_numpy(words), torch.from_numpy(regions),
                                           mask, agg=agg)
        np.testing.assert_allclose(got.numpy(), np.log(1e-8), rtol=1e-6)


def test_global_similarities_match_jax():
    rng = np.random.RandomState(4)
    img, txt = rng.randn(5, 16).astype(np.float32), rng.randn(7, 16).astype(np.float32)
    txt[2] = 0.0  # zero norm: clamped at EPS, as in JAX
    ref = np.asarray(gl.global_similarities(jnp.asarray(img), jnp.asarray(txt)))
    got = tgl.global_similarities(torch.from_numpy(img), torch.from_numpy(txt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("convention", ["train", "eval"])
def test_word_mask_matches_jax(convention):
    caps = np.asarray([0, 1, 5, 11, 12], np.int32)
    ref = np.asarray(gl.make_word_mask(jnp.asarray(caps), 12, convention))
    got = tgl.make_word_mask(torch.from_numpy(caps), 12, convention).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrapper_rejects_bad_inputs():
    w = torch.zeros(2, 5, 8)
    r = torch.zeros(3, 7, 8)
    m = torch.ones(2, 5, dtype=torch.bool)
    with pytest.raises(ValueError, match="forward-only"):
        local_sim.local_similarities(w.clone().requires_grad_(), r, m)
    with pytest.raises(TypeError, match="float32"):
        local_sim.local_similarities(w.double(), r, m)
    with pytest.raises(TypeError, match="word_mask"):
        local_sim.local_similarities(w, r, m.int())
    with pytest.raises(ValueError, match="shape mismatch"):
        local_sim.local_similarities(w, torch.zeros(3, 7, 4), m)
    with pytest.raises(ValueError, match="contiguous"):
        local_sim.local_similarities(w, torch.zeros(3, 8, 7).transpose(1, 2), m)
    with pytest.raises(ValueError, match="aggregation"):
        local_sim.local_similarities(w, r, m, agg="median")
    with pytest.raises(ValueError, match="temp1"):
        local_sim.local_similarities(w, r, m, temp1=100.0)


# ---- the card kernel's algorithm, pass by pass, on the CPU --------------------
#
# ``csrc/local_sim_fwd.cu`` (K1) packs the valid words into columns and runs
# the TPU kernel's Gram route as dense passes over the images; its first six
# passes (``csrc/local_sim_fwd_passes.cuh``) are K2's first six too.
# ``_mirror_fwd_passes`` repeats those passes in plain PyTorch, in the
# kernels' order and with their algebra (the word softmax per text segment of
# a row, the region softmax without a running max, cn2 through the Gram), up
# to e = exp(temp2 · cos) per column; ``_mirror_fwd`` adds K1's last pass,
# the aggregation per (image, text).  ``test_torch_port_local_sim_bwd.py``
# builds K2's mirror on the same passes.  Tolerances: MIRROR_TOL absolute
# against the plain version (f32 both sides, only the summation order
# differs); F32_TOL against ``local_matching`` and BF16_TOL against the
# Pallas kernel in interpret mode, as the plain version is held above.

MIRROR_TOL = 1e-5
EPS = local_sim.EPS


def _mirror_fwd_passes(words, regions, mask, *, temp1=4.0, temp2=5.0):
    """The shared forward passes over ``_pack_columns``'s columns, and the
    per-column cn2 and e of the kernels' last pass."""
    T, W, D = words.shape
    B, S, _ = regions.shape
    cols, col_text, text_start = local_sim._pack_columns(mask)
    N = cols.numel()
    assert int(text_start[-1]) == N
    seg = col_text.long()
    wc = words.reshape(T * W, D)[cols]                                # packed columns [N, D]
    ctx = regions
    wn = wc.square().sum(-1).clamp_min(1e-12).sqrt()                  # k?w_word_norms
    gram = ctx @ ctx.transpose(1, 2)                                  # k?p_gram [B, S, S]
    raw = ctx @ wc.T                                                  # k?p_raw [B, S, N]
    # k?w_row_softmax: per segment max and 1/sum, e2 = exp(temp1·a1 − max(temp1, 0))
    segs = seg.expand(B, S, N)
    row_m = torch.full((B, S, T), -torch.inf).scatter_reduce(2, segs, raw, "amax")
    ex = torch.exp(raw - row_m.gather(2, segs))
    row_iz = 1.0 / torch.zeros(B, S, T).index_add(2, seg, ex)
    a1 = ex * row_iz.gather(2, segs)
    e2 = torch.exp(temp1 * a1 - max(temp1, 0.0))
    a2 = e2 / e2.sum(1, keepdim=True)                                 # k?w_col_softmax
    dot = (a2 * raw).sum(1)                                           # [B, N]
    ga2 = gram @ a2                                                   # k?p_ga2
    cn2 = (a2 * ga2).sum(1)                                           # column_cn2
    cn = cn2.clamp_min(1e-12).sqrt()
    den = (wn * cn).clamp_min(EPS)
    e = torch.exp(temp2 * (dot / den))                                # column_exp
    return SimpleNamespace(cols=cols, seg=seg, segs=segs, wc=wc, wn=wn, raw=raw, a1=a1, a2=a2,
                           dot=dot, ga2=ga2, cn2=cn2, cn=cn, den=den, e=e)


def _mirror_fwd(words, regions, mask, *, temp1=4.0, temp2=5.0, agg="sum"):
    """K1: the forward passes, then ``k1w_pair_out``'s aggregation over each
    text's columns; a text with no column gets log(1e-8)."""
    T, B = words.shape[0], regions.shape[0]
    f = _mirror_fwd_passes(words, regions, mask, temp1=temp1, temp2=temp2)
    if agg == "max":
        v = torch.zeros(B, T).scatter_reduce(1, f.seg.expand(B, -1), f.e, "amax")
    else:
        v = torch.zeros(B, T).index_add(1, f.seg, f.e)
        if agg == "mean":
            v = v / torch.bincount(f.seg, minlength=T).clamp_min(1)
    return v.clamp_min(EPS).log()


def _mirror_inputs(seed, with_sink, T, B, W, R, D, cap_lens):
    words, regions, sink, caps = _inputs(seed, T, B, W, R, D, cap_lens)
    ctx = torch.from_numpy(regions)
    if with_sink:
        ctx = tgl.prepend_sink(ctx, torch.from_numpy(sink)).contiguous()
    return torch.from_numpy(words), ctx, caps


@pytest.mark.parametrize("with_sink,T,B,W,R,D,cap_lens", [
    # cap_len 0, 1 and W - 2 in each
    (False, 5, 4, 13, 25, 32, [11, 1, 0, 6, 3]),
    (True, 4, 3, 10, 16, 24, [0, 8, 1, 4]),
])
@pytest.mark.parametrize("convention", ["eval", "train"])
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_kernel_algorithm_matches_plain(agg, convention, with_sink, T, B, W, R, D, cap_lens):
    """The mirror against the plain version, which the tests above hold
    against JAX's ``local_matching`` at precision="highest"."""
    words, ctx, caps = _mirror_inputs(5, with_sink, T, B, W, R, D, cap_lens)
    mask = tgl.make_word_mask(torch.from_numpy(caps), W, convention)
    got = _mirror_fwd(words, ctx, mask, agg=agg)
    ref = local_sim.local_similarities_plain(words, ctx, mask, agg=agg)
    assert got.shape == (B, T) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=MIRROR_TOL)


@pytest.mark.parametrize("agg,convention,with_sink,T,B,W,R,D,cap_lens", [
    ("max", "eval", True, 4, 3, 13, 25, 16, [11, 1, 0, 5]),
    ("sum", "train", False, 5, 4, 12, 20, 16, [10, 1, 0, 4, 7]),
    ("mean", "train", True, 3, 2, 97, 40, 8, [95, 1, 30]),
])
def test_kernel_algorithm_matches_local_matching_highest(agg, convention, with_sink, T, B, W, R, D,
                                                         cap_lens):
    words, regions, sink, caps = _inputs(6, T, B, W, R, D, cap_lens)
    sink = sink if with_sink else None
    mask = gl.make_word_mask(jnp.asarray(caps), W, convention)
    ref = _jax_matching(words, regions, mask, agg, sink)
    ctx = torch.from_numpy(regions)
    if with_sink:
        ctx = tgl.prepend_sink(ctx, torch.from_numpy(sink)).contiguous()
    got = _mirror_fwd(torch.from_numpy(words), ctx, torch.from_numpy(np.array(mask)), agg=agg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("agg,convention,T,B,W,S,D,cap_lens", [
    ("max", "eval", 3, 2, 97, 362, 8, [95, 1, 0]),
    ("sum", "train", 5, 3, 13, 26, 32, [11, 1, 0, 4, 7]),
])
def test_kernel_algorithm_matches_pallas_interpret(agg, convention, T, B, W, S, D, cap_lens):
    """The inputs of ``test_plain_matches_pallas_interpret``, through the mirror."""
    words, regions, _, caps = _inputs(1, T, B, W, S, D, cap_lens)
    mask = gl.make_word_mask(jnp.asarray(caps), W, convention)
    ref = np.asarray(pallas_local_similarities(
        jnp.asarray(words), jnp.asarray(regions), mask, temp1=4.0, temp2=5.0, agg=agg,
        interpret=True))
    got = _mirror_fwd(torch.from_numpy(words), torch.from_numpy(regions),
                      torch.from_numpy(np.array(mask)), agg=agg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_kernel_algorithm_all_captions_empty(agg):
    """N = 0: no product runs, and every entry is log(1e-8), in the mirror
    as in the plain version."""
    words, ctx, _ = _mirror_inputs(7, True, 3, 2, 6, 9, 8, [0, 0, 0])
    mask = torch.zeros(3, 6, dtype=torch.bool)
    got = _mirror_fwd(words, ctx, mask, agg=agg)
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), np.full((2, 3), np.log(np.float32(1e-8))))
    ref = local_sim.local_similarities_plain(words, ctx, mask, agg=agg)
    np.testing.assert_allclose(ref.numpy(), got.numpy(), rtol=0, atol=MIRROR_TOL)


@pytest.mark.parametrize("D", [8, 30])
def test_pack_words(D):
    """The rows both kernels read: each valid word's vector, text by text,
    zero-padded to a multiple of 4 floats (D = 30: the padded path), from a
    16-byte aligned start."""
    W = 6
    rng = np.random.RandomState(8)
    words = torch.from_numpy(rng.randn(4, W, D).astype(np.float32))
    mask = tgl.make_word_mask(torch.tensor([0, 1, W - 1, 3]), W, "train")
    packed = local_sim._pack_words(words, mask)
    expect = words[mask]
    dp = -(-D // 4) * 4
    assert packed.wc.shape == (expect.shape[0], dp) and packed.wc.data_ptr() % 16 == 0
    np.testing.assert_array_equal(packed.wc[:, :D].numpy(), expect.numpy())
    assert not packed.wc[:, D:].any()
    assert packed.text_start.tolist() == [0, *np.cumsum(mask.sum(1).numpy()).tolist()]
    assert packed.cols.tolist() == np.flatnonzero(mask.numpy().reshape(-1)).tolist()
