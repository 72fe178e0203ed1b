"""The port's local-similarity wrapper and plain version against the JAX package.

Inputs come from numpy seeds and go through both packages.  Tolerances:
- against ``local_matching`` at precision="highest" (f32 both sides, only
  the summation order differs): 1e-4 absolute;
- against the Pallas kernel in interpret mode: 2e-2, the bf16-operand
  tolerance of ``tests/test_pallas_local_sim.py``.
The CUDA kernel itself is compared with the plain version on the card in
``tests/test_torch_port_cuda.py``.
"""

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
