"""Card tests of the port: the CUDA kernels against their plain versions.

This file imports neither JAX nor ``gloria_tpu``, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest`` because the repository's ``tests/conftest.py`` sets JAX
up.)  Without a card every test here skips.  Tolerances against the plain
versions, both sides f32 with TF32 off:
- forward (K1): 1e-3 absolute on log-similarities of magnitude ~1-20; only
  the summation order differs (cuBLAS products against tiled sums);
- backward (K2): 1e-3 · max|grad| + 1e-6 per output; the summation order
  differs, and the kernel adds the shares of the (image, text) pairs with
  atomics in an order that changes from run to run.
"""

import numpy as np
import pytest
import torch

from gloria_tpu_torch.ops import gloria_loss as tgl
from gloria_tpu_torch.ops import local_sim

KERNEL_TOL = 1e-3
GRAD_TOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("agg,convention,T,B,W,S,D", [
    ("max", "eval", 25, 64, 97, 362, 768),   # serving: 5 classes x 5 prompts, sink
    ("max", "eval", 25, 64, 97, 361, 768),   # serving without a sink
    ("sum", "train", 9, 5, 97, 362, 64),
    ("mean", "train", 7, 3, 13, 40, 32),
    ("max", "eval", 136, 130, 97, 362, 64),  # T and B above 128
])
def test_kernel_matches_plain(card, agg, convention, T, B, W, S, D):
    rng = np.random.RandomState(T * 1000 + B)
    caps = rng.randint(0, W - 1, size=T)
    caps[:3] = [0, 1, W - 2]
    words = torch.from_numpy(rng.randn(T, W, D).astype(np.float32)).to(card)
    regions = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(card)
    mask = tgl.make_word_mask(torch.from_numpy(caps).to(card), W, convention)
    before = local_sim.launches
    got = local_sim.local_similarities(words, regions, mask, agg=agg)
    torch.cuda.synchronize()
    assert local_sim.launches == before + 1
    ref = local_sim.local_similarities_plain(words, regions, mask, agg=agg)
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max()) <= KERNEL_TOL


@pytest.mark.cuda
def test_cuda_tensor_never_takes_the_plain_path(card, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel; it does not call the
    plain version, even when the launch fails."""
    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(local_sim, "local_similarities_plain", forbidden)
    words = torch.randn(2, 5, 8, device=card)
    regions = torch.randn(3, 7, 8, device=card)
    mask = torch.ones(2, 5, device=card)
    out = local_sim.local_similarities(words, regions, mask)
    assert out.shape == (3, 2) and out.is_cuda


def _train_inputs(card, agg_seed, T, B, W, S, D, caps):
    rng = np.random.RandomState(agg_seed)
    words = torch.from_numpy(rng.randn(T, W, D).astype(np.float32)).to(card)
    regions = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(card)
    g = torch.from_numpy(rng.randn(B, T).astype(np.float32)).to(card)
    mask = tgl.make_word_mask(torch.as_tensor(caps).to(card), W, "train")
    return words, regions, mask, g


@pytest.mark.cuda
@pytest.mark.parametrize("agg,T,B,W,S,D", [
    ("sum", 48, 48, 97, 361, 768),    # pretrain shape
    ("sum", 48, 48, 97, 362, 768),    # with the sink
    ("mean", 12, 10, 97, 361, 768),
    ("max", 12, 10, 97, 362, 768),
    ("sum", 136, 130, 97, 362, 64),   # T and B above 128
])
def test_bwd_kernel_matches_plain(card, agg, T, B, W, S, D):
    rng = np.random.RandomState(T + B)
    caps = rng.randint(23, 64, size=T)
    caps[:3] = [0, 1, W - 1]
    words, regions, mask, g = _train_inputs(card, T * 7 + B, T, B, W, S, D, caps)
    before = local_sim.launches_bwd
    dw, dr = local_sim.local_similarities_bwd(words, regions, mask, g, agg=agg)
    torch.cuda.synchronize()
    assert local_sim.launches_bwd == before + 1
    pw, pr = local_sim.local_similarities_bwd_plain(words, regions, mask, g, agg=agg)
    for got, ref in ((dw, pw), (dr, pr)):
        assert torch.isfinite(got).all()
        assert float((got - ref).abs().max()) <= GRAD_TOL * float(ref.abs().max()) + 1e-6


@pytest.mark.cuda
def test_fused_similarities_on_the_card_never_take_the_plain_path(card, monkeypatch):
    """Forward and backward of ``fused_local_similarities`` on CUDA tensors
    launch K1 once and K2 once, and agree with autograd through the plain
    version computed before the plain functions are forbidden."""
    words, regions, mask, g = _train_inputs(card, 3, 6, 5, 13, 41, 32, [12, 1, 0, 5, 9, 3])
    w_ref = words.clone().requires_grad_()
    r_ref = regions.clone().requires_grad_()
    ref = local_sim.local_similarities_plain(w_ref, r_ref, mask)
    (ref * g).sum().backward()

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(local_sim, "local_similarities_plain", forbidden)
    monkeypatch.setattr(local_sim, "local_similarities_bwd_plain", forbidden)
    w = words.clone().requires_grad_()
    r = regions.clone().requires_grad_()
    before = (local_sim.launches, local_sim.launches_bwd)
    sims = local_sim.fused_local_similarities(w, r, mask, 4.0, 5.0, "sum")
    (sims * g).sum().backward()
    torch.cuda.synchronize()
    assert (local_sim.launches, local_sim.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert float((sims - ref).abs().max()) <= KERNEL_TOL
    for got, exp in ((w.grad, w_ref.grad), (r.grad, r_ref.grad)):
        assert float((got - exp).abs().max()) <= GRAD_TOL * float(exp.abs().max()) + 1e-6
