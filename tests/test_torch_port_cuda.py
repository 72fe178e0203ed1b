"""Card tests of the port: the CUDA kernel against its plain version.

This file imports neither JAX nor ``gloria_tpu``, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest`` because the repository's ``tests/conftest.py`` sets JAX
up.)  Without a card every test here skips.  Tolerance against the plain
version: 1e-3 absolute on log-similarities of magnitude ~1-20; both sides
are f32 with TF32 off and differ only in summation order (the plain
version's cuBLAS products against the kernel's tiled sums).
"""

import numpy as np
import pytest
import torch

from gloria_tpu_torch.ops import gloria_loss as tgl
from gloria_tpu_torch.ops import local_sim

KERNEL_TOL = 1e-3


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
