"""The port's fused bottleneck tail (``gloria_tpu_torch.experiments.fused_bn``)
against the JAX op ``scripts/experiments/fused_bn.py``.

Inputs come from numpy seeds and go through both packages; on the CPU the
port runs its plain versions.  The JAX op runs through its reference
(``impl="reference"``) and through its Pallas kernels in interpret mode
(``impl="interpret"``).  Tolerances (the same hold the CUDA kernels against
the plain versions on the card, in ``chip_smoke.py``; the constants and
the checks are ``fused_bn.tail_errors`` / ``grad_errors``):
- y3: each entry within one bf16 ulp, ``|Δ| ≤ 2⁻⁷·|ref| + 1e-6``, and at most
  1e-3 of the entries differing at all (sums in another order can round the
  f32 sum to the neighbouring bf16 value).  Against the interpreter only,
  an entry may also move by the share of the z entries its row rounds to
  another bf16 value: XLA's CPU fusion there takes ``y2·scale + shift`` as
  one fma, where the op's contract (and its reference) rounds the product
  first.  At (600, 128, 128) one z entry of 76800 flips, and two y3 entries
  of its row then differ by more than one ulp (0.00360 against 0.00328);
- s1: per channel within ``1e-4 · Σ_rows|y3| + 1e-6``; s2 within
  ``1e-4 · s2 + 1e-6`` (f32 sums over bf16 values, another order);
- dy2: within one bf16 ulp of its largest entry + 1e-6, ``2^(⌊log2 max|dy2|⌋ − 7)``,
  2⁻⁸ to 2⁻⁷ of it (``5e-3 · max|dy2|`` falls short of one ulp when the
  largest entry sits low in its binade: on the card, max|dy2| ≈ 24 at
  ResNet-50's layer 4 with one entry one ulp, 0.125, off);
- dscale, dshift, dW: within ``1e-3 · max|·| + 1e-6`` (f32 sums).
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gloria_tpu_torch.experiments import fused_bn
from gloria_tpu_torch.utils import cuda_build

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@functools.cache
def _jax_op():
    """The JAX op, loaded from its file under a private name (a plain import
    would need ``scripts/experiments`` on sys.path, and its generic module
    name would then leak into every later test of the process)."""
    spec = importlib.util.spec_from_file_location(
        "_jax_fused_bn_reference", ROOT / "scripts" / "experiments" / "fused_bn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(m, k, n, seed):
    """numpy f32 arrays; y2 rounded to bf16 values, so both packages see the
    same bf16 tensor."""
    rng = np.random.RandomState(seed)
    y2 = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(torch.bfloat16).float().numpy()
    scale = (rng.rand(k) + 0.5).astype(np.float32)
    shift = (rng.randn(k) * 0.2).astype(np.float32)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    return y2, scale, shift, w


def _torch(y2, scale, shift, w):
    return (torch.from_numpy(y2).to(torch.bfloat16), torch.from_numpy(scale),
            torch.from_numpy(shift), torch.from_numpy(w))


def _jnp(y2, scale, shift, w):
    return jnp.asarray(y2, jnp.bfloat16), jnp.asarray(scale), jnp.asarray(shift), jnp.asarray(w)


def _bf16_values(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def fma_share(y2, scale, shift, w):
    """[M, N]: how far y3 moves when z comes from ``y2·scale + shift`` taken
    as one fma (one rounding) instead of a product and then a sum, the
    contract: Σ_k |Δz[m, k]| · |bf16(w)[k, n]|, zero in rows where no z
    entry rounds to another bf16 value."""
    a_fma = (y2.astype(np.float64) * scale + shift).astype(np.float32)
    a_mul_add = (y2 * scale).astype(np.float32) + shift
    dz = np.abs(_bf16_values(np.maximum(a_fma, 0)) - _bf16_values(np.maximum(a_mul_add, 0)))
    return dz @ np.abs(_bf16_values(w))


def _as_torch(x):
    return x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x, np.float32))


def assert_tail_close(got, ref, y3_slack=0.0):
    errors = fused_bn.tail_errors(got, [_as_torch(r) for r in ref], _as_torch(y3_slack))
    assert all(ratio <= 1.0 for _, ratio in errors.values()), errors


def assert_grads_close(got, ref):
    """got, ref: (dy2, dscale, dshift, dw)."""
    assert all(torch.isfinite(g).all() for g in got)
    errors = fused_bn.grad_errors(got, [_as_torch(r) for r in ref])
    assert all(ratio <= 1.0 for _, ratio in errors.values()), errors


SHAPES = [(1, 16, 32), (48, 16, 32), (600, 128, 128), (601, 24, 40)]  # (M, K, N)


@pytest.mark.parametrize("impl", ["reference", "interpret"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_forward_matches_jax(m, k, n, impl):
    args = _inputs(m, k, n, seed=m + k + n)
    ref = _jax_op().bottleneck_tail(*_jnp(*args), impl)
    got = fused_bn.bottleneck_tail_plain(*_torch(*args))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    assert_tail_close(got, ref, y3_slack=fma_share(*args) if impl == "interpret" else 0.0)


@pytest.mark.parametrize("x,ulp", [(1.0, 2.0 ** -7), (1.99, 2.0 ** -7), (24.0, 0.125),
                                   (-0.3, 2.0 ** -9), (0.0, 0.0)])
def test_bf16_ulp_is_the_spacing_of_bf16_values(x, ulp):
    assert fused_bn.bf16_ulp(x) == ulp
    if x:  # the gap to the next bf16 value up, from the bits
        b = torch.tensor([abs(x)], dtype=torch.bfloat16)
        up = (b.view(torch.int16) + 1).view(torch.bfloat16)
        assert float(up.float() - b.float()) == ulp


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    """On CPU tensors the wrapper and the autograd entry give the plain
    version's values exactly, and no kernel launch is counted."""
    tensors = _torch(*_inputs(601, 24, 40, seed=5))
    before = (fused_bn.launches_fwd, fused_bn.launches_bwd)
    plain = fused_bn.bottleneck_tail_plain(*tensors)
    for got in (fused_bn.bottleneck_tail_fwd(*tensors), fused_bn.bottleneck_tail(*tensors)):
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
    assert (fused_bn.launches_fwd, fused_bn.launches_bwd) == before


# (name, M, K, N, which cotangents the loss carries: y3, s1, s2)
BWD_CASES = [
    ("weighted", 48, 16, 32, (True, True, True)),
    ("weighted", 601, 24, 40, (True, True, True)),
    ("gs1-gs2-zero", 600, 128, 128, (True, False, False)),
    ("gy3-zero", 601, 24, 40, (False, True, True)),
]


@pytest.mark.parametrize("impl", ["reference", "interpret"])
@pytest.mark.parametrize("name,m,k,n,carried", BWD_CASES, ids=[
    f"{c[0]}-{c[1]}x{c[2]}x{c[3]}" for c in BWD_CASES])
def test_autograd_backward_matches_jax_grad(name, m, k, n, carried, impl):
    """The port's ``bottleneck_tail`` under torch autograd (plain backward on
    the CPU) against ``jax.grad`` of the JAX op, with the three outputs
    weighted as ``scripts/experiments/test_fused_bn.py`` weights them.  An
    output the torch loss leaves out gets autograd's zero cotangent; the JAX
    loss gives it weight 0."""
    args = _inputs(m, k, n, seed=3 * m + n)
    rng = np.random.RandomState(m + 7)
    c3 = rng.randn(m, n).astype(np.float32) * carried[0]
    c1 = rng.randn(n).astype(np.float32) * carried[1]
    c2 = (rng.randn(n) * 0.1).astype(np.float32) * carried[2]
    op = _jax_op()

    def loss(yy, sc, sh, ww):
        y3, s1, s2 = op.bottleneck_tail(yy, sc, sh, ww, impl)
        return jnp.sum(y3.astype(jnp.float32) * c3) + jnp.sum(s1 * c1) + jnp.sum(s2 * c2)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(*_jnp(*args))

    leaves = [t.requires_grad_() for t in _torch(*args)]
    y3, s1, s2 = fused_bn.bottleneck_tail(*leaves)
    terms = [(y3.float() * torch.from_numpy(c3)).sum(), (s1 * torch.from_numpy(c1)).sum(),
             (s2 * torch.from_numpy(c2)).sum()]
    sum(t for t, keep in zip(terms, carried) if keep).backward()
    got = [t.grad for t in leaves]
    assert got[0].dtype == torch.bfloat16 and got[3].dtype == torch.float32
    assert_grads_close(got, ref)


@pytest.mark.parametrize("case", ["y2 f32", "scale shape", "w non-contiguous", "w on meta",
                                  "meta device", "y2 1-D", "gy3 f32", "gs2 shape"])
def test_input_checks_raise(case):
    y2, scale, shift, w = _torch(*_inputs(8, 16, 32, seed=0))
    y3, gy3 = torch.zeros(8, 32, dtype=torch.bfloat16), torch.zeros(8, 32, dtype=torch.bfloat16)
    gs1, gs2 = torch.zeros(32), torch.zeros(32)
    fwd = None
    if case == "y2 f32":
        y2, err = y2.float(), TypeError
    elif case == "scale shape":
        scale, err = torch.ones(17), ValueError
    elif case == "w non-contiguous":
        w, err = torch.zeros(32, 16).t(), ValueError
    elif case == "w on meta":
        w, err = w.to("meta"), ValueError
    elif case == "meta device":
        y2, scale, shift, w = (t.to("meta") for t in (y2, scale, shift, w))
        err = ValueError
    elif case == "y2 1-D":
        y2, err = y2[0], ValueError
    elif case == "gy3 f32":
        gy3, err, fwd = gy3.float(), TypeError, False
    else:
        gs2, err, fwd = torch.zeros(31), ValueError, False
    if fwd is None:
        for fn in (fused_bn.bottleneck_tail_fwd, fused_bn.bottleneck_tail):
            with pytest.raises(err):
                fn(y2, scale, shift, w)
    with pytest.raises(err):
        fused_bn.bottleneck_tail_bwd(y2, scale, shift, w, y3, gy3, gs1, gs2)


def test_cuda_tensors_raise_when_the_build_fails_and_never_take_the_plain_path(monkeypatch):
    """CUDA-typed tensors (fake ones: no card here) reach the kernels' build;
    when it fails, the forward, the backward and the autograd entry raise
    its error and the plain versions are never called."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_nvcc(names):
        raise RuntimeError(f"nvcc not found, cannot build {names}")

    def forbidden(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(cuda_build, "build", no_nvcc)
    monkeypatch.setattr(fused_bn, "bottleneck_tail_plain", forbidden)
    monkeypatch.setattr(fused_bn, "bottleneck_tail_bwd_plain", forbidden)
    fused_bn._library_fwd.cache_clear()
    fused_bn._library_bwd.cache_clear()
    before = (fused_bn.launches_fwd, fused_bn.launches_bwd)
    with FakeTensorMode():
        y2 = torch.zeros(64, 16, dtype=torch.bfloat16, device="cuda")
        scale, shift = torch.ones(16, device="cuda"), torch.zeros(16, device="cuda")
        w = torch.zeros(16, 32, device="cuda")
        y3 = torch.zeros(64, 32, dtype=torch.bfloat16, device="cuda")
        gs = torch.zeros(32, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found.*fused_bn_fwd"):
            fused_bn.bottleneck_tail_fwd(y2, scale, shift, w)
        with pytest.raises(RuntimeError, match="nvcc not found.*fused_bn_fwd"):
            fused_bn.bottleneck_tail(y2, scale, shift, w)
        with pytest.raises(RuntimeError, match="nvcc not found.*fused_bn_bwd"):
            fused_bn.bottleneck_tail_bwd(y2, scale, shift, w, y3, y3, gs, gs)
    assert (fused_bn.launches_fwd, fused_bn.launches_bwd) == before
