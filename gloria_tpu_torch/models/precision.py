"""The compute-dtype policy: f32 parameters, activations stored in ``dtype``.

Port of the flax ``dtype`` / ``param_dtype=float32`` convention that the
JAX package's modules follow (``GLoRIA(dtype=jnp.bfloat16)``, what its
``run.py:216`` builds for precision 16 or bf16).  Parameters, BatchNorm
running statistics and LayerNorm parameters stay f32 ``nn.Parameter``s and
buffers; a layer casts them to its compute dtype where it uses them, as
flax's ``promote_dtype`` does, so the gradient reaches the f32 parameters
through that cast.  Every rounding point is an explicit :func:`round_to`
or :func:`widen` beside its JAX ``file:line`` (no ``torch.autocast``: its op
lists round elsewhere).  The default, ``torch.float32``, casts nothing:
each layer then runs the same operators as the plain ``nn`` layer it
extends, bit for bit, on whatever dtype the caller's tensors have (a module
cast to float64 as a whole still computes in float64).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in DTYPES:
        raise ValueError(f"compute dtype {dtype} is not one of {DTYPES} (float16 would need "
                         "loss scaling, which neither package has)")
    return dtype


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the reduced compute dtype ``dtype``; at float32,
    ``x`` itself."""
    return x if dtype == torch.float32 else x.to(dtype)


def widen(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in f32 under the reduced compute dtype ``dtype`` (JAX's
    ``astype(float32)`` after reduced-precision work); at float32, ``x``
    itself."""
    return x if dtype == torch.float32 else x.float()


class Linear(nn.Linear):
    """flax ``nn.Dense(dtype=compute_dtype, param_dtype=float32)``: input,
    kernel and bias cast to the compute dtype; the product is rounded to it,
    then the bias is added in it (two roundings,
    ``flax/linen/linear.py:Dense.__call__``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = check_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        if cd == torch.float32:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


class Conv2d(nn.Conv2d):
    """flax ``nn.Conv(use_bias=False, dtype=compute_dtype,
    param_dtype=float32)``, as every convolution of the backbones: input and
    kernel cast to the compute dtype, the output in it."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, bias=False, **kwargs)
        self.compute_dtype = check_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return self._conv_forward(round_to(x, cd), round_to(self.weight, cd), None)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=compute_dtype, param_dtype=float32)``:
    statistics, normalization and affine in f32 from the input cast to f32,
    the output cast to the compute dtype (``flax/linen/normalization.py:
    _compute_stats``, ``_normalize``)."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(normalized_shape, eps=eps)
        self.compute_dtype = check_dtype(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return round_to(super().forward(widen(x, cd)), cd)


def gelu(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Exact (erf) GELU of ``x`` (in compute dtype ``dtype``).  At float32
    ``F.gelu``; in a reduced dtype the formula of
    ``jax.nn.gelu(approximate=False)``, ``0.5 · x · erfc(−x · √½)``, with
    √½ rounded to that dtype and each operation rounded to it, as JAX
    evaluates it on the dtype's arrays."""
    if dtype == torch.float32:
        return F.gelu(x)
    sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.erfc(-x * sqrt_half)


def compute_dtype(module: nn.Module) -> torch.dtype:
    """The reduced compute dtype of any layer in ``module``, else float32."""
    for m in module.modules():
        cd = getattr(m, "compute_dtype", torch.float32)
        if cd != torch.float32:
            return cd
    return torch.float32


def refuse_dtype(dtype: torch.dtype, what: str, item: str) -> None:
    """Raise ``NotImplementedError`` naming ``item`` unless ``dtype`` is f32."""
    if dtype != torch.float32:
        raise NotImplementedError(f"{what} runs in float32 only; compute dtype {dtype} is not "
                                  f"ported there yet (queued in ROADMAP.md {item})")


def require_float32(module: nn.Module, what: str, item: str) -> None:
    """:func:`refuse_dtype` of ``module``'s compute dtype."""
    refuse_dtype(compute_dtype(module), what, item)


def require_float32_state(module: nn.Module) -> None:
    """The policy keeps every parameter and floating buffer (the BatchNorm
    running statistics) in at least f32: a module cast as a whole to a
    16-bit type (``.bfloat16()``) is refused, since its optimizer would then
    update rounded weights."""
    bad = [n for n, t in (*module.named_parameters(), *module.named_buffers())
           if t.is_floating_point() and t.element_size() < 4]
    if bad:
        raise ValueError(f"parameters and buffers stay float32 under the compute-dtype policy; "
                         f"{len(bad)} are not, e.g. {bad[:3]}: build the model with dtype= "
                         "instead of casting it")
