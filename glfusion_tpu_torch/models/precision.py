"""Compute types of the port's models, as flax's ``dtype`` field sets them.

Parameters stay float32; each layer casts its input and its parameters to
the compute type where it uses them, and autograd casts their gradients
back. The rounding points are the JAX package's:

* a convolution or a dense product returns the compute type (float32
  accumulation inside the library, one rounding of the output, then the
  bias added in the compute type);
* a product JAX asks for with ``preferred_element_type=float32``
  (:func:`matmul_f32`) returns the float32 accumulator unrounded;
* BatchNorm and LayerNorm take the compute type, normalize in float32
  (statistics, running averages and affine in float32) and return the
  compute type;
* elementwise operations (ReLU, adds, sigmoids) and each axis of the
  bilinear upsample (``ops/resize.py``) return the compute type.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in the compute type ``dtype``. float32, the reference's type,
    casts nothing: a float32 model computes as its tensors are, and a
    float64 copy of it (the tests' yardstick) stays float64."""
    return t if dtype == torch.float32 else t.to(dtype)


def compute_dtype(name: str) -> torch.dtype:
    """The torch type of a configuration's ``dtype`` name."""
    if name not in DTYPES:
        raise ValueError(f"dtype {name!r}: the port computes in "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


class _ComputeConv:
    """Mixin of a torch convolution computing in ``compute_dtype`` (flax's
    ``nn.Conv(dtype=...)``): input, weight and bias are cast at use and the
    output is in that type. Outside float32 the bias is added after the
    convolution's output is rounded, a second rounding, as flax does. The
    state dict is the torch module's."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def _unbiased(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, w, None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x)
        y = self._unbiased(x.to(dt), self.weight.to(dt))
        if self.bias is None:
            return y
        return y + self.bias.to(dt).view(-1, *(1,) * (y.dim() - 2))


class Conv1d(_ComputeConv, nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype``."""


class Conv2d(_ComputeConv, nn.Conv2d):
    """``nn.Conv2d`` computing in ``compute_dtype``."""


class Conv3d(_ComputeConv, nn.Conv3d):
    """``nn.Conv3d`` computing in ``compute_dtype``."""


class ConvTranspose3d(_ComputeConv, nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` computing in ``compute_dtype`` (no
    ``output_size`` argument)."""

    def _unbiased(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose3d(x, w, None, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """``F.linear`` in the compute type, as flax's ``nn.Dense(dtype=...)``:
    outside float32 the product is rounded, then the bias added."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (:func:`linear`)."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias, self.compute_dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that takes the compute type, normalizes a float32
    copy outside float32 and rounds once (CUDA has no mixed-type
    ``layer_norm``). flax's default eps is 1e-6, torch's 1e-5: callers
    porting a flax ``nn.LayerNorm()`` pass ``eps=1e-6``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype in (torch.float32, torch.float64):
            return super().forward(x)
        return super().forward(x.float()).to(x.dtype)


class _MatmulF32(torch.autograd.Function):
    """(M, K) @ (K, N) of bfloat16 CUDA operands into a float32 result:
    one cuBLAS product whose float32 accumulator is returned unrounded."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        # Every caller rounds the float32 result to bfloat16 once, so the
        # cotangent arriving here is a bfloat16 value: the cast is exact
        g = g.to(a.dtype)
        return g @ b.t(), a.t() @ g


def matmul_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a (..., K) @ w (N, K)ᵀ`` with a float32 result: the operands'
    products summed in float32 and not rounded to their type, as JAX's
    ``einsum(..., preferred_element_type=float32)``. float32 (and float64)
    operands take a plain product; bfloat16 ones a float32-output product
    on CUDA, and on the CPU a product of their float32 copies (each
    bfloat16 product is exact in float32)."""
    if a.dtype != torch.bfloat16:
        return a @ w.t()
    if a.device.type == "cuda":
        flat = a.reshape(-1, a.shape[-1])
        return _MatmulF32.apply(flat, w.t()).view(*a.shape[:-1], w.shape[0])
    return a.float() @ w.float().t()
