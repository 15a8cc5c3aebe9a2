"""TPAVI non-local fusion block, dot mode (port of ``glfusion_tpu/models/tpavi.py``).

Operates on a stacked multi-view feature volume, (B, V, H, W, C) at the
public interface as in JAX, over N = V·H·W tokens:

  θ, φ, g : 1×1×1 convs C → C' (C' = C/2 by default), with bias
  y = (θφᵀ / N)·g   (no softmax)
  W_z     : 1×1×1 conv C' → C, then BatchNorm3d whose scale and bias start
            at ZERO, so at initialization the block is identity + LayerNorm
  z = LayerNorm(W_z(y) + x) over channels, eps 1e-5

Parameter names are the reference's (``theta``, ``phi``, ``g``, ``W_z.0``,
``W_z.1``, ``norm_layer``); the 1×1×1 convs are applied as matmuls on the
(B, N, C) token matrix. The reference's unused audio path
(``align_channel``) is left out, as in JAX.

Compute type (``models/precision.py``): the projections cast tokens and
weights to ``dtype`` and return it; the plain attention orders return
float32 (JAX's ``preferred_element_type``), the kernel ``dtype``; W_z casts
y to ``dtype``; its BN and the LayerNorm normalize in float32 and return
``dtype``.

``attn_impl="pallas"`` runs the products in the hand-written CUDA kernel
(``ops/tpavi_fused.py``); any other value goes to
``ops/nonlocal_attn.py`` ('auto' | 'naive' | 'reassoc').
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import linear
from glfusion_tpu_torch.ops.nonlocal_attn import dot_nonlocal_attention
from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal


def _linear(conv: nn.Conv3d, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """A 1×1×1 Conv3d applied to (..., C_in) tokens, in ``dtype``."""
    return linear(x, conv.weight.flatten(1), conv.bias, dtype)


class TPAVI(nn.Module):
    def __init__(self, channels: int, inter_channels: int | None = None,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        inter = inter_channels or max(channels // 2, 1)
        self.inter = inter
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.theta = nn.Conv3d(channels, inter, 1)
        self.phi = nn.Conv3d(channels, inter, 1)
        self.g = nn.Conv3d(channels, inter, 1)
        self.W_z = nn.Sequential(nn.Conv3d(inter, channels, 1),
                                 nn.BatchNorm3d(channels))
        nn.init.zeros_(self.W_z[1].weight)
        nn.init.zeros_(self.W_z[1].bias)
        self.norm_layer = nn.LayerNorm(channels, eps=1e-5)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x: (B, V, H, W, C) → (B, V, H, W, C).

        kv: optional same-shape volume supplying the φ keys (cross-view
        attention); defaults to self-attention.
        """
        b, v, h, w, c = x.shape
        n = v * h * w
        dt = self.dtype
        tokens = x.reshape(b, n, c)
        if kv is None and not self.training:
            # Eval fast path: θ, φ, g project the same tokens, so run them
            # as ONE C → 3·C' product and split. The split views keep unit
            # channel stride, which the kernel takes without a copy.
            convs = (self.theta, self.phi, self.g)
            weight = torch.cat([m.weight.flatten(1) for m in convs])
            bias = torch.cat([m.bias for m in convs])
            theta, phi, g = linear(tokens, weight, bias, dt).split(
                self.inter, dim=-1)
        else:
            kv_tokens = tokens if kv is None else kv.reshape(b, n, c)
            theta = _linear(self.theta, tokens, dt)
            phi = _linear(self.phi, kv_tokens, dt)
            g = _linear(self.g, tokens, dt)

        if self.attn_impl == "pallas":
            y = fused_dot_nonlocal(theta, phi, g)
        else:
            y = dot_nonlocal_attention(theta, phi, g, impl=self.attn_impl)

        conv, bn = self.W_z
        wy = _linear(conv, y, dt).reshape(b * n, c)
        if self.training and bn.num_batches_tracked is not None:
            bn.num_batches_tracked.add_(1)
        # BatchNorm3d over (B, C, V, H, W) normalizes each channel over
        # B·V·H·W, i.e. over the rows of the token matrix.
        wy = F.batch_norm(wy, bn.running_mean, bn.running_var, bn.weight,
                          bn.bias, self.training, bn.momentum, bn.eps)
        z = wy.reshape(b, n, c) + tokens
        if dt == torch.float32:
            z = self.norm_layer(z)
        else:  # normalized in float32, rounded once (CUDA's layer_norm
            # takes no bfloat16 input with float32 affine)
            z = self.norm_layer(z.float()).to(dt)
        return z.reshape(b, v, h, w, c)
