"""TPAVI non-local fusion block (port of ``glfusion_tpu/models/tpavi.py``).

Operates on a stacked multi-view feature volume, (B, V, H, W, C) at the
public interface as in JAX, over N = V·H·W tokens:

  θ, φ, g : 1×1×1 convs C → C' (C' = C/2 by default), with bias
  y = (θφᵀ / N)·g   (mode 'dot', GL-Fusion's: no softmax)
  W_z     : 1×1×1 conv C' → C, then BatchNorm3d whose scale and bias start
            at ZERO, so at initialization the block is identity + LayerNorm
  z = LayerNorm(W_z(y) + x) over channels, eps 1e-5

The reference module's other modes (JAX ``TPAVI.mode``), on the same
tokens x and keys kv (x itself unless given):

  gaussian    : y = softmax(x kvᵀ)·g       (raw features; no θ, φ)
  embedded    : y = softmax(θ φᵀ)·g
  concatenate : y = (F / N)·g, F[i, j] = ReLU(W_f·[θᵢ ‖ φⱼ] + b_f)

with W_f a 1×1 conv 2C' → 1 (``W_f.0``, the reference's
``nn.Sequential(Conv2d, ReLU)``). The concatenation is not formed: W_f·[θᵢ
‖ φⱼ] is W_f[:C']·θᵢ + W_f[C':]·φⱼ, equal in real arithmetic, so the
pairwise map costs (B, N, N), not (B, N, N, 2C'). These modes are plain
products and a softmax; only ``dot`` has a hand-written kernel.

Parameter names are the reference's (``theta``, ``phi``, ``g``, ``W_z.0``,
``W_z.1``, ``norm_layer``); the 1×1×1 convs are applied as matmuls on the
(B, N, C) token matrix. The reference's unused audio path
(``align_channel``) is left out, as in JAX.

Compute type (``models/precision.py``): the projections cast tokens and
weights to ``dtype`` and return it; the plain attention orders return
float32 (JAX's ``preferred_element_type``), the kernel ``dtype``; W_z casts
y to ``dtype``; its BN and the LayerNorm normalize in float32 and return
``dtype``.

In ``dot`` mode ``attn_impl="pallas"`` runs the products in the
hand-written CUDA kernel (``ops/tpavi_fused.py``); any other value goes to
``ops/nonlocal_attn.py`` ('auto' | 'naive' | 'reassoc'). In the other modes
the products take the operands' type (JAX's einsums, no
``preferred_element_type``); ``concatenate``'s W_f, a flax ``Dense``
without a type, returns float32.

A sharded run (``parallel/``): with ``frames_split`` (a clip's frames
folded into the token axis, ``temporal``) the tokens are this rank's
frames of a clip split over the pass's batch axis
(``parallel.context.batch_axis()``). The attention's operands are then
gathered along the tokens, the attention runs once over all of them (the
kernel too, whole) and each rank keeps its own rows of y. Backward, the
rows' cotangents are gathered, every rank differentiates the whole
attention as one process does and keeps its own tokens' gradients.
``W_z``'s BatchNorm, swapped for the cross-rank one, normalizes over every
rank's rows.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import linear
from glfusion_tpu_torch.ops.nonlocal_attn import dot_nonlocal_attention
from glfusion_tpu_torch.ops.tpavi_fused import fused_dot_nonlocal
from glfusion_tpu_torch.parallel import context
from glfusion_tpu_torch.parallel.collectives import gather, own_rows
from glfusion_tpu_torch.parallel.norm import SyncBatchNorm


def _linear(conv: nn.Conv3d, x: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    """A 1×1×1 Conv3d applied to (..., C_in) tokens, in ``dtype``."""
    return linear(x, conv.weight.flatten(1), conv.bias, dtype)


MODES = ("dot", "gaussian", "embedded", "concatenate")


class TPAVI(nn.Module):
    def __init__(self, channels: int, inter_channels: int | None = None,
                 attn_impl: str = "auto", dtype: torch.dtype = torch.float32,
                 mode: str = "dot"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        inter = inter_channels or max(channels // 2, 1)
        self.inter = inter
        self.attn_impl = attn_impl
        self.dtype = dtype
        self.mode = mode
        if mode != "gaussian":
            self.theta = nn.Conv3d(channels, inter, 1)
            self.phi = nn.Conv3d(channels, inter, 1)
        self.g = nn.Conv3d(channels, inter, 1)
        if mode == "concatenate":
            self.W_f = nn.Sequential(nn.Conv2d(2 * inter, 1, 1), nn.ReLU())
        self.W_z = nn.Sequential(nn.Conv3d(inter, channels, 1),
                                 nn.BatchNorm3d(channels))
        nn.init.zeros_(self.W_z[1].weight)
        nn.init.zeros_(self.W_z[1].bias)
        self.norm_layer = nn.LayerNorm(channels, eps=1e-5)

    def _attention(self, theta: torch.Tensor, phi: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
        """y (B, N, C') of the projections, in every mode but gaussian."""
        n = theta.shape[1]
        if self.mode == "embedded":
            f = torch.matmul(theta, phi.transpose(1, 2))
            return torch.matmul(torch.softmax(f, dim=-1), g)
        if self.mode == "concatenate":
            wf = self.W_f[0]
            acc = torch.promote_types(theta.dtype, wf.weight.dtype)
            w = wf.weight.flatten()  # (2C'): θ's half, then φ's
            ti = theta.to(acc) @ w[:self.inter]
            pj = phi.to(acc) @ w[self.inter:]
            f = torch.relu(ti[:, :, None] + pj[:, None, :] + wf.bias)
            return torch.matmul(f / n, g.to(acc))
        if self.attn_impl == "pallas":
            return fused_dot_nonlocal(theta, phi, g)
        return dot_nonlocal_attention(theta, phi, g, impl=self.attn_impl)

    def forward(self, x: torch.Tensor, kv: torch.Tensor | None = None,
                frames_split: bool = False) -> torch.Tensor:
        """x: (B, V, H, W, C) → (B, V, H, W, C).

        kv: optional same-shape volume supplying the φ keys (cross-view
        attention); defaults to self-attention. ``frames_split``: the
        token axis holds this rank's frames of a clip split over the pass's
        batch axis (module docstring).
        """
        b, v, h, w, c = x.shape
        n = v * h * w
        dt = self.dtype
        tokens = x.reshape(b, n, c)
        kv_tokens = tokens if kv is None else kv.reshape(b, n, c)
        axis = context.batch_axis() if frames_split else None
        if axis is not None and axis.size == 1:
            axis = None

        def whole(*ts):  # every rank's tokens, in rank (frame) order
            if axis is None:
                return ts
            return tuple(gather(t, axis, 1) for t in ts)

        if self.mode == "gaussian":
            g = _linear(self.g, tokens, dt)
            q, k, g = whole(tokens, kv_tokens, g)
            f = torch.matmul(q, k.transpose(1, 2))
            y = torch.matmul(torch.softmax(f, dim=-1), g)
        else:
            if kv is None and not self.training:
                # Eval fast path: θ, φ, g project the same tokens, so run
                # them as ONE C → 3·C' product and split. The split views
                # keep unit channel stride, which the kernel takes without
                # a copy.
                convs = (self.theta, self.phi, self.g)
                weight = torch.cat([m.weight.flatten(1) for m in convs])
                bias = torch.cat([m.bias for m in convs])
                theta, phi, g = linear(tokens, weight, bias, dt).split(
                    self.inter, dim=-1)
            else:
                theta = _linear(self.theta, tokens, dt)
                phi = _linear(self.phi, kv_tokens, dt)
                g = _linear(self.g, tokens, dt)
            y = self._attention(*whole(theta, phi, g))
        if axis is not None:
            y = own_rows(y, axis, 1)

        conv, bn = self.W_z
        wy = _linear(conv, y, dt).reshape(b * n, c)
        # BatchNorm3d over (B, C, V, H, W) normalizes each channel over
        # B·V·H·W, i.e. over the rows of the token matrix.
        if isinstance(bn, SyncBatchNorm):
            wy = bn(wy)
        else:
            if self.training and bn.num_batches_tracked is not None:
                bn.num_batches_tracked.add_(1)
            wy = F.batch_norm(wy, bn.running_mean, bn.running_var,
                              bn.weight, bn.bias, self.training,
                              bn.momentum, bn.eps)
        z = wy.reshape(b, n, c) + tokens
        if dt == torch.float32:
            z = self.norm_layer(z)
        else:  # normalized in float32, rounded once (CUDA's layer_norm
            # takes no bfloat16 input with float32 affine)
            z = self.norm_layer(z.float()).to(dt)
        return z.reshape(b, v, h, w, c)
