"""Multi-view TimeSformer for scalar video regression in PyTorch (port of
``glfusion_tpu/models/timesformer.py``; reference
``models/TimeSformer.py``).

  * Input (B, V, F, H, W) single-channel multi-view video; each view is
    cut into p×p patches embedded by one Linear (``patch_embed``), and
    each view has its own learnable cls token (``cls_token`` (V, dim)).
  * Each layer: divided space-time attention, time attention folding the
    tokens as (view·frame) per spatial site and space attention as
    (view·patch) per frame, then a GEGLU feed-forward; every sublayer is
    pre-LayerNorm with a residual. LayerNorm eps is flax's 1e-6.
  * Rotary position embeddings: 1-D over the (V·F) time axis
    (``frame_rotary``) and axial 2-D over the (V·hp, wp) space grid
    (``axial_rotary``), applied to q and k. The tables are numpy float64
    rounded to float32, cast to q's type where they are used.
  * The cls token of each view attends over ALL of that view's tokens;
    the cls keys and values are prepended to every time or space group.
  * The attention is JAX's: q scaled by dim_head^-½, a product, a softmax,
    a product (plain torch products: JAX sends it to no Pallas kernel).
  * GEGLU's GELU is flax's default, the tanh approximation.
  * Head: the V cls tokens concatenated → LayerNorm → Linear.

Names are JAX's (``l{i}_time_attn.to_qkv``, ``l{i}_ff.fc1``, ``out_norm``
…). ``dtype`` is the compute type (``models/precision.py``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import LayerNorm, Linear, cast

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    x = x.unflatten(-1, (-1, 2))
    return torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)


def _apply_rot(q: torch.Tensor, k: torch.Tensor,
               rot: Tuple[torch.Tensor, torch.Tensor]):
    sin, cos = rot
    rd = sin.shape[-1]
    q_r, q_p = q[..., :rd], q[..., rd:]
    k_r, k_p = k[..., :rd], k[..., rd:]
    q_r = q_r * cos + _rotate_every_two(q_r) * sin
    k_r = k_r * cos + _rotate_every_two(k_r) * sin
    return torch.cat([q_r, q_p], -1), torch.cat([k_r, k_p], -1)


def _f32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def frame_rotary(n_tokens: int, dim_head: int):
    """1-D rotary over the folded (V·F) axis (reference RotaryEmbedding
    :53): (sin, cos), each (1, n_tokens, dim_head) float32."""
    inv = 1.0 / (10000 ** (np.arange(0, dim_head, 2, dtype=np.float64)
                           / dim_head))
    freqs = np.arange(n_tokens)[:, None] * inv[None, :]
    freqs = np.concatenate([freqs, freqs], -1)[None]
    return _f32(np.sin(freqs)), _f32(np.cos(freqs))


def axial_rotary(h: int, w: int, dim_head: int, max_freq: float = 10.0):
    """Axial 2-D rotary over an h×w grid (reference AxialRotaryEmbedding
    :22); the caller passes h already scaled by V. (sin, cos), each
    (1, h·w, 4·(dim_head // 4)) float32."""
    d4 = dim_head // 4
    scales = np.logspace(0.0, math.log(max_freq / 2) / math.log(2), d4,
                         base=2.0)[None]
    h_seq = np.linspace(-1, 1, h)[:, None] * scales * math.pi
    w_seq = np.linspace(-1, 1, w)[:, None] * scales * math.pi
    x_sinu = np.broadcast_to(h_seq[:, None, :], (h, w, d4))
    y_sinu = np.broadcast_to(w_seq[None, :, :], (h, w, d4))
    sin = np.concatenate([np.sin(x_sinu), np.sin(y_sinu)], -1)
    cos = np.concatenate([np.cos(x_sinu), np.cos(y_sinu)], -1)
    sin = np.repeat(sin.reshape(h * w, -1), 2, axis=-1)[None]
    cos = np.repeat(cos.reshape(h * w, -1), 2, axis=-1)[None]
    return _f32(sin), _f32(cos)


def _fold(t: torch.Tensor, axis: str, f: int, n: int) -> torch.Tensor:
    """(BH, V, F·N, D) → time groups (BH·N, V·F, D) or space groups
    (BH·F, V·N, D) (the reference's einops patterns at :321-322)."""
    bh, v, _, d = t.shape
    t = t.reshape(bh, v, f, n, d)
    if axis == "time":
        return t.permute(0, 3, 1, 2, 4).reshape(bh * n, v * f, d)
    return t.permute(0, 2, 1, 3, 4).reshape(bh * f, v * n, d)


def _unfold(t: torch.Tensor, axis: str, v: int, f: int,
            n: int) -> torch.Tensor:
    """The inverse of :func:`_fold`: → (BH, V, F·N, D)."""
    d = t.shape[-1]
    if axis == "time":
        t = t.reshape(-1, n, v, f, d).permute(0, 2, 3, 1, 4)
    else:
        t = t.reshape(-1, f, v, n, d).permute(0, 2, 1, 3, 4)
    return t.reshape(-1, v, f * n, d)


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, dim * mult * 2, compute_dtype=dtype)
        self.drop = nn.Dropout(dropout)  # after GEGLU, before fc2
        self.fc2 = Linear(dim * mult, dim, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, gates = self.fc1(x).chunk(2, dim=-1)
        y = y * F.gelu(gates, approximate="tanh")  # flax nn.gelu's default
        return self.fc2(self.drop(y))


class DividedAttention(nn.Module):
    """Space or time attention with per-view cls routing
    (reference :156-216)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Linear(dim, inner * 3, bias=False, compute_dtype=dtype)
        self.to_out = Linear(inner, dim, compute_dtype=dtype)
        self.drop = nn.Dropout(dropout)  # on the output projection

    def forward(self, x: torch.Tensor, axis: str, rot, f: int,
                n: int) -> torch.Tensor:
        b, v = x.shape[:2]
        h, d = self.heads, self.dim_head

        def heads(t):  # b v n (h d) -> (b h) v n d
            return t.unflatten(-1, (h, d)).permute(0, 3, 1, 2, 4).reshape(
                b * h, v, -1, d)

        q, k, vv = (heads(t) for t in self.to_qkv(x).chunk(3, dim=-1))
        q = q * d ** -0.5
        cls_q, q_ = q[:, :, :1], q[:, :, 1:]
        cls_k, k_ = k[:, :, :1], k[:, :, 1:]
        cls_v, v_ = vv[:, :, :1], vv[:, :, 1:]

        # the cls of each view attends over all that view's tokens
        sim = torch.einsum("bvid,bvjd->bvij", cls_q, k)
        cls_out = torch.einsum("bvij,bvjd->bvid", sim.softmax(-1), vv)

        q_, k_, v_ = (_fold(t, axis, f, n) for t in (q_, k_, v_))
        if rot is not None:  # float32 tables must not promote a bf16 chain
            q_, k_ = _apply_rot(q_, k_, tuple(t.to(q_.dtype) for t in rot))
        r = q_.shape[0] // cls_k.shape[0]  # groups per (batch, head)
        k_ = torch.cat([cls_k.reshape(b * h, v, d).repeat_interleave(r, 0),
                        k_], dim=1)
        v_ = torch.cat([cls_v.reshape(b * h, v, d).repeat_interleave(r, 0),
                        v_], dim=1)

        sim = torch.einsum("bid,bjd->bij", q_, k_)
        out = torch.einsum("bij,bjd->bid", sim.softmax(-1), v_)
        out = torch.cat([cls_out, _unfold(out, axis, v, f, n)], dim=2)
        out = out.reshape(b, h, v, -1, d).permute(0, 2, 3, 1, 4).reshape(
            b, v, -1, h * d)
        return self.drop(self.to_out(out))


class TimeSformer(nn.Module):
    """(B, V, F, H, W) multi-view video → (B, num_classes); ``num_views`` =
    V (JAX infers it from the input)."""

    def __init__(self, num_views: int, dim: int = 196, num_classes: int = 1,
                 patch_size: int = 14, depth: int = 12, heads: int = 4,
                 dim_head: int = 48, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.patch_size, self.depth = dtype, patch_size, depth
        self.dim_head = dim_head
        self.patch_embed = Linear(patch_size ** 2, dim, compute_dtype=dtype)
        self.cls_token = nn.Parameter(torch.randn(num_views, dim))
        for i in range(depth):
            for part in ("time", "space"):
                self.add_module(f"l{i}_{part}_norm", LayerNorm(dim, LN_EPS))
                self.add_module(f"l{i}_{part}_attn", DividedAttention(
                    dim, heads, dim_head, attn_dropout, dtype))
            self.add_module(f"l{i}_ff_norm", LayerNorm(dim, LN_EPS))
            self.add_module(f"l{i}_ff", GEGLUFeedForward(
                dim, dropout=ff_dropout, dtype=dtype))
        self.out_norm = LayerNorm(num_views * dim, LN_EPS)
        self.out_fc = Linear(num_views * dim, num_classes,
                             compute_dtype=dtype)
        # rotary tables per (V·F, V·hp, wp, device): built once on the host,
        # as JAX folds them into trace-time constants
        self._rot_cache: dict = {}

    def _rotary(self, v: int, f: int, hp: int, wp: int,
                device: torch.device) -> dict:
        key = (v * f, v * hp, wp, device)
        if key not in self._rot_cache:
            self._rot_cache[key] = {
                part: tuple(t.to(device) for t in tables)
                for part, tables in (
                    ("time", frame_rotary(v * f, self.dim_head)),
                    ("space", axial_rotary(v * hp, wp, self.dim_head)))}
        return self._rot_cache[key]

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, v, f, hh, ww = video.shape
        p = self.patch_size
        if hh % p or ww % p:
            raise ValueError(f"frames {hh}×{ww} are not a multiple of the "
                             f"patch size {p}")
        hp, wp = hh // p, ww // p
        n = hp * wp
        patches = video.reshape(b, v, f, hp, p, wp, p).permute(
            0, 1, 2, 3, 5, 4, 6).reshape(b, v, f * n, p * p)
        tokens = self.patch_embed(patches)
        cls = cast(self.cls_token, self.dtype)[None, :, None].expand(
            b, -1, -1, -1)
        x = torch.cat([cls, tokens], dim=2)

        rots = self._rotary(v, f, hp, wp, video.device)
        for i in range(self.depth):
            for part in ("time", "space"):
                y = getattr(self, f"l{i}_{part}_norm")(x)
                x = getattr(self, f"l{i}_{part}_attn")(y, part, rots[part],
                                                       f, n) + x
            x = getattr(self, f"l{i}_ff")(getattr(self, f"l{i}_ff_norm")(x)) \
                + x
        cls_out = self.out_norm(x[:, :, 0].reshape(b, -1))
        return self.out_fc(cls_out)
