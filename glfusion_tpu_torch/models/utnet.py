"""UTNet, the hybrid conv/transformer U-Net baseline, in PyTorch (port of
``glfusion_tpu/models/utnet.py``; reference ``models/utnet.py``).

  * A 5-stage encoder at widths base·(1, 2, 4, 8, 16); the stages named in
    ``block_list`` run max-pool → pre-activation ResBlock → N
    ``BasicTransBlock``s, the others two plain pre-activation blocks.
  * ``LinearAttention``: depthwise-separable q, k, v; k and v bilinearly
    resized (align_corners=True, ``ops/resize.resize_bilinear_ac``) to a
    reduce_size² grid. The relative position bias (a Swin-style table) is
    added BEFORE the 1/√d scale, as the reference orders it.
  * Decoder: cross-attention up blocks (``TransDecoderBlock``) where the
    high-resolution map queries the low-resolution one, plus a residual
    1×1 + ×2 bilinear path, skip concat and a pre-activation block; the
    other levels use the plain up block. Up blocks are keyed on the SKIP
    level (up4 iff '3' in ``block_list``, …, up1 iff '0').
  * Stage s takes its heads and block count from the END of the lists
    (``_stage_cfg``, reference ``utnet.py:29-52``).

Heads split channels in the reference's '(dim_head heads)' order. Modules
work in NCHW; names are JAX's. BatchNorm eps 1e-5, momentum 0.1.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import Conv2d, cast
from glfusion_tpu_torch.ops.resize import resize_bilinear_ac


def _resize_ac(x: torch.Tensor, hw) -> torch.Tensor:
    return resize_bilinear_ac(x, tuple(hw), h_axis=-2, w_axis=-1)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3×3 + pointwise 1×1, both without bias (reference :14-24)."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depthwise = Conv2d(cin, cin, 3, padding=1, groups=cin,
                                bias=False, compute_dtype=dtype)
        self.pointwise = Conv2d(cin, cout, 1, bias=False,
                                compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class PreActBasicBlock(nn.Module):
    """Pre-activation residual block (reference conv_trans_utils.py:46-78)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        conv = dict(bias=False, compute_dtype=dtype)
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = Conv2d(cin, features, 3, stride=stride, padding=1,
                            **conv)
        self.bn2 = nn.BatchNorm2d(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, **conv)
        self.shortcut = stride != 1 or cin != features
        if self.shortcut:
            self.short_bn = nn.BatchNorm2d(cin)
            self.short_conv = Conv2d(cin, features, 1, stride=stride, **conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)  # the identity shortcut must not promote
        out = self.conv1(torch.relu(self.bn1(x)))
        out = self.conv2(torch.relu(self.bn2(out)))
        residue = x
        if self.shortcut:
            residue = self.short_conv(torch.relu(self.short_bn(x)))
        return out + residue


def _relative_index(h: int, w: int) -> np.ndarray:
    """The (h·w, h·w) table rows of a Swin-style 2-D relative bias."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * h - 1
    return rel.sum(-1)


class RelativePositionBias(nn.Module):
    """Relative position bias over an h×w key grid, expanded to a qh×qw
    query grid by repeat (reference conv_trans_utils.py:344-382)."""

    def __init__(self, num_heads: int, h: int, w: int):
        super().__init__()
        self.num_heads, self.h, self.w = num_heads, h, w
        self.table = nn.Parameter(
            torch.randn((2 * h - 1) * (2 * w - 1), num_heads) * 0.02)
        self.register_buffer(
            "index", torch.from_numpy(_relative_index(h, w).reshape(-1)),
            persistent=False)

    def forward(self, qh: int, qw: int) -> torch.Tensor:
        h, w, heads = self.h, self.w, self.num_heads
        bias = self.table[self.index].view(h, w, h * w, heads)
        bias = bias.repeat_interleave(qh // h, dim=0)
        bias = bias.repeat_interleave(qw // w, dim=1)
        return bias.reshape(qh * qw, h * w, heads).permute(2, 0, 1)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, heads·dh, H, W) → (B, heads, HW, dh); channel c = d·heads + h."""
    b, c, h, w = t.shape
    return t.reshape(b, c // heads, heads, h * w).permute(0, 2, 3, 1)


def _merge_heads(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, heads, n, dh = t.shape
    return t.permute(0, 3, 1, 2).reshape(b, dh * heads, h, w)


def _attend(q, k, v, heads, rel_pos, qh, qw, inner):
    """softmax((qkᵀ + bias)·(inner/heads)^-½)·v on split heads → NCHW. In
    bfloat16 the resized k and v are float32 (``resize_bilinear_ac``), and
    the products promote to it, as JAX's einsums do."""
    dt = torch.promote_types(q.dtype, k.dtype)
    q, k, v = (_split_heads(t.to(dt), heads) for t in (q, k, v))
    attn = q @ k.transpose(-1, -2)
    if rel_pos is not None:
        attn = attn + rel_pos(qh, qw).to(attn.dtype)  # no promotion
    attn = torch.softmax(attn * (inner // heads) ** -0.5, dim=-1)
    return _merge_heads(attn @ v, qh, qw)


class LinearAttention(nn.Module):
    """Spatial-reduction multi-head attention (reference
    conv_trans_utils.py:150-215); dim_head = channels // heads."""

    def __init__(self, channels: int, heads: int, reduce_size: int = 8,
                 rel_pos: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.reduce_size = heads, reduce_size
        self.to_qkv = DepthwiseSeparableConv(channels, 3 * channels, dtype)
        if rel_pos:
            self.rel_pos = RelativePositionBias(heads, reduce_size,
                                                reduce_size)
        self.to_out = DepthwiseSeparableConv(channels, channels, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, c, h, w = x.shape
        q, k, v = self.to_qkv(x).chunk(3, dim=1)
        r = self.reduce_size
        if h != r:
            k, v = _resize_ac(k, (r, r)), _resize_ac(v, (r, r))
        out = _attend(q, k, v, self.heads, getattr(self, "rel_pos", None),
                      h, w, c)
        return self.to_out(out)


class CrossAttention(nn.Module):
    """Decoder cross-attention: high-resolution queries, low-resolution
    keys and values (reference LinearAttentionDecoder,
    conv_trans_utils.py:217-283)."""

    def __init__(self, q_ch: int, kv_ch: int, out_ch: int, heads: int,
                 reduce_size: int = 8, rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_ch, self.heads, self.reduce_size = out_ch, heads, reduce_size
        self.to_kv = DepthwiseSeparableConv(kv_ch, 2 * out_ch, dtype)
        self.to_q = DepthwiseSeparableConv(q_ch, out_ch, dtype)
        if rel_pos:
            self.rel_pos = RelativePositionBias(heads, reduce_size,
                                                reduce_size)
        self.to_out = DepthwiseSeparableConv(out_ch, out_ch, dtype)

    def forward(self, q_feat: torch.Tensor,
                kv_feat: torch.Tensor) -> torch.Tensor:
        hh, wh = q_feat.shape[-2:]
        k, v = self.to_kv(kv_feat).chunk(2, dim=1)
        q = self.to_q(q_feat)
        r = self.reduce_size
        if kv_feat.shape[-2] != r:
            k, v = _resize_ac(k, (r, r)), _resize_ac(v, (r, r))
        out = _attend(q, k, v, self.heads, getattr(self, "rel_pos", None),
                      hh, wh, self.out_ch)
        return self.to_out(out)


class BasicTransBlock(nn.Module):
    """BN → attention (+x) → BN/ReLU/1×1 (+residual) (reference :80-107)."""

    def __init__(self, channels: int, heads: int, reduce_size: int = 8,
                 rel_pos: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.bn1 = nn.BatchNorm2d(channels)
        self.attn = LinearAttention(channels, heads, reduce_size, rel_pos,
                                    dtype)
        self.bn2 = nn.BatchNorm2d(channels)
        self.mlp = Conv2d(channels, channels, 1, bias=False,
                          compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)
        out = self.attn(self.bn1(x)) + x
        return self.mlp(torch.relu(self.bn2(out))) + out


class TransDecoderBlock(nn.Module):
    """Cross-attention up block (reference BasicTransDecoderBlock
    :109-148)."""

    def __init__(self, low_ch: int, high_ch: int, out_ch: int, heads: int,
                 reduce_size: int = 8, rel_pos: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_ch = Conv2d(low_ch, out_ch, 1, compute_dtype=dtype)
        self.bn_l = nn.BatchNorm2d(low_ch)
        self.bn_h = nn.BatchNorm2d(high_ch)
        self.attn = CrossAttention(high_ch, low_ch, out_ch, heads,
                                   reduce_size, rel_pos, dtype)
        self.bn2 = nn.BatchNorm2d(out_ch)
        self.mlp = Conv2d(out_ch, out_ch, 1, bias=False, compute_dtype=dtype)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        residue = _resize_ac(self.conv_ch(low), high.shape[-2:])
        out = self.attn(self.bn_h(high), self.bn_l(low)) + residue
        return self.mlp(torch.relu(self.bn2(out))) + out


class UTNet(nn.Module):
    """Reference UTNet (``block_list='234'``, ``num_blocks=(1, 2, 4)``).

    (B, C_in, H, W) → (B, num_classes, H, W) logits; with
    ``return_features`` also the deepest encoder stage (the bottleneck).
    ``decoder_attn=False`` is UTNet_Encoderonly (reference :105)."""

    def __init__(self, in_channels: int = 1, num_classes: int = 1,
                 base: int = 32, block_list: str = "234",
                 num_blocks: Sequence[int] = (1, 2, 4),
                 heads: Sequence[int] = (2, 4, 8), reduce_size: int = 8,
                 rel_pos: bool = True, decoder_attn: bool = True,
                 return_features: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block_list = block_list
        self.num_blocks, self.heads = tuple(num_blocks), tuple(heads)
        self.return_features = return_features
        widths = [base * m for m in (1, 2, 4, 8, 16)]
        trans = dict(reduce_size=reduce_size, rel_pos=rel_pos, dtype=dtype)

        self.inc_block = PreActBasicBlock(in_channels, base, dtype=dtype)
        if "0" in block_list:
            self.inc_trans = BasicTransBlock(base, self.heads[0], **trans)
        else:
            self.inc_block2 = PreActBasicBlock(base, base, dtype=dtype)
        self.down = []  # per stage: the module names, in order
        for s in range(1, 5):
            is_trans, nblk, nh = self._stage_cfg(s)
            names = [f"down{s}_conv"]
            self.add_module(names[0], PreActBasicBlock(
                widths[s - 1], widths[s], dtype=dtype))
            if is_trans:
                for b in range(nblk):
                    names.append(f"down{s}_trans{b}")
                    self.add_module(names[-1], BasicTransBlock(
                        widths[s], nh, **trans))
            else:
                names.append(f"down{s}_conv2")
                self.add_module(names[-1], PreActBasicBlock(
                    widths[s], widths[s], dtype=dtype))
            self.down.append(names)
        self.up_attn = {}
        cur = widths[4]
        for s in range(4, 0, -1):
            w = widths[s - 1]
            # keyed on the SKIP level's trans-ness; heads from stage s
            self.up_attn[s] = decoder_attn and str(s - 1) in block_list
            if self.up_attn[s]:
                self.add_module(f"up{s}_attn", TransDecoderBlock(
                    cur, w, w, self._stage_cfg(s)[2], **trans))
                self.add_module(f"up{s}_conv", PreActBasicBlock(
                    2 * w, w, dtype=dtype))
            else:
                self.add_module(f"up{s}_conv_ch", Conv2d(
                    cur, w, 1, compute_dtype=dtype))
                self.add_module(f"up{s}_conv", PreActBasicBlock(
                    2 * w, w, dtype=dtype))
                self.add_module(f"up{s}_conv2", PreActBasicBlock(
                    w, w, dtype=dtype))
            cur = w
        self.outc = Conv2d(base, num_classes, 1, compute_dtype=dtype)

    def _stage_cfg(self, stage: int):
        """Stage 1..4 → (is_trans, num_blocks, heads): stage s reads slot
        s − 5 from the end of the lists, the first entry when the list is
        shorter (reference utnet.py:29-52)."""
        nb, hd = self.num_blocks, self.heads
        idx = stage - 5
        heads = hd[idx] if -len(hd) <= idx else hd[0]
        nblk = nb[idx] if -len(nb) <= idx else nb[0]
        return str(stage) in self.block_list, nblk, heads

    def forward(self, x: torch.Tensor):
        h1 = self.inc_block(x)
        h1 = (self.inc_trans(h1) if hasattr(self, "inc_trans")
              else self.inc_block2(h1))
        feats = [h1]
        for names in self.down:
            y = F.max_pool2d(feats[-1], 2, 2)
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        out = feats[4]
        for s in range(4, 0, -1):
            skip = feats[s - 1]
            if self.up_attn[s]:
                out = getattr(self, f"up{s}_attn")(out, skip)
                out = getattr(self, f"up{s}_conv")(torch.cat([out, skip], 1))
            else:
                up = _resize_ac(out, skip.shape[-2:])
                up = getattr(self, f"up{s}_conv_ch")(up)
                out = getattr(self, f"up{s}_conv")(torch.cat([skip, up], 1))
                out = getattr(self, f"up{s}_conv2")(out)
        out = self.outc(out)
        return (out, feats[4]) if self.return_features else out
