"""AVS-derived encoder-decoder baselines, in PyTorch (port of
``glfusion_tpu/models/avs.py``; reference ``models/ResNet_AVSModel.py`` and
the 2-branch backbone of ``models/resnet.py``).

  * ``B2ResNet``: an ImageNet-style ResNet-50 (3-channel 7×7 stride-2
    stem, BN, ReLU, 3×3 stride-2 max-pool), shared layer1/2, then TWO
    independent layer3/layer4 forks. v1.5 bottlenecks: the stride is on
    the 3×3, no bias, a ``down_*`` shortcut where the stride or the width
    changes. Echo frames are 1-channel, repeated to 3.
  * ``ClassifierModule``: the sum of four dilated 3×3 convs with bias
    (rates 3/6/12/18) projecting a stage to ``features``.
  * RefineNet decoder: ``ResidualConvUnit`` and ``FeatureFusionBlock``
    (the skip through an RCU, an RCU, two convs, a bilinear upsample with
    align_corners=True to the next stage's grid), ``OutputHead`` (conv, ×2
    bilinear with align_corners=False, conv, ReLU, 1×1 to the classes).
  * ``ViewChannelTransformer``: self-attention over the V·C channel tokens
    of dimension h·w, a BN over the token axis, a residual, and a LayerNorm
    over (C, V) with a (V,) affine.
  * ``PredEndecoder``: a main and another view through ``resnet`` and
    ``resnet2``, the heads shared by both, per-stage cross-view TPAVI (x
    from the main view, φ from the other), the main view decoded.
  * ``AVSTransfusion``: per-view encoding (one shared backbone, or
    ``per_view_params``: independently drawn ``resnet_{v}``), per-stage
    fusion (``transformer``: the channel transformer; ``tpavi``: TPAVI over
    the V·h·w tokens), one decoder applied to each view.
  * ``AVSBaseline``: a shared backbone, identity-width heads
    (256/512/1024/2048 at full width), a narrowing decoder, no fusion.

The second layer3/layer4 fork of ``B2ResNet`` feeds nothing. JAX still
computes it in train mode, where its BatchNorms' running statistics move
(XLA drops it in eval, where it has no effect); so the port runs it in
train mode, without a graph, and skips it in eval. Its parameters get no
gradient here and a zero one in JAX: the train step gives them a zero
gradient before Adam (``train/train_state.zero_fill_grads``), so they take
optax's weight-decay-only step too.

Modules work in NCHW; the models' inputs and outputs take JAX's layouts
((V, B, H, W, 1) → (V, B, ~H, ~W, classes) and (V, B, h, w, C) features).
Module names are JAX's, so ``utils/convert.zoo_state_dict_from_jax`` maps
flax paths 1:1. ``dtype`` is the compute type (``models/precision.py``).
No TPAVI here is built with an ``attn_impl``: they take ``"auto"``, as in
JAX, so no model of this file runs a hand-written kernel.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import Conv2d, Linear, cast
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.ops.resize import (resize_bilinear_ac,
                                           resize_bilinear_nchw)

Maps = List[torch.Tensor]


def _conv3(cin: int, cout: int, dtype: torch.dtype, rate: int = 1,
           bias: bool = True) -> Conv2d:
    return Conv2d(cin, cout, 3, padding=rate, dilation=rate, bias=bias,
                  compute_dtype=dtype)


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        cout = planes * 4
        conv = dict(bias=False, compute_dtype=dtype)
        self.dtype = dtype
        self.conv1 = Conv2d(cin, planes, 1, **conv)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            **conv)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, **conv)
        self.bn3 = nn.BatchNorm2d(cout)
        self.down_conv = self.down_bn = None
        if stride != 1 or cin != cout:
            self.down_conv = Conv2d(cin, cout, 1, stride=stride, **conv)
            self.down_bn = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)  # the identity shortcut must not promote
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        r = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(y + r, inplace=True)


def b2_stage_hw(hw: int) -> Tuple[int, ...]:
    """The side of ``B2ResNet``'s four taps for an hw² input: the stem,
    the pool and each stride-2 stage take ⌈n/2⌉ (112 → 28, 14, 7, 4)."""
    n, sides = (hw + 1) // 2, []
    for _ in range(4):  # the pool, then layer2..4's stride-2 first blocks
        n = (n + 1) // 2
        sides.append(n)
    return tuple(sides)


class B2ResNet(nn.Module):
    """2-branch ResNet-50: shared stem/layer1/2, forked layer3/4. Input
    (B, 3, H, W); returns the first fork's taps (x1, x2, x3_1, x4_1). In
    train mode the second fork runs for its BN statistics alone."""

    def __init__(self, widths: Sequence[int] = (64, 128, 256, 512),
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.blocks = tuple(blocks)
        self.conv1 = Conv2d(3, widths[0], 7, stride=2, padding=3,
                            bias=False, compute_dtype=dtype)
        self.bn1 = nn.BatchNorm2d(widths[0])
        cin = widths[0]
        for name, width, n, stride in (("layer1", widths[0], blocks[0], 1),
                                       ("layer2", widths[1], blocks[1], 2)):
            cin = self._stage(name, cin, width, n, stride, dtype)
        for fork in (1, 2):
            c = self._stage(f"layer3_{fork}", cin, widths[2], blocks[2], 2,
                            dtype)
            self._stage(f"layer4_{fork}", c, widths[3], blocks[3], 2, dtype)

    def _stage(self, name: str, cin: int, width: int, n: int, stride: int,
               dtype: torch.dtype) -> int:
        for b in range(n):
            self.add_module(f"{name}_b{b}", _Bottleneck(
                cin, width, stride if b == 0 else 1, dtype))
            cin = width * 4
        return cin

    def _run(self, name: str, n: int, x: torch.Tensor) -> torch.Tensor:
        for b in range(n):
            x = getattr(self, f"{name}_b{b}")(x)
        return x

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)), inplace=True)
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        n1, n2, n3, n4 = self.blocks
        x1 = self._run("layer1", n1, x)
        x2 = self._run("layer2", n2, x1)
        x3 = self._run("layer3_1", n3, x2)
        x4 = self._run("layer4_1", n4, x3)
        if self.training:
            with torch.no_grad():  # read by nothing: its BN statistics
                self._run("layer4_2", n4, self._run("layer3_2", n3, x2))
        return x1, x2, x3, x4


class ClassifierModule(nn.Module):
    """Sum of dilated 3×3 convs with bias (``conv{i}`` at ``rates``)."""

    def __init__(self, cin: int, features: int,
                 rates: Sequence[int] = (3, 6, 12, 18),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(rates)
        for i, r in enumerate(rates):
            self.add_module(f"conv{i}", _conv3(cin, features, dtype, r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv0(x)
        for i in range(1, self.n):
            out = out + getattr(self, f"conv{i}")(x)
        return out


class ResidualConvUnit(nn.Module):
    def __init__(self, c: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv3(c, c, dtype)
        self.conv2 = _conv3(c, c, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)
        y = self.conv1(F.relu(x))
        return self.conv2(F.relu(y)) + x


class FeatureFusionBlock(nn.Module):
    """(+ skip through ``rcu1``) → ``rcu2`` → ReLU, conv, ReLU, conv →
    bilinear (align_corners=True) to ``target_hw``. ``skip``: the block
    takes a skip (JAX creates ``rcu1`` only then)."""

    def __init__(self, cin: int, out_features: int, skip: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if skip:
            self.rcu1 = ResidualConvUnit(cin, dtype)
        self.rcu2 = ResidualConvUnit(cin, dtype)
        self.conv1 = _conv3(cin, cin, dtype)
        self.conv2 = _conv3(cin, out_features, dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None,
                target_hw: Sequence[int]) -> torch.Tensor:
        if skip is not None:
            x = cast(x, self.dtype) + self.rcu1(skip)
        x = F.relu(self.rcu2(x))
        x = self.conv2(F.relu(self.conv1(x)))
        return resize_bilinear_ac(x, tuple(target_hw), h_axis=-2, w_axis=-1)


class OutputHead(nn.Module):
    """conv → ×2 bilinear (align_corners=False) → conv → ReLU → 1×1."""

    def __init__(self, cin: int, num_classes: int = 5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv3(cin, 128, dtype)
        self.conv2 = _conv3(128, 32, dtype)
        self.out = Conv2d(32, num_classes, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        x = resize_bilinear_nchw(x, (x.shape[-2] * 2, x.shape[-1] * 2))
        return self.out(F.relu(self.conv2(x)))


class _ViewLayerNorm(nn.Module):
    """flax ``LayerNorm(reduction_axes=(-2, -1))`` on (…, C, V): the
    statistics over C and V jointly, the affine over V alone."""

    def __init__(self, views: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(views))
        self.bias = nn.Parameter(torch.zeros(views))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, V, C, h, w), normalized over (V, C) in float32 (or
        float64), returned in x's type."""
        xf = x if x.dtype in (torch.float32, torch.float64) else x.float()
        var, mean = torch.var_mean(xf, dim=(1, 2), keepdim=True,
                                   unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.view(1, -1, 1, 1, 1) + self.bias.view(
            1, -1, 1, 1, 1)
        return y.to(x.dtype)


class ViewChannelTransformer(nn.Module):
    """Self-attention over channel tokens: the V·C channels of the views
    are the tokens, each of dimension ``n_embd`` = h·w. So the ``query``,
    ``key``, ``value`` and ``proj`` Linear(h·w, h·w) are sized by the
    input's grid, ``bn`` is a BatchNorm over the V·C token axis with
    (V·C,) parameters, and ``norm`` normalizes over (C, V) with a (V,)
    affine. x (V, B, C, h, w) → the same, contiguous."""

    def __init__(self, views: int, channels: int, n_embd: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        for name in ("query", "key", "value", "proj"):
            self.add_module(name, Linear(n_embd, n_embd,
                                         compute_dtype=dtype))
        self.bn = nn.BatchNorm1d(views * channels)
        self.norm = _ViewLayerNorm(views)
        scale = math.sqrt(n_embd)  # JAX's √(h·w) cast to the compute type
        self.scale = (scale if dtype == torch.float32
                      else torch.tensor(scale, dtype=dtype).item())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v, b, c, h, w = x.shape
        tok = cast(x.transpose(0, 1).reshape(b, v * c, h * w), self.dtype)
        q, k, val = self.query(tok), self.key(tok), self.value(tok)
        att = torch.softmax(q @ k.transpose(1, 2) / self.scale, dim=-1)
        y = self.bn(self.proj(att @ val))
        out = self.norm((tok + y).view(b, v, c, h, w))
        return out.transpose(0, 1).contiguous()


def _heads(parent: nn.Module, cins: Sequence[int], couts: Sequence[int],
           dtype: torch.dtype) -> None:
    for i, (cin, cout) in enumerate(zip(cins, couts), 1):
        parent.add_module(f"conv{i}", ClassifierModule(cin, cout,
                                                       dtype=dtype))


def _decoder(parent: nn.Module, widths: Sequence[int], num_classes: int,
             dtype: torch.dtype) -> None:
    """``path4``..``path1`` (stage 4's width in, ``widths[i]`` out, the
    input of path i+1 the output of path i+2) and ``output_conv``.
    ``widths``: the four head widths, stage 1 first."""
    outs = (widths[0], widths[0], widths[1], widths[2])  # path1..path4
    for i in (4, 3, 2, 1):
        cin = widths[3] if i == 4 else outs[i]
        parent.add_module(f"path{i}", FeatureFusionBlock(
            cin, outs[i - 1], skip=i != 4, dtype=dtype))
    parent.output_conv = OutputHead(outs[0], num_classes, dtype)


def _decode(parent: nn.Module, f: Maps) -> torch.Tensor:
    """One view's four stage maps (NCHW, stage 1 first) → logits."""
    h, w = f[0].shape[-2:]
    y = parent.path4(f[3], None, f[2].shape[-2:])
    y = parent.path3(y, f[2], f[1].shape[-2:])
    y = parent.path2(y, f[1], f[0].shape[-2:])
    y = parent.path1(y, f[0], (2 * h, 2 * w))
    return parent.output_conv(y)


def _rgb(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 1) echo frames → (B, 3, H, W), the channel repeated."""
    return x.movedim(-1, 1).expand(-1, 3, -1, -1)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.movedim(-3, -1)


def attend(attn: TPAVI, maps: Maps, kv: Maps | None = None) -> Maps:
    """TPAVI over the V·h·w tokens of per-view NCHW maps (φ from ``kv``'s
    where given) → per-view NCHW-contiguous maps."""
    def volume(m):  # (B, V, h, w, C)
        return torch.stack(m, dim=1).permute(0, 1, 3, 4, 2)

    y = attn(volume(maps), None if kv is None else volume(kv))
    return [y[:, i].permute(0, 3, 1, 2).contiguous()
            for i in range(y.shape[1])]


class PredEndecoder(nn.Module):
    """Main-view + other-view cross-attention segmenter. main, other:
    (B, H, W, 1) → (logits (B, ~H, ~W, classes), the main view's fused
    stage-4 features (B, h, w, channel))."""

    def __init__(self, channel: int = 256,
                 tpavi_stages: Sequence[int] = (0, 1, 2, 3),
                 num_classes: int = 5,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.tpavi_stages = tuple(tpavi_stages)
        self.resnet = B2ResNet(widths, blocks, dtype)
        self.resnet2 = B2ResNet(widths, blocks, dtype)
        _heads(self, [wd * 4 for wd in widths], [channel] * 4, dtype)
        for i in self.tpavi_stages:
            self.add_module(f"tpavi_b{i + 1}", TPAVI(channel, dtype=dtype))
        _decoder(self, [channel] * 4, num_classes, dtype)

    def forward(self, main: torch.Tensor, other: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        heads = [getattr(self, f"conv{i + 1}") for i in range(4)]
        fm = [hd(t) for hd, t in zip(heads, self.resnet(_rgb(main)))]
        om = [hd(t) for hd, t in zip(heads, self.resnet2(_rgb(other)))]
        for i in self.tpavi_stages:
            attn = getattr(self, f"tpavi_b{i + 1}")
            fm[i] = attend(attn, [fm[i]], [om[i]])[0]
        return _nhwc(_decode(self, fm)), _nhwc(fm[3])


class AVSTransfusion(nn.Module):
    """Per-view encoder, per-stage cross-view fusion, per-view decode.

    ``fusion='transformer'`` with one shared ``resnet``: AVS_Transfusion;
    ``fusion='tpavi', per_view_params=True`` (``resnet_{v}``, drawn one
    after the other): model17. ``hw``: the input's side, which sizes the
    channel transformers' Linear layers. The shared backbone runs once a
    view (a BN normalization and a running-statistics update each); the
    heads, the decoder and ``output_conv`` are one module applied to each
    view. x (V, B, H, W, 1) → (logits (V, B, ~H, ~W, classes), the fused
    stage-4 features (V, B, h, w, channel))."""

    def __init__(self, views: int, hw: int, channel: int = 256,
                 fuse_stages: Sequence[int] = (0, 1, 2, 3),
                 num_classes: int = 5,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 fusion: str = "transformer", per_view_params: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if fusion not in ("transformer", "tpavi"):
            raise ValueError(f"unknown fusion {fusion!r}")
        self.fuse_stages, self.fusion = tuple(fuse_stages), fusion
        self.per_view_params = per_view_params
        if per_view_params:
            for v in range(views):
                self.add_module(f"resnet_{v}", B2ResNet(widths, blocks,
                                                        dtype))
        else:
            self.resnet = B2ResNet(widths, blocks, dtype)
        _heads(self, [wd * 4 for wd in widths], [channel] * 4, dtype)
        sides = b2_stage_hw(hw)
        for i in self.fuse_stages:
            if fusion == "tpavi":
                self.add_module(f"tpavi_b{i + 1}", TPAVI(channel,
                                                         dtype=dtype))
            else:
                self.add_module(f"attn{i + 1}", ViewChannelTransformer(
                    views, channel, sides[i] ** 2, dtype))
        _decoder(self, [channel] * 4, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        heads = [getattr(self, f"conv{i + 1}") for i in range(4)]
        fm: List[Maps] = [[], [], [], []]
        for v in range(x.shape[0]):
            bb = getattr(self, f"resnet_{v}") if self.per_view_params \
                else self.resnet
            for i, t in enumerate(bb(_rgb(x[v]))):
                fm[i].append(heads[i](t))
        for i in self.fuse_stages:
            if self.fusion == "tpavi":
                fm[i] = attend(getattr(self, f"tpavi_b{i + 1}"), fm[i])
            else:
                fm[i] = list(getattr(self, f"attn{i + 1}")(
                    torch.stack(fm[i])).unbind(0))
        outs = [_decode(self, [f[v] for f in fm]) for v in range(x.shape[0])]
        return _nhwc(torch.stack(outs)), _nhwc(torch.stack(fm[3]))


class AVSBaseline(nn.Module):
    """Per-view decode without fusion: ONE shared ``resnet`` (the first
    fork's taps), identity-width heads (``conv_i``: ch_i → ch_i for ch =
    4·widths) and the narrowing decoder ch_4 → ch_3 → ch_2 → ch_1 → ch_1.
    x (V, B, H, W, 1) → (logits (V, B, ~H, ~W, classes), stage-4 head
    features (V, B, h, w, ch_4))."""

    def __init__(self, num_classes: int = 5,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 blocks: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = [wd * 4 for wd in widths]
        self.resnet = B2ResNet(widths, blocks, dtype)
        _heads(self, ch, ch, dtype)
        _decoder(self, ch, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        heads = [getattr(self, f"conv{i + 1}") for i in range(4)]
        outs, feats = [], []
        for v in range(x.shape[0]):
            fm = [hd(t) for hd, t in zip(heads, self.resnet(_rgb(x[v])))]
            outs.append(_decode(self, fm))
            feats.append(fm[3])
        return _nhwc(torch.stack(outs)), _nhwc(torch.stack(feats))
