"""CEN, the Channel-Exchange RefineNet-LightWeight baseline, in PyTorch
(port of ``glfusion_tpu/models/cen.py``; reference ``models/CEN.py``).

  * S parallel streams (the views) share ALL conv weights (``SharedConv``,
    reference ``ModuleParallel``) and keep per-stream BatchNorms
    (``StreamBN``, reference ``BatchNorm2dParallel``).
  * The ResNet-50 bottlenecks exchange channels between streams after
    bn2 (``_exchange``): stream i keeps channel c where |γ_i[c]| ≥
    ``bn_threshold`` and takes it from stream (i + 1) mod S otherwise, the
    reference's 2-stream swap extended as a ring, as in JAX.
  * RefineNet-LightWeight decoder: 3×3 dimension reductions, RCU chains,
    CRP chains (5×5 stride-1 max-pools and convs), top-down bilinear
    merges with align_corners=True, a 3×3 classifier.
  * The streams are ensembled by a learned softmax ``alpha`` over the
    DETACHED per-stream logits.

Streams are folded into the batch: tensors are (S·B, C, H, W), stream s
the rows s·B … (s + 1)·B − 1, so a shared conv is one call and stream s's
slice is contiguous. ``StreamBN`` holds the stacked (S, C) parameters and
running statistics of JAX's and normalizes each stream with
``F.batch_norm`` (the reference's ``nn.BatchNorm2d`` per stream: its
running variance takes torch's unbiased update, where JAX's takes the
biased one; eval and train outputs are the same). Names are JAX's;
``dtype`` is the compute type.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import Conv2d, cast
from glfusion_tpu_torch.ops.resize import resize_bilinear_ac


class SharedConv(nn.Module):
    """ModuleParallel(conv): one weight set over the streams."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, stride=stride,
                           padding=kernel // 2, bias=bias,
                           compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class StreamBN(nn.Module):
    """BatchNorm2dParallel: per-stream BN with stacked (S, C) parameters
    (``weight`` is JAX's ``scale``, read by the exchange)."""

    def __init__(self, streams: int, channels: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.streams, self.momentum, self.eps = streams, momentum, eps
        self.weight = nn.Parameter(torch.ones(streams, channels))
        self.bias = nn.Parameter(torch.zeros(streams, channels))
        self.register_buffer("running_mean", torch.zeros(streams, channels))
        self.register_buffer("running_var", torch.ones(streams, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = x.unflatten(0, (self.streams, -1))  # (S, B, C, H, W)
        return torch.cat([F.batch_norm(
            parts[s], self.running_mean[s], self.running_var[s],
            self.weight[s], self.bias[s], self.training, self.momentum,
            self.eps) for s in range(self.streams)])


def _exchange(x: torch.Tensor, scales: torch.Tensor,
              threshold: float) -> torch.Tensor:
    """Channel exchange between S streams (reference modules.py:5-16).

    x: (S·B, C, H, W); scales: (S, C) stacked BN γ. Stream i keeps channel
    c where |γ_i[c]| ≥ threshold, else takes stream (i + 1) mod S's."""
    s = scales.shape[0]
    x = x.view(s, -1, *x.shape[1:])
    keep = (scales.abs() >= threshold)[:, None, :, None, None]
    out = torch.where(keep, x, torch.roll(x, -1, dims=0))
    return out.reshape(-1, *x.shape[2:])


class CENBottleneck(nn.Module):
    """Shared-conv bottleneck with the exchange after bn2 (CEN.py:145-191)."""

    def __init__(self, streams: int, cin: int, planes: int, stride: int = 1,
                 bn_threshold: float = 2e-2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.bn_threshold = dtype, bn_threshold
        out = planes * 4
        self.conv1 = SharedConv(cin, planes, 1, dtype=dtype)
        self.bn1 = StreamBN(streams, planes)
        self.conv2 = SharedConv(planes, planes, 3, stride=stride, dtype=dtype)
        self.bn2 = StreamBN(streams, planes)
        self.conv3 = SharedConv(planes, out, 1, dtype=dtype)
        self.bn3 = StreamBN(streams, out)
        self.downsample = stride != 1 or cin != out
        if self.downsample:
            self.down_conv = SharedConv(cin, out, 1, stride=stride,
                                        dtype=dtype)
            self.down_bn = StreamBN(streams, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)  # the identity shortcut must not promote
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.bn2.streams > 1:  # one stream: the exchange is the identity
            y = _exchange(y, self.bn2.weight, self.bn_threshold)
        y = self.bn3(self.conv3(torch.relu(y)))
        residual = self.down_bn(self.down_conv(x)) if self.downsample else x
        return torch.relu(y + residual)


class RCU(nn.Module):
    """Residual Conv Unit chain (reference RCUBlock, CEN.py:89-111)."""

    def __init__(self, features: int, num_blocks: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.num_blocks = dtype, num_blocks
        for i in range(num_blocks):
            self.add_module(f"b{i}_conv0", SharedConv(
                features, features, 3, bias=True, dtype=dtype))
            self.add_module(f"b{i}_conv1", SharedConv(
                features, features, 3, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)
        for i in range(self.num_blocks):
            y = getattr(self, f"b{i}_conv0")(torch.relu(x))
            x = getattr(self, f"b{i}_conv1")(torch.relu(y)) + x
        return x


class CRP(nn.Module):
    """Chained Residual Pooling (reference CRPBlock, CEN.py:67-85)."""

    def __init__(self, features: int, num_stages: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.num_stages = dtype, num_stages
        for i in range(num_stages):
            self.add_module(f"s{i}_conv", SharedConv(features, features, 3,
                                                     dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)
        top = x
        for i in range(self.num_stages):
            top = F.max_pool2d(top, 5, stride=1, padding=2)
            top = getattr(self, f"s{i}_conv")(top)
            x = x + top
        return x


class CENRefineNet(nn.Module):
    """RefineNet-50 with channel exchange (reference CEN.py:193-336).

    (S·B, C_in, H, W), stream-major → (per-stream logits (S·B, classes,
    H/4, W/4), the ensemble (B, classes, H/4, W/4), alpha_soft (S,))."""

    def __init__(self, streams: int, in_channels: int = 1,
                 num_classes: int = 5,
                 block_sizes: Sequence[int] = (3, 4, 6, 3),
                 bn_threshold: float = 2e-2, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.streams = streams
        self.conv1 = SharedConv(in_channels, 64, 7, stride=2, dtype=dtype)
        self.bn1 = StreamBN(streams, 64)
        self.layers = []
        cin = 64
        for li, (planes, blocks) in enumerate(
                zip((64, 128, 256, 512), block_sizes)):
            names = []
            for b in range(blocks):
                names.append(f"layer{li + 1}_b{b}")
                stride = 2 if li > 0 and b == 0 else 1
                self.add_module(names[-1], CENBottleneck(
                    streams, cin, planes, stride, bn_threshold, dtype))
                cin = planes * 4
            self.layers.append(names)
        self.drop = nn.Dropout(dropout)

        def conv(name, cin, cout):
            self.add_module(name, SharedConv(cin, cout, 3, dtype=dtype))

        conv("outl1_dimred", 2048, 512)
        self.adapt1 = RCU(512, 2, dtype)
        self.crp1 = CRP(512, 4, dtype)
        self.rcu1 = RCU(512, 3, dtype)
        conv("varout1", 512, 256)
        for lvl, cin in ((2, 1024), (3, 512), (4, 256)):
            conv(f"outl{lvl}_dimred", cin, 256)
            self.add_module(f"adapt{lvl}", RCU(256, 2, dtype))
            conv(f"adapt{lvl}_varout", 256, 256)
            self.add_module(f"crp{lvl}", CRP(256, 4, dtype))
            self.add_module(f"rcu{lvl}", RCU(256, 3, dtype))
            if lvl < 4:
                conv(f"varout{lvl}", 256, 256)
        self.clf = SharedConv(256, num_classes, 3, bias=True, dtype=dtype)
        self.alpha = nn.Parameter(torch.ones(streams))

    def forward(self, x: torch.Tensor):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        feats = []
        for names in self.layers:
            for name in names:
                y = getattr(self, name)(y)
            feats.append(y)
        l1, l2, l3, l4 = feats
        l4, l3 = self.drop(l4), self.drop(l3)

        def up_to(t, ref):
            return resize_bilinear_ac(t, tuple(ref.shape[-2:]), h_axis=-2,
                                      w_axis=-1)

        x4 = self.adapt1(self.outl1_dimred(l4))
        x4 = self.rcu1(self.crp1(torch.relu(x4)))
        top = up_to(self.varout1(x4), l3)
        for lvl, feat in ((2, l3), (3, l2), (4, l1)):
            t = getattr(self, f"adapt{lvl}")(
                getattr(self, f"outl{lvl}_dimred")(feat))
            t = torch.relu(getattr(self, f"adapt{lvl}_varout")(t) + top)
            t = getattr(self, f"rcu{lvl}")(getattr(self, f"crp{lvl}")(t))
            if lvl < 4:
                top = up_to(getattr(self, f"varout{lvl}")(t),
                            (l2, l1)[lvl - 2])
        logits = self.clf(self.drop(t))  # (S·B, classes, h, w)
        alpha_soft = torch.softmax(self.alpha, dim=0)
        per = logits.detach().view(self.streams, -1, *logits.shape[1:])
        dt = torch.promote_types(alpha_soft.dtype, per.dtype)
        ens = torch.einsum("s,s...->...", alpha_soft.to(dt), per.to(dt))
        return logits, ens, alpha_soft
