"""3-D ResNet with ECA attention and the mPAP regression head in PyTorch
(port of ``glfusion_tpu/models/resnet3d.py``; reference
``models/resnet3d.py``).

  * ``ECALayer``: global mean to (B, C), a 1-D convolution of ``k_size``
    taps over the CHANNEL axis (same padding, no bias), a sigmoid gate,
    the channels reweighted. flax's (k, 1, 1) ``conv_kernel`` is the
    ``Conv1d(1, 1, k)`` weight (1, 1, k) (``utils/convert.py``).
  * ``BasicBlock3D`` and ``Bottleneck3D``: 3-D residual blocks with ECA on
    the last BN's output before the residual add; a 1×1×1 conv + BN
    shortcut where the stride or the width changes.
  * ``ResNet3D``: a (t, 7, 7) stem with stride (t_stride, 2, 2) and padding
    (t//2, 3, 3), BN, ReLU, a 3³ stride-2 max-pool (padding 1, which counts
    as −inf, as flax's), 4 stages (stride 2 from the second), a global
    mean: the pooled feature (B, C).
  * ``Resnet50PAH``: a depth-101 ``ResNet3D`` with a (7, 7, 7) stride-2
    stem and a ``projection`` Linear to the scalar target.

Modules work in NCDHW; the input's channels are the views
(``models/registry._views_to_channels``), so the stem takes
``in_channels`` (JAX infers it from the input). Names are JAX's
(``backbone``, ``conv1``, ``layer{s}_b{b}``, ``down_conv`` …). BatchNorm
eps 1e-5, momentum 0.1 (flax 0.9); torch's running variance takes the
unbiased batch variance where flax's takes the biased one (ROADMAP Queue
3). ``dtype`` is the compute type (``models/precision.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import Conv1d, Conv3d, Linear, cast

DEPTH_TABLE = {
    10: ("basic", (1, 1, 1, 1)),
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}
EXPANSION = {"basic": 1, "bottleneck": 4}


def conv_bn(cin: int, cout: int, kernel, dtype: torch.dtype, stride=1,
            padding=0, dilation=1):
    """A bias-free ``Conv3d`` in the compute type and its ``BatchNorm3d``."""
    return (Conv3d(cin, cout, kernel, stride=stride, padding=padding,
                   dilation=dilation, bias=False, compute_dtype=dtype),
            nn.BatchNorm3d(cout))


def max_pool_stem(x: torch.Tensor) -> torch.Tensor:
    """3³ stride-2 max-pool with padding 1 (flax ``max_pool``, −inf pad)."""
    return F.max_pool3d(x, 3, stride=2, padding=1)


class ECALayer(nn.Module):
    """Efficient Channel Attention (reference resnet3d.py:11-34)."""

    def __init__(self, k_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv1d(1, 1, k_size, padding=k_size // 2, bias=False,
                           compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, C, D, H, W)
        y = cast(x.mean((2, 3, 4)), self.dtype)  # (B, C)
        gate = torch.sigmoid(self.conv(y[:, None, :])[:, 0])
        return x * gate[:, :, None, None, None].to(x.dtype)


class Residual3D(nn.Module):
    """The shortcut of a 3-D residual block: identity, or a strided 1×1×1
    conv + BN (``down_conv``, ``down_bn``) where the shape changes."""

    def _shortcut(self, cin: int, cout: int, stride: int,
                  dtype: torch.dtype) -> None:
        self.dtype = dtype
        if stride != 1 or cin != cout:
            self.down_conv, self.down_bn = conv_bn(cin, cout, 1, dtype,
                                                   stride=stride)
        else:
            self.down_conv = None

    def _residual(self, x: torch.Tensor) -> torch.Tensor:
        if self.down_conv is None:
            return x
        return self.down_bn(self.down_conv(x))


class BasicBlock3D(Residual3D):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 k_size: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1, self.bn1 = conv_bn(cin, planes, 3, dtype, stride, 1)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3, dtype, 1, 1)
        self.eca = ECALayer(k_size, dtype)
        self._shortcut(cin, planes, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)  # the identity shortcut must not promote
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.eca(self.bn2(self.conv2(y)))
        return torch.relu(y + self._residual(x))


class Bottleneck3D(Residual3D):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 k_size: int = 3, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = dilation
        self.conv1, self.bn1 = conv_bn(cin, planes, 1, dtype)
        self.conv2, self.bn2 = conv_bn(planes, planes, 3, dtype, stride, d,
                                       d)
        self.conv3, self.bn3 = conv_bn(planes, planes * 4, 1, dtype)
        self.eca = ECALayer(k_size, dtype)
        self._shortcut(cin, planes * 4, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)  # the identity shortcut must not promote
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.eca(self.bn3(self.conv3(y)))
        return torch.relu(y + self._residual(x))


class ResNet3D(nn.Module):
    """(B, in_channels, D, H, W) → pooled feature (B, ``out_channels``)."""

    def __init__(self, in_channels: int, depth: int = 50,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 conv1_t_size: int = 7, conv1_t_stride: int = 1,
                 no_max_pool: bool = False, widen_factor: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kind, layers = DEPTH_TABLE[depth]
        widths = [int(w * widen_factor) for w in widths]
        t = conv1_t_size
        self.conv1, self.bn1 = conv_bn(
            in_channels, widths[0], (t, 7, 7), dtype,
            stride=(conv1_t_stride, 2, 2), padding=(t // 2, 3, 3))
        self.no_max_pool = no_max_pool
        block = BasicBlock3D if kind == "basic" else Bottleneck3D
        cin, self.blocks = widths[0], []
        for li, (planes, blocks) in enumerate(zip(widths, layers)):
            for b in range(blocks):
                name = f"layer{li + 1}_b{b}"
                stride = 2 if li > 0 and b == 0 else 1
                self.add_module(name, block(cin, planes, stride,
                                            dtype=dtype))
                self.blocks.append(name)
                cin = planes * EXPANSION[kind]
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        if not self.no_max_pool:
            x = max_pool_stem(x)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x.mean((2, 3, 4))


class Resnet50PAH(nn.Module):
    """Video → scalar mPAP (reference resnet3d.py:355-416): a depth-101
    backbone with a (7, 7, 7) stride-2 stem and a Linear head.
    (B, in_channels, T, H, W) → (B, n_outputs)."""

    def __init__(self, in_channels: int, depth: int = 101,
                 n_outputs: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = ResNet3D(in_channels, depth=depth, conv1_t_size=7,
                                 conv1_t_stride=2, dtype=dtype)
        self.projection = Linear(self.backbone.out_channels, n_outputs,
                                 compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.backbone(x))
