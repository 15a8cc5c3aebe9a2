"""ResNet-50 backbone with the reference's "IEKD" deviations, in PyTorch.

The port of ``glfusion_tpu/models/resnet.py``:

* the stem is a 1-channel, stride-1, 7×7 conv with padding 2 AND bias, so a
  112² input gives a 110² stem map, 55² after the maxpool, 28² from layer2;
* torchvision bottlenecks with ``replace_stride_with_dilation=[False, True,
  True]``: layer3/4 keep stride 1, and the first block of a dilated stage
  uses the PREVIOUS dilation (torchvision's ``_make_layer`` rule);
* BatchNorm eps 1e-5, momentum 0.1 (the JAX side's flax momentum 0.9).

Modules work in NCHW. Names follow torchvision and the reference
(``init_block.{0,1}``, ``layer{s}.{b}.conv1`` …), so the flagship's per-view
``init_block.{v}`` / ``layer{s}.{v}`` ModuleDicts hold these same pieces.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1×1 → 3×3 (stride, dilation) → 1×1 (×expansion)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, expansion: int = 4):
        super().__init__()
        cout = planes * expansion
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        r = x if self.downsample is None else self.downsample(x)
        return self.relu(y + r)


def stage_plan(block_sizes: Sequence[int], widths: Sequence[int],
               dilate_stages: Sequence[bool]):
    """Per-stage (blocks, planes, stride, first_dilation, dilation) under
    the torchvision replace_stride_with_dilation rule."""
    plan = []
    dilation = 1
    for stage, (blocks, planes, dilate) in enumerate(
            zip(block_sizes, widths, dilate_stages)):
        stride = 1 if stage == 0 else 2
        prev_dilation = dilation
        if dilate:  # torchvision: dilation *= stride; stride = 1
            dilation *= stride
            stride = 1
        plan.append((blocks, planes, stride, prev_dilation, dilation))
    return plan


def iekd_stem(stem_width: int) -> nn.Sequential:
    """The IEKD stem: conv 7×7 s1 p2 with bias, BN, ReLU, maxpool 3×3 s2 p1."""
    return nn.Sequential(
        nn.Conv2d(1, stem_width, 7, stride=1, padding=2, bias=True),
        nn.BatchNorm2d(stem_width),
        nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2, padding=1))


def make_stages(stem_width: int, block_sizes: Sequence[int],
                widths: Sequence[int], expansion: int,
                dilate_stages: Sequence[bool]) -> list[nn.Sequential]:
    """The residual stages, one ``nn.Sequential`` of bottlenecks each."""
    stages, cin = [], stem_width
    for blocks, planes, stride, first_dil, dil in stage_plan(
            block_sizes, widths, dilate_stages):
        mods = []
        for b in range(blocks):
            mods.append(Bottleneck(cin, planes,
                                   stride=stride if b == 0 else 1,
                                   dilation=first_dil if b == 0 else dil,
                                   expansion=expansion))
            cin = planes * expansion
        stages.append(nn.Sequential(*mods))
    return stages


class ResNetIEKD(nn.Module):
    """1-channel stride-1-stem dilated ResNet; returns the last stage's map.

    Input (B, 1, H, W) → (B, widths[-1]·expansion, H', W') with H' = H/4 at
    the reference sizes (112 → 28).
    """

    def __init__(self, stem_width: int = 64,
                 block_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 expansion: int = 4,
                 dilate_stages: Sequence[bool] = (False, False, True, True)):
        super().__init__()
        self.init_block = iekd_stem(stem_width)
        self.num_stages = len(block_sizes)
        for s, stage in enumerate(make_stages(
                stem_width, block_sizes, widths, expansion, dilate_stages), 1):
            self.add_module(f"layer{s}", stage)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.init_block(x)
        for s in range(1, self.num_stages + 1):
            x = getattr(self, f"layer{s}")(x)
        return x
