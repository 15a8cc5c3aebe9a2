"""DeepLabV3 ASPP head, in PyTorch (port of ``glfusion_tpu/models/aspp.py``).

Head = ASPP (a 1×1 branch, dilated 3×3 branches at rates 12/24/36, an
image-pooling branch; 5×256 → 256 projection, dropout 0.5) → 3×3 conv + BN
+ ReLU → 1×1 conv to the outputs. Modules work in NCHW; names follow the
reference (``0.convs.{i}``, ``0.project``, ``1``, ``2``, ``4``).

The dilated branches are plain dilated convolutions. The JAX module's
clipped-tap rewrite (taps that only ever read zero padding at 28² are
skipped, the centre taps fused into one matmul) is an exact regrouping
chosen for the TPU and is left out here. The pooling branch's bilinear
upsample from 1×1 is an exact broadcast.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


class ASPP(nn.Module):
    def __init__(self, cin: int, channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36), dropout: float = 0.5):
        super().__init__()
        convs = [nn.Sequential(nn.Conv2d(cin, channels, 1, bias=False),
                               nn.BatchNorm2d(channels), nn.ReLU(inplace=True))]
        for r in rates:
            convs.append(nn.Sequential(
                nn.Conv2d(cin, channels, 3, padding=r, dilation=r,
                          bias=False),
                nn.BatchNorm2d(channels), nn.ReLU(inplace=True)))
        convs.append(nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            nn.Conv2d(cin, channels, 1, bias=False),
            nn.BatchNorm2d(channels), nn.ReLU(inplace=True)))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            nn.Conv2d(len(convs) * channels, channels, 1, bias=False),
            nn.BatchNorm2d(channels), nn.ReLU(inplace=True),
            nn.Dropout(dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [conv(x) for conv in self.convs]
        branches[-1] = branches[-1].expand(-1, -1, *x.shape[-2:])
        return self.project(torch.cat(branches, dim=1))


class DeepLabHead(nn.Sequential):
    """ASPP → 3×3 conv/BN/ReLU → 1×1 conv logits (no upsampling here)."""

    def __init__(self, cin: int, num_outputs: int, channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36), dropout: float = 0.5):
        super().__init__(
            ASPP(cin, channels, rates, dropout),
            nn.Conv2d(channels, channels, 3, padding=1, bias=False),
            nn.BatchNorm2d(channels),
            nn.ReLU(inplace=True),
            nn.Conv2d(channels, num_outputs, 1))
