"""R(2+1)D video ResNet in PyTorch (port of
``glfusion_tpu/models/r2plus1d.py``; reference ``models/rnet2dp1.py``).

  * ``Conv2Plus1D``: a 3-D conv factorized into a (1, 3, 3) spatial conv
    (stride (1, s, s)) → BN → ReLU → a (3, 1, 1) temporal conv (stride
    (s, 1, 1)), with ``_midplanes`` channels between them:
    (Cin·Cout·27) // (Cin·9 + 3·Cout), in integers, computed ONCE a block
    from the block's input width and used by both of its convs.
  * Stem (``R2Plus1dStem``): (1, 7, 7) stride (1, 2, 2) conv to 45
    channels → BN → ReLU → (3, 1, 1) conv to ``widths[0]`` → BN → ReLU.
  * 4 basic-block stages ([2, 2, 2, 2] at 64/128/256/512), stride 2 in
    (t, h, w) from stage 2; a global mean; a Linear head.
  * ``r2plus1d_18_iekd`` also returns the pooled feature.

Modules work in NCDHW with the views as input channels
(``models/registry._views_to_channels``; JAX infers the width). Names are
JAX's (``stem_spatial``, ``layer{s}_b{b}``, ``conv1.spatial`` …). BatchNorm
eps 1e-5, momentum 0.1; torch's running variance is unbiased (ROADMAP
Queue 3). ``dtype`` is the compute type.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from glfusion_tpu_torch.models.precision import Conv3d, Linear, cast
from glfusion_tpu_torch.models.resnet3d import Residual3D, conv_bn


def _midplanes(cin: int, cout: int) -> int:
    return (cin * cout * 3 * 3 * 3) // (cin * 3 * 3 + 3 * cout)


class Conv2Plus1D(nn.Module):
    def __init__(self, cin: int, features: int, midplanes: int,
                 stride: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        s = stride
        self.spatial, self.bn = conv_bn(cin, midplanes, (1, 3, 3), dtype,
                                        stride=(1, s, s), padding=(0, 1, 1))
        self.temporal = Conv3d(midplanes, features, (3, 1, 1),
                               stride=(s, 1, 1), padding=(1, 0, 0),
                               bias=False, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal(torch.relu(self.bn(self.spatial(x))))


class R2Plus1DBlock(Residual3D):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = _midplanes(cin, planes)  # once, from the block's input width
        self.conv1 = Conv2Plus1D(cin, planes, mid, stride, dtype)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = Conv2Plus1D(planes, planes, mid, dtype=dtype)
        self.bn2 = nn.BatchNorm3d(planes)
        self._shortcut(cin, planes, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)  # the identity shortcut must not promote
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + self._residual(x))


class R2Plus1D18(nn.Module):
    """(B, in_channels, T, H, W) → logits (B, num_classes)[, the pooled
    feature with ``return_features``, as r2plus1d_18_iekd]."""

    def __init__(self, in_channels: int = 1, num_classes: int = 400,
                 layers: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 return_features: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_features = return_features
        self.stem_spatial, self.stem_bn1 = conv_bn(
            in_channels, 45, (1, 7, 7), dtype, stride=(1, 2, 2),
            padding=(0, 3, 3))
        self.stem_temporal, self.stem_bn2 = conv_bn(
            45, widths[0], (3, 1, 1), dtype, padding=(1, 0, 0))
        cin, self.blocks = widths[0], []
        for li, (planes, blocks) in enumerate(zip(widths, layers)):
            for b in range(blocks):
                name = f"layer{li + 1}_b{b}"
                stride = 2 if li > 0 and b == 0 else 1
                self.add_module(name, R2Plus1DBlock(cin, planes, stride,
                                                    dtype))
                self.blocks.append(name)
                cin = planes
        self.fc = Linear(cin, num_classes, compute_dtype=dtype)

    def forward(self, x: torch.Tensor):
        x = torch.relu(self.stem_bn1(self.stem_spatial(x)))
        x = torch.relu(self.stem_bn2(self.stem_temporal(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        feat = x.mean((2, 3, 4))
        logits = self.fc(feat)
        return (logits, feat) if self.return_features else logits


def r2plus1d_18(num_classes: int = 400, in_channels: int = 1) -> R2Plus1D18:
    return R2Plus1D18(in_channels, num_classes)


def r2plus1d_18_iekd(num_classes: int = 400,
                     in_channels: int = 1) -> R2Plus1D18:
    return R2Plus1D18(in_channels, num_classes, return_features=True)
