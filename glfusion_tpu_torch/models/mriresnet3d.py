"""MedicalNet-style dilated 3-D ResNet and the multi-modality PFS regressor
in PyTorch (port of ``glfusion_tpu/models/mriresnet3d.py``; reference
``models/mriresnet3d.py``).

  * ``MRIResNet3D``: a 1-channel 7³ stride-2 stem to 64 channels, a 3³
    stride-2 max-pool, 4 stages whose (stride, dilation) are (1, 1),
    (2, 1), (1, 2), (1, 4) (MedicalNet), then the ``conv_seg`` head:
    ``ConvTranspose3d(32, 2, stride 2)`` → BN → ReLU → 3³ conv → BN → ReLU
    → 1³ conv to ``num_seg_classes`` (a coarse segmentation map); with
    ``pool_head`` a global mean instead (the PFS projector).
  * ``Resnet50PFS``: (B, M, D, H, W) single-channel volumes fold into the
    batch; a depth-101 ``model`` maps each to a seg map, a depth-18
    ``conv_projection`` pools each map to a feature, the M features
    concatenate into ``fc_projection``. Returns (out, seg). On echo the
    views are the modality axis (``models/registry.py``).

Modules work in NCDHW; names are JAX's (``conv1``, ``layer{s}_b{b}``,
``seg_deconv`` …). flax's ``ConvTranspose`` does not flip its kernel and
torch's does: the converter flips the taps (``utils/convert.py``).
BatchNorm eps 1e-5, momentum 0.1; torch's running variance is unbiased
(ROADMAP Queue 3). ``dtype`` is the compute type.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from glfusion_tpu_torch.models.precision import (Conv3d, ConvTranspose3d,
                                                 Linear, cast)
from glfusion_tpu_torch.models.resnet3d import (DEPTH_TABLE, EXPANSION,
                                                Residual3D, conv_bn,
                                                max_pool_stem)

# (stride, dilation) of the four stages (reference :130-140)
STAGES = ((1, 1), (2, 1), (1, 2), (1, 4))


class _Block3D(Residual3D):
    """Basic or bottleneck 3-D residual block with dilation
    (reference :52-112)."""

    def __init__(self, cin: int, planes: int, kind: str, stride: int = 1,
                 dilation: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kind, d = kind, dilation
        out = planes * EXPANSION[kind]
        if kind == "basic":
            self.conv1, self.bn1 = conv_bn(cin, planes, 3, dtype, stride, d,
                                           d)
            self.conv2, self.bn2 = conv_bn(planes, planes, 3, dtype, 1, d, d)
        else:
            self.conv1, self.bn1 = conv_bn(cin, planes, 1, dtype)
            self.conv2, self.bn2 = conv_bn(planes, planes, 3, dtype, stride,
                                           d, d)
            self.conv3, self.bn3 = conv_bn(planes, out, 1, dtype)
        self._shortcut(cin, out, stride, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = cast(x, self.dtype)  # the identity shortcut must not promote
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.kind == "bottleneck":
            y = self.bn3(self.conv3(torch.relu(y)))
        return torch.relu(y + self._residual(x))


class MRIResNet3D(nn.Module):
    """(B, in_channels, D, H, W) → seg map (B, num_seg_classes, D/4, H/4,
    W/4) (the stem, the pool and stage 2 each halve, the head doubles), or
    with ``pool_head`` the pooled feature (B, C) (the Resnet50PFS
    projector, reference :296-301)."""

    def __init__(self, in_channels: int = 1, depth: int = 101,
                 num_seg_classes: int = 1,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 pool_head: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        kind, layers = DEPTH_TABLE[depth]
        self.conv1, self.bn1 = conv_bn(in_channels, 64, 7, dtype, stride=2,
                                       padding=3)
        cin, self.blocks = 64, []
        for li, (planes, blocks) in enumerate(zip(widths, layers)):
            stride, dil = STAGES[li]
            for b in range(blocks):
                name = f"layer{li + 1}_b{b}"
                self.add_module(name, _Block3D(
                    cin, planes, kind, stride if b == 0 else 1, dil, dtype))
                self.blocks.append(name)
                cin = planes * EXPANSION[kind]
        self.out_channels = cin
        self.pool_head = pool_head
        if not pool_head:  # conv_seg (reference :147-171)
            self.seg_deconv = ConvTranspose3d(cin, 32, 2, stride=2,
                                              compute_dtype=dtype)
            self.seg_bn1 = nn.BatchNorm3d(32)
            self.seg_conv, self.seg_bn2 = conv_bn(32, 32, 3, dtype,
                                                  padding=1)
            self.seg_out = Conv3d(32, num_seg_classes, 1, bias=False,
                                  compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_stem(torch.relu(self.bn1(self.conv1(x))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        if self.pool_head:
            return x.mean((2, 3, 4))
        y = torch.relu(self.seg_bn1(self.seg_deconv(x)))
        y = torch.relu(self.seg_bn2(self.seg_conv(y)))
        return self.seg_out(y)


class Resnet50PFS(nn.Module):
    """Multi-modality volumes → regression (reference mriresnet3d.py:271-336).

    (B, M, D, H, W) single-channel volumes, ``num_modalities`` = M (the
    views on echo; JAX infers it from the input) → (out (B, n_outputs),
    seg (B·M, 1, D/4, H/4, W/4))."""

    def __init__(self, num_modalities: int, n_outputs: int = 12,
                 main_depth: int = 101, proj_depth: int = 18,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.model = MRIResNet3D(1, main_depth, 1, widths, dtype=dtype)
        self.conv_projection = MRIResNet3D(1, proj_depth, widths=widths,
                                           pool_head=True, dtype=dtype)
        self.fc_projection = Linear(
            num_modalities * self.conv_projection.out_channels, n_outputs,
            compute_dtype=dtype)

    def forward(self, x: torch.Tensor):
        b, m = x.shape[:2]
        flat = x.reshape(b * m, 1, *x.shape[2:])  # fold the modalities
        seg = self.model(flat)
        feats = self.conv_projection(seg).reshape(b, -1)
        return self.fc_projection(feats), seg
