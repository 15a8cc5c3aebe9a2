"""ResNet-50 backbone with the reference's "IEKD" deviations, in PyTorch.

The port of ``glfusion_tpu/models/resnet.py``:

* the stem is a 1-channel, stride-1, 7×7 conv with padding 2 AND bias, so a
  112² input gives a 110² stem map, 55² after the maxpool, 28² from layer2;
* torchvision bottlenecks with ``replace_stride_with_dilation=[False, True,
  True]``: layer3/4 keep stride 1, and the first block of a dilated stage
  uses the PREVIOUS dilation (torchvision's ``_make_layer`` rule);
* BatchNorm eps 1e-5, momentum 0.1 (the JAX side's flax momentum 0.9).

Compute type (``models/precision.py``): every convolution casts its input
and weights to ``dtype`` and returns that type, the stem's 7×7 kernel and
bias included (JAX's ``_stem_conv`` rounds them to bfloat16 too); BN
normalizes in float32 and returns ``dtype``; the residual add and the ReLU
run in ``dtype``.

Remat: a bottleneck with ``remat`` set runs under
``torch.utils.checkpoint`` (JAX's ``nn.remat`` of each block of a masked
stage): its activations are recomputed in the backward. The recompute runs
the block's BatchNorms in train mode again; it restores their running
statistics afterwards, so they move once per forward, as under flax, which
discards the recompute's mutation. The stem is never rematted.

Modules work in NCHW. Names follow torchvision and the reference
(``init_block.{0,1}``, ``layer{s}.{b}.conv1`` …), so the flagship's per-view
``init_block.{v}`` / ``layer{s}.{v}`` ModuleDicts hold these same pieces.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from glfusion_tpu_torch.models.precision import Conv2d


class Bottleneck(nn.Module):
    """torchvision bottleneck: 1×1 → 3×3 (stride, dilation) → 1×1 (×expansion)."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 dilation: int = 1, expansion: int = 4,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        cout = planes * expansion
        conv = dict(bias=False, compute_dtype=dtype)
        self.remat = remat
        self.conv1 = Conv2d(cin, planes, 1, **conv)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride,
                            padding=dilation, dilation=dilation, **conv)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = Conv2d(planes, cout, 1, **conv)
        self.bn3 = nn.BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                Conv2d(cin, cout, 1, stride=stride, **conv),
                nn.BatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._forward, x, use_reentrant=False,
                              context_fn=self._hold_running_stats)
        return self._forward(x)

    def _hold_running_stats(self):
        """checkpoint's (forward, recompute) contexts: the recompute puts
        back the BN buffers it finds."""
        bufs = [b for m in self.modules()
                if isinstance(m, nn.modules.batchnorm._BatchNorm)
                for b in m.buffers()]

        @contextlib.contextmanager
        def recompute():
            saved = [b.clone() for b in bufs]
            try:
                yield
            finally:
                with torch.no_grad():
                    for b, v in zip(bufs, saved):
                        b.copy_(v)

        return contextlib.nullcontext(), recompute()

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
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


def iekd_stem(stem_width: int, dtype: torch.dtype = torch.float32,
              in_channels: int = 1) -> nn.Sequential:
    """The IEKD stem: conv 7×7 s1 p2 with bias, BN, ReLU, maxpool 3×3 s2 p1.
    ``in_channels`` sizes the conv (JAX's ``_stem_conv`` takes the input's
    channels: 1 in the flagship, 3 in ``deeplabv3_resnet50``)."""
    return nn.Sequential(
        Conv2d(in_channels, stem_width, 7, stride=1, padding=2, bias=True,
               compute_dtype=dtype),
        nn.BatchNorm2d(stem_width),
        nn.ReLU(inplace=True),
        nn.MaxPool2d(3, stride=2, padding=1))


def remat_mask(num_stages: int, remat: bool,
               remat_stages: Sequence[bool] | None) -> tuple:
    """Per-stage remat flags: ``remat_stages``, or ``remat`` for every
    stage when it is None (JAX's rule)."""
    if remat_stages is None:
        return (remat,) * num_stages
    if len(remat_stages) != num_stages:
        raise ValueError(f"remat_stages has {len(remat_stages)} entries for "
                         f"{num_stages} stages")
    return tuple(remat_stages)


def make_stages(stem_width: int, block_sizes: Sequence[int],
                widths: Sequence[int], expansion: int,
                dilate_stages: Sequence[bool],
                dtype: torch.dtype = torch.float32,
                remat_stages: Sequence[bool] | None = None
                ) -> list[nn.Sequential]:
    """The residual stages, one ``nn.Sequential`` of bottlenecks each; the
    bottlenecks of stage s are rematted when ``remat_stages[s]``."""
    stages, cin = [], stem_width
    mask = remat_mask(len(block_sizes), False, remat_stages)
    for (blocks, planes, stride, first_dil, dil), remat in zip(stage_plan(
            block_sizes, widths, dilate_stages), mask):
        mods = []
        for b in range(blocks):
            mods.append(Bottleneck(cin, planes,
                                   stride=stride if b == 0 else 1,
                                   dilation=first_dil if b == 0 else dil,
                                   expansion=expansion, dtype=dtype,
                                   remat=remat))
            cin = planes * expansion
        stages.append(nn.Sequential(*mods))
    return stages


class ResNetIEKD(nn.Module):
    """1-channel stride-1-stem dilated ResNet; returns the last stage's map.

    Input (B, 1, H, W) → (B, widths[-1]·expansion, H', W') with H' = H/4 at
    the reference sizes (112 → 28). ``in_channels`` sizes the stem conv.
    With ``return_taps`` it returns JAX's taps instead: ``{"stem",
    "layer1", ...}``, where ``stem`` is the activation after the stem's
    ReLU and before its max-pool (the reference's ``x_layerbs``).
    """

    def __init__(self, stem_width: int = 64,
                 block_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512),
                 expansion: int = 4,
                 dilate_stages: Sequence[bool] = (False, False, True, True),
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_stages: Sequence[bool] | None = None,
                 in_channels: int = 1, return_taps: bool = False):
        super().__init__()
        self.init_block = iekd_stem(stem_width, dtype, in_channels)
        self.num_stages = len(block_sizes)
        self.return_taps = return_taps
        mask = remat_mask(len(block_sizes), remat, remat_stages)
        for s, stage in enumerate(make_stages(
                stem_width, block_sizes, widths, expansion, dilate_stages,
                dtype, mask), 1):
            self.add_module(f"layer{s}", stage)

    def forward(self, x: torch.Tensor):
        if not self.return_taps:
            x = self.init_block(x)
            for s in range(1, self.num_stages + 1):
                x = getattr(self, f"layer{s}")(x)
            return x
        x = self.init_block[:3](x)
        taps = {"stem": x}
        x = self.init_block[3](x)
        for s in range(1, self.num_stages + 1):
            x = taps[f"layer{s}"] = getattr(self, f"layer{s}")(x)
        return taps


@contextlib.contextmanager
def no_remat(model: nn.Module):
    """Run ``model``'s rematted bottlenecks without recompute inside this
    block: the JAX step's no-remat twin of the supervised pass
    (``remat_supervised=False``), on the same parameters."""
    blocks = [m for m in model.modules()
              if isinstance(m, Bottleneck) and m.remat]
    for b in blocks:
        b.remat = False
    try:
        yield
    finally:
        for b in blocks:
            b.remat = True
