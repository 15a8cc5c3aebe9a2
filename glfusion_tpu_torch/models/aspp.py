"""DeepLabV3 ASPP head, in PyTorch (port of ``glfusion_tpu/models/aspp.py``).

Head = ASPP (a 1×1 branch, dilated 3×3 branches at rates 12/24/36, an
image-pooling branch; 5×256 → 256 projection, dropout 0.5) → 3×3 conv + BN
+ ReLU → 1×1 conv to the outputs. Modules work in NCHW; names follow the
reference (``0.convs.{i}``, ``0.project``, ``1``, ``2``, ``4``).

Clipped taps. A dilated 3×3 conv is exactly the sum over its 9 taps of a
shifted 1×1 product restricted to the output region whose source lies
inside the map; the other positions of a tap read only zero padding. At the
flagship's 28² f4, rate 36 keeps only the centre tap, rate 24 border
strips 4 wide. :func:`decomposes` is JAX's static rule, taken per forward
from the input's h and w: a branch sums its in-bounds taps when they cover
less than half of the 9·h·w tap positions, and stays a plain dilated
convolution otherwise (rate 12 at 28²). When every rate decomposes, the
1×1 branch and the dilated branches' centre taps run as one
C → (1+R)·256 product that is split, and each dilated branch adds its
border taps (JAX's ``fuse_centers``). The tap products are matrix
products on one (B, h, w, C) copy of the input per call: the centre tap
reads it in place, a border tap copies its strip.

Rounding points (``models/precision.py``): the tap partials and the centre
product accumulate in float32 and are rounded to the compute type once, at
the end of a branch, as JAX's ``out`` is; the plain convolutions return the
compute type; BN normalizes in float32. The pooling branch's bilinear
upsample from 1×1 is an exact broadcast. Parameters stay ``nn.Conv2d``
weights of shape (Cout, Cin, 3, 3), so the weights bridge is unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from glfusion_tpu_torch.models.precision import Conv2d, cast, matmul_f32


def tap_bounds(r: int, d: int, size: int) -> tuple[int, int]:
    """Output-index range [lo, hi) whose source index i + d·r is in bounds."""
    return max(0, -d * r), min(size, size - d * r)


def active_taps(rate: int, h: int, w: int) -> int:
    """Output positions summed over the 9 taps whose source is in bounds."""
    total = 0
    for dy in (-1, 0, 1):
        ylo, yhi = tap_bounds(rate, dy, h)
        for dx in (-1, 0, 1):
            xlo, xhi = tap_bounds(rate, dx, w)
            total += max(0, yhi - ylo) * max(0, xhi - xlo)
    return total


def decomposes(rate: int, h: int, w: int) -> bool:
    """JAX's rule: sum the in-bounds taps when they are under half the
    full convolution's 9·h·w tap positions."""
    return active_taps(rate, h, w) * 2 < 9 * h * w


def add_taps(out: torch.Tensor, xh: torch.Tensor, weight: torch.Tensor,
             r: int, centre: bool) -> torch.Tensor:
    """Add a dilated 3×3 conv's in-bounds taps onto ``out`` in place.

    out: float32 (B, h, w, Cout); xh: (B, h, w, Cin) in the compute type;
    weight: (Cout, Cin, 3, 3) in the compute type; the centre tap is
    skipped unless ``centre``.
    """
    h, w = xh.shape[1], xh.shape[2]
    for ti, dy in enumerate((-1, 0, 1)):
        ylo, yhi = tap_bounds(r, dy, h)
        for tj, dx in enumerate((-1, 0, 1)):
            xlo, xhi = tap_bounds(r, dx, w)
            if yhi <= ylo or xhi <= xlo or (ti == tj == 1 and not centre):
                continue
            src = xh[:, ylo + dy * r:yhi + dy * r, xlo + dx * r:xhi + dx * r]
            out[:, ylo:yhi, xlo:xhi] += matmul_f32(src, weight[:, :, ti, tj])
    return out


def _nchw(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 (B, h, w, C) → (B, C, h, w) in ``dtype``, NCHW-contiguous
    (channels-last strides would make the next convolutions run
    channels-last, PERF.md's layout trap)."""
    return cast(y, dtype).permute(0, 3, 1, 2).contiguous()


class ASPP(nn.Module):
    def __init__(self, cin: int, channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36), dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.rates = tuple(rates)
        self.dtype = dtype
        conv = dict(bias=False, compute_dtype=dtype)
        convs = [nn.Sequential(Conv2d(cin, channels, 1, **conv),
                               nn.BatchNorm2d(channels), nn.ReLU(inplace=True))]
        for r in rates:
            convs.append(nn.Sequential(
                Conv2d(cin, channels, 3, padding=r, dilation=r, **conv),
                nn.BatchNorm2d(channels), nn.ReLU(inplace=True)))
        convs.append(nn.Sequential(
            nn.AdaptiveAvgPool2d(1),
            Conv2d(cin, channels, 1, **conv),
            nn.BatchNorm2d(channels), nn.ReLU(inplace=True)))
        self.convs = nn.ModuleList(convs)
        self.project = nn.Sequential(
            Conv2d(len(convs) * channels, channels, 1, **conv),
            nn.BatchNorm2d(channels), nn.ReLU(inplace=True),
            nn.Dropout(dropout))

    def dilated_convs(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The same outputs as plain convolutions (1×1 and dilated 3×3): the
        form at rates that do not decompose, and the reference the
        clipped-tap form is held against."""
        return [seq[0](x) for seq in self.convs[:-1]]

    def branch_convs(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The 1×1 and dilated branches' convolution outputs (before their
        BN), NCHW in the compute type, each in JAX's form for x's h, w."""
        dt = self.dtype
        h, w = x.shape[-2:]
        dilated = [seq[0] for seq in self.convs[1:-1]]
        split = [decomposes(r, h, w) for r in self.rates]
        if not any(split):
            return self.dilated_convs(x)
        xh = cast(x, dt).permute(0, 2, 3, 1).contiguous()  # (B, h, w, C)
        weights = [cast(conv.weight, dt) for conv in dilated]
        if all(split):
            # one product for the 1×1 branch and every centre tap
            b0 = cast(self.convs[0][0].weight, dt)[:, :, 0, 0]
            big = torch.cat([b0] + [k[:, :, 1, 1] for k in weights])
            parts = matmul_f32(xh, big).split(b0.shape[0], dim=-1)
            outs = [_nchw(parts[0], dt)]
            for part, k, r in zip(parts[1:], weights, self.rates):
                outs.append(_nchw(add_taps(part.clone(), xh, k, r, False),
                                  dt))
            return outs
        outs = [self.convs[0][0](x)]
        for conv, k, r, s in zip(dilated, weights, self.rates, split):
            if not s:
                outs.append(conv(x))
                continue
            acc = xh.new_zeros(xh.shape[:-1] + (k.shape[0],), dtype=(
                torch.promote_types(xh.dtype, torch.float32)))
            outs.append(_nchw(add_taps(acc, xh, k, r, True), dt))
        return outs

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [seq[2](seq[1](y))
                    for seq, y in zip(self.convs, self.branch_convs(x))]
        pool = self.convs[-1](x)
        branches.append(pool.expand(-1, -1, *x.shape[-2:]))
        return self.project(torch.cat(branches, dim=1))


class DeepLabHead(nn.Sequential):
    """ASPP → 3×3 conv/BN/ReLU → 1×1 conv logits (no upsampling here)."""

    def __init__(self, cin: int, num_outputs: int, channels: int = 256,
                 rates: Sequence[int] = (12, 24, 36), dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__(
            ASPP(cin, channels, rates, dropout, dtype),
            Conv2d(channels, channels, 3, padding=1, bias=False,
                   compute_dtype=dtype),
            nn.BatchNorm2d(channels),
            nn.ReLU(inplace=True),
            Conv2d(channels, num_outputs, 1, compute_dtype=dtype))
