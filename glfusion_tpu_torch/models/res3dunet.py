"""3-D residual U-Net with deep supervision in PyTorch (port of
``glfusion_tpu/models/res3dunet.py``; reference ``models/res3dunet.py``).

  * 4 encoder stages of 3×3×3 conv + PReLU chains with a residual add of
    the stage input (its channels broadcast, as torch does); stages 3 and 4
    use dilations (1, 2, 4) and (3, 4, 5); 2×2×2 stride-2 conv downsampling
    between stages; dropout after each residual but the first and last.
  * Decoder: the bottleneck chain, 2×2×2 stride-2 transposed convs, skip
    concat, conv chains with a residual add of the upsampled input.
  * Deep supervision: 4 heads (map1..map4) at 1/8, 1/4, 1/2, 1/1 scale,
    each a 1×1×1 conv → trilinear upsample (half-pixel, align_corners=False,
    ``jax.image.resize``'s linear) → channel softmax unless
    ``return_logits``; coarsest first (reference ``:210``).

Modules work in NCDHW; D, H and W must be divisible by 8. Names are JAX's
(``enc1_c0``, ``down1``, ``up2``, ``map1`` …); a flax ``ConvTranspose``
kernel maps to ``ConvTranspose3d`` with its taps flipped
(``utils/convert.py``). ``dtype`` is the compute type.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import (Conv3d, ConvTranspose3d,
                                                 cast)


class PReLU(nn.Module):
    """Per-channel PReLU (torch ``nn.PReLU(num_parameters=C)``, init 0.25):
    x where x ≥ 0, else a·x, the parameter cast to x's type."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.weight.to(x.dtype).view(-1, *(1,) * (x.dim() - 2))
        return torch.where(x >= 0, x, a * x)


class ConvPReLU(nn.Module):
    def __init__(self, cin: int, features: int, dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3d(cin, features, 3, padding=dilation,
                           dilation=dilation, compute_dtype=dtype)
        self.prelu = PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.conv(x))


class DownConv(nn.Module):
    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv3d(cin, features, 2, stride=2, compute_dtype=dtype)
        self.prelu = PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.conv(x))


class UpConv(nn.Module):
    def __init__(self, cin: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvTranspose3d(cin, features, 2, stride=2,
                                    compute_dtype=dtype)
        self.prelu = PReLU(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.prelu(self.conv(x))


def upsample_trilinear(x: torch.Tensor, factor: int) -> torch.Tensor:
    if factor == 1:
        return x
    d, h, w = x.shape[-3:]
    return F.interpolate(x, size=(d * factor, h * factor, w * factor),
                         mode="trilinear", align_corners=False)


class ResUNet3D(nn.Module):
    """(B, C_in, D, H, W) → 4 maps (B, out_channels, D, H, W), softmax over
    channels unless ``return_logits``; ``return_features`` also returns the
    1/8-scale bottleneck (after the dec1 chain), the cycle-feature tap."""

    def __init__(self, in_channels: int = 1, out_channels: int = 2,
                 widths: Sequence[int] = (16, 32, 64, 128, 256),
                 drop_rate: float = 0.2, return_logits: bool = False,
                 return_features: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.return_logits = return_logits
        self.return_features = return_features
        w16, w32, w64, w128, w256 = widths
        self.drop = nn.Dropout(drop_rate)

        self.chains = {}  # name → its number of ConvPReLUs

        def chain(name, cin, feats, dils):
            self.chains[name] = len(feats)
            for i, (f, d) in enumerate(zip(feats, dils)):
                self.add_module(f"{name}_c{i}", ConvPReLU(cin, f, d, dtype))
                cin = f

        chain("enc1", in_channels, (w16, w16), (1, 1))
        self.down1 = DownConv(w16, w32, dtype)
        chain("enc2", w32, (w32,) * 3, (1, 1, 1))
        self.down2 = DownConv(w32, w64, dtype)
        chain("enc3", w64, (w64,) * 3, (1, 2, 4))
        self.down3 = DownConv(w64, w128, dtype)
        chain("enc4", w128, (w128,) * 3, (3, 4, 5))
        self.down4 = ConvPReLU(w128, w256, dtype=dtype)
        chain("dec1", w128, (w256,) * 3, (1, 1, 1))
        self.map1 = Conv3d(w256, out_channels, 1, compute_dtype=dtype)
        self.up2 = UpConv(w256, w128, dtype)
        chain("dec2", w128 + w64, (w128,) * 3, (1, 1, 1))
        self.map2 = Conv3d(w128, out_channels, 1, compute_dtype=dtype)
        self.up3 = UpConv(w128, w64, dtype)
        chain("dec3", w64 + w32, (w64,) * 3, (1, 1, 1))
        self.map3 = Conv3d(w64, out_channels, 1, compute_dtype=dtype)
        self.up4 = UpConv(w64, w32, dtype)
        chain("dec4", w32 + w16, (w32,) * 2, (1, 1))
        self.map4 = Conv3d(w32, out_channels, 1, compute_dtype=dtype)

    def _chain(self, name: str, y: torch.Tensor) -> torch.Tensor:
        for i in range(self.chains[name]):
            y = getattr(self, f"{name}_c{i}")(y)
        return y

    def _act(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.return_logits else torch.softmax(y, dim=1)

    def forward(self, x: torch.Tensor):
        x = cast(x, self.dtype)  # the residual adds must not re-promote
        drop, chain = self.drop, self._chain
        lr1 = chain("enc1", x) + x
        sr1 = self.down1(lr1)
        lr2 = drop(chain("enc2", sr1) + sr1)
        sr2 = self.down2(lr2)
        lr3 = drop(chain("enc3", sr2) + sr2)
        sr3 = self.down3(lr3)
        lr4 = drop(chain("enc4", sr3) + sr3)
        sr4 = self.down4(lr4)

        out = drop(chain("dec1", lr4) + sr4)
        bottleneck = out
        o1 = self._act(upsample_trilinear(self.map1(out), 8))
        sr6 = self.up2(out)
        out = drop(chain("dec2", torch.cat([sr6, lr3], 1)) + sr6)
        o2 = self._act(upsample_trilinear(self.map2(out), 4))
        sr7 = self.up3(out)
        out = drop(chain("dec3", torch.cat([sr7, lr2], 1)) + sr7)
        o3 = self._act(upsample_trilinear(self.map3(out), 2))
        sr8 = self.up4(out)
        out = chain("dec4", torch.cat([sr8, lr1], 1)) + sr8
        o4 = self._act(self.map4(out))
        maps = (o1, o2, o3, o4)
        return (maps, bottleneck) if self.return_features else maps
