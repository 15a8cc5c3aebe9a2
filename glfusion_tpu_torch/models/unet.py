"""The U-Net family in PyTorch (port of ``glfusion_tpu/models/unet.py``).

One parameterized network covers the reference's four variants
(``models/unet.py``): ``U_Net :138``, ``R2U_Net :204``, ``AttU_Net :276``
and ``R2AttU_Net :349``, chosen by ``recurrent`` and ``attention``:

  * 5 encoder stages at ``widths`` with a 2×2 max-pool between stages; the
    decoder mirrors them with nearest ×2 upsample + 3×3 conv-BN-ReLU
    (``UpConv``), skip concat, then a double conv or an RRCNN block; a 1×1
    head.
  * ``RecurrentBlock``: ONE conv-BN-ReLU applied t + 1 times, x1 = conv(x),
    then x1 = conv(x + x1); its BN's running statistics move at each call,
    as flax's do. ``RRCNNBlock``: 1×1 projection, two recurrent blocks, a
    residual around the pair.
  * ``AttentionGate``: ψ = σ(BN(1×1(ReLU(BN(W_g g) + BN(W_x x))))); the
    skip is scaled by ψ before the concat.

Modules work in NCHW. Names are JAX's (``enc{i}``, ``up{i}``, ``att{i}``,
``dec{i}``, ``head``; ``ConvBNRelu``'s ``Conv_0``/``BatchNorm_0`` are
``conv``/``bn``). BatchNorm eps 1e-5, momentum 0.1 (flax 0.9). ``dtype``
is the compute type (``models/precision.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.models.precision import Conv2d


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor ×2 (torch ``nn.Upsample``'s default mode)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=kernel // 2,
                           compute_dtype=dtype)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class DoubleConv(nn.Module):
    """conv_block (reference models/unet.py:29-44): two 3×3 conv-BN-ReLU."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvBNRelu(cin, cout, dtype=dtype)
        self.conv2 = ConvBNRelu(cout, cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class UpConv(nn.Module):
    """up_conv (reference models/unet.py:46-58): ×2 nearest, 3×3 conv-BN-ReLU."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNRelu(cin, cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_2x(x))


class RecurrentBlock(nn.Module):
    """Recurrent_block (reference models/unet.py:60-79)."""

    def __init__(self, features: int, t: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.t = t
        self.conv = ConvBNRelu(features, features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.conv(x)
        for _ in range(self.t):
            x1 = self.conv(x + x1)
        return x1


class RRCNNBlock(nn.Module):
    """RRCNN_block (reference models/unet.py:80-93)."""

    def __init__(self, cin: int, features: int, t: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Conv2d(cin, features, 1, compute_dtype=dtype)
        self.rcnn1 = RecurrentBlock(features, t, dtype)
        self.rcnn2 = RecurrentBlock(features, t, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        return x + self.rcnn2(self.rcnn1(x))


class AttentionGate(nn.Module):
    """Attention_block (reference models/unet.py:108-136)."""

    def __init__(self, g_ch: int, x_ch: int, inter: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w_g = Conv2d(g_ch, inter, 1, compute_dtype=dtype)
        self.w_g_bn = nn.BatchNorm2d(inter)
        self.w_x = Conv2d(x_ch, inter, 1, compute_dtype=dtype)
        self.w_x_bn = nn.BatchNorm2d(inter)
        self.psi = Conv2d(inter, 1, 1, compute_dtype=dtype)
        self.psi_bn = nn.BatchNorm2d(1)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = torch.relu(self.w_g_bn(self.w_g(g)) + self.w_x_bn(self.w_x(x)))
        return x * torch.sigmoid(self.psi_bn(self.psi(psi)))


class UNet(nn.Module):
    """The 4-variant U-Net family behind one interface.

    (B, C_in, H, W) → (B, out_channels, H, W) logits, H and W divisible by
    16; with ``return_features`` also the deepest encoder stage (H/16), the
    cycle-feature tap of the registry's adapter.
    """

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 widths: Sequence[int] = (64, 128, 256, 512, 1024),
                 recurrent: bool = False, attention: bool = False,
                 t: int = 2, return_features: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.widths = widths = tuple(widths)
        self.attention = attention
        self.return_features = return_features

        def block(cin, cout):
            if recurrent:
                return RRCNNBlock(cin, cout, t, dtype)
            return DoubleConv(cin, cout, dtype)

        cin = in_channels
        for i, w in enumerate(widths):
            self.add_module(f"enc{i + 1}", block(cin, w))
            cin = w
        for i in range(len(widths) - 2, -1, -1):
            w = widths[i]
            self.add_module(f"up{i + 2}", UpConv(widths[i + 1], w, dtype))
            if attention:
                self.add_module(f"att{i + 2}",
                                AttentionGate(w, w, max(w // 2, 1), dtype))
            self.add_module(f"dec{i + 2}", block(2 * w, w))
        self.head = Conv2d(widths[0], out_channels, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor):
        skips = []
        for i in range(len(self.widths)):
            if i > 0:
                x = max_pool_2x2(x)
            x = getattr(self, f"enc{i + 1}")(x)
            skips.append(x)
        bottleneck = skips[-1]
        for i in range(len(self.widths) - 2, -1, -1):
            x = getattr(self, f"up{i + 2}")(x)
            skip = skips[i]
            if self.attention:
                skip = getattr(self, f"att{i + 2}")(x, skip)
            x = getattr(self, f"dec{i + 2}")(torch.cat([skip, x], dim=1))
        logits = self.head(x)
        return (logits, bottleneck) if self.return_features else logits
