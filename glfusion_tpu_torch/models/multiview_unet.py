"""Multi-view U-Net baselines in PyTorch (port of
``glfusion_tpu/models/multiview_unet.py``; reference ``models/ours.py``).

``baseline_unet :2416``: per-view independent U-Nets, a 1×1 head, no
cross-view communication; per-view logits at the input size and the
bottleneck features (the cycle loss's).

``multiview_unet :2518``: the same, plus a TPAVI dot-product block over the
stacked per-view bottlenecks before decoding (reference ``:2597-2602``). Its
TPAVI takes the default order (``attn_impl='auto'``, plain matmuls), as in
JAX, where only the flagship reaches the Pallas kernel.

Each view has its own encoder and decoder (``encoder.{i}``,
``decoder.{i}``), initialised independently, as JAX's ``nn.vmap`` with
``split_rngs={'params': True}`` gives. Modules work in NCHW; the public
interface is JAX's: (V, B, H, W, 1) in, ``mask`` (V, B, H, W, classes) and
``bottleneck`` (V, B, h, w, C) out.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from glfusion_tpu_torch.models.precision import Conv2d
from glfusion_tpu_torch.models.tpavi import TPAVI
from glfusion_tpu_torch.models.unet import DoubleConv, UpConv, max_pool_2x2


class _Encoder(nn.Module):
    def __init__(self, widths: Sequence[int], in_channels: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = len(widths)
        cin = in_channels
        for i, w in enumerate(widths):
            self.add_module(f"enc{i + 1}", DoubleConv(cin, w, dtype))
            cin = w

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for i in range(self.depth):
            if i > 0:
                x = max_pool_2x2(x)
            x = getattr(self, f"enc{i + 1}")(x)
            skips.append(x)
        return skips


class _Decoder(nn.Module):
    def __init__(self, widths: Sequence[int], out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth = len(widths)
        for i in range(len(widths) - 2, -1, -1):
            self.add_module(f"up{i + 2}", UpConv(widths[i + 1], widths[i],
                                                 dtype))
            self.add_module(f"dec{i + 2}", DoubleConv(2 * widths[i],
                                                      widths[i], dtype))
        self.head = Conv2d(widths[0], out_channels, 1, compute_dtype=dtype)

    def forward(self, skips: List[torch.Tensor]) -> torch.Tensor:
        x = skips[-1]
        for i in range(self.depth - 2, -1, -1):
            x = getattr(self, f"up{i + 2}")(x)
            x = getattr(self, f"dec{i + 2}")(torch.cat([skips[i], x], dim=1))
        return self.head(x)


class MultiviewUNet(nn.Module):
    """Per-view U-Nets with optional bottleneck TPAVI fusion (``fuse``)."""

    def __init__(self, num_views: int, num_classes: int = 5,
                 widths: Sequence[int] = (64, 128, 256, 512, 1024),
                 fuse: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = tuple(widths)
        self.encoder = nn.ModuleList(
            [_Encoder(widths, dtype=dtype) for _ in range(num_views)])
        self.fuse = fuse
        if fuse:
            self.global_attn = TPAVI(widths[-1], dtype=dtype)
        self.decoder = nn.ModuleList(
            [_Decoder(widths, num_classes, dtype) for _ in range(num_views)])

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        skips = [enc(x[i, ..., 0].unsqueeze(1))
                 for i, enc in enumerate(self.encoder)]
        x5 = torch.stack([s[-1] for s in skips])  # (V, B, C, h, w)
        if self.fuse:
            fused = self.global_attn(x5.permute(1, 0, 3, 4, 2))
            x5 = fused.permute(1, 0, 4, 2, 3).contiguous()
            for i, s in enumerate(skips):
                s[-1] = x5[i]
        mask = torch.stack([dec(s) for dec, s in zip(self.decoder, skips)])
        return {"mask": mask.permute(0, 1, 3, 4, 2),
                "bottleneck": x5.permute(0, 1, 3, 4, 2)}
