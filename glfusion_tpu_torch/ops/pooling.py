"""Pooling ops with torch semantics (floor division on the output size)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(kernel_size=3, stride=2, padding=1)`` on (N, H, W, C), the
    JAX function's layout (the model's stem runs the same pool in NCHW)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel_size=3, stride=2,
                     padding=1)
    return y.permute(0, 2, 3, 1)
