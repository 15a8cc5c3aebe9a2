"""Resize ops with the reference's PyTorch semantics.

The port of ``glfusion_tpu/ops/resize.py``:

* nearest (host loaders): ``src = floor(dst * in / out)`` with the scale in
  float32, as torch's ``interpolate(mode='nearest')`` computes it;
* bilinear with ``align_corners=False`` and no antialias, on the NHWC
  contract of the JAX function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _nearest_indices_np(out_size: int, in_size: int) -> np.ndarray:
    """torch nearest rule with the scale in FLOAT32 (e.g. 90 · (200/144)
    gives 124.9999 → 124, not the exact 125), as a plain numpy table."""
    scale = np.float32(in_size) / np.float32(out_size)
    idx = np.floor(np.arange(out_size, dtype=np.float32) * scale)
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def resize_bilinear_nchw(x: torch.Tensor, out_hw: tuple[int, int]
                         ) -> torch.Tensor:
    """Bilinear, align_corners=False, no antialias, on (N, C, H, W)."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=False on (..., H, W, C)."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = resize_bilinear_nchw(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                             out_hw)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_hw[0], out_hw[1], c)
