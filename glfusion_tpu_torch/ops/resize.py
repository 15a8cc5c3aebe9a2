"""Resize ops with the reference's PyTorch semantics.

The port of ``glfusion_tpu/ops/resize.py``:

* nearest (host loaders, and ``resize_nearest`` on the device):
  ``src = floor(dst * in / out)`` with the scale in float32, as torch's
  ``interpolate(mode='nearest')`` computes it;
* bilinear with ``align_corners=False`` and no antialias, on the NHWC
  contract of the JAX function;
* bilinear with ``align_corners=True`` (``resize_bilinear_ac``, the zoo's
  UTNet and CEN): JAX's host-side gather tables and a lerp one axis at a
  time, so a bfloat16 input rounds where JAX's does.
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
    """Bilinear, align_corners=False, no antialias, on (N, C, H, W).

    In bfloat16 the height is resized first and rounded to bfloat16, then
    the width, as ``jax.image.resize`` contracts one axis at a time (the
    width pass at the same size is exactly the identity)."""
    if x.dtype == torch.bfloat16:
        x = F.interpolate(x, size=(out_hw[0], x.shape[-1]), mode="bilinear",
                          align_corners=False, antialias=False)
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False, antialias=False)


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=False on (..., H, W, C)."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = resize_bilinear_nchw(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                             out_hw)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_hw[0], out_hw[1], c)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int],
                   h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """Nearest-neighbor spatial resize on the device (torch
    ``interpolate(mode='nearest')``'s index rule, from the host tables of
    :func:`_nearest_indices_np`). Default layout (..., H, W, C); pass axes
    for others."""
    if x.dim() < 3:
        # the default -3/-2 axes would swap H and W on a 2-D input
        raise ValueError(
            f"resize_nearest needs ndim >= 3 (got {x.dim()}); add a channel "
            f"axis (x[..., None]) or pass explicit h_axis/w_axis")
    h_axis, w_axis = h_axis % x.dim(), w_axis % x.dim()
    for axis, size in ((h_axis, out_hw[0]), (w_axis, out_hw[1])):
        idx = torch.from_numpy(_nearest_indices_np(size, x.shape[axis]))
        x = x.index_select(axis, idx.to(x.device))
    return x


def _linear_weights_ac(out_size: int, in_size: int):
    """align_corners=True gather indices and lerp weights (host tables):
    every output takes input 0 when either size is 1."""
    if out_size == 1 or in_size == 1:
        lo = np.zeros(out_size, np.int64)
        return lo, lo, np.zeros(out_size, np.float32)
    src = (np.arange(out_size, dtype=np.float64) * (in_size - 1)
           / (out_size - 1))
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.clip(lo + 1, 0, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _lerp_ac(x: torch.Tensor, out_size: int, axis: int) -> torch.Tensor:
    """One axis of the align_corners=True bilinear resize: lo·(1 − w) +
    hi·w with float32 weights (a bfloat16 input gives float32, as JAX's
    promotion does)."""
    lo, hi, w = _linear_weights_ac(out_size, x.shape[axis])
    shape = [1] * x.dim()
    shape[axis] = out_size
    dev = x.device
    w = torch.from_numpy(w).to(dev).view(shape)
    top = x.index_select(axis, torch.from_numpy(lo).to(dev))
    bot = x.index_select(axis, torch.from_numpy(hi).to(dev))
    return top * (1 - w) + bot * w


def resize_bilinear_ac(x: torch.Tensor, out_hw: tuple[int, int],
                       h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """Bilinear with align_corners=True (torch ``align_corners=True``) on
    (..., H, W, C), or on other axes (``h_axis=-2, w_axis=-1`` for NCHW).
    The height is interpolated first, then the width, as in JAX."""
    x = _lerp_ac(x, out_hw[0], h_axis % x.dim())
    return _lerp_ac(x, out_hw[1], w_axis % x.dim())
