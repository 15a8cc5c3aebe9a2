"""Spatial crops with MONAI-compatible semantics.

The port of ``glfusion_tpu/ops/crops.py``: a center crop (MONAI
``CenterSpatialCrop``: start = floor(in/2) − floor(crop/2)) and a crop at
explicit offsets. The JAX ``random_crop`` draws its offsets from a PRNG key
inside the function; here the caller draws them (``random_offsets`` from a
``torch.Generator``), so a test can hand both packages the same window.
"""

from __future__ import annotations

import torch


def _check_crop(x: torch.Tensor, crop_hw, h_axis: int, w_axis: int):
    """Validate layout and fit; returns normalized (h_axis, w_axis)."""
    if x.dim() < 3:
        raise ValueError(
            f"crop needs ndim >= 3 (got {x.dim()}); add a channel axis "
            f"(x[..., None]) or pass explicit h_axis/w_axis")
    h_axis, w_axis = h_axis % x.dim(), w_axis % x.dim()
    ch, cw = crop_hw
    if x.shape[h_axis] < ch or x.shape[w_axis] < cw:
        raise ValueError(
            f"crop {tuple(crop_hw)} exceeds input "
            f"{(x.shape[h_axis], x.shape[w_axis])}; resize first")
    return h_axis, w_axis


def random_crop(x: torch.Tensor, crop_hw, start, h_axis: int = -3,
                w_axis: int = -2) -> torch.Tensor:
    """The (crop_h, crop_w) window at ``start = (sh, sw)`` on (..., H, W, C):
    a uniform random crop whose window the caller drew
    (:func:`random_offsets`)."""
    h_axis, w_axis = _check_crop(x, crop_hw, h_axis, w_axis)
    (sh, sw), (ch, cw) = (int(v) for v in start), crop_hw
    if not (0 <= sh <= x.shape[h_axis] - ch and 0 <= sw <= x.shape[w_axis]
            - cw):
        raise ValueError(f"crop start {tuple(start)} out of range")
    return x.narrow(h_axis, sh, ch).narrow(w_axis, sw, cw)


def center_crop(x: torch.Tensor, crop_hw, h_axis: int = -3,
                w_axis: int = -2) -> torch.Tensor:
    """Center crop on (..., H, W, C): MONAI CenterSpatialCrop start rule."""
    h_axis, w_axis = _check_crop(x, crop_hw, h_axis, w_axis)
    start = (x.shape[h_axis] // 2 - crop_hw[0] // 2,
             x.shape[w_axis] // 2 - crop_hw[1] // 2)
    return random_crop(x, crop_hw, start, h_axis, w_axis)


def random_offsets(generator: torch.Generator, in_hw, crop_hw,
                   count: int = 1) -> torch.Tensor:
    """``count`` uniform crop starts, (count, 2) int64 on the generator's
    device: sh in [0, H − ch], sw in [0, W − cw]."""
    dev = generator.device
    sh = torch.randint(0, in_hw[0] - crop_hw[0] + 1, (count,),
                       generator=generator, device=dev)
    sw = torch.randint(0, in_hw[1] - crop_hw[1] + 1, (count,),
                       generator=generator, device=dev)
    return torch.stack([sh, sw], dim=1)

