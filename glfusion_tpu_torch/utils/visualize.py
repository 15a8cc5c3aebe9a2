"""Prediction visualization (reference ``main.py:546-648`` test_visualize).

The port of ``glfusion_tpu/utils/visualize.py``: sigmoid > 0.5 per channel,
argmax over [0.5 background | 5 class channels] (on the logits' device), the
reference's fixed class → RGBA table as a lookup, and one PNG a frame under
``<out>/<method>/192_data/<patient>/<view>/pred_<t>.png``, written by a
standard-library encoder (no PIL or matplotlib).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch

# class id → RGBA, the reference table (main.py:625-634): 0 background, then
# the 5 structure channels in mask order
COLOR_TABLE = np.array(
    [
        [0, 0, 0, 255],        # 0: background
        [55, 255, 254, 255],   # 1
        [27, 255, 46, 255],    # 2 (ra)
        [45, 0, 251, 255],     # 3 (rv)
        [251, 13, 15, 255],    # 4 (la)
        [223, 48, 236, 255],   # 5 (lv)
    ],
    dtype=np.uint8,
)


def class_map(logits) -> torch.Tensor:
    """(..., H, W, C) logits → (..., H, W) int64 class ids, 0 = background:
    a channel wins where its logit > 0, the first such channel on ties."""
    logits = torch.as_tensor(logits)
    binary = (logits > 0.0).float()
    bg = torch.full(binary.shape[:-1] + (1,), 0.5, device=binary.device)
    return torch.argmax(torch.cat([bg, binary], dim=-1), dim=-1)


def colorize(cls_map) -> np.ndarray:
    """(..., H, W) class ids → (..., H, W, 4) uint8 RGBA."""
    return COLOR_TABLE[np.asarray(cls_map)]


def write_png(path, rgba: np.ndarray) -> None:
    """Write an (H, W, 4) uint8 RGBA array as a PNG: signature, IHDR, one
    zlib IDAT (filter 0 on every row), IEND."""
    arr = np.ascontiguousarray(np.asarray(rgba, dtype=np.uint8))
    if arr.ndim != 3 or arr.shape[2] != 4:
        raise ValueError(f"expected (H, W, 4) RGBA uint8, got {arr.shape}")
    h, w = arr.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        body = tag + payload
        return (struct.pack(">I", len(payload)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)  # 8-bit RGBA
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    Path(path).write_bytes(png)


def save_clip_visualization(out_dir, method_name: str, patient_id: str,
                            view: str, logits) -> int:
    """Write one clip view's (T, H, W, C) logits as pred_<t>.png files;
    returns the number of frames."""
    rgba = colorize(class_map(logits).cpu().numpy())  # (T, H, W, 4)
    d = Path(out_dir) / method_name / "192_data" / str(patient_id) / str(view)
    d.mkdir(parents=True, exist_ok=True)
    for t in range(rgba.shape[0]):
        write_png(d / f"pred_{t}.png", rgba[t])
    return rgba.shape[0]
