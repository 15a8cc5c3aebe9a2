"""Label remapping into the unified 5-structure channel space.

The port of ``glfusion_tpu/ops/masks.py``: one static table maps a raw
label value of a view to its global channel (RA, RV, LA, LV, PA), or −1 for
background:

  view '1' (PLAX):  1→LV(3), 2→RV(1)
  view '2' (PA-LAX): 1→PA(4)
  view '3' (PSAX):  1→LV(3), 2→RV(1)
  view '4' (A4C):   1→LV(3), 2→LA(2), 3→RA(0), 4→RV(1)

Out-of-range raw values (negative, or above 4) map to background, like the
reference's exact-equality tests.
"""

from __future__ import annotations

import numpy as np
import torch

from glfusion_tpu_torch.config import ALL_VIEWS, NUM_CLASSES

MAX_RAW_LABEL = 4

# channel index per (view, raw label value); -1 = background.
_TABLE = {
    "1": {1: 3, 2: 1},
    "2": {1: 4},
    "3": {1: 3, 2: 1},
    "4": {1: 3, 2: 2, 3: 0, 4: 1},
}


def view_label_table() -> np.ndarray:
    """(num_views, max_raw_label+1) int table of global channel ids (-1=bg)."""
    table = -np.ones((len(ALL_VIEWS), MAX_RAW_LABEL + 1), dtype=np.int32)
    for vi, view in enumerate(ALL_VIEWS):
        for raw, ch in _TABLE[view].items():
            table[vi, raw] = ch
    return table


_TABLE_ARR = torch.from_numpy(view_label_table()).long()


def mask_to_allclass(raw_mask: torch.Tensor, view) -> torch.Tensor:
    """Integer label map (..., H, W) → (..., H, W, NUM_CLASSES) float one-hot.

    ``view`` is a view name ('1'..'4') or an index into ALL_VIEWS.
    """
    view_idx = ALL_VIEWS.index(view) if isinstance(view, str) else int(view)
    raw = raw_mask.long()
    in_range = (raw >= 0) & (raw <= MAX_RAW_LABEL)
    table = _TABLE_ARR[view_idx].to(raw.device)
    chan = torch.where(in_range, table[raw.clamp(0, MAX_RAW_LABEL)], -1)
    classes = torch.arange(NUM_CLASSES, device=raw.device)
    return (chan[..., None] == classes).float()
