"""Host data pipeline of the port. So far only the eval/serving
view-alignment rule; the loaders are ROADMAP M9."""

from __future__ import annotations

import numpy as np


def align_views(vols, clip_length: int, t: int = None):
    """Stack per-view clip arrays to ``(V, T, ...)`` with one common T.

    Present views are trimmed to the common minimum frame count
    (≤ ``clip_length``, or the explicit ``t``); missing views (``None``) are
    zero-filled, as the reference pads missing views with zeros. Returns
    ``(stacked, t)`` or ``(None, 0)`` when every view is missing.
    """
    if all(v is None for v in vols):
        return None, 0
    if t is None:
        t = min(min(clip_length, v.shape[0]) for v in vols if v is not None)
    vols = [None if v is None else v[:t] for v in vols]
    shape = next(v.shape for v in vols if v is not None)
    out = [np.zeros(shape, np.float32) if v is None else v for v in vols]
    return np.stack(out), t
