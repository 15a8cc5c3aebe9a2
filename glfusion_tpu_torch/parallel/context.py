"""Which axis the batch of the pass in flight is split over.

A train step runs each of its passes inside :func:`split_pass`: with the
mesh's ``data`` axis when the pass's batch is split over it, with none when
the batch is whole on every rank (a batch axis ``data`` does not divide is
replicated, as JAX's ``shard_batch`` does). The layers whose result couples
the frames of a batch read it: the cross-rank BatchNorm (moments over the
global batch), the fused stem (its partials), TPAVI over a clip's frames
(``temporal``), the cycle loss's feature gather and dropout (the global
batch's mask). The context spans the pass's backward too, where a
rematerialized block runs its forward again; it also holds the pass's
gathered leaves (``gathered``). It is a dynamic scope, as
``torch.no_grad`` is: the layers that read it sit deep inside every
model's forward, whose signatures do not carry it.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from glfusion_tpu_torch.parallel.collectives import Axis

_NONE = Axis()
# (axis, the pass's gathered leaves) of each pass in flight, innermost last
_current = [(_NONE, None)]


def batch_axis() -> Axis:
    """The axis the batch in flight is split over (size 1: not split)."""
    return _current[-1][0]


def gathered(key, gather: Callable[[], torch.Tensor]) -> torch.Tensor:
    """A leaf split over ``model``, gathered once a pass: its forward, the
    recompute of rematerialized blocks and the backward share one gather
    (outside a pass, each read gathers)."""
    cache = _current[-1][1]
    if cache is None:
        return gather()
    if key not in cache:
        cache[key] = gather()
    return cache[key]


@contextlib.contextmanager
def split_pass(axis: Axis | None):
    """Run a pass (forward and backward) whose batch is split over
    ``axis`` (None: not split)."""
    _current.append((axis if axis is not None else _NONE, {}))
    try:
        yield
    finally:
        _current.pop()
