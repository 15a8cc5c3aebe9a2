"""``--debug-nans``: stop at the first operation that makes a NaN.

JAX's ``jax_debug_nans`` checks the output of every primitive, in the
forward and the backward, and raises at the first NaN. PyTorch's
``torch.autograd.set_detect_anomaly`` checks only the backward (and names
the forward op whose gradient went wrong), so this adds the forward: a
``TorchDispatchMode`` that looks at every floating output of every ATen
operation, the registered kernels' ops included, and raises
``FloatingPointError`` naming the op. Like ``jax_debug_nans`` it looks for
NaN only, not for inf.

It is slow: every op's output is reduced and read back to the host, a
synchronisation per op on the card. It is a tool for finding where a
NaN starts, not for a run.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


# ops whose output is memory not yet written
_UNINITIALIZED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}


class NaNCheckMode(TorchDispatchMode):
    """Raise at the first ATen op whose floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel() and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (shape {tuple(t.shape)})")
        return out


@contextlib.contextmanager
def debug_nans():
    """Check every op's output (forward) and autograd's anomaly mode
    (backward) inside the block."""
    with torch.autograd.set_detect_anomaly(True), NaNCheckMode():
        yield
