"""Tracing, timing and numerical-debug tools (port of
``glfusion_tpu/utils/profiling.py``).

  * ``trace(logdir)``: a ``torch.profiler`` block (CPU, and CUDA when the
    card is there) that writes a Chrome trace, ``<logdir>/trace.json``.
  * ``time_fn(fn, *args)``: seconds per call: CUDA events around ``iters``
    calls, ending in a synchronize, when an argument lies on the card; the
    host clock otherwise. PyTorch runs eagerly, so no call can be hoisted
    or elided, which JAX's chained ``lax.scan`` guards against.
  * ``flops_of(fn, *args)``: the FLOP of one call counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (matmuls and
    convolutions), or None where it cannot count.
  * ``consume_state(tot, model)``: JAX's fold of every parameter and
    buffer into one scalar.
  * ``debug_nans``: ``utils/debug.py``'s context manager.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_leaves

from glfusion_tpu_torch.utils.debug import debug_nans

__all__ = ["trace", "time_fn", "flops_of", "consume_state", "debug_nans"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block: ``with trace('/tmp/prof'): run_step()``; the
    Chrome trace is ``<logdir>/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def time_fn(fn: Callable[..., Any], *args, iters: int = 10,
            warmup: bool = True) -> float:
    """Seconds per call of ``fn(*args)``: CUDA events when an argument is
    a CUDA tensor (the events' span over ``iters`` calls, read after a
    synchronize), the host clock otherwise."""
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda
               for a in tree_leaves(args))
    if warmup:
        fn(*args)
    if cuda:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters


def flops_of(fn: Callable[..., Any], *args) -> float | None:
    """FLOP of one ``fn(*args)`` call (it runs once), or None."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:
        return None


def consume_state(tot: torch.Tensor, model: torch.nn.Module) -> torch.Tensor:
    """Fold every parameter (max |p|) and every floating buffer (its mean,
    JAX's ``batch_stats``) into ``tot``, in float32."""
    for p in model.parameters():
        tot = tot + p.detach().abs().max().float()
    for b in model.buffers():
        if b.is_floating_point():
            tot = tot + b.mean().float()
    return tot
