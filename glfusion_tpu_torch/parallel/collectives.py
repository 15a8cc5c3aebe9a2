"""The port's collectives: what XLA emits for JAX's sharded programs.

Every collective here is built from ``all_reduce`` alone, so one code path
runs over gloo on the CPU, over gloo on one shared card (gloo takes CUDA
tensors in ``all_reduce`` and ``broadcast`` only) and over NCCL. A gather
is an ``all_reduce`` of a zero-filled buffer that holds each rank's own
slice: exact, since x + 0 = x.

An :class:`Axis` is one of a mesh's process groups (``data``, ``model`` or
the whole world) with this rank's place in it; an axis of size 1 makes
every collective the identity, so a one-process run goes through the same
code.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Axis:
    """A process group and this rank's index in it (``group`` None with
    ``size`` 1: no communication)."""

    size: int = 1
    index: int = 0
    group: Optional[object] = None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the axis (half types through a float32
        copy: gloo sums float32 on every build). Returns ``t``."""
        if self.size == 1:
            return t
        if t.dtype in (torch.bfloat16, torch.float16):
            wide = t.float()
            torch.distributed.all_reduce(wide, group=self.group)
            t.copy_(wide)
            return t
        torch.distributed.all_reduce(t, group=self.group)
        return t

    def own(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous slice of ``x`` along ``dim``."""
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)

    def gather_(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order (no
        autograd)."""
        if self.size == 1:
            return x
        shape = list(x.shape)
        n = shape[dim]
        shape[dim] = n * self.size
        buf = x.new_zeros(shape)
        buf.narrow(dim, self.index * n, n).copy_(x)
        return self.all_reduce_(buf)


class _GatherOwnGrad(torch.autograd.Function):
    """Gather along ``dim``; backward: this rank's slice of the cotangent.
    Right where everything downstream of the gather is computed alike on
    every rank of the axis (a loss computed once on every rank, a weight
    gathered at use, an attention over every rank's tokens whose output
    rows each rank keeps through :func:`own_rows`), so each rank's
    cotangent is already the whole."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.gather_(x.detach(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.own(g, ctx.dim).contiguous(), None, None


class _OwnRows(torch.autograd.Function):
    """This rank's slice along ``dim``; backward: every rank's cotangent
    gathered, so the whole cotangent of the gathered tensor it was cut
    from reaches each rank (which then computes the same backward as one
    process, bit for bit)."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.own(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.gather_(g.contiguous(), ctx.dim), None, None


def gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (differentiable; the
    backward keeps this rank's slice of its own cotangent)."""
    if axis.size == 1:
        return x
    return _GatherOwnGrad.apply(x, axis, dim)


def own_rows(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (differentiable; the
    backward gathers every rank's cotangent)."""
    if axis.size == 1:
        return x
    return _OwnRows.apply(x, axis, dim)


def merge_moments(count: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                  axis: Axis):
    """Merge each rank's per-channel (count, mean, M2) over the axis, in
    rank order on every rank (Chan et al., the form of the fused stem's
    ``batch_moments``): (total count, mean, biased variance). ``count`` is
    a tensor of one element or one a channel."""
    c = mean.shape[-1]
    rows = torch.stack([count.to(mean.dtype).expand(c), mean, m2])
    rows = axis.gather_(rows.unsqueeze(0), 0)  # (ranks, 3, C)
    n, m, q = rows.unbind(1)
    total = n.sum(0)
    mu = (n * m).sum(0) / total
    var = (q.sum(0) + (n * (m - mu) ** 2).sum(0)) / total
    return total, mu, var
