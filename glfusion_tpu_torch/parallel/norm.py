"""Cross-rank BatchNorm and dropout for a sharded run.

``shard_module`` swaps these in for every ``nn.BatchNorm{1,2,3}d``, CEN's
``StreamBN`` and ``nn.Dropout`` when the mesh has more than one rank:

* :class:`SyncBatchNorm` normalizes over the global batch. Each rank's
  per-channel (count, mean, M2) is gathered and merged in rank order on
  every rank (``collectives.merge_moments``); the backward all-reduces
  Σdy and Σdy·x̂ over the same ranks and returns this rank's own Σ as the
  scale and bias gradients (the step sums gradients over ``data``). The
  running statistics move from the merged moments with torch's unbiased
  factor n/(n − 1), n the global count (standing deviation: flax's is
  biased). A pass whose batch is not split (``context.batch_axis()`` of
  size 1) normalizes its own batch. Compute types are
  ``models/precision.py``'s: the input's type in and out, the statistics
  and the affine in float32 (float64 for a float64 model).
* Running statistics split over ``model`` stay split: each rank updates
  its own channels, and an eval forward gathers them.
* :class:`SplitDropout` draws the mask of the global batch (the batch
  axis leading) and keeps this rank's rows, so the ranks' masks are
  independent and, where the batch axis leads, one process's.

``torch.nn.SyncBatchNorm`` is not used: it raises on the CPU, and its
backward keeps no rank order.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from glfusion_tpu_torch.parallel import context
from glfusion_tpu_torch.parallel.collectives import Axis, merge_moments


class _SyncBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, axis):
        acc = torch.promote_types(x.dtype, torch.float32)
        c = x.shape[1]
        xf = x.to(acc).transpose(0, 1).reshape(c, -1)  # (C, n)
        var, mean = torch.var_mean(xf, dim=1, unbiased=False)
        n = xf.new_tensor(float(xf.shape[1]))
        total, mean, var = merge_moments(n, mean, var * n, axis)
        invstd = torch.rsqrt(var + eps)
        shape = (1, c) + (1,) * (x.dim() - 2)
        xhat = (x.to(acc) - mean.view(shape)) * invstd.view(shape)
        y = xhat
        if weight is not None:
            y = xhat * weight.to(acc).view(shape) + bias.to(acc).view(shape)
        ctx.axis = axis
        ctx.save_for_backward(xhat, invstd, weight, total[:1])
        ctx.x_dtype = x.dtype
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        xhat, invstd, weight, total = ctx.saved_tensors
        acc = xhat.dtype
        c = xhat.shape[1]
        shape = (1, c) + (1,) * (xhat.dim() - 2)
        dims = [0] + list(range(2, xhat.dim()))
        d = dy.to(acc)
        own = torch.stack([d.sum(dims), (d * xhat).sum(dims)])  # (2, C)
        glob = ctx.axis.all_reduce_(own.clone())
        scale = invstd if weight is None else invstd * weight.to(acc)
        dx = scale.view(shape) * (
            d - (glob[0] / total).view(shape)
            - xhat * (glob[1] / total).view(shape))
        dw = db = None
        if weight is not None:
            dw, db = own[1].to(weight.dtype), own[0].to(weight.dtype)
        return dx.to(ctx.x_dtype), dw, db, None, None


def sync_batch_norm(x: torch.Tensor, weight, bias, eps: float,
                    axis: Axis | None = None):
    """Train-mode BatchNorm of x (N, C, ...) over the batch of every rank
    of ``axis`` (default: the pass's ``context.batch_axis()``). Returns (y
    in x's type, global mean, global biased variance)."""
    axis = context.batch_axis() if axis is None else axis
    return _SyncBN.apply(x, weight, bias, eps, axis)


def global_count(x: torch.Tensor, axis: Axis) -> int:
    """The values a channel of x (N, C, ...) has over the ranks of
    ``axis``, each rank holding as many (a split batch divides evenly):
    known on the host, so no read of the device."""
    return x.numel() // x.shape[1] * axis.size


def update_running(rm, rv, mean, var, n: int, momentum, stat_axis=None):
    """Running averages of this rank's channels from one batch's moments
    over ``n`` values a channel (``stat_axis``: the model axis they are
    split over, else None), torch's unbiased factor."""
    with torch.no_grad():
        if stat_axis is not None:
            mean, var = stat_axis.own(mean, 0), stat_axis.own(var, 0)
        unbiased = var * (n / max(n - 1, 1))
        rm.mul_(1 - momentum).add_(mean.to(rm.dtype), alpha=momentum)
        rv.mul_(1 - momentum).add_(unbiased.to(rv.dtype), alpha=momentum)


class SyncBatchNorm(nn.modules.batchnorm._BatchNorm):
    """A BatchNorm of any rank over the global batch (module docstring).
    Its state dict is the torch BatchNorm's it replaces."""

    stat_axis: Axis | None = None  # set by shard_module

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2-D input, got {x.dim()}-D")

    @classmethod
    def replacing(cls, bn: nn.modules.batchnorm._BatchNorm) -> "SyncBatchNorm":
        new = cls(bn.num_features, bn.eps, bn.momentum, bn.affine,
                  bn.track_running_stats, device="meta")
        new._parameters = bn._parameters
        new._buffers = bn._buffers
        new.train(bn.training)
        return new

    def running_stats(self):
        """Full (running mean, running variance), gathered over ``model``
        where they are split."""
        rm, rv = self.running_mean, self.running_var
        if self.stat_axis is not None:
            rm, rv = (self.stat_axis.gather_(t, 0) for t in (rm, rv))
        return rm, rv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training and self.track_running_stats:
            rm, rv = self.running_stats()
            return F.batch_norm(x, rm, rv, self.weight, self.bias, False,
                                0.0, self.eps)
        axis = context.batch_axis()
        y, mean, var = sync_batch_norm(x, self.weight, self.bias, self.eps,
                                       axis)
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
            update_running(self.running_mean, self.running_var, mean, var,
                           global_count(x, axis), self.momentum,
                           self.stat_axis)
        return y


class SyncStreamBN(nn.Module):
    """CEN's ``StreamBN`` (per-stream BN, (S, C) leaves) over the global
    batch; its running statistics split over ``model`` on their channel
    axis (1)."""

    stat_axis: Axis | None = None

    @classmethod
    def replacing(cls, bn: nn.Module) -> "SyncStreamBN":
        new = cls()
        new.streams, new.momentum, new.eps = bn.streams, bn.momentum, bn.eps
        new._parameters = bn._parameters
        new._buffers = bn._buffers
        new.train(bn.training)
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = x.unflatten(0, (self.streams, -1))  # (S, B, C, H, W)
        w, b = self.weight, self.bias
        rm, rv = self.running_mean, self.running_var
        if not self.training:
            if self.stat_axis is not None:
                rm, rv = (self.stat_axis.gather_(t, 1) for t in (rm, rv))
            return torch.cat([F.batch_norm(
                parts[s], rm[s], rv[s], w[s], b[s], False, 0.0, self.eps)
                for s in range(self.streams)])
        out, axis = [], context.batch_axis()
        for s in range(self.streams):
            y, mean, var = sync_batch_norm(parts[s], w[s], b[s], self.eps,
                                           axis)
            update_running(rm[s], rv[s], mean, var,
                           global_count(parts[s], axis), self.momentum,
                           self.stat_axis)
            out.append(y)
        return torch.cat(out)


class SplitDropout(nn.Dropout):
    """``nn.Dropout`` whose mask is drawn for the global batch (the batch
    axis leading) and sliced to this rank's rows in a split pass."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = context.batch_axis()
        if not self.training or self.p == 0 or axis.size == 1:
            return super().forward(x)
        ones = x.new_ones((x.shape[0] * axis.size,) + tuple(x.shape[1:]))
        return x * axis.own(F.dropout(ones, self.p, True), 0)
