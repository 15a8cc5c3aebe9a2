"""``FusedIEKDStem``: the IEKD stem run through the fused stem kernels.

The port of ``experiments/stem_module.py``. Its state-dict keys are those
of ``models/resnet.iekd_stem`` (``0.weight``, ``0.bias``, ``1.weight``,
``1.bias``, ``1.running_mean``, ``1.running_var``,
``1.num_batches_tracked``), so it replaces a flagship's
``init_block[v]`` through ``load_state_dict`` and the weights bridge needs
no change. Swapping it in is the caller's act, as in the JAX package's
in-model A/B; no configuration flag selects it.

Running statistics follow ``nn.BatchNorm2d``: momentum 0.1, the unbiased
batch variance, ``num_batches_tracked`` counted. In a sharded run (its BN
swapped for ``parallel.norm.SyncBatchNorm``) the statistics are the global
batch's (``fused_stem_train``'s ``axis``, the pass's batch axis).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from glfusion_tpu_torch.experiments.stem_fused import (fused_stem_eval,
                                                       fused_stem_train)
from glfusion_tpu_torch.parallel import context
from glfusion_tpu_torch.parallel.norm import SyncBatchNorm, update_running


class FusedIEKDStem(nn.Sequential):
    """conv 7×7 s1 p2 (+bias) → BN → ReLU → maxpool 3×3 s2 p1 on
    (B, 1, H, W) → (B, C, hp, wp), in four kernels (train) or one (eval)."""

    def __init__(self, stem_width: int = 64):
        super().__init__(
            nn.Conv2d(1, stem_width, 7, stride=1, padding=2, bias=True),
            nn.BatchNorm2d(stem_width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self[0], self[1]
        sync = isinstance(bn, SyncBatchNorm)  # a sharded run's
        if not self.training:
            rm, rv = (bn.running_stats() if sync
                      else (bn.running_mean, bn.running_var))
            return fused_stem_eval(x, conv.weight, conv.bias, bn.weight,
                                   bn.bias, rm, rv)
        axis = context.batch_axis()
        out, mean, var = fused_stem_train(x, conv.weight, conv.bias,
                                          bn.weight, bn.bias, axis)
        n = x.shape[0] * (x.shape[2] - 2) * (x.shape[3] - 2) * axis.size
        bn.num_batches_tracked.add_(1)
        update_running(bn.running_mean, bn.running_var, mean, var, n,
                       bn.momentum, bn.stat_axis if sync else None)
        return out


def swap_in_fused_stems(model: nn.Module) -> None:
    """Replace every view's ``init_block[v]`` of a flagship with a
    ``FusedIEKDStem`` that carries the same weights and statistics."""
    for v, stem in list(model.init_block.items()):
        fused = FusedIEKDStem(stem[0].out_channels)
        fused.load_state_dict(stem.state_dict())
        model.init_block[v] = fused.to(stem[0].weight.device).train(
            stem.training)
