"""Train and eval steps of the flagship.

The port of the base path of ``glfusion_tpu/train/step.py`` (reference
``main.py:193-243`` and ``:500-519``). One train step:

  1. the supervised forward on the stacked views → Σ over the test views of
     the BCE-sum of the fused mask;
  2. the cycle forward on the per-view clips (frames as batch) →
     ``f4_global`` summed over space → one cycle loss per view;
  3. one Adam step on the gradient of seg + cycle_weight·cyc.

BatchNorm running statistics update supervised → cycle, as the module
calls run. The two passes are differentiated one after the other (the
supervised graph is freed before the cycle forward runs); the summed
gradient is that of the total, and the peak memory is that of the larger
pass. ``fuse_passes``, ``grad_accum``, CPS, ``temporal``, ``cycle_light``,
remat and checkify are ROADMAP M10.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.train.losses import (bce_with_logits_sum,
                                             dense_seg_cycle_loss,
                                             seg_cycle_loss)
from glfusion_tpu_torch.train.metrics import confusion_counts

_UNPORTED = ("fuse_passes", "temporal", "cycle_light", "checkify")


def supervised_view_indices(cfg: Config) -> tuple:
    """Indices of the supervised (loss-bearing) views within model.views;
    a test view missing from the model is an error, as in the reference."""
    views = tuple(cfg.model.views)
    missing = [v for v in cfg.train.test_views if v not in views]
    if missing:
        raise ValueError(
            f"test_views {missing} not in model views {views}; the "
            f"supervised loss would be silently empty")
    return tuple(views.index(v) for v in cfg.train.test_views)


def _check_supported(cfg: Config) -> None:
    tc = cfg.train
    on = [k for k in _UNPORTED if getattr(tc, k)]
    if on or tc.grad_accum != 1:
        raise NotImplementedError(
            f"train options {on or ['grad_accum']} are ROADMAP M10")


def cycle_loss(cfg: Config, f4_global: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """Σ over views of the cycle loss on (V, T, h, w, C) features."""
    tc = cfg.train
    feat = f4_global.sum(dim=(2, 3))  # (V, T, C)
    kw = dict(target_region=tc.cycle_target_region, cyc_off=tc.cycle_offset,
              chunk=tc.cycle_chunk, temperature=tc.cycle_temperature)
    total = feat.new_zeros(())
    for vi in range(feat.shape[0]):
        if tc.dense_cyc:
            total = total + dense_seg_cycle_loss(feat[vi], **kw)
        else:
            total = total + seg_cycle_loss(generator, feat[vi], **kw)
    return total


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """``train_step(batch, generator) -> metrics`` (tensors on the device).

    batch: images (V, B, H, W, 1), masks (V, B, H, W, 5) and, when the
    cycle loss is on, clips (V, T, H, W, 1). The generator draws the sampled
    cycle starts. Metrics: loss, seg_loss, cyc_loss and per-view confusion
    counts tp/fp/fn/tn (V,).
    """
    _check_supported(cfg)
    test_idx = supervised_view_indices(cfg)
    tc = cfg.train

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        masks = batch["masks"]
        out = model(batch["images"])
        seg = sum(bce_with_logits_sum(out["mask"][vi], masks[vi])
                  for vi in test_idx)
        seg.backward()
        mask_logits = out["mask"].detach()
        del out
        cyc = torch.zeros((), device=masks.device)
        if tc.use_cycle and "clips" in batch:
            out2 = model(batch["clips"])
            cyc = cycle_loss(cfg, out2["f4_global"], generator)
            (tc.cycle_weight * cyc).backward()
            del out2
        optimizer.step()
        with torch.no_grad():
            seg, cyc = seg.detach(), cyc.detach()
            counts = confusion_counts((mask_logits > 0.0).float(), masks,
                                      dim=tuple(range(1, mask_logits.dim())))
        return {"loss": seg + tc.cycle_weight * cyc, "seg_loss": seg,
                "cyc_loss": cyc, **counts}

    return train_step


def make_eval_step(cfg: Config, model: torch.nn.Module) -> Callable:
    """``eval_step(batch) -> {loss, counts, part_counts, logits}``: the fused
    mask's BCE-sum over the test views, per-view confusion counts (V,) and
    per-view, per-structure counts (V, 5)."""
    test_idx = supervised_view_indices(cfg)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict:
        model.eval()
        logits = model(batch["images"])["mask"]  # (V, B, H, W, 5)
        masks = batch["masks"]
        loss = sum(bce_with_logits_sum(logits[vi], masks[vi])
                   for vi in test_idx)
        pred = (logits > 0.0).float()
        counts = confusion_counts(pred, masks,
                                  dim=tuple(range(1, logits.dim())))
        part_counts = confusion_counts(pred, masks,
                                       dim=tuple(range(1, logits.dim() - 1)))
        return {"loss": loss, "counts": counts, "part_counts": part_counts,
                "logits": logits}

    return eval_step
