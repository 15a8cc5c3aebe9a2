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
pass.

The options of the JAX step (``config.TrainConfig``), with its exclusions:

* ``cycle_light``: the cycle forward computes only ``f4_global``;
* ``fuse_passes``: one forward over the supervised batch and the clip
  concatenated (``sup_count``), one backward of the total;
* ``grad_accum``: the batch holds ``grad_accum`` contiguous microbatches,
  each forward and backward in turn (the gradients sum in ``.grad``), then
  the cycle pass once, then one Adam step; BN running statistics thread
  microbatch → microbatch → cycle;
* ``remat_supervised=False`` with ``model.remat``: the supervised forward
  runs without recompute (``models/resnet.no_remat``).

``temporal``, CPS and ``checkify`` are ROADMAP Queue 1.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.models.resnet import no_remat
from glfusion_tpu_torch.train.losses import (bce_with_logits_sum,
                                             dense_seg_cycle_loss,
                                             seg_cycle_loss)
from glfusion_tpu_torch.train.metrics import confusion_counts

_UNPORTED = ("temporal", "checkify")


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
    """JAX's exclusions (``train/step.py:83-97``), after the options the
    port has not taken yet."""
    tc = cfg.train
    on = [k for k in _UNPORTED if getattr(tc, k)]
    if on:
        raise NotImplementedError(f"train options {on} are ROADMAP Queue 1")
    accum = int(tc.grad_accum)
    if accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {accum}")
    if tc.fuse_passes and cfg.model.remat and not tc.remat_supervised:
        raise ValueError("fuse_passes runs one merged pass; "
                         "remat_supervised=False (a separate "
                         "supervised-pass module) cannot apply")
    if accum > 1 and tc.fuse_passes:
        raise ValueError("grad_accum > 1 is exclusive of fuse_passes: one "
                         "knob merges the passes into a single forward, the "
                         "other splits them (see TrainConfig.grad_accum)")


def cycle_loss(cfg: Config, f4_global: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
    """Σ over views of the cycle loss on (V, T, h, w, C) features."""
    tc = cfg.train
    feat = f4_global.sum(dim=(2, 3))  # (V, T, C)
    kw = dict(target_region=tc.cycle_target_region, cyc_off=tc.cycle_offset,
              chunk=tc.cycle_chunk, temperature=tc.cycle_temperature)
    total = torch.zeros((), device=feat.device)  # float32, as in JAX
    for vi in range(feat.shape[0]):
        if tc.dense_cyc:
            total = total + dense_seg_cycle_loss(feat[vi], **kw)
        else:
            total = total + seg_cycle_loss(generator, feat[vi], **kw)
    return total


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer) -> Callable:
    """``train_step(batch, generator) -> metrics`` (tensors on the device).

    batch: images (V, B·grad_accum, H, W, 1), masks (V, B·grad_accum, H, W,
    5) and, when the cycle loss is on, clips (V, T, H, W, 1). The generator
    draws the sampled cycle starts. Metrics: loss, seg_loss, cyc_loss and
    per-view confusion counts tp/fp/fn/tn (V,).
    """
    _check_supported(cfg)
    test_idx = supervised_view_indices(cfg)
    tc = cfg.train
    accum = int(tc.grad_accum)
    twin = cfg.model.remat and not tc.remat_supervised

    def seg_loss(logits, masks):
        return sum(bce_with_logits_sum(logits[vi], masks[vi])
                   for vi in test_idx)

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        images, masks = batch["images"], batch["masks"]
        clips = batch.get("clips") if tc.use_cycle else None
        cyc = torch.zeros((), device=masks.device)
        if tc.fuse_passes and clips is not None:
            out = model(torch.cat([images, clips.to(images.dtype)], dim=1),
                        sup_count=images.shape[1])
            seg = seg_loss(out["mask"], masks)
            cyc = cycle_loss(cfg, out["f4_global"], generator)
            (seg + tc.cycle_weight * cyc).backward()
            mask_logits = out["mask"].detach()
        else:
            n = images.shape[1]
            if n % accum:
                raise ValueError(f"batch of {n} frames/view does not divide "
                                 f"into grad_accum={accum} microbatches")
            mb = n // accum
            seg, logits = torch.zeros((), device=masks.device), []
            for a in range(accum):
                part = slice(a * mb, (a + 1) * mb)
                with no_remat(model) if twin else contextlib.nullcontext():
                    out = model(images[:, part])
                s = seg_loss(out["mask"], masks[:, part])
                s.backward()
                seg = seg + s.detach()
                logits.append(out["mask"].detach())
                del out
            mask_logits = torch.cat(logits, dim=1)
            if clips is not None:
                light = {"features_only": True} if tc.cycle_light else {}
                out2 = model(clips, **light)
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
