"""Train and eval steps of the flagship and the segmentation zoo.

The port of the base path of ``glfusion_tpu/train/step.py`` (reference
``main.py:193-243`` and ``:500-519``). One train step:

  1. the supervised forward on the stacked views → Σ over the test views of
     the BCE-sum of the fused mask (and of each deep-supervision map a zoo
     model returns as ``mask_aux``);
  2. the cycle forward on the per-view clips (frames as batch) →
     ``f4_global`` summed over space → one cycle loss per view;
  3. one Adam step on the gradient of seg + cycle_weight·cyc; a parameter
     neither loss reaches takes a zero gradient, as in JAX
     (``train_state.zero_fill_grads``).

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
  runs without recompute (``models/resnet.no_remat``);
* ``temporal``: the cycle forward folds the clip's frames into the
  attention's token axis (``is_video``);
* ``cps=True`` (the model is ``GlobalAndLocalCPS``): both networks' BCE,
  plus ``cps_weight`` × each network's BCE against the other's thresholded
  predictions, which carry no gradient;
* ``checkify``: the loss and the float32 global gradient norm must be
  finite. As in JAX the verdict is read one step late (``checkify_flush``
  reads the last one at the epoch's end), so no step waits for its own:
  the two numbers are copied to pinned host memory behind an event, which
  the next step's call waits on after it has enqueued its own work.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict

import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.models.resnet import no_remat
from glfusion_tpu_torch.train.losses import (bce_with_logits_sum,
                                             dense_seg_cycle_loss,
                                             seg_cycle_loss)
from glfusion_tpu_torch.train.metrics import confusion_counts
from glfusion_tpu_torch.train.train_state import zero_fill_grads


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


def _check_supported(cfg: Config, cps: bool) -> None:
    """JAX's exclusions (``train/step.py:83-97``)."""
    tc = cfg.train
    if tc.fuse_passes and (cps or tc.temporal):
        raise ValueError("fuse_passes is exclusive of CPS/temporal "
                         "(see TrainConfig.fuse_passes)")
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


class FinitenessCheck:
    """``checkify``'s two checks, read one step late (JAX
    ``train/step.py:338-389``): ``record`` queues a step's loss and float32
    global gradient norm and then reads the previous step's; ``flush``
    reads what is left. A non-finite value raises with JAX's message."""

    def __init__(self):
        self.pending = []

    def record(self, loss: torch.Tensor, grads) -> None:
        vals = torch.stack([
            loss.detach().float(),
            torch.nn.utils.get_total_norm(
                [g.float() for g in grads]).float()])
        event = None
        if vals.is_cuda:
            host = torch.empty(2, dtype=torch.float32, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            vals = host
        previous, self.pending = self.pending, [(vals, event)]
        for item in previous:
            self._throw(*item)

    def flush(self) -> None:
        while self.pending:
            self._throw(*self.pending.pop(0))

    @staticmethod
    def _throw(vals: torch.Tensor, event) -> None:
        if event is not None:
            event.synchronize()  # that step's copy only, not later work
        loss, gnorm = vals.tolist()
        if not math.isfinite(loss):
            raise RuntimeError(f"non-finite training loss {loss}")
        if not math.isfinite(gnorm):
            raise RuntimeError(f"non-finite gradient norm {gnorm}")


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    cps: bool = False) -> Callable:
    """``train_step(batch, generator) -> metrics`` (tensors on the device).

    batch: images (V, B·grad_accum, H, W, 1), masks (V, B·grad_accum, H, W,
    5) and, when the cycle loss is on, clips (V, T, H, W, 1). The generator
    draws the sampled cycle starts. Metrics: loss, seg_loss, cyc_loss and
    per-view confusion counts tp/fp/fn/tn (V,). ``cps``: ``model`` is the
    ``GlobalAndLocalCPS`` twin. ``train_step.seg_loss(out, masks)`` is the
    step's supervised loss of a forward's output. With
    ``cfg.train.checkify`` the step has a ``checkify_flush()`` that raises
    on the last step's non-finite loss or gradient norm.
    """
    _check_supported(cfg, cps)
    test_idx = supervised_view_indices(cfg)
    tc = cfg.train
    accum = int(tc.grad_accum)
    twin = cfg.model.remat and not tc.remat_supervised
    checker = FinitenessCheck() if tc.checkify else None

    def seg_loss(out, masks):
        """Σ over the test views of the BCE-sum, of the mask and of every
        deep-supervision map (``mask_aux``, JAX ``step.py:138-144``); under
        CPS both networks' and ``cps_weight`` × the cross pseudo-supervision
        terms (JAX ``step.py:145-160``)."""
        loss = sum(bce_with_logits_sum(out["mask"][vi], masks[vi])
                   for vi in test_idx)
        for aux in out.get("mask_aux", ()):
            for vi in test_idx:
                loss = loss + bce_with_logits_sum(aux[vi], masks[vi])
        if not cps:
            return loss
        pseudo1 = (out["mask"].detach() > 0.0).to(masks.dtype)
        pseudo2 = (out["mask_2"].detach() > 0.0).to(masks.dtype)
        cps_loss = 0.0
        for vi in test_idx:
            loss = loss + bce_with_logits_sum(out["mask_2"][vi], masks[vi])
            cps_loss = (cps_loss
                        + bce_with_logits_sum(out["mask"][vi], pseudo2[vi])
                        + bce_with_logits_sum(out["mask_2"][vi],
                                              pseudo1[vi]))
        return loss + tc.cps_weight * cps_loss

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
            seg = seg_loss(out, masks)
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
                s = seg_loss(out, masks[:, part])
                s.backward()
                seg = seg + s.detach()
                logits.append(out["mask"].detach())
                del out
            mask_logits = torch.cat(logits, dim=1)
            if clips is not None:
                light = {"features_only": True} if tc.cycle_light else {}
                if tc.temporal:
                    light["is_video"] = True
                out2 = model(clips, **light)
                cyc = cycle_loss(cfg, out2["f4_global"], generator)
                (tc.cycle_weight * cyc).backward()
                del out2
        seg, cyc = seg.detach(), cyc.detach()
        total = seg + tc.cycle_weight * cyc
        zero_fill_grads(optimizer)
        if checker is not None:
            checker.record(total, [p.grad for p in model.parameters()
                                   if p.grad is not None])
        optimizer.step()
        with torch.no_grad():
            counts = confusion_counts((mask_logits > 0.0).float(), masks,
                                      dim=tuple(range(1, mask_logits.dim())))
        return {"loss": total, "seg_loss": seg, "cyc_loss": cyc, **counts}

    train_step.seg_loss = seg_loss  # the supervised loss of (out, masks)
    if checker is not None:
        train_step.checkify_flush = checker.flush
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
