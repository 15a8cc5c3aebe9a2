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

On a mesh (``parallel/``; JAX's GSPMD step, written out) every rank gets
the whole global batch and runs its slice of each pass's batch axis
(stacked views and clips alike: axis 1), inside
``parallel.context.split_pass`` so the BatchNorms take the global batch's
moments. A microbatch of ``grad_accum`` is the global batch's contiguous
microbatch, split the same way. The cycle loss gathers the (V, T, C)
feature sums of every rank's frames and is computed once on each rank (its
gather's backward keeps each rank's own frames). A pass whose batch axis
``data`` does not divide runs whole on every rank and counts once: on the
data group's first rank, the others' losses weighted 0. After the
backward the gradients are summed over ``data`` (``sharding.
reduce_gradients``: the loss is a sum over the global batch, so a sum,
not a mean); the metrics too. ``checkify``'s norm is taken after that,
each split leaf's slices summed over ``model``.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Dict

import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.models.resnet import no_remat
from glfusion_tpu_torch.parallel import context
from glfusion_tpu_torch.parallel.collectives import gather
from glfusion_tpu_torch.parallel.mesh import Mesh
from glfusion_tpu_torch.parallel.sharding import (global_grad_norm,
                                                  reduce_gradients)
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
    """Σ over views of the cycle loss on (V, T, h, w, C) features. In a
    pass whose frames are split between ranks the (V, T, C) sums of every
    rank are gathered in frame order, and each rank computes the whole
    loss."""
    tc = cfg.train
    feat = gather(f4_global.sum(dim=(2, 3)), context.batch_axis(), 1)
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

    def record(self, loss: torch.Tensor, gnorm: torch.Tensor) -> None:
        vals = torch.stack([loss.detach().float(), gnorm.float()])
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


def _pass_tools(mesh: Mesh):
    """The mesh's per-pass helpers: ``split_of(*ns)`` (the data axis when it
    divides every batch axis of a pass, else None), ``local(x, axis)``
    (this rank's slice of axis 1) and ``weight(axis)`` (1, or for a
    replicated pass 1 on the data group's first rank and 0 elsewhere, so
    the pass counts once in the sums over ``data``)."""
    data = mesh.data_axis
    once = 1.0 if data.index == 0 else 0.0

    def split_of(*ns):
        return data if all(mesh.divides(n) for n in ns) else None

    def local(x, axis):
        return x if axis is None else data.own(x, 1)

    def weight(axis):
        return 1.0 if axis is not None else once

    return split_of, local, weight


def _sum_over(axis, tensors: Dict[str, torch.Tensor]) -> Dict:
    """Each tensor summed over ``axis`` (one all-reduce)."""
    if axis.size == 1:
        return tensors
    keys = list(tensors)
    dt = functools.reduce(torch.promote_types,
                          (tensors[k].dtype for k in keys), torch.float32)
    flat = torch.cat([tensors[k].to(dt).reshape(-1) for k in keys])
    axis.all_reduce_(flat)
    out, offset = {}, 0
    for k in keys:
        t = tensors[k]
        out[k] = flat[offset:offset + t.numel()].view_as(t).to(t.dtype)
        offset += t.numel()
    return out


def _weighted_counts(logits, masks, weight, dim) -> Dict[str, torch.Tensor]:
    counts = confusion_counts((logits > 0.0).float(), masks, dim=dim)
    return {k: v * weight for k, v in counts.items()}


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    cps: bool = False, mesh: Mesh | None = None) -> Callable:
    """``train_step(batch, generator) -> metrics`` (tensors on the device).

    batch: images (V, B·grad_accum, H, W, 1), masks (V, B·grad_accum, H, W,
    5) and, when the cycle loss is on, clips (V, T, H, W, 1): the global
    batch, on every rank of ``mesh`` (module docstring). The generator
    draws the sampled cycle starts (the same on every rank). Metrics, of
    the global batch: loss, seg_loss, cyc_loss and per-view confusion
    counts tp/fp/fn/tn (V,). ``cps``: ``model`` is the
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
    mesh = mesh or Mesh()
    split_of, local, weight = _pass_tools(mesh)
    params = [p for g in optimizer.param_groups for p in g["params"]]

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

    def counts_of(logits, masks, w):
        return _weighted_counts(logits, masks, w,
                                tuple(range(1, logits.dim())))

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        images, masks = batch["images"], batch["masks"]
        clips = batch.get("clips") if tc.use_cycle else None
        cyc = torch.zeros((), device=masks.device)
        seg = torch.zeros((), device=masks.device)
        counts = None
        if tc.fuse_passes and clips is not None:
            axis = split_of(images.shape[1], clips.shape[1])
            im, mk, cl = (local(t, axis) for t in (images, masks, clips))
            w = weight(axis)
            with context.split_pass(axis):
                out = model(torch.cat([im, cl.to(im.dtype)], dim=1),
                            sup_count=im.shape[1])
                s = seg_loss(out, mk)
                cyc = cycle_loss(cfg, out["f4_global"], generator)
                ((s + tc.cycle_weight * cyc) * w).backward()
            seg = s.detach() * w
            counts = counts_of(out["mask"].detach(), mk, w)
            del out
        else:
            n = images.shape[1]
            if n % accum:
                raise ValueError(f"batch of {n} frames/view does not divide "
                                 f"into grad_accum={accum} microbatches")
            mb = n // accum
            axis = split_of(mb)
            w = weight(axis)
            for a in range(accum):
                part = slice(a * mb, (a + 1) * mb)
                mk = local(masks[:, part], axis)
                with context.split_pass(axis):
                    with no_remat(model) if twin else contextlib.nullcontext():
                        out = model(local(images[:, part], axis))
                    s = seg_loss(out, mk)
                    (s * w).backward()
                seg = seg + s.detach() * w
                c = counts_of(out["mask"].detach(), mk, w)
                counts = c if counts is None else {k: counts[k] + c[k]
                                                   for k in c}
                del out
            if clips is not None:
                light = {"features_only": True} if tc.cycle_light else {}
                if tc.temporal:
                    light["is_video"] = True
                axis = split_of(clips.shape[1])
                with context.split_pass(axis):
                    out2 = model(local(clips, axis), **light)
                    cyc = cycle_loss(cfg, out2["f4_global"], generator)
                    (tc.cycle_weight * cyc * weight(axis)).backward()
                del out2
        zero_fill_grads(optimizer)
        reduce_gradients(params, model, mesh)
        # the global batch's sums (the cycle loss is whole on every rank)
        sums = _sum_over(mesh.data_axis, {"seg_loss": seg, **counts})
        seg, cyc = sums.pop("seg_loss"), cyc.detach()
        total = seg + tc.cycle_weight * cyc
        if checker is not None:
            checker.record(total, global_grad_norm(params, model, mesh))
        optimizer.step()
        return {"loss": total, "seg_loss": seg, "cyc_loss": cyc, **sums}

    train_step.seg_loss = seg_loss  # the supervised loss of (out, masks)
    if checker is not None:
        train_step.checkify_flush = checker.flush
    return train_step


def make_eval_step(cfg: Config, model: torch.nn.Module,
                   mesh: Mesh | None = None) -> Callable:
    """``eval_step(batch) -> {loss, counts, part_counts, logits}``: the fused
    mask's BCE-sum over the test views, per-view confusion counts (V,) and
    per-view, per-structure counts (V, 5), of the global batch. On a mesh
    each rank takes its slice of the batch's axis 1 (or the whole, where
    ``data`` does not divide it) and the loss and counts are summed over
    ``data``; ``logits`` are this rank's (:func:`whole_logits`)."""
    test_idx = supervised_view_indices(cfg)
    mesh = mesh or Mesh()
    split_of, local, weight = _pass_tools(mesh)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict:
        model.eval()
        axis = split_of(batch["images"].shape[1])
        w = weight(axis)
        logits = model(local(batch["images"], axis))["mask"]  # (V, B, ...)
        masks = local(batch["masks"], axis)
        loss = sum(bce_with_logits_sum(logits[vi], masks[vi])
                   for vi in test_idx)
        counts = _weighted_counts(logits, masks, w,
                                  tuple(range(1, logits.dim())))
        part_counts = _weighted_counts(logits, masks, w,
                                       tuple(range(1, logits.dim() - 1)))
        sums = _sum_over(mesh.data_axis, {
            "loss": loss if w == 1.0 else loss * w,
            **{f"c_{k}": v for k, v in counts.items()},
            **{f"p_{k}": v for k, v in part_counts.items()}})
        return {"loss": sums["loss"],
                "counts": {k: sums[f"c_{k}"] for k in counts},
                "part_counts": {k: sums[f"p_{k}"] for k in part_counts},
                "logits": logits}

    return eval_step


def whole_logits(logits: torch.Tensor, frames: int,
                 mesh: Mesh | None) -> torch.Tensor:
    """The global batch's (V, B, ...) logits from each rank's ``eval_step``
    logits of a batch of ``frames`` (a collective where the batch was
    split; JAX's ``_fetch``)."""
    if mesh is None or not mesh.divides(frames):
        return logits
    return mesh.data_axis.gather_(logits.contiguous(), 1)
