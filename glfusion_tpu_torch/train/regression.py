"""The mPAP regression path on the card (port of
``glfusion_tpu/train/regression.py``).

The reference ships the pieces of a video → scalar regression task without
a wired trainer: ``PAHDataset`` (loader.py:35-189, mPAP or Vmax targets),
the regressors of ``models/registry.build_reg_model`` and the scalar
metrics (``utils/scores.py``). ``RegressionTrainer`` wires them as JAX
does:

  * the loss is mean((pred[..., 0] − target)²); a model returning a tuple
    (Resnet50PFS's (out, seg)) is scored on ``out[0]``;
  * torch-style Adam (L2 1e-5 before the moments) on the per-epoch cosine
    schedule (``train/train_state.py``), stepped at each epoch's end;
  * randomness is a function of (seed, epoch, step), as the segmentation
    ``Trainer``'s (``train/trainer.step_randomness``): each step seeds the
    generator of its crops and the global RNG (dropout);
  * checkpoints are ``utils/checkpoint.CheckpointManager``'s
    ``net_*.pth`` + ``state_*.pth`` pairs, written in the background;
  * ``evaluate()`` scores the val split: MSE, MAE, RMSE and R².

On a mesh (``parallel/``) each rank runs its slice of the batch's axis 0
(JAX ``regression.py:163``), or the whole batch where ``data`` does not
divide it (counted once); the loss is then Σ(pred − target)² over the
rank's slice over the global batch size, so the gradients summed over
``data`` are the global mean's. Only the lead rank writes checkpoints;
``evaluate()`` gathers every rank's predictions.

Deviations from JAX, by design: no ``--torch-ckpt`` (no reference
checkpoint exists for these models, and JAX's converter maps none); the
BatchNorms' running variance takes torch's unbiased update where flax's
takes the biased one (ROADMAP Queue 3).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.data.infos import PatientIndex, load_infos, load_split
from glfusion_tpu_torch.data.pipeline import (RegressionClipLoader,
                                              preprocess_regression_batch)
from glfusion_tpu_torch.data.prefetch import prefetch
from glfusion_tpu_torch.models.registry import _views_to_channels
from glfusion_tpu_torch.parallel import context
from glfusion_tpu_torch.parallel.mesh import Mesh, make_mesh
from glfusion_tpu_torch.parallel.sharding import (reduce_gradients,
                                                  shard_batch, shard_module)
from glfusion_tpu_torch.serve import resolve_device
from glfusion_tpu_torch.train.train_state import (load_payload,
                                                  make_optimizer,
                                                  make_scheduler,
                                                  state_payload,
                                                  zero_fill_grads)
from glfusion_tpu_torch.train.trainer import step_randomness, to_device
from glfusion_tpu_torch.utils.checkpoint import CheckpointManager
from glfusion_tpu_torch.utils.cluster import barrier
from glfusion_tpu_torch.utils.scores import mae, mse, r2, rmse


def _prediction(out) -> torch.Tensor:
    """(B,) of a regressor's output (B, 1), or of its tuple's first."""
    return (out[0] if isinstance(out, tuple) else out)[..., 0]


def make_regression_train_step(model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer,
                               mesh: Mesh | None = None) -> Callable:
    """``step(batch) → {'loss', 'pred'}`` (device tensors, detached): one
    MSE update of ``model`` in train mode; ``batch`` holds ``clips`` (the
    model's input) and ``targets`` (B,), the global batch on every rank of
    ``mesh``; ``pred`` is this rank's slice's."""
    mesh = mesh or Mesh()
    data = mesh.data_axis
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        n = batch["targets"].shape[0]
        split = mesh.divides(n)
        local = shard_batch(batch, mesh, batch_axis=0)
        clips, targets = local["clips"], local["targets"]
        with context.split_pass(data if split else None):
            pred = _prediction(model(clips))
            # the global batch's mean: this rank's rows summed over n
            loss = ((pred - targets) ** 2).sum() / n
            weight = 1.0 if split or data.index == 0 else 0.0
            (loss * weight).backward()
        zero_fill_grads(optimizer)
        reduce_gradients(params, model, mesh)
        loss = loss.detach()
        if data.size > 1:
            loss = data.all_reduce_(loss * weight)
        optimizer.step()
        return {"loss": loss, "pred": pred.detach()}

    return step


def make_regression_eval_step(model: torch.nn.Module,
                              mesh: Mesh | None = None) -> Callable:
    """``step(batch) → pred`` (B,): the eval-mode forward of the global
    batch (on a mesh each rank's slice, gathered)."""
    mesh = mesh or Mesh()

    @torch.inference_mode()
    def step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        clips = batch["clips"]
        if not mesh.divides(clips.shape[0]):
            return _prediction(model(clips))
        pred = _prediction(model(mesh.data_axis.own(clips, 0)))
        return mesh.data_axis.gather_(pred.contiguous(), 0)

    return step


class RegressionTrainer:
    """Video clips → a scalar target (mPAP or Vmax); reports MSE, MAE, RMSE
    and R².

    Parameters
    ----------
    cfg: the run's :class:`Config` (views, crop and resize sizes,
        ``reg_clip_frames``, batch size, optimizer, seed, save directory).
    model: a regressor of ``models/registry.build_reg_model``, already
        initialized (the CLI seeds torch with ``cfg.train.seed`` first).
    data_paths: the dataset's ``infos`` and ``data_list_dir``.
    label_type: the target column, ``mPAP`` or ``Vmax``.
    input_adapter: clips (V, B, H, W, T) → the model's input; None takes
        ``_views_to_channels``.
    device: None → CUDA (raises without it); ``"cpu"`` runs on the CPU.
    """

    def __init__(self, cfg: Config, model: torch.nn.Module,
                 data_paths: Dict[str, str], label_type: str = "mPAP",
                 input_adapter: Optional[Callable] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = make_mesh(data=cfg.train.mesh_data,
                              model=cfg.train.mesh_model)
        self._input_adapter = input_adapter or _views_to_channels

        index = PatientIndex.from_infos(load_infos(data_paths["infos"]),
                                        cfg.data.use_data)
        dl = Path(data_paths["data_list_dir"])
        self.train_loader, self.val_loader = (
            RegressionClipLoader(index, load_split(dl / split),
                                 cfg.model.views, cfg, is_train=is_train,
                                 label_type=label_type, seed=cfg.train.seed)
            for split, is_train in (("train_list.npy", True),
                                    ("val_list.npy", False)))

        self.model = shard_module(model.to(self.device), self.mesh)
        # JAX's schedule counts steps in epochs of this many
        self.steps_per_epoch = max(
            len(self.train_loader) // cfg.train.batch_size, 1)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.scheduler = make_scheduler(cfg, self.optimizer)
        self.train_step = make_regression_train_step(self.model,
                                                     self.optimizer,
                                                     self.mesh)
        self.eval_step = make_regression_eval_step(self.model, self.mesh)
        self.ckpt = CheckpointManager(cfg.train.save_dir,
                                      max_to_keep=cfg.train.ckpt_keep)
        self.epoch = 0

    def _batch(self, host_batch: dict, is_train: bool,
               generator: Optional[torch.Generator] = None) -> dict:
        """A host batch → the step's device batch (crop, /255, the model's
        layout)."""
        clips = preprocess_regression_batch(
            to_device(host_batch["clips_raw"], self.device),
            crop_hw=self.cfg.data.crop_hw, is_train=is_train,
            generator=generator)
        return {"clips": self._input_adapter(clips),
                "targets": to_device(host_batch["targets"], self.device)}

    def train_epoch(self, epoch: int = 0) -> Dict[str, float]:
        """One epoch of MSE steps; the schedule then steps. Returns the mean
        loss and the step count (the losses are fetched once)."""
        cfg = self.cfg
        losses = []
        for host_batch in prefetch(
                self.train_loader.batches(cfg.train.batch_size, epoch)):
            with step_randomness(cfg.train.seed, epoch, len(losses),
                                 self.device) as gen:
                m = self.train_step(self._batch(host_batch, True, gen))
            losses.append(m["loss"])
        self.scheduler.step()
        return {"loss": (float(torch.stack(losses).mean().item())
                         if losses else 0.0),
                "steps": len(losses)}

    def save(self, epoch: int, wait: bool = False) -> None:
        """Checkpoint the whole train state as ``epoch`` (in the background
        unless ``wait``). Every rank calls it; the lead rank writes."""
        payload = state_payload(self.model, self.optimizer, self.scheduler)
        if self.mesh.lead:
            self.ckpt.save(payload, epoch)
        if wait:
            self.ckpt.wait()
            barrier()

    def load_latest(self) -> bool:
        """Restore the newest checkpoint (weights, BN statistics, Adam, the
        schedule); ``self.epoch`` becomes the epoch after it. False if
        there is none (reg-val then scores fresh weights)."""
        restored = self.ckpt.restore_latest()
        if restored is None:
            return False
        payload, self.epoch = restored
        load_payload(payload, self.model, self.optimizer, self.scheduler)
        return True

    def evaluate(self) -> Dict[str, float]:
        """MSE, MAE, RMSE and R² over the val split (centre crops, whole
        batches, the last one short); {} when the split is empty."""
        preds, targets = [], []
        for host_batch in prefetch(
                self.val_loader.batches(self.cfg.train.batch_size)):
            preds.append(self.eval_step(self._batch(host_batch, False)))
            targets.append(host_batch["targets"])
        if not preds:
            return {}
        p = torch.cat(preds).float().cpu().numpy()
        t = np.concatenate(targets)
        return {"mse": float(mse(t, p)), "mae": float(mae(t, p)),
                "rmse": float(rmse(t, p)), "r2": float(r2(t, p))}
