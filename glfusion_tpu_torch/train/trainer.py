"""Trainer: the reference's train and validation loops on the card.

The port of ``glfusion_tpu/train/trainer.py`` (``Trainer.__init__``,
``train``, ``_train_epoch``, ``validation_and_test``,
``evaluate_val_frames``, ``evaluate_clips``). Host batches come from the
numpy loaders through a prefetch thread; the crop, /255 and label remap run
on the card (``data/pipeline.preprocess_batch``); metrics accumulate on the
card and are fetched once per epoch or evaluation.

Checkpoints are the reference's format: ``{'network': state_dict}`` saved
as ``<save_dir>/net_{epoch:05}.pth`` after each saved epoch, which the JAX
CLI reads through ``--torch-ckpt``; ``load_latest`` reads the newest.
Orbax semantics (atomic async saves, retention, optimizer state, resume,
preemption), parameter histograms and ``sweep_checkpoints`` are ROADMAP M15.
"""

from __future__ import annotations

import json
import re
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.data.infos import PatientIndex, load_infos, load_split
from glfusion_tpu_torch.data.pipeline import (AlignedClipLoader, ByteLRU,
                                              MISS, SegFrameLoader,
                                              TestClipLoader,
                                              preprocess_batch,
                                              view_ids_tuple)
from glfusion_tpu_torch.data.prefetch import prefetch
from glfusion_tpu_torch.models import GlobalAndLocal
from glfusion_tpu_torch.serve import resolve_device
from glfusion_tpu_torch.train.metrics import overlap_metrics
from glfusion_tpu_torch.train.step import make_eval_step, make_train_step
from glfusion_tpu_torch.train.train_state import (make_optimizer,
                                                  make_scheduler)
from glfusion_tpu_torch.utils.convert import load_checkpoint

# the reference's fixed eval split of the 10 test clips (main.py:423-424)
VAL_CLIPS = ["0_0", "0_2"]
TEST_CLIPS = ["0_1", "0_3", "0_4", "0_5", "0_6", "0_7", "0_8", "0_9"]
_CKPT = re.compile(r"net_(\d{5})\.pth$")


def _sum(a, b):
    if isinstance(a, dict):
        return {k: _sum(a[k], b[k]) for k in a}
    return a + b


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


class Trainer:
    """Train and evaluate the flagship.

    Parameters
    ----------
    cfg: the run's :class:`Config`.
    data_paths: the dataset's ``infos``, ``unlab_infos``, ``test_infos`` and
        ``data_list_dir``; None writes the synthetic corpus (seeded by
        ``cfg.train.seed``) into a temporary directory.
    device: None → CUDA (raises without it); ``"cpu"`` runs on the CPU.
    model: an already built flagship to train (for instance with fused
        stems swapped in); None builds ``GlobalAndLocal(cfg.model)``.
    """

    def __init__(self, cfg: Config, data_paths: Optional[Dict[str, str]] = None,
                 verbose: bool = True, device=None,
                 model: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        self.verbose = verbose
        self.device = resolve_device(device)
        torch.manual_seed(cfg.train.seed)  # initial weights and dropout

        if data_paths is None:
            from glfusion_tpu_torch.data.synthetic import (
                generate_synthetic_dataset)
            tmp = tempfile.mkdtemp(prefix="glfusion_torch_synth_")
            data_paths = generate_synthetic_dataset(
                tmp, cfg.data, views=cfg.model.views, seed=cfg.train.seed)
            self._log(f"synthetic dataset generated under {tmp}")
        self.data_paths = data_paths

        infos = load_infos(data_paths["infos"])
        unlab = load_infos(data_paths["unlab_infos"])
        self.test_infos = load_infos(data_paths["test_infos"])
        dl = Path(data_paths["data_list_dir"])
        self.train_list = load_split(dl / "train_list.npy")
        self.val_list = load_split(dl / "val_list.npy")
        self.test_list = load_split(dl / "test_list.npy")

        index = PatientIndex.from_infos(infos, cfg.data.use_data)
        unlab_index = PatientIndex.from_infos(unlab, cfg.data.use_data)
        views = cfg.model.views
        seed = cfg.train.seed
        self.train_loader = SegFrameLoader(index, self.train_list, views, cfg,
                                           is_train=True, seed=seed)
        self.valid_loader = SegFrameLoader(index, self.val_list, views, cfg,
                                           is_train=False, seed=seed)
        self.cycle_loader = AlignedClipLoader(unlab_index, self.train_list,
                                              views, cfg, seed=seed)
        self.view_ids = view_ids_tuple(views)

        self.model = (model if model is not None
                      else GlobalAndLocal(cfg.model)).to(self.device)
        # one update takes batch_size·grad_accum frames a view
        self.update_frames = cfg.train.batch_size * cfg.train.grad_accum
        self.steps_per_epoch = max(
            len(self.train_loader) // self.update_frames, 1)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.scheduler = make_scheduler(cfg, self.optimizer)
        self.train_step = make_train_step(cfg, self.model, self.optimizer)
        self.eval_step = make_eval_step(cfg, self.model)
        # draws the train crops and the sampled cycle starts
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.save_dir = Path(cfg.train.save_dir)
        self._eval_clip_cache = ByteLRU(1 << 30)
        self.epoch = 0
        log_dir = Path(cfg.train.log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = log_dir / "metrics.jsonl"

    # ----------------------------------------------------------- checkpoints

    def checkpoint_path(self, epoch: int) -> Path:
        return self.save_dir / f"net_{epoch:05}.pth"

    def save(self, epoch: int) -> Path:
        """Write ``net_{epoch:05}.pth`` as the reference does (weights and BN
        statistics; the optimizer state is not saved, as in the
        reference)."""
        self.save_dir.mkdir(parents=True, exist_ok=True)
        path = self.checkpoint_path(epoch)
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        tmp = path.with_suffix(".tmp")
        torch.save({"network": sd}, tmp)
        tmp.replace(path)
        return path

    def load_latest(self) -> bool:
        """Load the newest ``net_*.pth`` of ``save_dir``; False if none."""
        found = sorted((int(m.group(1)), p) for p in self.save_dir.glob(
            "net_*.pth") if (m := _CKPT.search(p.name)))
        if not found:
            return False
        epoch, path = found[-1]
        self.model.load_state_dict(load_checkpoint(str(path)))
        self.epoch = epoch + 1
        self._log(f"loaded checkpoint {path}")
        return True

    # -------------------------------------------------------------- training

    def train(self, num_epochs: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        num_epochs = num_epochs or cfg.train.num_epochs
        last = {}
        for epoch in range(self.epoch, num_epochs):
            t0 = time.time()
            m = self._train_epoch(epoch)
            m["epoch_time_s"] = time.time() - t0
            last = m
            self._write_log({"epoch": epoch, **m})
            self._log(f"epoch {epoch}: loss={m['loss']:.1f} "
                      f"seg={m['seg_loss']:.1f} cyc={m['cyc_loss']:.4f} "
                      f"dice={m['dice']:.4f} ({m['epoch_time_s']:.1f}s)")
            self.scheduler.step()  # the cosine steps once per epoch
            self.epoch = epoch + 1
            if (cfg.train.eval_every_epochs > 0
                    and (epoch + 1) % cfg.train.eval_every_epochs == 0):
                self.validation_and_test()
            if (cfg.train.save_every_epochs > 0
                    and (epoch + 1) % cfg.train.save_every_epochs == 0):
                self.save(epoch)
        return last

    def _cycle_clips(self, epoch: int):
        """Endless cycle clips of the epoch (restarted on exhaustion), or
        None when the cycle loss is off or no clip exists."""
        if not (self.cfg.train.use_cycle and len(self.cycle_loader) > 0):
            return None
        gen = self.cycle_loader.clips(epoch)
        first = next(gen, None)
        if first is None:
            return None

        def restarting(g, head):
            yield head
            while True:
                clip = next(g, None)
                if clip is None:
                    g = self.cycle_loader.clips(epoch)
                    clip = next(g, None)
                    if clip is None:
                        return
                yield clip

        return restarting(gen, first)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def train_batch(self, host_batch: dict, cycle_iter) -> dict:
        """One host batch → the device batch the train step takes."""
        cfg = self.cfg
        batch = preprocess_batch(
            self._to_device(host_batch["images_raw"]),
            self._to_device(host_batch["masks_raw"]),
            crop_hw=cfg.data.crop_hw, is_train=True, view_ids=self.view_ids,
            generator=self.generator)
        if cycle_iter is not None:
            batch["clips"] = self._to_device(next(cycle_iter))[..., None]
        return batch

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        cycle_iter = self._cycle_clips(epoch)
        agg, steps = None, 0
        for host_batch in prefetch(
                self.train_loader.batches(self.update_frames, epoch)):
            metrics = self.train_step(self.train_batch(host_batch,
                                                       cycle_iter),
                                      self.generator)
            agg = metrics if agg is None else _sum(agg, metrics)
            steps += 1
        if agg is None:
            return {"loss": 0.0, "seg_loss": 0.0, "cyc_loss": 0.0,
                    "dice": 0.0, "steps": 0}
        agg = _to_host(agg)  # one transfer for the epoch
        counts = {k: float(agg[k].sum()) for k in ("tp", "fp", "fn", "tn")}
        return {
            "loss": float(agg["loss"]) / steps,
            "seg_loss": float(agg["seg_loss"]) / steps,
            "cyc_loss": float(agg["cyc_loss"]) / steps,
            "dice": float(overlap_metrics(counts)["dice"]),
            "steps": steps,
        }

    # ------------------------------------------------------------ evaluation

    def validation_and_test(self) -> Dict[str, dict]:
        """Clip evaluation over the fixed val/test split, plus frame-level
        metrics over the val-split patients."""
        results = {}
        val_ids = [i for i in VAL_CLIPS if i in self.test_infos]
        test_ids = [i for i in TEST_CLIPS if i in self.test_infos]
        extra = sorted(set(self.test_infos) - set(VAL_CLIPS)
                       - set(TEST_CLIPS))
        if extra:
            # clip ids outside the reference split: the same 2/8 shares,
            # in sorted order, so no clip is dropped
            n_val = max(1, len(extra) // 5) if len(extra) > 1 else 0
            val_ids = val_ids + extra[:n_val]
            test_ids = test_ids + extra[n_val:]
        for name, ids in (("Inner-val", val_ids), ("Inner-test", test_ids)):
            if ids:
                results[name] = self.evaluate_clips(ids, name)
        if len(self.valid_loader) > 0:
            results["Val-frames"] = self.evaluate_val_frames()
        return results

    def evaluate_val_frames(self, tag: str = "Val-frames") -> dict:
        """Frame-level eval over the val_list patients (labeled frames,
        center crop)."""
        cfg = self.cfg
        acc, frames, batches = None, 0, 0
        for host_batch in prefetch(
                self.valid_loader.batches(cfg.train.batch_size)):
            batch = preprocess_batch(
                self._to_device(host_batch["images_raw"]),
                self._to_device(host_batch["masks_raw"]),
                crop_hw=cfg.data.crop_hw, is_train=False,
                view_ids=self.view_ids)
            out = self.eval_step(batch)
            out = {"loss": out["loss"], "counts": out["counts"]}
            acc = out if acc is None else _sum(acc, out)
            frames += host_batch["images_raw"].shape[1]
            batches += 1
        if acc is None:
            return {"loss": 0.0, "frames": 0, "views": {}}
        acc = _to_host(acc)
        report = {"loss": float(acc["loss"]) / batches, "frames": frames,
                  "views": {}}
        for vi, view in enumerate(cfg.model.views):
            m = overlap_metrics({k: float(acc["counts"][k][vi])
                                 for k in acc["counts"]})
            report["views"][view] = {k: float(v) for k, v in m.items()}
            self._log(f"------ {tag} view {view} ------ "
                      f"Dice {m['dice']:.4f} PixelAcc {m['pixel_acc']:.4f} "
                      f"({frames} frames)")
        self._write_log({"eval": tag, **{
            f"dice_{v}": report["views"][v]["dice"] for v in report["views"]}})
        return report

    def eval_clips(self, clip_ids):
        """Decoded eval clips (cached across evaluations)."""
        cfg = self.cfg
        for cid in clip_ids:
            if cid not in self.test_infos:
                continue
            clip = self._eval_clip_cache.get(cid)
            if clip is MISS:
                loader = TestClipLoader(self.test_infos, [cid],
                                        cfg.model.views, cfg.data.clip_length)
                clip = next(loader.clips(), None)
                self._eval_clip_cache.put(cid, clip)
            if clip is not None:
                yield clip

    def evaluate_clips(self, clip_ids, tag: str = "eval") -> dict:
        """Frames-as-batch clip evaluation (reference main.py:459-543)."""
        cfg = self.cfg
        v = cfg.model.num_views
        acc, nclips = None, 0
        for clip in prefetch(self.eval_clips(clip_ids)):
            batch = {"images": self._to_device(clip["images"]),
                     "masks": self._to_device(clip["masks"])}
            out = self.eval_step(batch)
            out = {"loss": out["loss"], "counts": out["counts"],
                   "part_counts": out["part_counts"]}
            acc = out if acc is None else _sum(acc, out)
            nclips += 1
        if acc is None:
            loss = 0.0
            totals = {k: np.zeros(v) for k in ("tp", "fp", "fn", "tn")}
            parts = {k: np.zeros((v, cfg.model.num_classes))
                     for k in ("tp", "fp", "fn", "tn")}
        else:
            acc = _to_host(acc)
            loss = float(acc["loss"]) / nclips
            totals, parts = acc["counts"], acc["part_counts"]
        report = {"loss": loss, "clips": nclips, "views": {}}
        for vi, view in enumerate(cfg.model.views):
            m = overlap_metrics({k: float(totals[k][vi]) for k in totals})
            pm = overlap_metrics({k: np.asarray(parts[k][vi]) for k in parts})
            report["views"][view] = {
                **{k: float(val) for k, val in m.items()},
                "part_dice": [float(x) for x in np.asarray(pm["dice"])],
            }
            r = report["views"][view]
            self._log(f"------ {tag} view {view} ------ "
                      f"Dice {r['dice']:.4f} PixelAcc {r['pixel_acc']:.4f} "
                      f"Precision {r['precision']:.4f} "
                      f"Recall {r['recall']:.4f} "
                      f"parts {['%.3f' % p for p in r['part_dice']]}")
        self._write_log({"eval": tag, **{
            f"dice_{v}": report["views"][v]["dice"] for v in report["views"]}})
        return report

    # ----------------------------------------------------------------- utils

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[glfusion_torch] {msg}", flush=True)

    def _write_log(self, record: dict) -> None:
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
