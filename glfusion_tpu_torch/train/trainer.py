"""Trainer: the reference's train and validation loops on the card.

The port of ``glfusion_tpu/train/trainer.py``: ``train``, ``_train_epoch``,
``validation_and_test``, ``evaluate_val_frames``, ``evaluate_clips``, the
lifecycle (``request_stop``, ``load_latest``, ``load_torch_checkpoint``,
``load_imagenet_backbone``, ``sweep_checkpoints``) and the output modes
(``test_visualize``, ``infer``). Host batches come from the numpy loaders
through a prefetch thread; the crop, /255 and label remap run on the card
(``data/pipeline.preprocess_batch``); metrics accumulate on the card and are
fetched once per epoch or evaluation.

Checkpoints (``utils/checkpoint.py``) hold the whole training state: the
reference's ``net_{epoch:05}.pth`` (``{'network': state_dict}``, which the
JAX CLI reads through ``--torch-ckpt``) and a sidecar with Adam's state and
the schedule's epoch. They are written in the background; ``train()``
flushes them before it returns, also when it raises.

Randomness is a pure function of (seed, epoch, step), as in JAX
(``trainer.py:136-148``, ``:327-329``): each step seeds its own generator
(the crops and the sampled cycle starts) and the global RNG (ASPP dropout),
inside ``torch.random.fork_rng``, from ``step_seed``. Nothing random carries
from one step to the next, so a run resumed from an epoch's checkpoint takes
the uninterrupted run's draws. The draws are not JAX's: the two packages use
different generators; the property is what is ported.
"""

from __future__ import annotations

import contextlib
import json
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
from glfusion_tpu_torch.models import GlobalAndLocalCPS, build_model
from glfusion_tpu_torch.models.glfusion import HEADS_IN_CYCLE
from glfusion_tpu_torch.serve import resolve_device
from glfusion_tpu_torch.train.metrics import overlap_metrics
from glfusion_tpu_torch.train.step import make_eval_step, make_train_step
from glfusion_tpu_torch.train.train_state import (load_payload,
                                                  make_optimizer,
                                                  make_scheduler,
                                                  state_payload)
from glfusion_tpu_torch.utils.checkpoint import CheckpointManager
from glfusion_tpu_torch.utils.convert import MIXES, load_checkpoint
from glfusion_tpu_torch.utils.summary import SummaryWriter

# the reference's fixed eval split of the 10 test clips (main.py:423-424)
VAL_CLIPS = ["0_0", "0_2"]
TEST_CLIPS = ["0_1", "0_3", "0_4", "0_5", "0_6", "0_7", "0_8", "0_9"]


def step_seed(seed: int, epoch: int, step: int) -> int:
    """The seed of one train step: a fixed function of (seed + 1, epoch,
    step) (``numpy.random.SeedSequence``), below 2⁶³."""
    words = np.random.SeedSequence([seed + 1, epoch, step]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


@contextlib.contextmanager
def step_randomness(seed: int, epoch: int, step: int, device: torch.device):
    """One train step's randomness: yields the generator of its crops (and
    the cycle starts), with the global RNG (dropout) seeded too, both from
    ``step_seed``; the global RNG's state is put back after."""
    s = step_seed(seed, epoch, step)
    cuda = device.type == "cuda"
    with torch.random.fork_rng(devices=[device.index or 0] if cuda else [],
                               device_type="cuda"):
        torch.manual_seed(s)
        yield torch.Generator(device=device).manual_seed(s)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch array on ``device``: on CUDA through pinned memory,
    without blocking the host."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _sum(a, b):
    if isinstance(a, dict):
        return {k: _sum(a[k], b[k]) for k in a}
    return a + b


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


class Trainer:
    """Train and evaluate the flagship, one of its variants, the CPS twin or
    a model of the zoo (``cfg.model.arch``).

    Parameters
    ----------
    cfg: the run's :class:`Config`.
    data_paths: the dataset's ``infos``, ``unlab_infos``, ``test_infos`` and
        ``data_list_dir``; None writes the synthetic corpus (seeded by
        ``cfg.train.seed``) into a temporary directory.
    device: None → CUDA (raises without it); ``"cpu"`` runs on the CPU.
    model: an already built model of ``cfg.model`` to train (for instance
        the flagship with fused stems swapped in); None builds it
        (``models.build_model``, the registry).
    """

    def __init__(self, cfg: Config, data_paths: Optional[Dict[str, str]] = None,
                 verbose: bool = True, device=None,
                 model: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        self.verbose = verbose
        self.device = resolve_device(device)
        torch.manual_seed(cfg.train.seed)  # the initial weights

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

        if model is None:
            model, self.cps = build_model(cfg.model, hw=cfg.data.crop_hw)
        else:
            self.cps = isinstance(model, GlobalAndLocalCPS)
        self.model = model.to(self.device)
        self._check_options()
        # one update takes batch_size·grad_accum frames a view
        self.update_frames = cfg.train.batch_size * cfg.train.grad_accum
        self.steps_per_epoch = max(
            len(self.train_loader) // self.update_frames, 1)
        self.optimizer = make_optimizer(cfg, self.model.parameters())
        self.scheduler = make_scheduler(cfg, self.optimizer)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          cps=self.cps)
        self.eval_step = make_eval_step(cfg, self.model)
        self.ckpt = CheckpointManager(cfg.train.save_dir,
                                      max_to_keep=cfg.train.ckpt_keep)
        self._eval_clip_cache = ByteLRU(1 << 30)
        self.epoch = 0
        self._stop_requested = False
        log_dir = Path(cfg.train.log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self._metrics_path = log_dir / "metrics.jsonl"
        self.summary = SummaryWriter(str(log_dir))

    def _check_options(self) -> None:
        """JAX's exclusions (``trainer.py:84-104``): of a zoo arch, of the
        CPS twin, and of ``fg_bg`` and ``local_only``, whose cycle slot
        needs the heads."""
        tc = self.cfg.train
        zoo = self.cfg.model.arch != "glfusion"
        heads = self.cfg.model.variant in HEADS_IN_CYCLE
        if tc.cycle_light and (zoo or self.cps or heads):
            raise ValueError(
                "cycle_light requires the plain glfusion arch (non-CPS; "
                "not fg_bg/local_only, whose cycle features need the "
                "classifier heads): the fast cycle forward computes "
                "f4_global directly")
        if tc.temporal and (zoo or self.cps):
            raise ValueError(
                "temporal (video attention on cycle clips) requires the "
                "plain glfusion arch: only GlobalAndLocal folds frames "
                "into the attention token axis (is_video)")
        if tc.fuse_passes and (zoo or self.cps or heads):
            raise ValueError(
                "fuse_passes requires the plain glfusion arch (non-CPS; "
                "not fg_bg/local_only): the merged pass slices the head "
                "tail onto the supervised frames only")

    # ------------------------------------------------------------- lifecycle

    def request_stop(self) -> None:
        """Stop at the next epoch boundary: ``train()`` finishes the epoch in
        flight, checkpoints it (off the ``save_every`` cadence too), flushes
        and returns, and ``--resume`` continues from there. Only sets a flag,
        so a signal handler may call it (the CLI's SIGTERM hook)."""
        self._stop_requested = True

    def checkpoint_path(self, epoch: int) -> Path:
        """The reference's ``net_{epoch:05}.pth`` of one saved epoch."""
        return self.ckpt.paths(epoch)[0]

    def save(self, epoch: int) -> None:
        """Checkpoint the whole training state as ``epoch``, in the
        background (``self.ckpt.wait()`` flushes)."""
        self.ckpt.save(state_payload(self.model, self.optimizer,
                                     self.scheduler), epoch)

    def load_latest(self) -> bool:
        """Restore the newest complete checkpoint: weights, BN statistics,
        Adam's moments and step counts, the schedule's epoch; training goes
        on at the epoch after it. False if there is none."""
        restored = self.ckpt.restore_latest()
        if restored is None:
            return False
        payload, self.epoch = restored
        load_payload(payload, self.model, self.optimizer, self.scheduler)
        self._log(f"restored checkpoint at epoch {self.epoch}")
        return True

    def load_torch_checkpoint(self, path: str) -> None:
        """Load a reference ``net_XXXXX.pth`` (``{'network': state_dict}``,
        reference ``main.py:454-457``) into the weights and BN statistics.
        The optimizer is untouched, as in JAX: the reference never saved
        it.

        As in JAX (``utils/torch_convert.py``), entries the model does not
        have are ignored, and a tree the file does not cover is an error:
        a ``KeyError`` naming what is missing, raised before anything is
        loaded. The variants' 1×1 convs (``merge``, ``early_mix``,
        ``late_mix``) are never read from such a file: JAX's converter does
        not map them (its first forward then fails on the missing conv, or
        its converter on the centerness head those variants lack), and the
        reference's names for them are not known."""
        if self.cfg.model.arch != "glfusion" or self.cps:
            raise ValueError("--torch-ckpt requires the plain glfusion arch "
                             "(the converter maps Global_and_Local's "
                             "state-dict names)")
        unmapped = [n for n in MIXES if hasattr(self.model, n)]
        if unmapped:
            raise KeyError(
                f"--torch-ckpt: variant {self.cfg.model.variant!r} has "
                f"1×1 convs ({', '.join(unmapped)}) that the reference "
                "checkpoint converter does not map")
        sd = load_checkpoint(path)
        want = self.model.state_dict()
        missing = [k for k in want if k not in sd]
        if missing:
            raise KeyError(f"{path} has no {missing[0]!r} ({len(missing)} "
                           "of the model's entries missing)")
        self.model.load_state_dict({k: sd[k] for k in want})
        self._log(f"loaded torch checkpoint {path}")

    def load_imagenet_backbone(self, path: str) -> None:
        """Start every view's backbone from a local torchvision ImageNet
        ResNet-50, as the reference does (``utils/imagenet_init.py``): the
        1-channel stem conv, the heads and the attentions keep their
        initialization."""
        if self.cfg.model.arch != "glfusion" or self.cps:
            raise ValueError("--imagenet-backbone requires the plain "
                             "glfusion arch (the mapping targets the "
                             "flagship's stacked-view backbone tree)")
        from glfusion_tpu_torch.utils.imagenet_init import (
            load_imagenet_backbone, merge_backbone)

        conv = load_imagenet_backbone(path, self.cfg.model)
        self.model.load_state_dict(merge_backbone(self.model.state_dict(),
                                                  conv))
        self._log(f"initialized backbone from ImageNet weights {path}")

    # -------------------------------------------------------------- training

    def train(self, num_epochs: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        num_epochs = num_epochs or cfg.train.num_epochs
        last = {}
        # decode the epoch's files on a background thread while the first
        # steps run (JAX's first-step compile; here the first kernels)
        self.train_loader.warm_async(self.epoch)
        try:
            for epoch in range(self.epoch, num_epochs):
                t0 = time.time()
                m = self._train_epoch(epoch)
                m["epoch_time_s"] = time.time() - t0
                last = m
                self.scheduler.step()  # the cosine steps once per epoch
                self._write_log({"epoch": epoch, **m})
                self._log(f"epoch {epoch}: loss={m['loss']:.1f} "
                          f"seg={m['seg_loss']:.1f} cyc={m['cyc_loss']:.4f} "
                          f"dice={m['dice']:.4f} ({m['epoch_time_s']:.1f}s)")
                if cfg.train.log_histograms:
                    self._log_param_histograms(epoch)
                if (cfg.train.eval_every_epochs > 0
                        and (epoch + 1) % cfg.train.eval_every_epochs == 0):
                    self.validation_and_test()
                saved = (cfg.train.save_every_epochs > 0
                         and (epoch + 1) % cfg.train.save_every_epochs == 0)
                if saved or self._stop_requested:
                    self.save(epoch)  # asynchronous; flushed below
                self.epoch = epoch + 1
                if self._stop_requested:
                    self._log(f"stop requested: checkpointed epoch {epoch}, "
                              "exiting")
                    break
        finally:
            self.train_loader.stop_warming()
            # the last checkpoint is in place when train() ends, also when
            # an exception (out of memory, Ctrl-C) leaves the loop
            self.ckpt.wait()
            self.summary.flush()
        return last

    def step_randomness(self, epoch: int, step: int):
        """One train step's randomness (:func:`step_randomness`)."""
        return step_randomness(self.cfg.train.seed, epoch, step, self.device)

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
        return to_device(a, self.device)

    def train_batch(self, host_batch: dict, cycle_iter,
                    generator: torch.Generator) -> dict:
        """One host batch → the device batch the train step takes; the
        crops are drawn from ``generator``."""
        cfg = self.cfg
        batch = preprocess_batch(
            self._to_device(host_batch["images_raw"]),
            self._to_device(host_batch["masks_raw"]),
            crop_hw=cfg.data.crop_hw, is_train=True, view_ids=self.view_ids,
            generator=generator)
        if cycle_iter is not None:
            batch["clips"] = self._to_device(next(cycle_iter))[..., None]
        return batch

    def _train_epoch(self, epoch: int) -> Dict[str, float]:
        cycle_iter = self._cycle_clips(epoch)
        agg, steps = None, 0
        for host_batch in prefetch(
                self.train_loader.batches(self.update_frames, epoch)):
            with self.step_randomness(epoch, steps) as gen:
                metrics = self.train_step(
                    self.train_batch(host_batch, cycle_iter, gen), gen)
            agg = metrics if agg is None else _sum(agg, metrics)
            steps += 1
        # --checkify reads each step's verdict one step late; the last one
        # is read here, so a non-finite step raises before the epoch ends
        flush = getattr(self.train_step, "checkify_flush", None)
        if flush is not None:
            flush()
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

    def sweep_checkpoints(self, min_epoch: int = 50) -> dict:
        """Validate every saved epoch; the best Inner-val mean Dice wins.

        The reference's sweep (``main.py:316-323``, ``:414-416``) picks the
        best epoch ≥ ``min_epoch``; when no saved epoch reaches it (a short
        run), every epoch counts. The trainer's own weights and epoch are put
        back afterwards.
        """
        steps = self.ckpt.all_steps()
        if not steps:
            self._log("no checkpoints to sweep")
            return {}
        best = {"epoch": None, "val_dice": -1.0, "test": None}
        apply_min = any(s >= min_epoch for s in steps)
        original = {k: v.clone() for k, v in self.model.state_dict().items()}
        original_epoch = self.epoch
        try:
            for step in steps:
                payload = self.ckpt.restore_step(step, train_state=False)
                if payload is None:
                    continue
                self.model.load_state_dict(payload["network"])
                self.epoch = step
                res = self.validation_and_test()
                val = res.get("Inner-val", {}).get("views", {})
                val_dice = (float(np.mean([v["dice"] for v in val.values()]))
                            if val else 0.0)
                self._log(f"sweep epoch {step}: val dice {val_dice:.4f}")
                if (step >= min_epoch or not apply_min) \
                        and val_dice > best["val_dice"]:
                    best = {"epoch": step, "val_dice": val_dice,
                            "test": res.get("Inner-test")}
        finally:
            self.model.load_state_dict(original)
            self.epoch = original_epoch
        if best["epoch"] is not None:
            self._log(f"best val epoch {best['epoch']} "
                      f"(dice {best['val_dice']:.4f})")
        return best

    # ---------------------------------------------------------------- output

    def _test_clip_logits(self):
        """(clip id, (V, T, H, W, 5) logits on the device) of every test clip
        in id order."""
        cfg = self.cfg
        loader = TestClipLoader(self.test_infos, sorted(self.test_infos),
                                cfg.model.views, cfg.data.clip_length)
        for clip in prefetch(loader.clips()):
            batch = {"images": self._to_device(clip["images"]),
                     "masks": self._to_device(clip["masks"])}
            yield clip["clip_id"], self.eval_step(batch)["logits"]

    def test_visualize(self, method_name: str = "glfusion_tpu_torch",
                       out_dir: str = "./visualze_for_ppt") -> int:
        """Write colorized prediction PNGs of every test clip
        (reference ``main.py:546-648``):
        ``<out>/<method>/192_data/<patient>/<view>/pred_<t>.png``. Returns
        the number of PNGs written."""
        from glfusion_tpu_torch.utils.visualize import save_clip_visualization

        written = 0
        for cid, logits in self._test_clip_logits():
            for vi, view in enumerate(self.cfg.model.views):
                written += save_clip_visualization(out_dir, method_name, cid,
                                                   view, logits[vi])
            self._log(f"patient {cid} pred finished")
        return written

    def infer(self, out_dir: str = "./predictions") -> int:
        """Predict every test clip and write its masks as NIfTI:
        ``pred_<clip>_v<view>.nii.gz``, (5, H, W, T) uint8 (the
        ``Test_Seg_PAHDataset`` label layout), logit > 0 as the threshold.
        Returns the number of files written."""
        from glfusion_tpu_torch.data.nifti import write_nifti

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        written = 0
        for cid, logits in self._test_clip_logits():
            pred = (logits > 0.0).to(torch.uint8).cpu().numpy()
            for vi, view in enumerate(self.cfg.model.views):
                # (T, H, W, 5) → (5, H, W, T)
                write_nifti(out / f"pred_{cid}_v{view}.nii.gz",
                            np.transpose(pred[vi], (3, 1, 2, 0)))
                written += 1
            self._log(f"clip {cid} predicted")
        return written

    # ----------------------------------------------------------------- utils

    def _log_param_histograms(self, epoch: int) -> None:
        """One TensorBoard histogram a parameter (``--log-histograms``, the
        reference's optional pass, ``main.py:252-255``)."""
        if not self.summary.active:
            return
        for name, p in self.model.named_parameters():
            self.summary.add_histogram(f"params/{name}",
                                       p.detach().float().cpu().numpy(),
                                       epoch)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[glfusion_torch] {msg}", flush=True)

    def _write_log(self, record: dict) -> None:
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        # numeric fields mirrored to TensorBoard (reference main.py:874-883)
        for k, v in record.items():
            if isinstance(v, (int, float)) and k != "epoch":
                self.summary.add_scalar(k, v, self.epoch)
