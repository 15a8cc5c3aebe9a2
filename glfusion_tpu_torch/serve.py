"""Pipelined online clip inference (the serving path) on the card.

The port of ``glfusion_tpu/serve.py::ClipPipeline``. Three stages overlap:

  decode  (NIfTI decode and normalization in a host thread pool)
    ‖ forward (enqueued on the current CUDA stream; up to ``depth`` clips
      are in flight on the card while the host decodes the next ones)
    ‖ fetch (the thresholded uint8 masks, 4× smaller than float32 logits,
      are copied into pinned host memory without blocking; a CUDA event
      marks the copy's end and the clip is yielded once it has completed)

A clip longer than ``clip_length`` is trimmed to it (the protocol's cap,
as in JAX). A shorter one runs at its true frame count: JAX pads every
clip to ``clip_length`` so that its jitted forward compiles once, which
eager PyTorch does not need, and in eval every frame is computed alone (BN
on running statistics, TPAVI within a frame), so padding frames change no
mask. An exported program has a symbolic frame axis and runs the true
length too.

``forward`` replaces the model with a serving forward that takes the
(V, T, H, W, 1) images and returns uint8 masks: an exported program
(``utils/model_export.load_serving_forward``). ``serve_test_clips`` is
``--mode serve``: ``Trainer.infer``'s outputs through the pipeline.
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch

from glfusion_tpu_torch.config import Config
from glfusion_tpu_torch.data.nifti import read_nifti, write_nifti
from glfusion_tpu_torch.data.pipeline import align_views


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller names a device. Never a silent fallback:
    without CUDA, only an explicit ``device='cpu'`` runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type == "cuda" and dev.index is None:  # this process's card
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ClipPipeline:
    """Overlapped decode → forward → fetch over a stream of clips.

    Parameters
    ----------
    cfg: the run's :class:`Config`; ``cfg.model.views`` and
        ``cfg.data.clip_length`` shape the input.
    model: a model of ``cfg.model`` with its weights; it is moved to
        ``device`` and put in eval mode. None when ``forward`` is given.
    depth: clips kept in flight on the card.
    threads: host decode workers.
    device: ``None`` → CUDA (raises without it); ``"cpu"`` for tests.
    forward: a serving forward (images → uint8 masks) in place of the
        model, e.g. a loaded export.
    expected_hw: the spatial size an export is pinned to; other clips are
        refused with a clear error.
    """

    def __init__(self, cfg: Config, model: torch.nn.Module | None = None,
                 depth: int = 2, threads: int = 2, device=None,
                 forward: Callable[[torch.Tensor], torch.Tensor] | None = None,
                 expected_hw: int | None = None):
        if (model is None) == (forward is None):
            raise ValueError("ClipPipeline takes a model or a forward")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = None if model is None else model.to(self.device).eval()
        self._forward = forward
        self.depth = max(1, depth)
        self.threads = max(1, threads)
        self._expected_hw = expected_hw

    # ------------------------------------------------------------- helpers

    def _trim_clip(self, images: np.ndarray) -> Tuple[np.ndarray, int]:
        """Trim (V, T, H, W, 1) to ``clip_length`` frames; returns the clip
        and its frame count."""
        if self._expected_hw is not None and (
                images.shape[2:4] != (self._expected_hw, self._expected_hw)):
            raise ValueError(
                f"clip spatial size {images.shape[2:4]} does not match the "
                f"AOT export's pinned {self._expected_hw}²: serve clips at "
                f"the exported size, re-export with --export-hw, or serve "
                f"the live checkpoint (no --from-export)")
        images = images[:, :self.cfg.data.clip_length]
        return images, images.shape[1]

    def _masks(self, x: torch.Tensor) -> torch.Tensor:
        """(V, T, H, W, 1) images on the device → (V, T, H, W, C) uint8
        masks, logit > 0 (sigmoid > 0.5)."""
        with torch.inference_mode():
            if self._forward is not None:
                return self._forward(x)
            return (self.model(x)["mask"] > 0).to(torch.uint8).contiguous()

    def _enqueue(self, images: np.ndarray):
        """Start one clip's forward; returns (host masks, event).

        On the card the upload, the forward and the copy of the uint8
        masks into pinned memory are all enqueued on the current stream;
        the event marks the copy's end. On the CPU the masks are ready.
        """
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        cuda = self.device.type == "cuda"
        if cuda:
            x = x.pin_memory().to(self.device, non_blocking=True)
        masks = self._masks(x)
        if not cuda:
            return masks, None
        with torch.inference_mode():
            host = torch.empty(masks.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(masks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    @staticmethod
    def _fetch(host: torch.Tensor, event, t_true: int) -> np.ndarray:
        if event is not None:
            event.synchronize()
        return host[:, :t_true].numpy().copy()  # release the pinned buffer

    # -------------------------------------------------------------- stream

    def predict_iter(
        self,
        items: Iterable[Any],
        decode: Callable[[Any], Tuple[str, np.ndarray]],
    ) -> Iterator[Tuple[str, np.ndarray]]:
        """Yield ``(clip_id, masks)`` for each item, pipelined.

        ``decode(item) -> (clip_id, images)`` runs in the host thread pool
        (images (V, T, H, W, 1) float32 in [0,1], or None to skip the clip);
        yielded masks are (V, T_true, H, W, classes) uint8, in input order.
        """
        items_it = iter(items)
        with ThreadPoolExecutor(max_workers=self.threads) as ex:
            decoded = collections.deque()   # decode futures, input order
            inflight = collections.deque()  # (clip_id, t_true, host, event)

            def submit() -> bool:
                try:
                    item = next(items_it)
                except StopIteration:
                    return False
                decoded.append(ex.submit(decode, item))
                return True

            for _ in range(self.threads + 1):
                if not submit():
                    break

            while decoded or inflight:
                # drain a finished prediction once the window is full (or
                # nothing is left to feed)
                if inflight and (len(inflight) >= self.depth or not decoded):
                    cid, t_true, host, event = inflight.popleft()
                    yield cid, self._fetch(host, event, t_true)
                    continue
                cid, images = decoded.popleft().result()
                submit()
                if images is None:
                    continue  # no requested view present: skip the clip
                images, t_true = self._trim_clip(np.asarray(images))
                inflight.append((cid, t_true, *self._enqueue(images)))

    # --------------------------------------------------------- conveniences

    def decode_paths(self, item: Tuple[str, Dict[str, str]]):
        """Decode one ``(clip_id, {view: image_path})`` to (cid, images):
        each view read with the NIfTI reader, /255-normalized and stacked at
        its native spatial size (see :meth:`stack_raw_views`)."""
        cid, paths = item
        return cid, self.stack_raw_views(
            {v: read_nifti(p) for v, p in paths.items() if p is not None})

    def stack_raw_views(self, vols_by_view: Dict[str, np.ndarray]):
        """Raw per-view volumes → the (V, T, H, W, 1) forward input.

        Each volume is a raw uint8-range array, (1, H, W, T) or (H, W, T);
        it is /255-normalized and re-laid-out, then views are aligned to one
        common frame count (≤ clip_length) with zeros for missing views.
        Returns ``None`` when no requested view is present.
        """
        vols = []
        for view in self.cfg.model.views:
            raw = vols_by_view.get(view)
            if raw is None:
                vols.append(None)
                continue
            vol = np.asarray(raw, np.float32) / 255.0
            # an unconditional squeeze() would also collapse T on
            # single-frame clips
            if vol.ndim == 4 and vol.shape[0] == 1:
                vol = vol[0]
            if vol.ndim == 2:
                vol = vol[..., None]  # single frame: (H, W) → (H, W, 1)
            if vol.ndim != 3:
                raise ValueError(
                    f"view {view}: expected (H, W, T) or (1, H, W, T) "
                    f"volume, got shape {np.asarray(raw).shape}")
            vols.append(np.moveaxis(vol, -1, 0)[..., None])  # (T, H, W, 1)
        images, _ = align_views(vols, self.cfg.data.clip_length)
        return images

    def predict_one(self, images: np.ndarray) -> np.ndarray:
        """Serial single-clip prediction (no pipelining): uint8 masks."""
        images, t_true = self._trim_clip(np.asarray(images))
        return self._fetch(*self._enqueue(images), t_true)

    def predict_paths(
        self,
        clips: Sequence[Tuple[str, Dict[str, str]]],
    ) -> Iterator[Tuple[str, np.ndarray]]:
        """Serve from NIfTI paths: ``(clip_id, {view: image_path})``."""
        return self.predict_iter(clips, self.decode_paths)


def export_pipeline_kwargs(from_export: str, cfg: Config,
                           device=None) -> Dict[str, Any]:
    """Load a saved export and check it against this run's configuration
    (JAX ``serve.py::export_pipeline_kwargs``): the views and the class
    count must match. Returns :class:`ClipPipeline` keyword arguments:
    ``forward`` and ``expected_hw``."""
    from glfusion_tpu_torch.utils import model_export

    meta = model_export.read_meta(from_export)  # checked before the load
    if meta.get("views") and list(meta["views"]) != list(cfg.model.views):
        raise ValueError(
            f"export {from_export} was built for views {meta['views']} "
            f"but this run is configured for {list(cfg.model.views)}")
    if meta.get("num_classes") not in (None, cfg.model.num_classes):
        raise ValueError(
            f"export {from_export} predicts {meta['num_classes']} "
            f"classes but this run is configured for "
            f"{cfg.model.num_classes}")
    forward, _ = model_export.load_serving_forward(from_export, device)
    return {"forward": forward,
            "expected_hw": meta.get("input_hw") or meta.get("crop_hw")}


def serve_test_clips(trainer, out_dir: str = "./predictions",
                     depth: int = 2, threads: int = 2,
                     from_export: str | None = None) -> dict:
    """``--mode serve``: ``Trainer.infer`` through the pipeline, with timing.

    The same files as ``Trainer.infer`` (``pred_<clip>_v<view>.nii.gz``,
    (5, H, W, T) uint8), with decode, forward and fetch overlapped; returns
    ``{"written", "clips", "clips_per_s", "wall_s"}``. ``from_export``
    serves a saved export (``--mode export``) instead of the live weights.
    """
    from pathlib import Path

    from glfusion_tpu_torch.utils.cluster import get_world_size

    if get_world_size() > 1:
        # The pipeline stages clips onto this process's card and writes
        # each mask whole: a per-process path that cannot see another
        # process's shards. Serving scales by replica, not by sharding one
        # stream across processes.
        raise ValueError(
            "--mode serve is a single-controller path; in a multi-process "
            "run serve one replica per host, or use --mode infer (which "
            "assembles process-spanning shards)")
    cfg = trainer.cfg
    if from_export is None:
        pipe = ClipPipeline(cfg, trainer.model, depth=depth, threads=threads,
                            device=trainer.device)
    else:
        pipe = ClipPipeline(cfg, depth=depth, threads=threads,
                            device=trainer.device,
                            **export_pipeline_kwargs(from_export, cfg,
                                                     trainer.device))
    clips = [(cid, dict(trainer.test_infos[cid]["views_images"]))
             for cid in sorted(trainer.test_infos)]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = served = 0  # a clip with no requested view is skipped
    t0 = time.perf_counter()
    for cid, pred in pipe.predict_paths(clips):
        served += 1
        for vi, view in enumerate(cfg.model.views):
            # (T, H, W, 5) → (5, H, W, T)
            write_nifti(out / f"pred_{cid}_v{view}.nii.gz",
                        np.transpose(pred[vi], (3, 1, 2, 0)))
            written += 1
    wall = time.perf_counter() - t0
    return {"written": written, "clips": served,
            "clips_per_s": round(served / wall, 3) if wall else None,
            "wall_s": round(wall, 3)}
