"""Host loaders and the device-side preprocess of the port.

The port of ``glfusion_tpu/data/pipeline.py``. Split of work:

  host   — NIfTI decode, labeled-frame selection (raw label sum > 100),
           nearest resize to the static 144² grid (numpy copies of the JAX
           package's loaders, drawing the same frames from the same seed:
           the train, cycle and test loaders, and the two whole-label
           loaders ``AllMaskFrameLoader`` and ``FullVideoLoader``);
  device — paired random (train) or center (eval) crop to 112², /255, raw
           label → 5-structure one-hot (``preprocess_batch``); the
           regression clips' crop and /255 (``preprocess_regression_batch``,
           for ``RegressionClipLoader``'s batches).

NIfTI files are read by ``data.nifti.read_nifti``: the native C++ decoder
when it is built, the pure-Python reader otherwise. ``SegFrameLoader``
decodes each batch's missing files in one batched native read
(``_prefill``), and its ``warm_async`` thread decodes the epoch's files
ahead of the train loop (``Trainer.train`` starts and stops it, as JAX's
does); warming changes when a file is decoded, never what a batch holds.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Iterator, Sequence

import numpy as np
import torch

from glfusion_tpu_torch.config import ALL_VIEWS, Config
from glfusion_tpu_torch.data.infos import PatientIndex
from glfusion_tpu_torch.data.nifti import read_nifti
from glfusion_tpu_torch.native import read_nifti_batch_native
from glfusion_tpu_torch.ops.crops import center_crop, random_offsets
from glfusion_tpu_torch.ops.masks import mask_to_allclass
from glfusion_tpu_torch.ops.resize import _nearest_indices_np


# ---------------------------------------------------------------- host side

def _resize_nearest_np(x: np.ndarray, out_hw) -> np.ndarray:
    """(H, W[, ...]) nearest resize on host, the torch float32 index rule."""
    hi = _nearest_indices_np(out_hw[0], x.shape[0])
    wi = _nearest_indices_np(out_hw[1], x.shape[1])
    return x[hi][:, wi]


MISS = object()


class ByteLRU:
    """Byte-bounded LRU of numpy entries (None values cost 0 bytes). One
    lock guards it: the prefetch thread, the warm-up thread and the train
    loop fill it at once (decoding runs outside the lock)."""

    def __init__(self, max_bytes: int):
        self._d: collections.OrderedDict = collections.OrderedDict()
        self.max_bytes = max_bytes
        self._used = 0
        self._lock = threading.Lock()

    def keys(self) -> set:
        """A snapshot of the cached keys."""
        with self._lock:
            return set(self._d)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @staticmethod
    def _nbytes(v) -> int:
        if v is None:
            return 0
        if isinstance(v, tuple):
            return sum(a.nbytes for a in v if a is not None)
        if isinstance(v, dict):
            return sum(a.nbytes for a in v.values() if hasattr(a, "nbytes"))
        return v.nbytes

    def get(self, key, default=MISS):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
            return default

    def put(self, key, value) -> None:
        with self._lock:
            if key in self._d:
                self._used -= self._nbytes(self._d.pop(key))
            self._d[key] = value
            self._used += self._nbytes(value)
            while self._used > self.max_bytes and len(self._d) > 1:
                _, old = self._d.popitem(last=False)
                self._used -= self._nbytes(old)


def align_views(vols, clip_length: int, t: int = None):
    """Stack per-view clip arrays to ``(V, T, ...)`` with one common T.

    Present views are trimmed to the common minimum frame count
    (≤ ``clip_length``, or the explicit ``t``); missing views (``None``) are
    zero-filled, as the reference pads missing views with zeros. Returns
    ``(stacked, t)`` or ``(None, 0)`` when every view is missing.
    """
    if all(v is None for v in vols):
        return None, 0
    if t is None:
        t = min(min(clip_length, v.shape[0]) for v in vols if v is not None)
    vols = [None if v is None else v[:t] for v in vols]
    shape = next(v.shape for v in vols if v is not None)
    out = [np.zeros(shape, np.float32) if v is None else v for v in vols]
    return np.stack(out), t


def labeled_frames(lab: np.ndarray) -> np.ndarray:
    """Indices of labeled frames in an (H, W, T) raw label volume: frames
    whose raw label sum exceeds 100 (the reference's input_select)."""
    return np.flatnonzero(lab.reshape(-1, lab.shape[-1]).sum(0) > 100)


class SegFrameLoader:
    """Single-frame multi-view segmentation batches (``Seg_PAHDataset``).

    Yields host batches: images (V, B, R, R) float32 raw intensity, masks
    (V, B, R, R) int32 raw labels, R = ``resize_hw``. Missing views give
    zero frames. Train batches are shuffled per epoch and drop the last
    partial batch; eval batches keep it. Decoded, resized videos stay in a
    byte-bounded LRU, which each batch fills first with one batched native
    read of what it lacks (``_prefill``) and ``warm_async`` fills ahead of
    the epoch.
    """

    def __init__(self, index: PatientIndex, ids: Sequence[str],
                 views: Sequence[str], cfg: Config, is_train: bool,
                 seed: int = 0, cache_bytes: int = 4 << 30):
        self.index = index
        self.ids = [i for i in ids if i in index.records]
        self.views = tuple(views)
        self.cfg = cfg
        self.is_train = is_train
        self.seed = seed
        self._cache = ByteLRU(cache_bytes)
        self._warm_stop = threading.Event()

    def __len__(self) -> int:
        n = len(self.ids)
        return n * self.cfg.data.train_repeat if self.is_train else n

    def _make_entry(self, img: np.ndarray, lab: np.ndarray):
        """(resized images, resized labels, labeled frames) of a decoded
        video: the labeled-frame rule on the raw labels (all frames when
        none is labeled), then the nearest resize to ``resize_hw``."""
        r = self.cfg.data.resize_hw
        img, lab = np.asarray(img).squeeze(), np.asarray(lab).squeeze()
        if img.ndim == 2:
            img, lab = img[..., None], lab[..., None]
        labeled = labeled_frames(lab)
        if len(labeled) == 0:
            labeled = np.arange(lab.shape[-1])
        return (_resize_nearest_np(img, (r, r)),
                _resize_nearest_np(lab, (r, r)), labeled)

    def _prefill(self, keys) -> None:
        """Decode the uncached files of ``keys`` in one batched native read
        (outside the cache's lock). Keys repeat within a batch under
        ``train_repeat``: each is decoded once. Without the decoder, or
        when the batch needs the pure reader, it leaves the files to
        ``_load``."""
        missing, paths = [], []
        cached = self._cache.keys()
        for key in dict.fromkeys(keys):
            if key in cached:
                continue
            img_p, lab_p = self.index.view_paths(*key)
            if img_p is None:
                self._cache.put(key, (None, None, None))
            else:
                missing.append(key)
                paths.extend((img_p, lab_p))
        if not missing:
            return
        try:
            vols = read_nifti_batch_native(paths)
        except (OSError, RuntimeError, ValueError):
            # no decoder, or a file it leaves to the pure reader: _load
            # reads these one by one
            return
        for i, key in enumerate(missing):
            self._cache.put(key, self._make_entry(vols[2 * i],
                                                  vols[2 * i + 1]))

    def _load(self, pid: str, view: str):
        """(resized_images (R,R,T), resized_labels (R,R,T), labeled_idx)."""
        key = (pid, view)
        hit = self._cache.get(key)
        if hit is not MISS:
            return hit
        img_p, lab_p = self.index.view_paths(pid, view)
        if img_p is None:
            entry = (None, None, None)
        else:
            entry = self._make_entry(read_nifti(img_p), read_nifti(lab_p))
        self._cache.put(key, entry)
        return entry

    def epoch_keys(self, epoch: int = 0) -> list:
        """The (pid, view) keys ``batches(..., epoch)`` reads, each once,
        in the order of first use."""
        rs = np.random.RandomState(self.seed + epoch if self.is_train
                                   else self.seed)
        order = np.arange(len(self))
        if self.is_train:
            rs.shuffle(order)
        keys = {}
        for oi in order:
            pid = self.ids[oi % len(self.ids)]
            for view in self.views:
                keys.setdefault((pid, view))
        return list(keys)

    def warm_async(self, epoch: int = 0, chunk: int = 8):
        """Decode the epoch's files into the cache on a daemon thread, in
        the order the epoch reads them, ``chunk`` keys a batched read; the
        train loop's own ``_prefill`` and ``_load`` take what is there.
        It stops at ``stop_warming``, once the cache is 90 % full (further
        entries would evict the earliest-needed ones), or at any error
        (``_load`` covers the misses). Returns the thread, or None when
        the epoch reads nothing."""
        keys = self.epoch_keys(epoch)
        if not keys:
            return None
        self._warm_stop.clear()

        def run():
            for i in range(0, len(keys), chunk):
                if self._warm_stop.is_set():
                    return
                if self._cache.used_bytes >= 0.9 * self._cache.max_bytes:
                    return
                try:
                    self._prefill(keys[i:i + chunk])
                except Exception:
                    return

        t = threading.Thread(target=run, daemon=True,
                             name="glfusion-warm-ingest")
        t.start()
        return t

    def stop_warming(self) -> None:
        self._warm_stop.set()

    def batches(self, batch_size: int, epoch: int = 0) -> Iterator[dict]:
        rs = np.random.RandomState(self.seed + epoch if self.is_train
                                   else self.seed)
        order = np.arange(len(self))
        if self.is_train:
            rs.shuffle(order)
        r = self.cfg.data.resize_hw
        nb = (len(order) // batch_size if self.is_train
              else -(-len(order) // batch_size))
        for b in range(nb):
            take = order[b * batch_size:(b + 1) * batch_size]
            if len(take) == 0:
                return
            imgs = np.zeros((len(self.views), len(take), r, r), np.float32)
            masks = np.zeros((len(self.views), len(take), r, r), np.int32)
            self._prefill([(self.ids[oi % len(self.ids)], view)
                           for oi in take for view in self.views])
            for bi, oi in enumerate(take):
                pid = self.ids[oi % len(self.ids)]
                for vi, view in enumerate(self.views):
                    img, lab, labeled = self._load(pid, view)
                    if img is None:
                        continue
                    fr = int(rs.choice(labeled))
                    imgs[vi, bi] = img[..., fr].astype(np.float32)
                    masks[vi, bi] = lab[..., fr].astype(np.int32)
            yield {"images_raw": imgs, "masks_raw": masks}


class AlignedClipLoader:
    """Fixed-length cycle clips (``Aligned_Video_Seg_PAHDataset``).

    Yields (V, T, H, W) float32 RAW-intensity clips (the reference feeds
    cycle clips without /255). Clips shorter than ``clip_length`` are
    self-concatenated; longer ones take the first ``clip_length`` frames.
    """

    def __init__(self, index: PatientIndex, ids: Sequence[str],
                 views: Sequence[str], cfg: Config, seed: int = 0,
                 cache_bytes: int = 4 << 30):
        self.index = index
        self.ids = [i for i in ids if i in index.records]
        self.views = tuple(views)
        self.cfg = cfg
        self.seed = seed
        self._cache = ByteLRU(cache_bytes)

    def __len__(self) -> int:
        return len(self.ids)

    def _load_clip(self, pid: str, view: str):
        key = (pid, view)
        hit = self._cache.get(key)
        if hit is not MISS:
            return hit
        img_p, _ = self.index.view_paths(pid, view)
        if img_p is None:
            entry = None
        else:
            vol = np.asarray(read_nifti(img_p))
            if vol.ndim == 4:  # (H, W, T, 1)
                vol = vol.squeeze(-1)
            t = self.cfg.data.clip_length
            while vol.shape[-1] < t:
                vol = np.concatenate([vol, vol], axis=-1)
            entry = vol[..., :t].astype(np.float32)
        self._cache.put(key, entry)
        return entry

    def clips(self, epoch: int = 0) -> Iterator[np.ndarray]:
        rs = np.random.RandomState(self.seed + epoch)
        order = rs.permutation(len(self.ids))
        hw = self.cfg.data.crop_hw
        t = self.cfg.data.clip_length
        for oi in order:
            pid = self.ids[oi]
            out = np.zeros((len(self.views), t, hw, hw), np.float32)
            ok = False
            for vi, view in enumerate(self.views):
                vol = self._load_clip(pid, view)
                if vol is None:
                    continue
                if vol.shape[:2] != (hw, hw):
                    vol = _resize_nearest_np(vol, (hw, hw))
                out[vi] = np.moveaxis(vol, -1, 0)  # (T, H, W)
                ok = True
            if ok:
                yield out


class RegressionClipLoader:
    """Multi-view video clips and a scalar target (``PAHDataset``,
    reference loader.py:35-189; JAX ``data/pipeline.py:443-520``).

    Per patient each view is nearest-resized (the float32 index rule) to
    ``resize_hw``² × ``reg_clip_frames``; the target is ``label_type``
    (``mPAP`` or ``Vmax``), and patients whose target is missing or NaN
    are skipped. Yields host batches: ``clips_raw`` (V, B, R, R, T) float32
    raw intensity, missing views zero, and ``targets`` (B,) float32;
    ``preprocess_regression_batch`` crops and scales on the device. Train
    batches are shuffled by ``RandomState(seed + epoch)`` and drop the
    last short batch; eval batches keep it. Resized volumes stay in a
    byte-bounded LRU.
    """

    def __init__(self, index: PatientIndex, ids: Sequence[str],
                 views: Sequence[str], cfg: Config, is_train: bool,
                 label_type: str = "mPAP", seed: int = 0):
        self.index = index
        self.views = tuple(views)
        self.cfg = cfg
        self.is_train = is_train
        self.label_type = label_type
        self.seed = seed
        self.ids = [
            i for i in ids if i in index.records
            and index.records[i].get(label_type) is not None
            and not np.isnan(index.records[i][label_type])
        ]
        self._cache = ByteLRU(4 << 30)

    def __len__(self) -> int:
        return len(self.ids)

    def _load(self, pid: str, view: str, t: int, r: int):
        key = (pid, view)
        hit = self._cache.get(key)
        if hit is not MISS:
            return hit
        img_p, _ = self.index.view_paths(pid, view)
        if img_p is None:
            entry = None
        else:
            vol = np.asarray(read_nifti(img_p), np.float32).squeeze()
            # nearest resize H, W → r and T → t (MONAI Resized semantics)
            hi = _nearest_indices_np(r, vol.shape[0])
            wi = _nearest_indices_np(r, vol.shape[1])
            ti = _nearest_indices_np(t, vol.shape[2])
            entry = vol[hi][:, wi][:, :, ti]
        self._cache.put(key, entry)
        return entry

    def batches(self, batch_size: int, epoch: int = 0) -> Iterator[dict]:
        rs = np.random.RandomState(self.seed + epoch if self.is_train
                                   else self.seed)
        order = np.arange(len(self.ids))
        if self.is_train:
            rs.shuffle(order)
        r = self.cfg.data.resize_hw
        t = self.cfg.data.reg_clip_frames
        nb = (len(order) // batch_size if self.is_train
              else -(-len(order) // batch_size))
        for b in range(nb):
            take = order[b * batch_size:(b + 1) * batch_size]
            clips = np.zeros((len(self.views), len(take), r, r, t),
                             np.float32)
            targets = np.zeros(len(take), np.float32)
            for bi, oi in enumerate(take):
                pid = self.ids[oi]
                targets[bi] = float(self.index.records[pid][self.label_type])
                for vi, view in enumerate(self.views):
                    vol = self._load(pid, view, t, r)
                    if vol is not None:
                        clips[vi, bi] = vol
            yield {"clips_raw": clips, "targets": targets}


class TestClipLoader:
    """Raw evaluation clips (``Test_Seg_PAHDataset``): no transform, /255.

    Yields per-clip dicts with images (V, T, H, W, 1) float32 in [0,1] and
    masks (V, T, H, W, 5) float32, the frames-as-batch eval feed.
    """

    def __init__(self, test_infos: Dict[str, dict], ids: Sequence[str],
                 views: Sequence[str], clip_length: int):
        self.infos = test_infos
        self.ids = list(ids)
        self.views = tuple(views)
        self.clip_length = clip_length

    def __len__(self):
        return len(self.ids)

    def clips(self) -> Iterator[dict]:
        for cid in self.ids:
            rec = self.infos[cid]
            imgs, masks = [], []
            for view in self.views:
                ip = rec["views_images"].get(view)
                lp = rec["views_labels"].get(view)
                if ip is None or lp is None:
                    imgs.append(None)
                    masks.append(None)
                    continue
                img = np.asarray(read_nifti(ip), np.float32) / 255.0
                lab = np.asarray(read_nifti(lp), np.float32)
                # img (1, H, W, T) → (T, H, W, 1); lab (5, H, W, T) → (T, H, W, 5)
                imgs.append(np.transpose(img, (3, 1, 2, 0)))
                masks.append(np.transpose(lab, (3, 1, 2, 0)))
            images, t = align_views(imgs, self.clip_length)
            if images is None:
                continue  # no requested view exists for this clip
            mask_stack, _ = align_views(masks, self.clip_length, t=t)
            yield {"clip_id": cid, "images": images, "masks": mask_stack}


class AllMaskFrameLoader:
    """Every annotated frame is one sample (``Seg_PAHDataset_all_mask``,
    loader.py:1340-1678; JAX ``AllMaskFrameLoader``): enumerates (patient,
    view, frame) triples whose raw label sum exceeds 100, in deterministic
    order."""

    def __init__(self, index: PatientIndex, ids: Sequence[str],
                 views: Sequence[str], cfg: Config):
        self.index = index
        self.views = tuple(views)
        self.cfg = cfg
        self.items: list[tuple] = []
        self._cache: Dict[tuple, tuple] = {}
        for pid in ids:
            if pid not in index.records:
                continue
            for view in self.views:
                img_p, lab_p = index.view_paths(pid, view)
                if img_p is None:
                    continue
                lab = np.asarray(read_nifti(lab_p)).squeeze()
                if lab.ndim == 2:
                    lab = lab[..., None]
                for fr in labeled_frames(lab):
                    self.items.append((pid, view, int(fr)))

    def __len__(self) -> int:
        return len(self.items)

    def frames(self) -> Iterator[dict]:
        r = self.cfg.data.resize_hw
        for pid, view, fr in self.items:
            key = (pid, view)
            if key not in self._cache:
                img_p, lab_p = self.index.view_paths(pid, view)
                img = np.asarray(read_nifti(img_p)).squeeze()
                lab = np.asarray(read_nifti(lab_p)).squeeze()
                if img.ndim == 2:
                    img, lab = img[..., None], lab[..., None]
                self._cache[key] = (img, lab)
            img, lab = self._cache[key]
            yield {
                "patient": pid, "view": view, "frame": fr,
                "image_raw": _resize_nearest_np(
                    img[..., fr].astype(np.float32), (r, r)),
                "mask_raw": _resize_nearest_np(
                    lab[..., fr].astype(np.int32), (r, r)),
            }


class FullVideoLoader:
    """Whole labeled videos per patient/view (``Align_Seg_PAHDataset``,
    loader.py:745-963; JAX ``FullVideoLoader``): the full frame sequence
    with raw per-frame labels, nearest-resized spatially; no cropping
    (eval-style)."""

    def __init__(self, index: PatientIndex, ids: Sequence[str],
                 views: Sequence[str], cfg: Config):
        self.index = index
        self.ids = [i for i in ids if i in index.records]
        self.views = tuple(views)
        self.cfg = cfg

    def __len__(self) -> int:
        return len(self.ids)

    def videos(self) -> Iterator[dict]:
        r = self.cfg.data.resize_hw
        for pid in self.ids:
            out = {"patient": pid, "views": {}}
            for view in self.views:
                img_p, lab_p = self.index.view_paths(pid, view)
                if img_p is None:
                    continue
                img = np.asarray(read_nifti(img_p), np.float32).squeeze()
                lab = np.asarray(read_nifti(lab_p), np.int32).squeeze()
                if img.ndim == 2:
                    img, lab = img[..., None], lab[..., None]
                out["views"][view] = {
                    "images_raw": _resize_nearest_np(img, (r, r)),
                    "masks_raw": _resize_nearest_np(lab, (r, r)),
                }
            if out["views"]:
                yield out


# -------------------------------------------------------------- device side

def preprocess_batch(images_raw: torch.Tensor, masks_raw: torch.Tensor, *,
                     crop_hw: int, is_train: bool, view_ids: Sequence[int],
                     generator: torch.Generator | None = None,
                     offsets: torch.Tensor | None = None) -> dict:
    """Crop + /255 + label remap on the batch's device.

    images_raw / masks_raw: (V, B, R, R). Returns images (V, B, c, c, 1) in
    [0, 1] and masks (V, B, c, c, 5). Train crops one window per (view,
    sample), shared by image and mask, drawn from ``generator`` (or given as
    ``offsets`` (V, B, 2)); eval takes the center crop.
    """
    v, b, r, _ = images_raw.shape
    c = crop_hw
    if is_train:
        if offsets is None:
            offsets = random_offsets(generator, (r, r), (c, c), v * b)
        offsets = offsets.reshape(v * b, 2).to(images_raw.device)
        ar = torch.arange(c, device=images_raw.device)
        rows = (offsets[:, 0:1] + ar)[:, :, None]
        cols = (offsets[:, 1:2] + ar)[:, None, :]
        n = torch.arange(v * b, device=images_raw.device)[:, None, None]
        imgs = images_raw.reshape(v * b, r, r)[n, rows, cols].reshape(
            v, b, c, c)
        msks = masks_raw.reshape(v * b, r, r)[n, rows, cols].reshape(
            v, b, c, c)
    else:
        imgs = center_crop(images_raw[..., None], (c, c))[..., 0]
        msks = center_crop(masks_raw[..., None], (c, c))[..., 0]
    images = (imgs.float() / 255.0)[..., None]
    masks5 = torch.stack([mask_to_allclass(msks[i], vid)
                          for i, vid in enumerate(view_ids)])
    return {"images": images, "masks": masks5}


def preprocess_regression_batch(clips_raw: torch.Tensor, *, crop_hw: int,
                                is_train: bool,
                                generator: torch.Generator | None = None,
                                offsets: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Crop + /255 of regression clips on their device (``PAHDataset``'s
    transform, reference loader.py:155-185): (V, B, R, R, T) → (V, B, c, c,
    T) in [0, 1] (×float32(1/255), as XLA computes JAX's /255). One window
    a sample, shared by its views and frames:
    train draws it from ``generator`` (or takes ``offsets`` (B, 2)); eval
    takes JAX's centre, ((R − c) // 2) on both axes."""
    v, b, r, _, t = clips_raw.shape
    c = crop_hw
    if is_train:
        if offsets is None:
            offsets = random_offsets(generator, (r, r), (c, c), b)
        offsets = offsets.reshape(b, 2).to(clips_raw.device)
        ar = torch.arange(c, device=clips_raw.device)
        rows = (offsets[:, 0:1] + ar)[:, :, None]
        cols = (offsets[:, 1:2] + ar)[:, None, :]
        n = torch.arange(b, device=clips_raw.device)[:, None, None]
        out = clips_raw[:, n, rows, cols]  # (V, B, c, c, T)
    else:
        off = (r - c) // 2
        out = clips_raw[:, :, off:off + c, off:off + c]
    # XLA computes JAX's ``/ 255.0`` as a product with float32(1/255):
    # the same product keeps the batches equal to JAX's bit for bit
    return out * (1.0 / 255.0)


def view_ids_tuple(views: Sequence[str]) -> tuple[int, ...]:
    return tuple(ALL_VIEWS.index(v) for v in views)
