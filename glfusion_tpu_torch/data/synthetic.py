"""Synthetic echo-like dataset in the exact reference on-disk contract.

Generates, per patient and view, raw .nii.gz videos (image uint8 (H,W,T),
integer label (H,W,T) with the view's native label values), pre-aligned
112²-style cycle clips (image (H,W,T,1), 5-ch mask (5,H,W,T,1) — the
``Aligned_Video_Seg_PAHDataset`` contract, reference
``datasets/loader.py:996-1009``), and test clips (image (1,H,W,T), mask
(5,H,W,T) — the ``Test_Seg_PAHDataset`` contract, ``:1100-1112``), plus
``infos/*.npy`` index dicts and ``data_list/*.npy`` splits.

A copy of ``glfusion_tpu/data/synthetic.py``: the same arrays and files
from the same seed (the port imports nothing of ``glfusion_tpu``).

Content is a beating heart cartoon: per structure an ellipse whose radius
pulses over time; the image shows bright structure boundaries over speckle
noise. Enough signal that a few training steps measurably reduce loss.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from glfusion_tpu_torch.config import ALL_VIEWS, DataConfig
from glfusion_tpu_torch.data.nifti import write_nifti
from glfusion_tpu_torch.ops.masks import view_label_table

# native label values per view (reference datasets/loader.py:296-316)
_VIEW_LABELS = {"1": (1, 2), "2": (1,), "3": (1, 2), "4": (1, 2, 3, 4)}


def _heart_frame(hw: int, t: int, num_t: int, labels: Sequence[int],
                 rs: np.random.RandomState, jitter: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One (image, label) frame: pulsating ellipses per structure."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    pulse = 1.0 + 0.25 * np.sin(2 * np.pi * t / max(num_t // 4, 2))
    label = np.zeros((hw, hw), np.uint8)
    img = rs.randint(0, 35, (hw, hw)).astype(np.float32)
    for i, lv in enumerate(labels):
        cy = hw * (0.3 + 0.35 * (i % 2)) + jitter[i, 0]
        cx = hw * (0.3 + 0.35 * (i // 2)) + jitter[i, 1]
        ry = hw * 0.12 * pulse
        rx = hw * 0.10 * pulse
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        inside = d <= 1.0
        boundary = (d <= 1.15) & (d >= 0.85)
        label[inside] = lv
        img[boundary] += 160.0
        img[inside] += 40.0
    return np.clip(img, 0, 255).astype(np.uint8), label


def _make_video(hw: int, num_t: int, labels: Sequence[int],
                rs: np.random.RandomState) -> tuple[np.ndarray, np.ndarray]:
    jitter = rs.uniform(-hw * 0.05, hw * 0.05, (len(labels), 2))
    imgs, labs = [], []
    for t in range(num_t):
        im, lb = _heart_frame(hw, t, num_t, labels, rs, jitter)
        imgs.append(im)
        labs.append(lb)
    return np.stack(imgs, -1), np.stack(labs, -1)  # (H, W, T)


def generate_synthetic_dataset(root: str | Path, cfg: DataConfig,
                               views: Sequence[str] = ("1", "3", "4"),
                               seed: int = 0) -> dict:
    """Write the full synthetic dataset tree under ``root``; returns paths."""
    root = Path(root)
    (root / "nii").mkdir(parents=True, exist_ok=True)
    (root / "infos").mkdir(exist_ok=True)
    (root / "data_list").mkdir(exist_ok=True)
    rs = np.random.RandomState(seed)
    table = view_label_table()

    n = cfg.synthetic_num_patients
    hw = cfg.synthetic_raw_hw
    num_t = cfg.synthetic_num_frames
    chw = cfg.crop_hw
    clip_t = max(cfg.clip_length, 4)

    infos = {}
    unlab_infos = {}
    ids = [f"p{idx:03d}" for idx in range(n)]
    for pid in ids:
        views_images, views_labels = {}, {}
        al_images, al_labels = {}, {}
        for view in views:
            img, lab = _make_video(hw, num_t, _VIEW_LABELS[view], rs)
            ip = root / "nii" / f"{pid}_v{view}_img.nii.gz"
            lp = root / "nii" / f"{pid}_v{view}_lab.nii.gz"
            write_nifti(ip, img)
            write_nifti(lp, lab)
            views_images[view] = str(ip)
            views_labels[view] = str(lp)

            # aligned cycle clip: crop-size video + 5ch mask, trailing dim 1
            cimg, clab = _make_video(chw, clip_t, _VIEW_LABELS[view], rs)
            vi = ALL_VIEWS.index(view)
            chan = table[vi][np.clip(clab.astype(np.int64), 0, 4)]
            cmask = np.stack([(chan == c) for c in range(5)]).astype(np.uint8)
            aip = root / "nii" / f"{pid}_v{view}_aligned_img.nii.gz"
            alp = root / "nii" / f"{pid}_v{view}_aligned_lab.nii.gz"
            write_nifti(aip, cimg[..., None])            # (H, W, T, 1)
            write_nifti(alp, cmask[..., None])           # (5, H, W, T, 1)
            al_images[view] = str(aip)
            al_labels[view] = str(alp)
        rec = dict(number=pid, mPAP=float(rs.uniform(20, 80)),
                   Vmax=float(rs.uniform(2, 5)), Ps=float(rs.uniform(30, 90)),
                   dataset_name="rmyy", fold=int(rs.randint(5)))
        infos[pid] = dict(rec, views_images=views_images,
                          views_labels=views_labels)
        unlab_infos[pid] = dict(rec, views_images=al_images,
                                views_labels=al_labels)

    # test clips '0_0'..'0_9' (Test_Seg_PAHDataset contract). The reference's
    # test clips are pre-processed offline to 112²; here that means running
    # unseen patients through the DETERMINISTIC version of the train
    # transform (nearest resize to 144² then center crop 112²) so eval
    # measures generalization, not a scale/statistics shift.
    def _resize_video(vol, out_hw):
        hi = np.floor(np.arange(out_hw) *
                      np.float32(vol.shape[0]) / np.float32(out_hw))
        wi = np.floor(np.arange(out_hw) *
                      np.float32(vol.shape[1]) / np.float32(out_hw))
        hi = np.clip(hi.astype(np.int64), 0, vol.shape[0] - 1)
        wi = np.clip(wi.astype(np.int64), 0, vol.shape[1] - 1)
        return vol[hi][:, wi]

    rhw = cfg.resize_hw
    off = (rhw - chw) // 2
    test_infos = {}
    for ci in range(10):
        cid = f"0_{ci}"
        views_images, views_labels = {}, {}
        for view in views:
            rimg, rlab = _make_video(hw, clip_t, _VIEW_LABELS[view], rs)
            cimg = _resize_video(rimg, rhw)[off:off + chw, off:off + chw]
            clab = _resize_video(rlab, rhw)[off:off + chw, off:off + chw]
            vi = ALL_VIEWS.index(view)
            chan = table[vi][np.clip(clab.astype(np.int64), 0, 4)]
            cmask = np.stack([(chan == c) for c in range(5)]).astype(np.uint8)
            ip = root / "nii" / f"test_{cid}_v{view}_img.nii.gz"
            lp = root / "nii" / f"test_{cid}_v{view}_lab.nii.gz"
            write_nifti(ip, cimg[None])                  # (1, H, W, T)
            write_nifti(lp, cmask)                       # (5, H, W, T)
            views_images[view] = str(ip)
            views_labels[view] = str(lp)
        test_infos[cid] = dict(number=cid, mPAP=0.0, Vmax=0.0, Ps=0.0,
                               dataset_name="rmyy", fold=0,
                               views_images=views_images,
                               views_labels=views_labels)

    np.save(root / "infos" / "save_infos_reg_v2.npy", infos)
    np.save(root / "infos" / "infos_unlab.npy", unlab_infos)
    np.save(root / "infos" / "test_infos.npy", test_infos)
    # splits: ~70/15/15
    k1, k2 = max(1, int(n * 0.7)), max(1, int(n * 0.15))
    np.save(root / "data_list" / "train_list.npy", np.asarray(ids[:k1]))
    np.save(root / "data_list" / "val_list.npy", np.asarray(ids[k1:k1 + k2]))
    np.save(root / "data_list" / "test_list.npy", np.asarray(ids[k1 + k2:]))
    return {
        "root": str(root),
        "infos": str(root / "infos" / "save_infos_reg_v2.npy"),
        "unlab_infos": str(root / "infos" / "infos_unlab.npy"),
        "test_infos": str(root / "infos" / "test_infos.npy"),
        "data_list_dir": str(root / "data_list"),
    }
