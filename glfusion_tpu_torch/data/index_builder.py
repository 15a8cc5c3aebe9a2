"""Build the ``infos/*.npy`` + ``data_list/*.npy`` index from a CSV manifest.

The port of ``glfusion_tpu/data/index_builder.py``: the same manifest gives
the same files, key order and seeded split included.

The reference ships its dataset index as pickled numpy dicts
(``infos/save_infos_reg_v2.npy`` etc., SURVEY.md §2.1) with no tooling to
produce them — its authors built the pickles offline from hospital xlsx
exports (``data_xlsx/*``, readable here via :mod:`glfusion_tpu_torch.data.xlsx`).
This module is the missing onboarding path: a plain CSV manifest of a
user's own NIfTI corpus in, the exact on-disk contract the loaders consume
out (same keys and array layouts as reference ``datasets/loader.py``
expects and as :func:`glfusion_tpu_torch.data.synthetic.generate_synthetic_dataset`
writes).

Manifest columns (header row required; extra columns ignored):

  * ``patient_id`` — record key (for ``kind=test`` this is the clip id);
  * ``view`` — one of the standard views ``1``/``2``/``3``/``4``;
  * ``image`` — path to the image ``.nii.gz`` (relative paths resolve
    against the manifest's directory);
  * ``label`` — path to the mask ``.nii.gz`` (optional: omit for
    image-only views);
  * ``kind`` — ``labeled`` (default; → labeled-frame training index),
    ``aligned`` (pre-aligned cycle clips → ``infos_unlab``), or ``test``
    (pre-extracted eval clips → ``test_infos``);
  * ``split`` — optional ``train``/``val``/``test`` for labeled patients;
    either every labeled patient carries one or none does (then a seeded
    shuffle fills ``--val-frac``/``--test-frac``);
  * ``mPAP``, ``Vmax``, ``Ps`` — optional regression targets (float);
  * ``dataset_name``, ``fold`` — optional provenance fields (the loaders
    filter on ``dataset_name``; default matches ``DataConfig.use_data``).

Array contracts checked by ``check_shapes=True`` (read every volume):

  * ``labeled``: image ``(H, W, T)`` (or ``(H, W)``), label same spatial
    shape with integer class values (reference ``loader.py:296-316``);
  * ``aligned``: image ``(H, W, T[, 1])``;
  * ``test``: image ``(1, H, W, T)``, label ``(5, H, W, T)``
    (``Test_Seg_PAHDataset``, reference ``loader.py:1100-1112``).

Run as a script::

    python -m glfusion_tpu_torch.data.index_builder manifest.csv ./dataset_root
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from glfusion_tpu_torch.config import ALL_VIEWS

_KINDS = ("labeled", "aligned", "test")
_SPLITS = ("train", "val", "test")


@dataclasses.dataclass
class ManifestRow:
    patient_id: str
    view: str
    image: str
    label: Optional[str]
    kind: str
    split: Optional[str]
    scalars: Dict[str, float]
    dataset_name: Optional[str]
    fold: Optional[int]
    line: int  # 1-based line number in the CSV, for error messages


def read_manifest(path: str | Path) -> List[ManifestRow]:
    """Parse + validate the CSV; relative paths resolve against its dir."""
    path = Path(path)
    base = path.parent
    rows: List[ManifestRow] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{path}: empty manifest")
        missing = {"patient_id", "view", "image"} - set(reader.fieldnames)
        if missing:
            raise ValueError(
                f"{path}: manifest header is missing required column(s) "
                f"{sorted(missing)} (got {reader.fieldnames})")
        for i, rec in enumerate(reader, start=2):  # line 1 is the header
            get = lambda k: (rec.get(k) or "").strip()
            pid, view = get("patient_id"), get("view")
            if not pid:
                raise ValueError(f"{path}:{i}: empty patient_id")
            if view not in ALL_VIEWS:
                raise ValueError(
                    f"{path}:{i}: view {view!r} is not one of {ALL_VIEWS}")
            kind = get("kind") or "labeled"
            if kind not in _KINDS:
                raise ValueError(
                    f"{path}:{i}: kind {kind!r} is not one of {_KINDS}")
            split = get("split") or None
            if split is not None and split not in _SPLITS:
                raise ValueError(
                    f"{path}:{i}: split {split!r} is not one of {_SPLITS}")
            img = get("image")
            if not img:
                raise ValueError(f"{path}:{i}: empty image path")
            img_p = str((base / img).resolve()) if not Path(img).is_absolute() else img
            lab = get("label") or None
            lab_p = None
            if lab is not None:
                lab_p = str((base / lab).resolve()) if not Path(lab).is_absolute() else lab
            scalars = {}
            for k in ("mPAP", "Vmax", "Ps"):
                v = get(k)
                if v:
                    try:
                        scalars[k] = float(v)
                    except ValueError:
                        raise ValueError(f"{path}:{i}: {k}={v!r} is not a float")
            fold = None
            if get("fold"):
                try:
                    fold = int(get("fold"))
                except ValueError:
                    raise ValueError(f"{path}:{i}: fold={get('fold')!r} is not an int")
            rows.append(ManifestRow(
                patient_id=pid, view=view, image=img_p, label=lab_p,
                kind=kind, split=split, scalars=scalars,
                dataset_name=get("dataset_name") or None, fold=fold, line=i))
    if not rows:
        raise ValueError(f"{path}: manifest has a header but no rows")
    return rows


def _check_volume(row: ManifestRow) -> None:
    """Read the NIfTI volumes and validate the per-kind array contract."""
    from glfusion_tpu_torch.data.nifti import read_nifti

    img = np.asarray(read_nifti(row.image))
    lab = np.asarray(read_nifti(row.label)) if row.label else None
    where = f"manifest line {row.line} ({row.patient_id}/{row.view})"
    if row.kind == "labeled":
        sq = img.squeeze()
        if sq.ndim not in (2, 3):
            raise ValueError(
                f"{where}: labeled image must be (H, W[, T]); got {img.shape}")
        if lab is not None and lab.squeeze().shape != sq.shape:
            raise ValueError(
                f"{where}: label shape {lab.shape} does not match image "
                f"{img.shape}")
    elif row.kind == "aligned":
        sq = img.squeeze()
        if sq.ndim != 3:
            raise ValueError(
                f"{where}: aligned clip image must be (H, W, T[, 1]); "
                f"got {img.shape}")
    else:  # test
        if img.ndim != 4 or img.shape[0] != 1:
            raise ValueError(
                f"{where}: test clip image must be (1, H, W, T); "
                f"got {img.shape}")
        if lab is None:
            raise ValueError(f"{where}: test clips require a label")
        if lab.ndim != 4 or lab.shape[0] != 5:
            raise ValueError(
                f"{where}: test clip label must be (5, H, W, T); "
                f"got {lab.shape}")
        if lab.shape[1:] != img.shape[1:]:
            raise ValueError(
                f"{where}: test label {lab.shape} does not match image "
                f"{img.shape} on (H, W, T)")


def _fold_rows(rows: Sequence[ManifestRow], dataset_name: str) -> Dict[str, dict]:
    """Group one kind's rows into the infos record dict."""
    infos: Dict[str, dict] = {}
    for r in rows:
        rec = infos.setdefault(r.patient_id, {
            "number": r.patient_id, "mPAP": 0.0, "Vmax": 0.0, "Ps": 0.0,
            "dataset_name": dataset_name, "fold": 0,
            "views_images": {}, "views_labels": {},
        })
        if r.view in rec["views_images"]:
            raise ValueError(
                f"manifest line {r.line}: duplicate ({r.patient_id}, "
                f"view {r.view}, kind {r.kind})")
        rec["views_images"][r.view] = r.image
        rec["views_labels"][r.view] = r.label
        for k, v in r.scalars.items():
            rec[k] = v
        if r.dataset_name is not None:
            rec["dataset_name"] = r.dataset_name
        if r.fold is not None:
            rec["fold"] = r.fold
    return infos


def _make_splits(ids: Sequence[str], explicit: Dict[str, str],
                 val_frac: float, test_frac: float,
                 seed: int) -> Dict[str, list]:
    ids = list(ids)
    if explicit:
        missing = [i for i in ids if i not in explicit]
        if missing:
            raise ValueError(
                "either every labeled patient carries a split or none "
                f"does; missing a split: {sorted(missing)[:5]}"
                f"{'…' if len(missing) > 5 else ''}")
        return {s: [i for i in ids if explicit[i] == s] for s in _SPLITS}
    if val_frac < 0 or test_frac < 0 or val_frac + test_frac >= 1:
        raise ValueError(
            f"need val_frac + test_frac in [0, 1); got {val_frac}, {test_frac}")
    rs = np.random.RandomState(seed)
    order = [ids[i] for i in rs.permutation(len(ids))]
    n_val = int(round(len(ids) * val_frac))
    n_test = int(round(len(ids) * test_frac))
    n_train = len(ids) - n_val - n_test
    if ids and n_train <= 0:
        raise ValueError("split fractions leave no training patients")
    return {"train": sorted(order[:n_train]),
            "val": sorted(order[n_train:n_train + n_val]),
            "test": sorted(order[n_train + n_val:])}


def build_index(manifest: str | Path, out_root: str | Path, *,
                dataset_name: str = "rmyy", val_frac: float = 0.15,
                test_frac: float = 0.15, seed: int = 0,
                check_shapes: bool = False,
                require_files: bool = True) -> dict:
    """Manifest CSV → the on-disk index contract under ``out_root``.

    Returns the same paths dict shape as
    :func:`glfusion_tpu_torch.data.synthetic.generate_synthetic_dataset`, ready
    for ``Trainer(cfg, data_paths=...)`` — or point ``--data-root`` at
    ``out_root`` if the ``.nii.gz`` paths live under it too.
    """
    rows = read_manifest(manifest)

    if require_files:
        for r in rows:
            for p in filter(None, (r.image, r.label)):
                if not Path(p).exists():
                    raise FileNotFoundError(
                        f"manifest line {r.line}: {p} does not exist")
    if check_shapes:
        for r in rows:
            _check_volume(r)

    by_kind = {k: [r for r in rows if r.kind == k] for k in _KINDS}
    infos = _fold_rows(by_kind["labeled"], dataset_name)
    unlab = _fold_rows(by_kind["aligned"], dataset_name)
    test_infos = _fold_rows(by_kind["test"], dataset_name)

    explicit = {}
    for r in by_kind["labeled"]:
        if r.split is not None:
            prev = explicit.setdefault(r.patient_id, r.split)
            if prev != r.split:
                raise ValueError(
                    f"manifest line {r.line}: patient {r.patient_id} has "
                    f"conflicting splits {prev!r} and {r.split!r}")
    splits = _make_splits(list(infos), explicit, val_frac, test_frac, seed)

    out = Path(out_root)
    (out / "infos").mkdir(parents=True, exist_ok=True)
    (out / "data_list").mkdir(exist_ok=True)
    np.save(out / "infos" / "save_infos_reg_v2.npy", infos)
    # cycle clips are optional: an empty infos_unlab trains without the
    # cycle loss (tests/test_losses.py covers the empty cycle stream)
    np.save(out / "infos" / "infos_unlab.npy", unlab)
    np.save(out / "infos" / "test_infos.npy", test_infos)
    for s in _SPLITS:
        np.save(out / "data_list" / f"{s}_list.npy", np.asarray(splits[s]))
    return {
        "root": str(out),
        "infos": str(out / "infos" / "save_infos_reg_v2.npy"),
        "unlab_infos": str(out / "infos" / "infos_unlab.npy"),
        "test_infos": str(out / "infos" / "test_infos.npy"),
        "data_list_dir": str(out / "data_list"),
        "counts": {"labeled": len(infos), "aligned": len(unlab),
                   "test_clips": len(test_infos),
                   "splits": {s: len(splits[s]) for s in _SPLITS}},
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Build the glfusion_tpu_torch dataset index (infos/*.npy + "
                    "data_list/*.npy) from a CSV manifest of NIfTI files.")
    ap.add_argument("manifest", help="CSV manifest (see module docstring)")
    ap.add_argument("out_root", help="output dataset root (for --data-root)")
    ap.add_argument("--dataset-name", default="rmyy",
                    help="default dataset_name for rows that omit one "
                         "(must appear in DataConfig.use_data to load)")
    ap.add_argument("--val-frac", type=float, default=0.15)
    ap.add_argument("--test-frac", type=float, default=0.15)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--check-shapes", action="store_true",
                    help="read every volume and validate the per-kind "
                         "array contract (slow on large corpora)")
    args = ap.parse_args(argv)
    paths = build_index(args.manifest, args.out_root,
                        dataset_name=args.dataset_name,
                        val_frac=args.val_frac, test_frac=args.test_frac,
                        seed=args.seed, check_shapes=args.check_shapes)
    c = paths["counts"]
    print(f"indexed {c['labeled']} labeled patients "
          f"(splits {c['splits']}), {c['aligned']} cycle-clip patients, "
          f"{c['test_clips']} test clips → {paths['root']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
