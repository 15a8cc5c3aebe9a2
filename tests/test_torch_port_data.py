"""The user's onboarding path in the port, against the JAX package on the
CPU: the index builder (``data/index_builder.py``), the center manifests
(``data/xlsx.py``) and the two whole-label loaders (``AllMaskFrameLoader``,
``FullVideoLoader``); then an index built by the port trains and validates
each variant family through the CLI's ``--data-root``.

All of it is host code: same inputs through both packages, compared
exactly (no tolerance).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_port_common import one_torch_thread  # noqa: F401
from glfusion_tpu import config as jconfig
from glfusion_tpu.data import index_builder as jbuilder
from glfusion_tpu.data import pipeline as jpipe
from glfusion_tpu.data import xlsx as jxlsx
from glfusion_tpu.data.infos import PatientIndex as JPatientIndex
from glfusion_tpu_torch import cli
from glfusion_tpu_torch import config as pconfig
from glfusion_tpu_torch.data import (AllMaskFrameLoader, FullVideoLoader,
                                     index_builder, xlsx)
from glfusion_tpu_torch.data.infos import PatientIndex, load_infos, load_split
from glfusion_tpu_torch.data.synthetic import generate_synthetic_dataset
from test_xlsx import _write_workbook

ROOT = Path(__file__).resolve().parent.parent
COLUMNS = ["patient_id", "view", "image", "label", "kind", "split", "mPAP",
           "Vmax", "Ps", "dataset_name", "fold"]
FILES = ["infos/save_infos_reg_v2.npy", "infos/infos_unlab.npy",
         "infos/test_infos.npy", "data_list/train_list.npy",
         "data_list/val_list.npy", "data_list/test_list.npy"]


def _rows(infos, kind, scalars=False, rename=None):
    """Manifest rows of an infos dict; ``rename`` maps record ids to the
    user's own (the test clips' ids, which the Trainer then splits)."""
    rows = []
    for pid, rec in infos.items():
        for view, image in rec["views_images"].items():
            row = {"patient_id": (rename or {}).get(pid, pid), "view": view,
                   "image": image, "label": rec["views_labels"].get(view)
                   or "", "kind": kind}
            if scalars:
                row.update(mPAP=rec["mPAP"], Vmax=rec["Vmax"],
                           dataset_name=rec["dataset_name"], fold=1)
            rows.append(row)
    return rows


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The tiny synthetic corpus and a manifest of it: labeled patients with
    their scalars, the cycle clips, and the test clips under user ids."""
    tmp = tmp_path_factory.mktemp("onboarding")
    cfg = pconfig.tiny_config()
    paths = generate_synthetic_dataset(tmp / "synth", cfg.data,
                                       views=cfg.model.views, seed=0)
    tests = load_infos(paths["test_infos"])
    rows = (_rows(load_infos(paths["infos"]), "labeled", scalars=True)
            + _rows(load_infos(paths["unlab_infos"]), "aligned")
            + _rows(tests, "test",
                    rename={c: f"clip_{i}" for i, c in enumerate(tests)}))
    manifest = tmp / "manifest.csv"
    with open(manifest, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        w.writerows(rows)
    return tmp, manifest, paths


def _same_npy(a: Path, b: Path) -> None:
    """Equal loaded contents, dict key order included, at every level."""
    x = np.load(a, allow_pickle=True)
    y = np.load(b, allow_pickle=True)
    if x.dtype == object:
        x, y = x.item(), y.item()
        assert json.dumps(x, default=str) == json.dumps(y, default=str), a
    else:
        np.testing.assert_array_equal(x, y, err_msg=str(a))
        assert x.dtype == y.dtype


def test_index_builder_matches_jax(corpus):
    """The same manifest through both builders (``check_shapes``, a seeded
    split): the same six files, loaded contents and key order equal, and
    the same returned counts; the manifest errors are JAX's."""
    tmp, manifest, _ = corpus
    kw = dict(val_frac=0.25, test_frac=0.25, seed=3, check_shapes=True)
    got = index_builder.build_index(manifest, tmp / "port", **kw)
    want = jbuilder.build_index(manifest, tmp / "jax", **kw)
    assert got["counts"] == want["counts"]
    assert got["counts"]["splits"] == {"train": 2, "val": 1, "test": 1}
    for f in FILES:
        _same_npy(tmp / "port" / f, tmp / "jax" / f)

    bad = tmp / "bad.csv"
    bad.write_text("patient_id,view,image\np1,9,x.nii.gz\n")
    for mod in (index_builder, jbuilder):
        with pytest.raises(ValueError, match="view '9' is not one of"):
            mod.read_manifest(bad)


def test_index_builder_runs_as_a_module_and_trains(corpus, tmp_path):
    """``python -m glfusion_tpu_torch.data.index_builder`` with JAX's flags
    writes what JAX's ``main`` writes; then ``--variant V --data-root`` on
    that index trains one epoch and validates (Inner-val and Inner-test
    taken from the user's clip ids) for one variant of each family: the
    global branch alone, the local branch alone, both merged by the 1×1
    conv, and no attention (the V→1 input mix)."""
    tmp, manifest, _ = corpus
    flags = ["--dataset-name", "rmyy", "--val-frac", "0.25", "--test-frac",
             "0.25", "--seed", "5"]
    root = tmp_path / "root"
    run = subprocess.run(
        [sys.executable, "-m", "glfusion_tpu_torch.data.index_builder",
         str(manifest), str(root), *flags],
        cwd=ROOT, capture_output=True, text=True, check=True)
    assert "indexed 4 labeled patients" in run.stdout
    assert jbuilder.main([str(manifest), str(tmp_path / "jax"), *flags]) == 0
    for f in FILES:
        _same_npy(root / f, tmp_path / "jax" / f)

    for variant in ("global_only", "local_only", "conv_merge",
                    "early_fusion"):
        out = tmp_path / variant
        cli.main(["--mode", "train", "--tiny", "--platform", "cpu",
                  "--variant", variant, "--data-root", str(root),
                  "--epochs", "1", "--save-dir", str(out / "ckpt"),
                  "--log-dir", str(out / "log")])
        log = [json.loads(line) for line in
               (out / "log" / "metrics.jsonl").read_text().splitlines()]
        assert np.isfinite(log[0]["loss"]) and log[0]["loss"] > 0, variant
        evals = [r for r in log if "Inner-val" in json.dumps(r)]
        assert evals, (variant, log)
        assert (out / "ckpt" / "net_00000.pth").exists(), variant


@pytest.mark.parametrize("loader", ["all_mask", "full_video"])
def test_whole_label_loaders_match_jax(corpus, loader):
    """``AllMaskFrameLoader`` (every frame whose raw label sum exceeds 100)
    and ``FullVideoLoader`` (each labeled video whole) on the same index:
    the same items in the same order, every array equal in value and
    type."""
    _, _, paths = corpus
    cfg, jcfg = pconfig.tiny_config(), jconfig.tiny_config()
    infos = load_infos(paths["infos"])
    ids = load_split(Path(paths["data_list_dir"]) / "train_list.npy")
    ids += ["missing_patient"]  # skipped by both
    views = cfg.model.views
    index = PatientIndex.from_infos(infos, cfg.data.use_data)
    jindex = JPatientIndex.from_infos(infos, jcfg.data.use_data)
    if loader == "all_mask":
        got = AllMaskFrameLoader(index, ids, views, cfg)
        want = jpipe.AllMaskFrameLoader(jindex, ids, views, jcfg)
        assert got.items == want.items and len(got) == len(want) > 0
        pairs = list(zip(got.frames(), want.frames()))
        assert len(pairs) == len(got)
        for a, b in pairs:
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        return
    got = FullVideoLoader(index, ids, views, cfg)
    want = jpipe.FullVideoLoader(jindex, ids, views, jcfg)
    assert len(got) == len(want) == len(ids) - 1
    pairs = list(zip(got.videos(), want.videos()))
    assert len(pairs) == len(got)
    for a, b in pairs:
        assert a["patient"] == b["patient"]
        assert list(a["views"]) == list(b["views"]) == list(views)
        for view in views:
            for k, arr in a["views"][view].items():
                ref = b["views"][view][k]
                np.testing.assert_array_equal(arr, ref, err_msg=k)
                assert arr.dtype == ref.dtype, k


def test_xlsx_matches_jax(tmp_path):
    """The same workbooks through both readers: a center manifest with a
    ``name`` column (dropped), numbers, shared strings and every ``Ps``
    marker form, one without ``name``; the sheet rows, the records, the
    directory load and the infos cross-check equal JAX's."""
    _write_workbook(
        tmp_path / "dataset_pa_nii_szfw_center_1.xlsx",
        ["name", "number", "mPAP", "Vmax", "Ps"],
        [["Zhang", "P1", 35, 3.4, "√"], ["Li", "P2", 52.5, None, "缺3"],
         ["Wang", "P3", None, 2.9, "仅4、6"], ["Zhao", "P4", 28, 3.1,
                                              "缺5/7"],
         [None, None, None, None, "note"]])
    _write_workbook(tmp_path / "dataset_pa_nii_gy_center_2.xlsx",
                    ["number", "mPAP", "Vmax", "Ps"],
                    [["P1", 41, 3.8, "1,3,4"], ["Q7", 19.5, 2.2, None]])
    for path in sorted(tmp_path.glob("*.xlsx")):
        assert xlsx.read_sheet(path) == jxlsx.read_sheet(path)
    got = xlsx.load_manifest_dir(tmp_path)
    want = jxlsx.load_manifest_dir(tmp_path)
    assert list(got) == list(want) == ["dataset_pa_nii_gy_center_2",
                                       "dataset_pa_nii_szfw_center_1"]
    for stem in got:
        assert list(got[stem]) == list(want[stem])
        for number, rec in got[stem].items():
            assert (dataclasses.astuple(rec)
                    == dataclasses.astuple(want[stem][number]))
    assert "Zhang" not in json.dumps(
        {k: [dataclasses.astuple(r) for r in v.values()]
         for k, v in got.items()}, ensure_ascii=False)
    infos = {"a": {"fold": "dataset_pa_nii_szfw_center_1", "number": "P2",
                   "mPAP": 52.5, "Vmax": float("nan"),
                   "Ps": ("1", "2", "4", "5", "6", "7")},
             "b": {"fold": "dataset_pa_nii_gy_center_2", "number": "P9",
                   "mPAP": 1.0}}
    assert (xlsx.cross_check_infos(got, infos)
            == jxlsx.cross_check_infos(want, infos)
            == {"matched": 1, "checked": 1, "missing_row": 1})
    for marker in (None, "", "√", "缺3", "缺1、6", "仅4、6", "2/5", "1,3,4"):
        assert xlsx.parse_positions(marker) == jxlsx.parse_positions(marker)
    for mod in (xlsx, jxlsx):
        with pytest.raises(ValueError, match="unrecognized Ps marker"):
            mod.parse_positions("maybe")
