"""Center-manifest reader: the reference's ``data_xlsx/*.xlsx`` contract.

The port of ``glfusion_tpu/data/xlsx.py`` (standard library only, as
there).

The reference ships five per-center Excel manifests (its
``data_xlsx/dataset_pa_nii_{gy,rmyy,szfw}_center_*.xlsx``) that no
reference *code* reads — they are the upstream source the
``infos/*.npy`` index was built from: each infos record's ``fold`` field is
exactly a manifest file stem, and its ``number`` / ``mPAP`` / ``Vmax`` /
``Ps`` fields reproduce the manifest columns (verified against
``infos/save_infos_reg_v2.npy`` by ``tests/test_xlsx.py``).

This module closes that last inventory row (SURVEY.md §2.1) with a
stdlib-only XLSX reader — no openpyxl/pandas dependency — plus the
center-schema normalization:

* gy_20220306 / rmyy_*: columns ``number | mPAP | Vmax | Ps``.
* gy_20220407 / szfw: a leading ``name`` column holds real patient names;
  it is **dropped on read** (privacy) and never stored.
* The ``Ps`` column is an availability marker over echo positions 1–7:
  ``√`` (all present), ``缺3`` / ``缺5/7`` / ``缺1、6`` (listed positions
  missing), ``仅4、6`` (ONLY the listed positions present). It normalizes
  to the present-position list that infos records carry as ``Ps``.
"""

from __future__ import annotations

import dataclasses
import re
import zipfile
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"

#: Echo "positions" (video files 1.nii.gz .. 7.nii.gz per patient); the
#: model's standard views {'1','3','4'} are a subset.
ALL_POSITIONS: Tuple[str, ...] = ("1", "2", "3", "4", "5", "6", "7")


def _column_of(cell_ref: str) -> str:
    m = re.match(r"[A-Z]+", cell_ref)
    if m is None:
        raise ValueError(f"bad cell reference {cell_ref!r}")
    return m.group(0)


def read_sheet(path: str | Path, sheet: str = "sheet1") -> List[Dict[str, str]]:
    """Parse one worksheet into a list of {column-letter: string} dicts.

    Minimal OOXML support: inline numbers and shared strings (including
    multi-run ``<r>`` text), which is all the reference manifests use.
    Empty cells are absent from the row dict.
    """
    with zipfile.ZipFile(str(path)) as z:
        strings: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall(f"{_NS}si"):
                strings.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
        root = ET.fromstring(z.read(f"xl/worksheets/{sheet}.xml"))
    rows: List[Dict[str, str]] = []
    for row in root.iter(f"{_NS}row"):
        parsed: Dict[str, str] = {}
        for cell in row.findall(f"{_NS}c"):
            value = cell.find(f"{_NS}v")
            if value is None or value.text is None:
                continue
            text = value.text
            if cell.get("t") == "s":
                text = strings[int(text)]
            parsed[_column_of(cell.get("r", "A"))] = text
        rows.append(parsed)
    return rows


def parse_positions(marker: Optional[str]) -> Tuple[str, ...]:
    """Normalize a ``Ps`` availability marker to the present positions.

    ``√``/empty → all 7; ``缺<list>`` → all minus the listed ones;
    ``仅<list>`` or a bare digit list → exactly the listed ones. List
    separators seen in the manifests: ``、`` ``/`` ``,``.
    """
    if marker is None:
        return ALL_POSITIONS
    marker = marker.strip()
    if marker in ("", "√"):
        return ALL_POSITIONS
    listed = tuple(p for p in re.findall(r"\d", marker) if p in ALL_POSITIONS)
    if marker.startswith("仅") or re.fullmatch(r"[\d、/,\s]+", marker):
        # "only these" (explicit 仅 prefix, or a bare position list)
        return listed
    if marker.startswith("缺"):  # "missing these"
        missing = set(listed)
        return tuple(p for p in ALL_POSITIONS if p not in missing)
    raise ValueError(f"unrecognized Ps marker {marker!r}")


@dataclasses.dataclass(frozen=True)
class CenterRecord:
    """One patient row of a center manifest (name column dropped)."""

    number: str                 # 'P<k>' patient id within the center fold
    mPAP: Optional[float]       # mean pulmonary arterial pressure (target)
    Vmax: Optional[float]       # max tricuspid regurgitation velocity
    positions: Tuple[str, ...]  # echo positions present on disk


def _to_float(text: Optional[str]) -> Optional[float]:
    if text is None or text.strip() in ("", "√"):
        return None
    try:
        return float(text)
    except ValueError:
        return None


def load_center_manifest(path: str | Path) -> Dict[str, CenterRecord]:
    """Read one ``dataset_pa_nii_*_center_*.xlsx`` into {number: record}.

    The header row is located by its ``number`` cell; a leading ``name``
    column (present in gy_20220407/szfw) is skipped and its contents are
    not retained. Rows without a patient number (trailing notes) are
    dropped.
    """
    rows = read_sheet(path)
    header_idx = None
    columns: Dict[str, str] = {}
    for i, row in enumerate(rows):
        lowered = {col: val.strip().lower() for col, val in row.items()}
        if "number" in lowered.values():
            header_idx = i
            columns = {name: col for col, name in lowered.items()}
            break
    if header_idx is None:
        raise ValueError(f"{path}: no header row with a 'number' column")

    num_col = columns["number"]
    mpap_col = columns.get("mpap")
    vmax_col = columns.get("vmax")
    ps_col = columns.get("ps")

    records: Dict[str, CenterRecord] = {}
    for row in rows[header_idx + 1:]:
        number = row.get(num_col, "").strip()
        if not number:
            continue
        # All five shipped manifests number rows 'P1','P2',... (verified
        # against the reference data_xlsx/); non-P numbers are kept
        # verbatim rather than guessed at — a silent renumbering would
        # shift every patient's clinical values by one.
        records[number] = CenterRecord(
            number=number,
            mPAP=_to_float(row.get(mpap_col)) if mpap_col else None,
            Vmax=_to_float(row.get(vmax_col)) if vmax_col else None,
            positions=parse_positions(row.get(ps_col) if ps_col else None),
        )
    return records


def load_manifest_dir(directory: str | Path) -> Dict[str, Dict[str, CenterRecord]]:
    """Load every ``*.xlsx`` manifest in a directory, keyed by file stem.

    The stem is the infos records' ``fold`` field, so
    ``load_manifest_dir(d)[rec['fold']][rec['number']]`` looks up a
    patient's manifest row.
    """
    return {
        p.stem: load_center_manifest(p)
        for p in sorted(Path(directory).glob("*.xlsx"))
    }


def cross_check_infos(
    manifests: Mapping[str, Mapping[str, CenterRecord]],
    infos: Mapping[str, Mapping],
    fields: Sequence[str] = ("mPAP", "Vmax", "Ps"),
) -> Dict[str, int]:
    """Count infos records whose fields agree with their manifest row.

    Returns {'matched': n, 'checked': m, 'missing_row': k}; a field
    comparison is skipped when the infos side is None (the builder dropped
    some columns for some folds). Used by ``tests/test_xlsx.py`` to prove
    the reader reconstructs the shipped index.
    """
    matched = checked = missing = 0
    for rec in infos.values():
        fold, number = rec.get("fold"), rec.get("number")
        manifest = manifests.get(fold or "")
        if manifest is None or number is None:
            continue
        row = manifest.get(number)
        if row is None:
            missing += 1
            continue
        checked += 1
        ok = True
        for field in fields:
            want = rec.get(field)
            if want is None:
                continue
            if field == "Ps":
                ok &= tuple(want) == row.positions
                continue
            try:
                want_f = float(want)
            except (TypeError, ValueError):
                continue  # non-numeric placeholder ('/', '\\') in infos
            if want_f != want_f:  # NaN in infos ⇔ empty manifest cell
                ok &= getattr(row, field) is None
            else:
                have = getattr(row, field)
                ok &= have is not None and abs(want_f - have) < 1e-6
        matched += int(ok)
    return {"matched": matched, "checked": checked, "missing_row": missing}
