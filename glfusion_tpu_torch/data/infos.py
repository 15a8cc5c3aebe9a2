"""Dataset index: the reference's ``infos/*.npy`` pickled-dict contract.

A copy of ``glfusion_tpu/data/infos.py`` (the port imports nothing of
``glfusion_tpu``).

Each infos file maps patient id → record with (at least) keys
``dataset_name``, ``fold``, ``views_images`` {view → .nii.gz path or None},
``views_labels`` {view → path or None} (SURVEY.md §2.1; inspected from
``infos/save_infos_reg_v2.npy``). Splits are plain string arrays in
``data_list/{train,val,test}_list.npy``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Mapping, Sequence

import numpy as np


@dataclasses.dataclass
class PatientIndex:
    """Filtered view of an infos dict (reference loader ``get_dict``)."""

    records: Dict[str, dict]

    @classmethod
    def from_infos(cls, infos: Mapping[str, dict],
                   set_select: Sequence[str]) -> "PatientIndex":
        records = {
            k: {
                "images": v["views_images"],
                "masks": v["views_labels"],
                "fold": v.get("fold"),
                "dataset_name": v.get("dataset_name"),
                # regression targets (reference loader.py:141-151)
                "mPAP": v.get("mPAP"),
                "Vmax": v.get("Vmax"),
                "Ps": v.get("Ps"),
            }
            for k, v in infos.items()
            if v.get("dataset_name") in set(set_select)
        }
        return cls(records)

    def ids(self) -> list[str]:
        return list(self.records.keys())

    def view_paths(self, patient_id: str, view: str):
        """(image_path, label_path) or (None, None) if the view is missing."""
        rec = self.records[patient_id]
        img = rec["images"].get(view)
        lab = rec["masks"].get(view)
        if img is None or lab is None:
            return None, None
        return img, lab


def load_infos(path: str | Path) -> Dict[str, dict]:
    return np.load(str(path), allow_pickle=True).item()


def load_split(path: str | Path) -> list[str]:
    return [str(x) for x in np.load(str(path), allow_pickle=True)]
