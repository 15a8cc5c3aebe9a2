"""TensorBoard summaries (reference ``main.py:147,874-883`` add_summary).

The port of ``glfusion_tpu/utils/summary.py``: a thin writer over
``torch.utils.tensorboard`` when it imports, and an inactive one otherwise,
which says so once. The JSONL metrics log (``train/trainer.py``) is written
either way.

Event files need no TensorFlow. tensorboard imports TensorFlow, when it is
installed, unless ``tensorboard.compat.notf`` exists (its "no TensorFlow"
switch, which selects its own file layer); the writer sets that switch
before the import, unless TensorFlow is already loaded, because importing
TensorFlow takes seconds in every process that trains.
"""

from __future__ import annotations

import sys
import types

import numpy as np


def _tensorboard_writer_class():
    if "tensorflow" not in sys.modules:
        sys.modules.setdefault("tensorboard.compat.notf",
                               types.ModuleType("tensorboard.compat.notf"))
    from torch.utils.tensorboard import SummaryWriter as TBWriter
    return TBWriter


class SummaryWriter:
    """add_scalar / add_histogram, inactive when tensorboard is missing."""

    def __init__(self, log_dir: str):
        self._tb = None
        try:
            self._tb = _tensorboard_writer_class()(log_dir=log_dir)
        except Exception as e:
            print(f"[glfusion_torch] TensorBoard writer disabled "
                  f"({type(e).__name__}: {e}); metrics.jsonl still written",
                  file=sys.stderr, flush=True)

    @property
    def active(self) -> bool:
        return self._tb is not None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        if self._tb is not None:
            self._tb.add_histogram(tag, np.asarray(values), step)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()
