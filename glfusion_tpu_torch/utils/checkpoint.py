"""Checkpoints of the whole training state, written in the background.

The port of ``glfusion_tpu/utils/checkpoint.py`` (``CheckpointManager`` with
its flax backend's semantics; torch has no orbax, so there is one backend).
Each saved epoch ``e`` is two files:

  ``net_{e:05}.pth``    ``{'network': state_dict}``: the reference's file,
                        unchanged, so the JAX CLI's ``--torch-ckpt`` and
                        ``utils/convert.load_checkpoint`` read it;
  ``state_{e:05}.pth``  ``{'epoch': e, 'optimizer': ..., 'scheduler': ...}``:
                        Adam's moments and step counts, the schedule's epoch.

``save()`` snapshots the state to host memory inside the call (on CUDA: copies
into pinned buffers, enqueued on the current stream, so the train steps that
follow cannot overwrite what is being saved), then one writer thread
serializes and writes, in the order the saves were made. Each file is written
under a hidden temporary name and renamed. A save first removes the epoch's
old sidecar, then renames the net file, then the sidecar: the sidecar marks a
complete pair, so a process killed at any moment leaves only whole epochs in
``all_steps()``.
"""

from __future__ import annotations

import os
import re
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional, Tuple

import torch

_NET = re.compile(r"^net_(\d{5})\.pth$")


def snapshot(tree):
    """Host copies of every tensor of a nested dict/list/tuple, and the CUDA
    event after which the copies are complete (None when nothing was on the
    card). Anything else is kept as it is."""
    pending = []

    def copy(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if x.is_cuda:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                pending.append(host)
                return host
            return x.clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    host = copy(tree)
    event = None
    if pending:
        event = torch.cuda.Event()
        event.record()
    return host, event


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_name(f".tmp_{path.name}")
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Asynchronous, atomic checkpoints under one directory.

    ``max_to_keep=None`` keeps every saved epoch, as the reference does: its
    sweep picks the best epoch ≥ 50 over every ``net_*.pth``. An int bounds
    the disk (``--ckpt-keep``); the oldest epochs go first.
    """

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="ckpt-writer")
        self._lock = threading.Lock()
        self._pending: List[Future] = []
        self._error: Optional[BaseException] = None
        # one record a durable save: epoch, bytes, blocking_s, write_s
        self.saves: List[dict] = []

    def paths(self, epoch: int) -> Tuple[Path, Path]:
        """(net file, sidecar) of one epoch."""
        return (self.directory / f"net_{epoch:05}.pth",
                self.directory / f"state_{epoch:05}.pth")

    # ------------------------------------------------------------ writing

    def save(self, payload: dict, epoch: int) -> None:
        """Checkpoint ``payload`` (``network``, ``optimizer``, ``scheduler``
        state dicts) as ``epoch``. Returns once the host snapshot is taken;
        :meth:`wait` blocks until the files are in place."""
        t0 = time.perf_counter()
        host, event = snapshot(payload)
        blocking_s = time.perf_counter() - t0
        fut = self._writer.submit(self._write, host, event, epoch, blocking_s)
        with self._lock:
            self._pending.append(fut)

    def _write(self, host: dict, event, epoch: int, blocking_s: float):
        try:
            if event is not None:
                event.synchronize()
            t0 = time.perf_counter()
            net, side = self.paths(epoch)
            side.unlink(missing_ok=True)  # the pair is incomplete from here
            _atomic_save({"network": host["network"]}, net)
            _atomic_save({"epoch": epoch, **{k: v for k, v in host.items()
                                             if k != "network"}}, side)
            self.saves.append({
                "epoch": epoch,
                "bytes": net.stat().st_size + side.stat().st_size,
                "blocking_s": blocking_s,
                "write_s": time.perf_counter() - t0})
            if self._max_to_keep is not None:
                for old in self._scan()[:-self._max_to_keep]:
                    old_net, old_side = self.paths(old)
                    old_side.unlink(missing_ok=True)
                    old_net.unlink(missing_ok=True)
        except Exception as e:  # surfaced by the next wait()
            with self._lock:
                if self._error is None:
                    self._error = e

    def wait(self) -> None:
        """Block until every queued save is in place; re-raise the first
        write failure (a full disk must not let a run end with no
        checkpoint)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"async checkpoint save failed: {err!r}") \
                from err

    # ------------------------------------------------------------ reading

    def _scan(self) -> List[int]:
        steps = []
        for p in self.directory.iterdir():
            m = _NET.match(p.name)
            if m and self.paths(int(m.group(1)))[1].exists():
                steps.append(int(m.group(1)))
        return sorted(steps)

    def all_steps(self) -> List[int]:
        """Sorted epochs whose two files are both in place."""
        self.wait()
        return self._scan()

    def restore_step(self, step: int, train_state: bool = True
                     ) -> Optional[dict]:
        """One epoch's payload on the CPU, or None: ``network`` and, with
        ``train_state``, ``optimizer``, ``scheduler`` and ``epoch``."""
        if step not in self.all_steps():
            return None
        net, side = self.paths(step)
        payload = {"network": torch.load(net, map_location="cpu",
                                         weights_only=True,
                                         mmap=True)["network"]}
        if train_state:
            payload.update(torch.load(side, map_location="cpu",
                                      weights_only=True, mmap=True))
        return payload

    def restore_latest(self) -> Optional[Tuple[dict, int]]:
        """The newest epoch's whole payload and the epoch to train next."""
        steps = self.all_steps()
        if not steps:
            return None
        return self.restore_step(steps[-1]), steps[-1] + 1
