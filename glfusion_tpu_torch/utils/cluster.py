"""Cluster environment: join a multi-process run from the launcher's
variables.

The port of ``glfusion_tpu/utils/cluster.py`` (reference ``utils/tools.py``),
name for name. The launcher's variables are the source of truth: an
MPI-style launcher (``mpirun``, ``srun``) sets ``PMI_SIZE``/``PMI_RANK`` or
``OMPI_COMM_WORLD_SIZE``/``OMPI_COMM_WORLD_RANK``, the coordinator is
``MASTER_ADDR`` or the Azure Batch variables, and the port is 23455.

A port process drives one device, so a k-card run is k processes (JAX's one
process spans every local device; that is the standing deviation). The
backend is NCCL where each rank has a card of its own, and gloo on the CPU
or where ranks share a card. Each rank's card is ``cuda:{local_rank %
device_count}``, set before the group is made. A world of 1 stays a plain
single-process run. There is no fallback: a world the launcher names but
the run cannot join raises.
"""

from __future__ import annotations

import datetime
import os
import sys

import torch

# how long a rank waits at a collective before it raises (a hung peer)
TIMEOUT_S = 600


def _env_int(names) -> int | None:
    for var in names:
        if os.environ.get(var) is not None:
            return int(os.environ[var] or 0)
    return None


def _env_world_size() -> int | None:
    """World size from launcher env vars alone (no backend touch)."""
    ws = _env_int(("PMI_SIZE", "OMPI_COMM_WORLD_SIZE"))
    return None if ws is None else max(ws, 1)


def _joined() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def get_world_size() -> int:
    """Process count (reference utils/tools.py:5-14)."""
    if _joined():
        return torch.distributed.get_world_size()
    ws = _env_world_size()
    return ws if ws is not None else 1


def get_global_rank() -> int:
    """Global process rank (reference utils/tools.py:17-26)."""
    if _joined():
        return torch.distributed.get_rank()
    rank = _env_int(("PMI_RANK", "OMPI_COMM_WORLD_RANK"))
    return rank if rank is not None else 0


def get_local_rank() -> int:
    """Node-local rank (reference utils/tools.py:29-38)."""
    rank = _env_int(("MPI_LOCALRANKID", "OMPI_COMM_WORLD_LOCAL_RANK"))
    return rank if rank is not None else 0


def get_local_size(world_size: int) -> int:
    """Processes on this node: ``MPI_LOCALNRANKS`` or
    ``OMPI_COMM_WORLD_LOCAL_SIZE``, else the whole world (one node)."""
    n = _env_int(("MPI_LOCALNRANKS", "OMPI_COMM_WORLD_LOCAL_SIZE"))
    return n if n else world_size


def get_master_ip() -> str:
    """Coordinator address (reference utils/tools.py:41-46, plus the
    conventional ``MASTER_ADDR`` so non-Azure MPI launches can name their
    coordinator)."""
    if os.environ.get("MASTER_ADDR"):
        return os.environ["MASTER_ADDR"]
    if os.environ.get("AZ_BATCH_MASTER_NODE") is not None:
        return os.environ["AZ_BATCH_MASTER_NODE"].split(":")[0]
    if os.environ.get("AZ_BATCHAI_MPI_MASTER_NODE") is not None:
        return os.environ["AZ_BATCHAI_MPI_MASTER_NODE"]
    return "127.0.0.1"


def launcher_world() -> tuple[int, int] | None:
    """(world size, rank) from the launcher's variables, None for a plain
    single-process run. A world of more than one without a rank raises."""
    ws = _env_world_size()
    if ws is None or ws <= 1:
        return None
    rank = _env_int(("PMI_RANK", "OMPI_COMM_WORLD_RANK"))
    if rank is None:
        raise RuntimeError(
            f"world size {ws} detected but no rank env var "
            f"(PMI_RANK/OMPI_COMM_WORLD_RANK) is set — cannot join the "
            f"distributed runtime")
    if not 0 <= rank < ws:
        raise RuntimeError(f"rank {rank} outside the world of {ws}")
    return ws, rank


def choose_backend(cpu: bool, world_size: int) -> str:
    """gloo on the CPU or where ranks share a card, else NCCL."""
    if cpu:
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a multi-process run on CUDA, but CUDA is not available; pass "
            "--platform cpu to run it on the CPU")
    shared = get_local_size(world_size) > torch.cuda.device_count()
    return "gloo" if shared else "nccl"


def initialize_distributed(port: int = 23455, cpu: bool = False) -> None:
    """Multi-process bring-up: ``torch.distributed.init_process_group`` at
    the launcher's coordinator, then a barrier right away (JAX syncs after
    bring-up too, so the ranks' first collective is not their model's).
    No-op for ordinary single-process runs. ``cpu``: the run computes on
    the CPU (``--platform cpu``); else each rank takes its card first."""
    world = launcher_world()
    if world is None:
        return
    ws, rank = world
    if _joined():
        if (torch.distributed.get_world_size(),
                torch.distributed.get_rank()) != (ws, rank):
            raise RuntimeError("a process group of another world is "
                               "already initialized")
        return
    backend = choose_backend(cpu, ws)
    if not cpu:
        torch.cuda.set_device(get_local_rank() % torch.cuda.device_count())
    master = get_master_ip()
    if master == "127.0.0.1" and rank != 0:
        # correct for single-HOST multi-process launches (the 2-process
        # tests); on a multi-node launch this process would dial its own
        # localhost and hang at rendezvous — say so before it does
        print(
            "[glfusion] distributed init: no coordinator address found "
            "(MASTER_ADDR / Azure Batch vars unset) — assuming all "
            f"{ws} processes share this host and dialing 127.0.0.1:{port}; "
            "multi-NODE launches must set MASTER_ADDR",
            file=sys.stderr, flush=True)
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{master}:{port}", world_size=ws,
        rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    barrier()


def barrier() -> None:
    """All ranks meet (an all-reduce of one number: one code path over
    gloo and NCCL). No-op outside a multi-process run."""
    if _joined() and torch.distributed.get_world_size() > 1:
        torch.distributed.all_reduce(torch.zeros(1, device=_comm_device()))


def _comm_device() -> torch.device:
    if torch.distributed.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
