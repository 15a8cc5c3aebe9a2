"""The (data, model) mesh over the world's processes.

The port of ``glfusion_tpu/parallel/mesh.py``. A port process drives one
device, so the mesh's places are the world's ranks: rank r sits at
(r // model, r % model), the row-major ``reshape(data, model)`` of JAX's
``mesh.py:38``. ``data=-1`` takes every rank that ``model`` leaves. A world
of 1 gives a trivial 1×1 mesh, so code paths do not branch on it.

Each rank holds three :class:`~glfusion_tpu_torch.parallel.collectives.Axis`:
``data_axis`` (the ranks of its mesh column: the batch is split over it and
gradients summed over it), ``model_axis`` (its row: the chosen parameters
are split over it) and ``world_axis``. ``torch.distributed.new_group`` is
collective: every rank creates every group, in the same order, also those
it is not in.
"""

from __future__ import annotations

import dataclasses

import torch

from glfusion_tpu_torch.parallel.collectives import Axis


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int = 1
    model: int = 1
    rank: int = 0
    data_axis: Axis = Axis()
    model_axis: Axis = Axis()
    world_axis: Axis = Axis()

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def lead(self) -> bool:
        """The rank that logs and writes (global rank 0)."""
        return self.rank == 0

    @property
    def trivial(self) -> bool:
        return self.size == 1

    def divides(self, n: int) -> bool:
        """Whether a batch axis of ``n`` splits over ``data`` (else the
        batch is replicated, as JAX's ``shard_batch`` does)."""
        return self.data > 1 and n % self.data == 0


def _world() -> tuple[int, int, bool]:
    """(size, rank, joined) of the process group, or of one process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), True
    return 1, 0, False


def make_mesh(data: int = -1, model: int = 1,
              world_size: int | None = None) -> Mesh:
    """Build a (data, model) mesh over the world's ranks.

    ``data=-1`` consumes every rank not used by ``model``. ``world_size``
    sizes a mesh without a process group (its shape alone, rank 0, no
    groups); by default the world is the process group's, or 1.
    """
    n, rank, joined = _world()
    if world_size is not None:
        n, rank, joined = world_size, 0, False
    if model < 1:
        model = 1
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model={model}")
    if data == -1:
        data = n // model
    if data * model > n:
        raise ValueError(
            f"mesh (data={data}, model={model}) needs {data * model} "
            f"devices but only {n} are available")
    if data * model != n and joined:
        # the excluded ranks would still enter every collective and hang it
        raise ValueError(
            f"mesh (data={data}, model={model}) uses {data * model} of "
            f"{n} global devices; multi-process runs must use ALL "
            f"devices (every process enters the same program)")
    if not joined or n == 1:
        return Mesh(data=data, model=model, rank=rank)
    d, m = rank // model, rank % model
    dist = torch.distributed
    data_group = model_group = None
    # the same groups in the same order on every rank: columns, rows, world
    if data > 1:
        for col in range(model):
            g = dist.new_group([r * model + col for r in range(data)])
            if col == m:
                data_group = g
    if model > 1:
        for row in range(data):
            g = dist.new_group([row * model + c for c in range(model)])
            if row == d:
                model_group = g
    return Mesh(data=data, model=model, rank=rank,
                data_axis=Axis(data, d, data_group),
                model_axis=Axis(model, m, model_group),
                world_axis=Axis(n, rank, dist.group.WORLD))
