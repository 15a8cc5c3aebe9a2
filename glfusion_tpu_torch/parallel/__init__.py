"""Multi-process training: the (data, model) mesh, its sharding rule and the
collectives (the port of ``glfusion_tpu/parallel/``).

JAX lays a ``jax.sharding.Mesh`` over its devices and lets GSPMD insert the
collectives. The port runs one process a device (``utils/cluster.py``) and
writes them out: ``collectives.py`` (gathers and sums built from
``all_reduce``), ``norm.py`` (BatchNorm over the global batch),
``sharding.py`` (which leaves split over ``model``, the batch's slice of
each rank, gradient sums) and ``context.py`` (whether the pass in flight
has its batch split).
"""

from glfusion_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from glfusion_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_batch,
    shard_module,
)
