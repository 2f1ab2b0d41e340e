"""Production mesh construction (counterpart of ``repro.launch.mesh``).

``make_production_mesh`` is a FUNCTION (not a module-level constant), so
importing this module touches no device and no process group: the
caller initialises ``torch.distributed`` first (``init_process_group``
with its address, world size and rank; the ``fake`` backend for a dry
run on one host) and then builds the mesh over the group's ranks.

Mesh shapes, as the reference lays them out for its TPU v5e pods (the
reference's numbers, not measurements of this port):
    single-pod: (16, 16)    axes ("data", "model")   — 256 ranks
    multi-pod : (2, 16, 16) axes ("pod", "data", "model") — 512 ranks

Axis semantics (bound by repro_torch.parallel.sharding.DEFAULT_RULES):
    pod   — data parallelism across pods
    data  — FSDP + expert parallelism + batch DP inside a pod
    model — tensor parallelism / sequence parallelism inside a pod
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ``("data", "model")`` mesh, or (2, 16, 16) over
    ``("pod", "data", "model")``; needs a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """Every rank of the initialised group as a 1D ``("data",)`` mesh."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
