"""Data-parallel and fully sharded training over ``torch.distributed``
(counterpart of ``videotgb_tpu/parallel``: the ``dp`` and ``fsdp`` axes;
``tp``, ``pp`` and ``sp`` raise, ROADMAP.md queue 1 items 4-6)."""

from videotgb_torch.parallel.mesh import MeshConfig, create_mesh, local_mesh
from videotgb_torch.parallel.sharding import (
    logical_to_mesh,
    replicate,
    shard_batch,
    shard_params,
)

__all__ = [
    "MeshConfig",
    "create_mesh",
    "local_mesh",
    "logical_to_mesh",
    "replicate",
    "shard_batch",
    "shard_params",
]
