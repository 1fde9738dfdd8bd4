"""Parallel layouts over ``torch.distributed`` (counterpart of
``videotgb_tpu/parallel``): data-parallel and fully sharded training (the
``dp`` and ``fsdp`` axes), tensor-parallel serving (``tp``) and sequence
parallelism in training and serving (``sp``); ``pp`` raises, ROADMAP.md
queue 1 item 5."""

from videotgb_torch.parallel.mesh import MeshConfig, create_mesh, local_mesh
from videotgb_torch.parallel.sharding import (
    logical_to_mesh,
    replicate,
    shard_batch,
    shard_params,
)
from videotgb_torch.parallel.sequence import shard_sp
from videotgb_torch.parallel.tensor import shard_tp, tp_shard_state_dict

__all__ = [
    "MeshConfig",
    "create_mesh",
    "local_mesh",
    "logical_to_mesh",
    "replicate",
    "shard_batch",
    "shard_params",
    "shard_sp",
    "shard_tp",
    "tp_shard_state_dict",
]
