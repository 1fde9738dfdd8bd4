"""Parallel layouts over ``torch.distributed`` (counterpart of
``videotgb_tpu/parallel``): data-parallel and fully sharded training (the
``dp`` and ``fsdp`` axes), tensor-parallel serving (``tp``), pipeline
parallelism in training (``pp``) and sequence parallelism in training and
serving (``sp``)."""

from videotgb_torch.parallel.mesh import MeshConfig, create_mesh, local_mesh
from videotgb_torch.parallel.sharding import (
    logical_to_mesh,
    replicate,
    shard_batch,
    shard_params,
)
from videotgb_torch.parallel.pipeline import (
    active_pp_mesh,
    pipeline_apply,
    place_pipeline_params,
    shard_pp,
)
from videotgb_torch.parallel.sequence import shard_sp
from videotgb_torch.parallel.tensor import shard_tp, tp_shard_state_dict

__all__ = [
    "MeshConfig",
    "active_pp_mesh",
    "create_mesh",
    "local_mesh",
    "logical_to_mesh",
    "pipeline_apply",
    "place_pipeline_params",
    "replicate",
    "shard_batch",
    "shard_params",
    "shard_pp",
    "shard_sp",
    "shard_tp",
    "tp_shard_state_dict",
]
