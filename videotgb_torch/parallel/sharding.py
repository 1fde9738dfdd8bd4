"""Batch and parameter placement over the ``("dp", "fsdp")`` mesh
(counterpart of ``videotgb_tpu/parallel/sharding.py``).

The JAX package annotates parameters with logical axis names and lets
GSPMD shard a global batch and the losses over it. Here each rank holds
its rows of every global batch and the model, whole (``dp``) or sharded by
FSDP2 (``fsdp``, :func:`shard_params`), and three things keep a step at
world N equal to the JAX step on the global batch:

* :func:`global_count`: a loss that divides a sum over valid entries by
  their count (span CE, the LM CE) divides by the count over every rank,
  so the sum over ranks of the ranks' losses is the global loss, and the
  sum of their gradients its gradient;
* :func:`global_draw`: a random draw over batch rows (dropout masks, the
  Gumbel noise of the selection) draws the global batch's tensor and keeps
  this rank's rows; kernel D takes :func:`row_offset` for its Philox
  counter;
* :func:`all_reduce_sum`: the gradients (on the data-parallel route), the
  loss and the aux scalars summed over ranks.

All three read the split that :func:`batch_split` sets; outside it (one
process) they are the identity.
"""

from __future__ import annotations

import contextlib
import threading
import types
from typing import Any

import numpy as np
import torch

from videotgb_torch.parallel.mesh import (
    DATA_AXIS, FSDP_AXIS, PIPELINE_AXIS, TENSOR_AXIS, mesh_rank)

# rules: logical axis name -> mesh axis (or None = replicate)
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", (DATA_AXIS, FSDP_AXIS)),
    ("embed", FSDP_AXIS),
    ("heads", TENSOR_AXIS),
    ("kv", None),
    ("mlp", TENSOR_AXIS),
    ("vocab", TENSOR_AXIS),
    ("conv_in", None),
    ("conv_out", None),
    ("seq", None),
    # stacked axis from nn.scan-over-layers: stage-sharded when the mesh has
    # a pp extent (size-1 pp axes make this a no-op on non-pipelined meshes)
    ("layers", PIPELINE_AXIS),
)


def logical_to_mesh(logical_spec, rules=DEFAULT_RULES) -> tuple:
    """Logical axis names (a tuple, or a JAX ``PartitionSpec``) -> mesh
    axes, as a tuple: each name maps through ``rules``, a tuple of names
    to the flattened tuple of their mesh axes (None where none maps)."""
    table = dict(rules)
    axes = []
    for name in logical_spec:
        if name is None:
            axes.append(None)
        elif isinstance(name, (tuple, list)):
            flat = []
            for sub in name:
                mapped = table.get(sub)
                if mapped is None:
                    continue
                flat.extend(mapped if isinstance(mapped, tuple) else (mapped,))
            axes.append(tuple(flat) if flat else None)
        else:
            axes.append(table.get(name))
    return tuple(axes)


# ------------------------------------------------------------- the split
# per thread: .split, (this rank's index, ranks) or None; .lockstep
_STATE = threading.local()


def _split():
    return getattr(_STATE, "split", None)


@contextlib.contextmanager
def batch_split(mesh, lockstep: bool = False):
    """Within the block, batches are this rank's rows of global batches
    split over ``mesh``'s dp x fsdp ranks (nothing changes without a
    mesh; on a mesh of one rank the collectives run on that rank alone).
    ``lockstep``: a host loop that stops on a device flag (a decode) stops
    on every rank together, when every rank's flag is set
    (:func:`all_ranks`), as a sharded model's gathers need."""
    prev = _split(), getattr(_STATE, "lockstep", False)
    _STATE.split = None if mesh is None else mesh_rank(mesh)
    _STATE.lockstep = lockstep and _STATE.split is not None
    try:
        yield
    finally:
        _STATE.split, _STATE.lockstep = prev


def all_ranks(flag: torch.Tensor) -> torch.Tensor:
    """A 0-dim bool flag set on every rank, under a lockstep split (a
    collective); the flag itself otherwise."""
    if not getattr(_STATE, "lockstep", False):
        return flag
    out = flag.to(torch.int32).reshape(1).clone()
    torch.distributed.all_reduce(out, op=torch.distributed.ReduceOp.MIN)
    return out[0].bool()


def split() -> tuple[int, int]:
    """(this rank's index, ranks) of the active split; (0, 1) without one."""
    return _split() or (0, 1)


def global_count(count: torch.Tensor) -> torch.Tensor:
    """``count`` summed over the ranks of the active split (a collective:
    every rank calls it at the same point); ``count`` itself without one."""
    if _split() is None:
        return count
    total = count.detach().clone()
    torch.distributed.all_reduce(total)
    return total


def global_draw(draw, shape, axis: int = 0) -> torch.Tensor:
    """``draw(shape)`` where ``shape[axis]`` is this rank's rows: under a
    split, ``draw`` makes the global batch's tensor (``shape[axis]`` times
    the ranks) and this rank's rows of it are returned, so each row gets
    the numbers it gets at world 1."""
    if _split() is None:
        return draw(tuple(shape))
    rank, world = _split()
    rows = shape[axis]
    full = list(shape)
    full[axis] = rows * world
    return draw(tuple(full)).narrow(axis, rank * rows, rows)


def local_rows(x: torch.Tensor, rows: int, axis: int = 0) -> torch.Tensor:
    """This rank's ``rows`` of a tensor that holds the global batch along
    ``axis`` (a caller's handed-in noise); ``x`` when it holds ``rows``."""
    if _split() is None or x.shape[axis] == rows:
        return x
    rank, world = _split()
    if x.shape[axis] != rows * world:
        raise ValueError(f"a tensor of {x.shape[axis]} rows along axis "
                         f"{axis} is neither this rank's {rows} nor the "
                         f"global batch's {rows * world}")
    return x.narrow(axis, rank * rows, rows)


def row_offset(rows: int) -> int:
    """The global index of this rank's first row (kernel D's Philox
    counter), for a split of ``rows`` rows a rank."""
    return split()[0] * rows


def all_reduce_sum(tensors: list[torch.Tensor],
                   bucket_bytes: int = 256 << 20) -> None:
    """Sum each tensor over the ranks, in place: flattened into buckets of
    one dtype up to ``bucket_bytes``, one ``all_reduce`` a bucket."""
    buckets: dict[torch.dtype, list[list[torch.Tensor]]] = {}
    for t in tensors:
        groups = buckets.setdefault(t.dtype, [[]])
        size = sum(x.numel() for x in groups[-1]) * t.element_size()
        if groups[-1] and size + t.numel() * t.element_size() > bucket_bytes:
            groups.append([])
        groups[-1].append(t)
    for groups in buckets.values():
        for group in groups:
            flat = torch.cat([t.reshape(-1) for t in group])
            torch.distributed.all_reduce(flat)
            for t, piece in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(piece.view_as(t))


# ------------------------------------------------------------- placement
def shard_batch(batch: Any, mesh, axis: int = 0) -> Any:
    """This rank's rows of a global batch: every tensor or array leaf split
    along ``axis`` over the dp x fsdp ranks (``axis=1``: a
    steps-per-dispatch window stacked (K, B, ...)). A leaf whose ``axis``
    does not divide by the ranks (scalars, per-step constants) goes whole
    to every rank, as the JAX placement replicates it."""
    rank, world = mesh_rank(mesh)

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        if (isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > axis
                and x.shape[axis] % world == 0):
            rows = x.shape[axis] // world
            index = [slice(None)] * axis + [slice(rank * rows,
                                                  (rank + 1) * rows)]
            return x[tuple(index)]
        return x

    return put(batch)


def fsdp_units(model: torch.nn.Module) -> list[torch.nn.Module]:
    """The modules :func:`shard_params` wraps below the root: every
    transformer block and RAFT."""
    from videotgb_torch.models.llama import LlamaBlock
    from videotgb_torch.models.qformer import QFormerLayer
    from videotgb_torch.models.raft import RAFT
    from videotgb_torch.models.t5 import T5Block
    from videotgb_torch.models.tgb import TGBLayer
    from videotgb_torch.models.vit import ViTLayer

    kinds = (ViTLayer, QFormerLayer, T5Block, LlamaBlock, TGBLayer, RAFT)
    return [m for m in model.modules() if isinstance(m, kinds)]


def _root_call(self, fn, *args, **kwargs):
    return fn(self, *args, **kwargs)


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """FSDP2 on ``model`` in place: ``fully_shard`` on each transformer
    block (ViT, Q-Former, T5, LLaMA, TGB), on RAFT as one unit and on the
    root, sharded over the mesh's ``fsdp`` dim and replicated over ``dp``
    (HSDP where both exceed 1). Frozen parameters shard with the rest, as
    the JAX fsdp axis shards them. A unit's parameters are gathered when
    its forward runs; RAFT's ``consecutive`` and the root's ``root_call``
    (see :func:`sharded_call`) count as forwards. A unit is resharded after
    its forward and gathered again for its backward.

    FSDP2 passes the inputs a unit takes with a gradient through one
    autograd node, so the unit's gradient contributions to such an input
    (a T5 decoder block's K and V projections of the encoder output) are
    summed before they join the other units': in bf16 the gradients round
    otherwise than the unwrapped model's, by about a bf16 step in the
    leaves behind that input."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)

    if mesh is None or mesh[FSDP_AXIS].size() == 1:
        raise ValueError("shard_params needs a mesh with an fsdp extent "
                         "above 1")
    place = mesh if mesh[DATA_AXIS].size() > 1 else mesh[FSDP_AXIS]
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=place)
        if hasattr(unit, "consecutive"):
            register_fsdp_forward_method(unit, "consecutive")
    model.root_call = types.MethodType(_root_call, model)
    fully_shard(model, mesh=place)
    register_fsdp_forward_method(model, "root_call")
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    return hasattr(model, "root_call")


def sharded_call(model: torch.nn.Module, fn, *args, **kwargs):
    """``fn(model, *args, **kwargs)``; on a model under
    :func:`shard_params`, run as the root's forward, so the root unit's
    parameters (embeddings, norms, projections outside the blocks) are
    gathered for it and its backward reduces their gradients."""
    if is_sharded(model):
        return model.root_call(fn, *args, **kwargs)
    return fn(model, *args, **kwargs)


def _shard_axis(t):
    """(process group, index, size) of the mesh dim a DTensor shards its
    dim 0 over (FSDP2's placement, replicated on any other dim)."""
    from torch.distributed.tensor import Shard

    dims = [d for d, p in enumerate(t.placements) if isinstance(p, Shard)]
    if len(dims) != 1 or t.placements[dims[0]].dim != 0:
        raise ValueError(f"a DTensor sharded as {t.placements}: FSDP2 "
                         "shards dim 0 over one mesh dim")
    mesh = t.device_mesh
    return (mesh.get_group(dims[0]), mesh.get_local_rank(dims[0]),
            mesh.size(dims[0]))


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of an FSDP2 shard (a collective every rank of its
    mesh dim joins), or ``t`` itself when it is not a DTensor. The ranks'
    chunks (``torch.chunk`` of dim 0, the last ones short or empty) are
    padded to one size and gathered with ``all_gather_into_tensor``:
    ``DTensor.full_tensor`` waits on functional collectives, which end the
    process with a segmentation fault over gloo on CUDA tensors (torch
    2.11)."""
    if not hasattr(t, "to_local"):
        return t
    group, rank, world = _shard_axis(t)
    local = t.detach().to_local()
    rows = -(-t.shape[0] // world)
    padded = local.new_zeros((rows, *t.shape[1:]))
    padded[:local.shape[0]] = local
    out = local.new_empty((rows * world, *t.shape[1:]))
    torch.distributed.all_gather_into_tensor(out, padded, group=group)
    return out[:t.shape[0]]


def shard_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of the whole tensor ``full`` as a DTensor placed
    as the DTensor ``like`` (no communication)."""
    from torch.distributed.tensor import DTensor

    _, rank, world = _shard_axis(like)
    rows = -(-like.shape[0] // world)
    piece = full[rank * rows:min((rank + 1) * rows, full.shape[0])]
    return DTensor.from_local(
        piece.to(device=like.device, dtype=like.dtype).contiguous(),
        like.device_mesh, like.placements, run_check=False,
        shape=like.shape, stride=like.stride())


def replicate(tree: Any, mesh=None) -> Any:
    """Every tensor of ``tree`` made rank 0's on every rank, in place
    (``broadcast`` from rank 0); the tree itself without a process group."""
    if not torch.distributed.is_initialized():
        return tree
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            leaves.append(x)

    walk(tree)
    with torch.no_grad():
        for t in leaves:
            torch.distributed.broadcast(t, src=0)
    return tree
