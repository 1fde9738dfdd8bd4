"""The device mesh of a run (counterpart of
``videotgb_tpu/parallel/mesh.py``).

The JAX package names five mesh axes and lets GSPMD place the collectives:

  dp    - data parallel (batch rows split, gradients summed)
  fsdp  - parameter sharding (ZeRO-3: all-gather on use, reduce-scatter of
          the gradients)
  tp    - tensor parallel (attention heads / MLP hidden split)
  pp    - pipeline parallel (layer stages)
  sp    - sequence parallel (token-split residual streams)

Here each rank is one process on one device (``torch.distributed``), and
the mesh is a ``DeviceMesh`` over the world with dims ``("dp", "fsdp",
"tp", "pp", "sp")`` in the JAX mesh's order, ``sp`` innermost: the batch
splits over dp x fsdp (the ``tp``, ``pp`` and ``sp`` ranks of one dp x
fsdp position hold the same rows), parameters shard over ``fsdp`` and
replicate over ``dp`` (FSDP2 / HSDP, ``parallel.sharding.shard_params``),
serving slices heads, MLP hidden units and vocabularies over ``tp``
(``parallel.tensor.shard_tp``), training stages the layers of a
``scan_layers`` tower over ``pp`` (``parallel.pipeline.shard_pp``), and
the residual streams split their tokens over ``sp``
(``parallel.sequence.shard_sp``). The layouts the port does not run raise
``NotImplementedError`` naming the ROADMAP.md item that holds them: ``tp``
above 1 in training, ``fsdp`` above 1 beside ``tp`` or ``sp``, ``pp`` in
serving and ``pp`` beside ``tp``, ``fsdp`` or ``sp`` above 1. Axis sizes
multiply to the world size; the default layout (``dp=-1``) is
data-parallel over every rank, as the reference trains DDP x 4. The
coordinates are read by dim name (:func:`axis_rank`).
"""

from __future__ import annotations

import dataclasses
import math

DATA_AXIS = "dp"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tp"
PIPELINE_AXIS = "pp"
SEQUENCE_AXIS = "sp"
AXIS_NAMES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, PIPELINE_AXIS, SEQUENCE_AXIS)

# where the layouts this port does not run yet are queued
PP_SERVING = ("pipeline parallelism (pp, ROADMAP.md queue 1 item 5) trains "
              "only: serving and the QA CLI shard with dp/fsdp/tp/sp, as the "
              "JAX package's do")
PP_TP = ("pp and tp together (stages of tp-sliced layers) are ROADMAP.md "
         "queue 1 item 11")
PP_FSDP = ("pp and fsdp together (FSDP2 units over stage-held layers) are "
           "ROADMAP.md queue 1 item 12")
PP_SP = ("pp and sp together (token-split streams through the stages) are "
         "ROADMAP.md queue 1 item 13")
TP_TRAINING = ("tensor-parallel training (tp) is ROADMAP.md queue 1 item 4; "
               "the port serves tp layouts only")
FSDP_TP = ("fsdp and tp together (FSDP2 over a tp-sliced model) are "
           "ROADMAP.md queue 1 item 4")
FSDP_SP = ("fsdp and sp together (FSDP2 units over token-split streams) are "
           "ROADMAP.md queue 1 item 4")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh axis sizes; -1 means "absorb remaining devices" (like np.reshape)."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int, int]:
        sizes = [self.dp, self.fsdp, self.tp, self.pp, self.sp]
        wildcard = [i for i, s in enumerate(sizes) if s == -1]
        if len(wildcard) > 1:
            raise ValueError("at most one mesh axis may be -1")
        known = math.prod(s for s in sizes if s != -1)
        if wildcard:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {sizes}"
                )
            sizes[wildcard[0]] = n_devices // known
        if math.prod(sizes) != n_devices:
            raise ValueError(f"mesh {sizes} != device count {n_devices}")
        return tuple(sizes)  # type: ignore[return-value]


def parse_mesh_spec(spec: str, allow_pp: bool = True) -> MeshConfig:
    """Parse a CLI mesh string like ``"dp=2,tp=4"`` into a :class:`MeshConfig`.

    Unknown axis names (typos like ``ps=2``) raise instead of silently
    producing a default mesh. ``allow_pp=False`` rejects ``pp`` with a clear
    message for entry points that have no pipeline schedule (serving /
    batch inference shard with dp/fsdp/tp/sp only; pp lives in the trainer,
    parallel/pipeline.py).
    """
    kv: dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec item {part!r} (expected axis=size, "
                f"e.g. 'dp=2,tp=4')")
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in AXIS_NAMES:
            raise ValueError(
                f"unknown mesh axis {k!r}; valid axes: {', '.join(AXIS_NAMES)}")
        if k == PIPELINE_AXIS and not allow_pp:
            raise ValueError(
                "pp (pipeline parallel) is only available in the trainer "
                "(parallel/pipeline.py); shard serving/inference with "
                "dp/fsdp/tp/sp")
        try:
            kv[k] = int(v)
        except ValueError:
            raise ValueError(f"mesh axis size must be an int: {part!r}") from None
    return MeshConfig(**{**{"dp": 1}, **kv})


def check_ported(config: MeshConfig, serving: bool = False) -> None:
    """Raise ``NotImplementedError`` for a layout the port does not run:
    ``pp`` other than 1 in serving (``serving=True``), and beside a ``tp``,
    ``fsdp`` or ``sp`` above 1 (the JAX pipeline runs its stages with tp
    at 1, ``videotgb_tpu/parallel/pipeline.py:60-62``); ``tp`` above 1
    outside serving (``serving=False``: training and evaluation);
    ``fsdp`` above 1 beside a ``tp`` or an ``sp`` above 1. A -1 counts as
    above 1 (it could absorb ranks)."""
    if config.pp != 1:
        if serving:
            raise NotImplementedError(f"mesh axis pp={config.pp}: "
                                      f"{PP_SERVING}")
        for axis, why in (("tp", PP_TP), ("fsdp", PP_FSDP), ("sp", PP_SP)):
            if getattr(config, axis) != 1:
                raise NotImplementedError(
                    f"mesh pp={config.pp}, {axis}={getattr(config, axis)}: "
                    f"{why}")
    if config.tp != 1 and not serving:
        raise NotImplementedError(f"mesh axis tp={config.tp}: {TP_TRAINING}")
    if config.tp != 1 and config.fsdp != 1:
        raise NotImplementedError(
            f"mesh fsdp={config.fsdp}, tp={config.tp}: {FSDP_TP}")
    if config.sp != 1 and config.fsdp != 1:
        raise NotImplementedError(
            f"mesh fsdp={config.fsdp}, sp={config.sp}: {FSDP_SP}")


def mesh_layout(config: MeshConfig, world: int):
    """The ranks of a world laid out as the mesh, an int array of shape
    (dp, fsdp, tp, pp, sp): row-major, ``sp`` innermost, as the JAX package
    reshapes its device list (``videotgb_tpu/parallel/mesh.py:104-124``)."""
    import numpy as np

    return np.arange(world).reshape(config.resolve(world))


def create_mesh(config: MeshConfig | None = None,
                device_type: str | None = None, serving: bool = False):
    """The ``("dp", "fsdp", "tp", "pp", "sp")`` ``DeviceMesh`` over the process
    group's world (:func:`mesh_layout`), its sizes from ``config`` resolved
    against the world size.

    Returns None in a single process with no process group (one device
    needs no mesh); a layout :func:`check_ported` refuses raises (``tp``
    above 1 only where ``serving``). ``device_type`` is where the ranks'
    tensors live (FSDP2 places its shards there): by default "cuda" on an
    NCCL group, else "cpu"; a gloo group also carries CUDA tensors, through
    the host."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    config = config or MeshConfig()
    check_ported(config, serving=serving)
    if not (dist.is_available() and dist.is_initialized()):
        config.resolve(1)  # a layout that wants more ranks raises here
        return None
    layout = mesh_layout(config, dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.from_numpy(layout),
                      mesh_dim_names=AXIS_NAMES)


def local_mesh(n: int | None = None, **axis_sizes: int):
    """The mesh of :func:`create_mesh` from axis sizes (tests / single-host
    runs); ``n``, where given, must be the world size."""
    import torch.distributed as dist

    cfg = MeshConfig(**axis_sizes) if axis_sizes else MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n is not None and n != world:
        raise ValueError(f"local_mesh over {n} devices in a world of {world} "
                         "ranks: each rank is one device")
    return create_mesh(cfg)


def axis_rank(mesh, axis: str) -> tuple[int, int]:
    """(this rank's index on the mesh dim named ``axis``, the dim's size);
    (0, 1) without a mesh, or on a mesh that lacks the dim. The dim is
    looked up in the mesh's ``mesh_dim_names`` (``AXIS_NAMES`` for a mesh
    without names, as ``create_mesh`` orders them)."""
    if mesh is None:
        return 0, 1
    names = getattr(mesh, "mesh_dim_names", None) or AXIS_NAMES
    coord = mesh.get_coordinate()
    dim = names.index(axis) if axis in names else len(coord)
    if dim >= len(coord):
        return 0, 1
    return coord[dim], mesh.size(dim)


def mesh_rank(mesh) -> tuple[int, int]:
    """(this rank's index in the batch split, the split's size): the
    row-major position over ``("dp", "fsdp")``; (0, 1) without a mesh. The
    ``tp``, ``pp`` and ``sp`` ranks of one position share it: they hold
    the same rows."""
    dp_i, dp = axis_rank(mesh, DATA_AXIS)
    fsdp_i, fsdp = axis_rank(mesh, FSDP_AXIS)
    return dp_i * fsdp + fsdp_i, dp * fsdp


def tp_rank(mesh) -> tuple[int, int]:
    """(this rank's index on the ``tp`` axis, the axis's size); (0, 1)
    without a mesh."""
    return axis_rank(mesh, TENSOR_AXIS)


def pp_rank(mesh) -> tuple[int, int]:
    """(this rank's stage on the ``pp`` axis, the axis's size); (0, 1)
    without a mesh."""
    return axis_rank(mesh, PIPELINE_AXIS)


def sp_rank(mesh) -> tuple[int, int]:
    """(this rank's index on the ``sp`` axis, the axis's size); (0, 1)
    without a mesh. The ``sp`` ranks of one dp x fsdp position hold the
    same rows, and each holds its own slice of their tokens."""
    return axis_rank(mesh, SEQUENCE_AXIS)
