"""The device mesh of a training run (counterpart of
``videotgb_tpu/parallel/mesh.py``).

The JAX package names five mesh axes and lets GSPMD place the collectives:

  dp    - data parallel (batch rows split, gradients summed)
  fsdp  - parameter sharding (ZeRO-3: all-gather on use, reduce-scatter of
          the gradients)
  tp    - tensor parallel (attention heads / MLP hidden split)
  pp    - pipeline parallel (layer stages)
  sp    - sequence parallel (token-split residual streams)

Here each rank is one process on one device (``torch.distributed``), and
the mesh is a ``DeviceMesh`` over the world with dims ``("dp", "fsdp")``:
the batch splits over both, parameters shard over ``fsdp`` and replicate
over ``dp`` (FSDP2 / HSDP, ``parallel.sharding.shard_params``). ``tp``,
``pp`` and ``sp`` above 1 raise ``NotImplementedError`` naming the
ROADMAP.md item that holds them. Axis sizes multiply to the world size;
the default layout (``dp=-1``) is data-parallel over every rank, as the
reference trains DDP x 4.
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

# where the axes this port does not run yet are queued
UNPORTED = {
    TENSOR_AXIS: "tensor parallelism (tp) is ROADMAP.md queue 1 item 4",
    PIPELINE_AXIS: "pipeline parallelism (pp) is ROADMAP.md queue 1 item 5",
    SEQUENCE_AXIS: "sequence parallelism (sp) is ROADMAP.md queue 1 item 6",
}


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


def check_ported(config: MeshConfig) -> None:
    """Raise ``NotImplementedError`` for a ``tp``, ``pp`` or ``sp`` extent
    above 1 (or -1, which could absorb devices into one of them)."""
    for axis, why in UNPORTED.items():
        size = getattr(config, axis)
        if size not in (1,):
            raise NotImplementedError(
                f"mesh axis {axis}={size}: the port trains dp and fsdp "
                f"layouts only; {why}")


def create_mesh(config: MeshConfig | None = None,
                device_type: str | None = None):
    """The ``("dp", "fsdp")`` ``DeviceMesh`` over the process group's
    world, its sizes from ``config`` resolved against the world size.

    Returns None in a single process with no process group (one device
    needs no mesh); ``tp``, ``pp`` or ``sp`` above 1 raise.
    ``device_type`` is where the ranks' tensors live (FSDP2 places its
    shards there): by default "cuda" on an NCCL group, else "cpu"; a gloo
    group also carries CUDA tensors, through the host."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    check_ported(config)
    if not (dist.is_available() and dist.is_initialized()):
        config.resolve(1)  # a layout that wants more ranks raises here
        return None
    world = dist.get_world_size()
    dp, fsdp, _, _, _ = config.resolve(world)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dp, fsdp),
                            mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


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


def mesh_rank(mesh) -> tuple[int, int]:
    """(this rank's index in the batch split, the split's size): the
    row-major position over ``("dp", "fsdp")``; (0, 1) without a mesh."""
    if mesh is None:
        return 0, 1
    dp_i, fsdp_i = mesh.get_coordinate()
    fsdp = mesh.size(1)
    return dp_i * fsdp + fsdp_i, mesh.size()
