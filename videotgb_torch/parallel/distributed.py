"""Process groups, process-sharded work lists and the launcher of the
layouts that ask for more ranks than the caller started (counterpart of
``videotgb_tpu/parallel/distributed.py``).

Each rank is one process on one device. Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` in the
environment) :func:`initialize` joins the group: NCCL with
``torch.cuda.set_device(LOCAL_RANK)`` on the card, gloo on the CPU. Without
a launcher, :func:`spawn` starts the ranks itself (the reference's
``ddp_spawn`` and ``ddp_sim`` strategies): a localhost rendezvous,
``start_method="spawn"``, and an error if any rank fails or the time
limit passes, every rank then killed.

Process-sharded inference (the reference's --num_chunks CLI loop,
eval/inference.py:21-29) maps to :func:`process_chunk`.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import socket
import time

import torch
import torch.distributed as dist

from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.dist")

# a collective that waits longer than this raises instead of hanging
COLLECTIVE_TIMEOUT_S = 600


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


_index, _count = process_index, process_count


def is_coordinator() -> bool:
    return process_index() == 0


def env_world() -> int:
    """``WORLD_SIZE`` of a launcher's environment; 1 without one."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def initialize(backend: str | None = None, device_type: str = "cuda",
               timeout_s: float = COLLECTIVE_TIMEOUT_S) -> bool:
    """Join the process group the environment describes. Idempotent: a
    no-op when the group exists, and at world 1. ``backend`` defaults to
    NCCL for ``device_type="cuda"`` and gloo for "cpu"; NCCL first sets
    the rank's device to ``cuda:{LOCAL_RANK}``. Returns whether a group of
    more than one rank is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = env_world()
    if world <= 1:
        return False
    rank = int(os.environ["RANK"])
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    kwargs = {}
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        if backend == "nccl":
            kwargs["device_id"] = torch.device(
                "cuda", torch.cuda.current_device())
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ["MASTER_PORT"]
    dist.init_process_group(
        backend, init_method=f"tcp://{addr}:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        **kwargs)
    log.info("distributed: rank %d/%d on %s", rank, world, backend)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_chunk(items: list, process_index: int | None = None,
                  process_count: int | None = None) -> list:
    """Shard a work list across processes (contiguous chunks, matching the
    reference's split semantics, eval/inference.py:12-29)."""
    p = process_index if process_index is not None else _index()
    n = process_count if process_count is not None else _count()
    chunk = math.ceil(len(items) / n)
    return items[p * chunk : (p + 1) * chunk]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, nprocs, port, backend, device_type,
               device_ids, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(device_ids[rank]),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    initialize(backend, device_type)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        shutdown()
    if rank == 0:  # plain pickle: no shared memory outlives the rank
        results.put(pickle.dumps(out))


def spawn(fn, nprocs: int, backend: str, args: tuple = (),
          device_type: str = "cpu", device_ids: list[int] | None = None,
          timeout_s: float | None = None):
    """Run ``fn(*args)`` in ``nprocs`` new processes joined over
    ``backend`` on a localhost rendezvous, and return rank 0's result.
    ``device_ids[r]`` is rank r's ``LOCAL_RANK`` (default r; two ranks may
    share a card over gloo, not over NCCL). Raises if a rank raises, dies,
    or the ranks outlive ``timeout_s``: every rank is then killed."""
    import torch.multiprocessing as mp

    device_ids = list(device_ids or range(nprocs))
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(fn, args, nprocs, free_port(), backend,
                          device_type, device_ids, results),
        nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out = None
    try:
        while True:
            if not results.empty():  # read as it comes: a full pipe blocks
                out = results.get()
            if procs.join(timeout=0.5):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks outlived {timeout_s} s")
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.kill()
                p.join()
    if out is None:
        out = results.get()
    return pickle.loads(out)


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (the object itself in one process)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` in one process)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()
