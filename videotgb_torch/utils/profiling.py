"""Profiling hooks (the port's ``videotgb_tpu/utils/profiling.py``).

* :func:`trace` - the ``debug=profiler`` trace around ``fit`` (the
  counterpart of the ``jax.profiler`` trace that ``videotgb_tpu/train.py``
  wraps around it; reference configs/debug/profiler.yaml).
* :func:`timed` - the median wall time of a call after warm-up, the device
  synchronised after each call (in place of the JAX module's host fetch).
* :func:`decode_throughput` - the host video-decode microbenchmark
  (reference demo/debug.py:8-25).
* :func:`device_events`, :func:`summarize` and :func:`traced` - device
  time by operation and by kernel family from a ``torch.profiler`` run, the
  counterpart of ``tools/traceprobe.py::summarize``. On the card an
  operation is a CUDA kernel, copy or set; on the CPU it is an operator's
  self time (its children's time excluded, so nothing counts twice).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Iterable

import torch

from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.profile")

# kernel families of a trace, by substrings of the kernels' names; the rest
# is OTHER
FAMILIES = {
    "kernel D": ("select_frames_kernel",),
    "kernels B/E": ("corr_tile::tile_kernel", "corr_gather_kernel"),
    "kernel C": ("bwd_one_pass", "bwd_rows", "bwd_cols"),
    "kernel H": ("gemm_kernel",),
    "kernel A": ("flash_mma_kernel", "flash_fma_kernel"),
    "cuBLAS/cuDNN": ("gemm", "xmma", "cutlass", "nvjet", "conv", "cudnn"),
}
OTHER = "eager elementwise/reductions/copies"


@contextlib.contextmanager
def trace(trace_dir: str, device: torch.device):
    """Profile the enclosed work with ``torch.profiler`` (host operations,
    and the card's kernels when ``device`` is CUDA) and write a Chrome trace
    to ``<trace_dir>/fit.pt.trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "fit.pt.trace.json")
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    log.info("profile trace written to %s", path)


def synchronize() -> None:
    """Wait for the card's queued work, where the process has used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, iters: int = 5, warmup: int = 1,
          **kwargs) -> tuple[float, Any]:
    """(median wall seconds of ``fn(*args, **kwargs)``, its last output):
    ``warmup`` untimed calls, then ``iters`` timed ones, each ended by a
    device synchronise."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


def decode_throughput(path: str, num_frames: int = 32, size: int = 224,
                      iters: int = 3) -> dict[str, float]:
    """Host video-decode microbenchmark (demo/debug.py:8-25 measured 19.3 s
    per video in the reference)."""
    from videotgb_torch.data.video_io import read_video_cv2

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        read_video_cv2(path, num_frames=num_frames, size=(size, size))
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    return {"decode_s": med, "frames_per_s": num_frames / med}


def family(name: str) -> str:
    """The kernel family (``FAMILIES``) of an operation's name, or OTHER."""
    return next((f for f, keys in FAMILIES.items()
                 if any(k in name for k in keys)), OTHER)


def device_events(prof, device) -> list[tuple[str, float]]:
    """(name, ms) of every device operation of a finished
    ``torch.profiler.profile``: on a CUDA ``device`` its kernels, copies and
    sets; on the CPU each operator's self time. User annotations (the
    optimizer's ``record_function`` spans, which the profiler also puts on
    the device's timeline) cover operations and are not counted."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if not e.is_user_annotation]
    if torch.device(device).type == "cuda":
        return [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in events if e.device_type == DeviceType.CUDA]
    return [(e.name, e.self_cpu_time_total / 1e3) for e in events
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0]


def summarize(events: Iterable[tuple[str, float]],
              wall_ms: float | None = None) -> dict:
    """Device time of ``events`` ((name, ms) pairs) grouped by name and by
    family: ``{"device_total_ms", "wall_ms", "ops", "by_name",
    "families"}``, each group ``{"ms", "n", "pct"}`` (``pct`` of the total),
    names ordered by time, families in ``FAMILIES`` order with OTHER
    last."""
    by_name: dict[str, dict] = {}
    families = {f: {"ms": 0.0, "n": 0} for f in (*FAMILIES, OTHER)}
    total, ops = 0.0, 0
    for name, ms in events:
        row = by_name.setdefault(name, {"ms": 0.0, "n": 0})
        row["ms"] += ms
        row["n"] += 1
        fam = families[family(name)]
        fam["ms"] += ms
        fam["n"] += 1
        total += ms
        ops += 1
    for row in (*by_name.values(), *families.values()):
        row["pct"] = 100.0 * row["ms"] / total if total else 0.0
    ordered = dict(sorted(by_name.items(), key=lambda kv: -kv[1]["ms"]))
    return {"device_total_ms": total, "wall_ms": wall_ms, "ops": ops,
            "by_name": ordered, "families": families}


def traced(fn: Callable, device, reps: int = 1,
           trace_path: str | None = None) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler``, the device
    synchronised before and after: :func:`summarize` of their device
    operations with the synchronised wall of the traced calls (the trace's
    own cost included). Python stacks and shapes are not recorded: host
    events crowd a long trace. ``trace_path`` also writes the Chrome trace
    there."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    synchronize()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        synchronize()
        wall = (time.perf_counter() - t) * 1e3
    if trace_path is not None:
        prof.export_chrome_trace(trace_path)
    out = summarize(device_events(prof, device), wall)
    out["trace"] = trace_path
    return out


def print_summary(summary: dict, top: int = 40) -> None:
    """The JAX trace probe's JSON lines: ``{"device_total_ms", "trace"}``
    with the synchronised ``wall_ms`` added, then ``{"op", "ms", "n",
    "pct"}`` for the ``top`` operations by device time."""
    print(json.dumps({"device_total_ms": round(summary["device_total_ms"], 3),
                      "trace": summary.get("trace"),
                      "wall_ms": round(summary["wall_ms"], 3)}), flush=True)
    for name, row in list(summary["by_name"].items())[:top]:
        print(json.dumps({"op": name[:110], "ms": round(row["ms"], 3),
                          "n": row["n"], "pct": round(row["pct"], 1)}),
              flush=True)
