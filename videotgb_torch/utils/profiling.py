"""The ``debug=profiler`` trace (counterpart of the ``jax.profiler`` trace
that ``videotgb_tpu/train.py`` wraps around ``fit``; reference
configs/debug/profiler.yaml, trainer.profiler="simple")."""

from __future__ import annotations

import contextlib
import os

import torch

from videotgb_torch.utils.logging import get_logger

log = get_logger("videotgb_torch.profile")


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
