"""Probe tools of the port: each runs one hand-written kernel beside the
variants it was written to be compared with, at the shapes of the JAX
package's probe of the same name (``tools/*.py``), and prints its lines.

    python -m videotgb_torch.tools.lookupprobe      # kernel E
    python -m videotgb_torch.tools.lnprobe          # kernel F
    python -m videotgb_torch.tools.attnlayoutprobe  # kernel G

They run on the CUDA device unless given ``--device cpu``.
"""

import statistics
import time

import torch


def timed(fn, iters: int = 5) -> float:
    """Median seconds of ``fn()`` after one warm-up call; ``float()`` of the
    result's f32 sum waits for the device."""
    float(fn().sum(dtype=torch.float32))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(fn().sum(dtype=torch.float32))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)
