"""Probe tools of the port: each runs one hand-written kernel beside the
variants it was written to be compared with, at the shapes of the JAX
package's probe of the same name (``tools/*.py``), and prints its lines.

    python -m videotgb_torch.tools.lookupprobe       # kernel E
    python -m videotgb_torch.tools.lnprobe           # kernel F
    python -m videotgb_torch.tools.attnlayoutprobe   # kernel G
    python -m videotgb_torch.tools.int8pallas_probe  # kernel H, 8192^3
    python -m videotgb_torch.tools.int8sweep         # kernel H at ViT-g shapes
    python -m videotgb_torch.tools.int8probe         # ViT-g, bf16 vs W8A8

They run on the CUDA device unless given ``--device cpu``, which runs the
plain versions of the kernels on the CPU (use small shapes there).
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


def timed_loop(fn, iters: int, device) -> float:
    """Mean seconds per call of ``fn()`` over ``iters`` back-to-back calls
    after one warm-up call, the device synchronised before and after (the
    JAX probes' timing: the calls queue on the device without a host wait
    between them). Unlike :func:`timed` it reads nothing of the output: an
    f32 sum of a (65,792 x 6144) product would add ~20% to its time."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters
