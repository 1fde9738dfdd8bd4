"""Probe and trace tools of the port: each is the counterpart of the JAX
package's tool of the same name (``tools/*.py``), at its shapes and flags,
and prints its lines.

    python -m videotgb_torch.tools.lookupprobe       # kernel E
    python -m videotgb_torch.tools.lnprobe           # kernel F
    python -m videotgb_torch.tools.attnlayoutprobe   # kernel G
    python -m videotgb_torch.tools.int8pallas_probe  # kernel H, 8192^3
    python -m videotgb_torch.tools.int8sweep         # kernel H at ViT-g shapes
    python -m videotgb_torch.tools.int8probe         # ViT-g, bf16 vs W8A8
    python -m videotgb_torch.tools.traceprobe        # a serving segment traced
    python -m videotgb_torch.tools.traintraceprobe   # a training step traced
    python -m videotgb_torch.tools.perfprobe         # ViT layouts, segments
    python -m videotgb_torch.tools.qformerattnprobe  # Q-Former attention, A
    python -m videotgb_torch.tools.raftencprobe      # RAFT encoder stages
    python -m videotgb_torch.tools.stemprobe         # RAFT stem variants
    python -m videotgb_torch.tools.decodeprobe       # host video decode
    python -m videotgb_torch.tools.convert_checkpoint     # released weights
    python -m videotgb_torch.tools.build_llama_tokenizer  # the LLaMA asset

They run on the CUDA device unless given ``--device cpu``, which runs the
plain versions of the kernels on the CPU (use small shapes there);
``decodeprobe``, ``convert_checkpoint`` and ``build_llama_tokenizer`` run
on the host only.
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
