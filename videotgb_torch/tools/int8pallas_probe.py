"""int8 GEMM probe: kernel H (hand-written int8 and bf16 tensor-core GEMMs)
beside the library's int8 and bf16 products, at 8192^3.

The counterpart of the JAX package's ``tools/int8pallas_probe.py``, which
asked whether a custom int8 kernel beats the compiler's int8 dot, i.e.
whether the W8A8 serving path (``ops/quant.py``) gets its own kernel. Its
lines, on the card:

  * ``torch._int_mm`` int8 -> int32 -> bf16 (the probe's "xla int8" line;
    the library's int8 product, a yardstick the port never calls);
  * kernel H int8 (``csrc/int8_mm.cu``, bf16 epilogue) at each block tiling
    the CUDA source instantiates (``ops.quant.TILES``; the TPU probe's five
    VMEM block sizes have no meaning on the card);
  * kernel H bf16 (``csrc/bf16_mm.cu``) at each tiling, and
    ``torch.matmul`` in bf16.

The probe's w (K, N) is transposed once, outside the timed region, to the
(N, K) operand the kernels take; ``torch._int_mm`` gets the (K, N) view of
that same tensor. Each line gives ms (the mean over ``--iters`` calls
queued back to back) and TOP/s (TF/s for bf16).

    python -m videotgb_torch.tools.int8pallas_probe [--m 8192] [--k 8192]
        [--n 8192] [--iters 8] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.ops.quant import TILES, bf16_mm, int8_mm
from videotgb_torch.tools import timed_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=8192)
    ap.add_argument("--k", type=int, default=8192)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    m, k, n = args.m, args.k, args.n
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    wq_t = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                         dtype=torch.int8).t().contiguous()
    xb = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    wb_t = torch.randn((k, n), generator=gen, device=dev).to(
        torch.bfloat16).t().contiguous()
    flops = 2 * m * k * n
    out = {}

    def line(label, fn, unit):
        t = timed_loop(fn, args.iters, dev)
        out[label] = {"ms": t * 1e3, "rate": flops / t / 1e12}
        print(f"{label:34s}: {t * 1e3:8.3f} ms {flops / t / 1e12:7.1f} "
              f"{unit} on {dev}", flush=True)

    cube = f"{m}x{k}x{n}"
    line(f"torch._int_mm int8 {cube}",
         lambda: torch._int_mm(xq, wq_t.t()).to(torch.bfloat16), "TOP/s")
    for i, tile in enumerate(TILES):
        line(f"kernel H int8 {tile} -> bf16",
             lambda i=i: int8_mm(xq, wq_t, torch.bfloat16, tile=i), "TOP/s")
    for i, tile in enumerate(TILES):
        line(f"kernel H bf16 {tile}",
             lambda i=i: bf16_mm(xb, wb_t, tile=i), "TF/s")
    line(f"torch.matmul bf16 {cube}", lambda: xb @ wb_t.t(), "TF/s")
    return out


if __name__ == "__main__":
    main()
