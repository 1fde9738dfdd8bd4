"""int8 against bf16 matmul at ViT-g serving shapes: where the W8A8 path's
time goes.

The counterpart of the JAX package's ``tools/int8sweep.py``. For each shape
(x (M, K) times w (K, N), M = 256 frames x 257 tokens) it prints five
lines, separating the costs of ``ops.quant.int8_matmul``:

  * bf16: ``x @ w`` (``torch.matmul``);
  * int8 pure: pre-quantized operands through kernel H, bf16 epilogue;
  * int8 +dequant: kernel H's int32 accumulator times the scales' outer
    product, cast to bf16;
  * int8 +dyn act: the activation quantized at run time too;
  * int8 full dyn: ``int8_matmul`` as the serving path runs it (weights
    quantized on every call as well).

w is made (K, N) as the (K, N) view of an (N, K) tensor, the layout of the
port's dense weights, so the quantized weight reaches kernel H without a
copy. Each line gives ms (the mean over ``--iters`` calls queued back to
back) and TOP/s (TF/s for bf16).

    python -m videotgb_torch.tools.int8sweep [--iters 8] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.ops.quant import (
    int8_matmul,
    int8_mm,
    quantize_cols,
    quantize_rows,
)
from videotgb_torch.tools import timed_loop

SHAPES = [
    # (M, K, N, label)
    (65792, 1408, 6144, "vit mlp wi  (256f)"),
    (65792, 6144, 1408, "vit mlp wo  (256f)"),
    (65792, 1408, 4224, "vit qkv     (256f)"),
    (8192, 8192, 8192, "8k cube"),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for m, k, n, label in SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((n, k), generator=gen, device=dev).to(
            torch.bfloat16).T  # (K, N) view of an (N, K) weight
        xq, xs = quantize_rows(x)
        wq, ws = quantize_cols(w)
        wq_t = wq.T.contiguous()  # already contiguous: no copy
        flops = 2 * m * k * n

        def deq(acc, sa):
            return (acc.float() * sa * ws).to(torch.bfloat16)

        def dyn_act():
            aq, sa = quantize_rows(x)
            return deq(int8_mm(aq, wq_t), sa)

        variants = (
            ("bf16", lambda: x @ w, "TF/s"),
            ("int8 pure", lambda: int8_mm(xq, wq_t, torch.bfloat16), "TOP/s"),
            ("int8 +dequant", lambda: deq(int8_mm(xq, wq_t), xs), "TOP/s"),
            ("int8 +dyn act", dyn_act, "TOP/s"),
            ("int8 full dyn", lambda: int8_matmul(x, w), "TOP/s"),
        )
        for name, fn, unit in variants:
            t = timed_loop(fn, args.iters, dev)
            out[label, name] = {"ms": t * 1e3, "rate": flops / t / 1e12}
            print(f"{label:22s} {name:15s} : {t * 1e3:8.3f} ms "
                  f"{flops / t / 1e12:7.1f} {unit} on {dev}", flush=True)
        print(flush=True)
        del x, w, xq, wq, wq_t
    return out


if __name__ == "__main__":
    main()
