"""Compare Q-Former attention formulations at serving shapes.

The counterpart of the JAX package's ``tools/qformerattnprobe.py``. Both
Q-Former shapes (self: 32 queries over 32 keys; cross: 32 queries over 264
ViT-g patches, k and v projected from 1408), 12 heads of 64, bf16:

  a) q/k/v products -> reshape -> transpose to (B, H, S, D) -> the plain
     attention (f32 scores and softmax) -> transpose back -> out product
  b) the same products, no transposes: einsums straight on (B, S, H, D)
  c) kernel A (``ops/attention.py::flash_attention``, which launches
     ``flash_forward_cuda`` on CUDA tensors) below the 128^2 rule that
     sends these shapes to the plain version in the models

Each variant runs a stack of L mini-layers (products, attention, output
product, residual); it prints ms per layer and its largest difference
from (a) on one layer.

    python -m videotgb_torch.tools.qformerattnprobe [--layers 12]
        [--iters 5] [--frames 256] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.ops.attention import dot_product_attention, flash_attention
from videotgb_torch.utils.profiling import timed

QUERIES, KV, HEADS, HEAD_DIM, WIDTH, ENC_WIDTH = 32, 264, 12, 64, 768, 1408


def _heads(t):
    b, s, _ = t.shape
    return t.reshape(b, s, HEADS, HEAD_DIM)


def attn_a(q, k, v):
    """Transposes into (B, H, S, D), plain attention."""
    q, k, v = (_heads(t).transpose(1, 2) for t in (q, k, v))
    ctx = dot_product_attention(q, k, v, scale=HEAD_DIM ** -0.5)
    return ctx.transpose(1, 2).reshape(q.shape[0], -1, WIDTH)


def attn_b(q, k, v):
    """(B, S, H, D) all the way: no transposes."""
    q, k, v = (_heads(t) for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * HEAD_DIM ** -0.5
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return ctx.to(v.dtype).reshape(q.shape[0], -1, WIDTH)


def attn_c(q, k, v):
    """Kernel A on the (B, H, S, D) transposes, below the flash rule."""
    q, k, v = (_heads(t).transpose(1, 2) for t in (q, k, v))
    ctx = flash_attention(q, k, v, scale=HEAD_DIM ** -0.5)
    return ctx.transpose(1, 2).reshape(q.shape[0], -1, WIDTH)


VARIANTS = {"a transpose+einsum": attn_a, "b bshd einsum     ": attn_b,
            "c flash kernel A  ": attn_c}


def weights(dev, gen, dtype=torch.bfloat16) -> tuple:
    """(wq, wks, wvs, wk, wv, wo): the self-attention products from the
    queries' width, the cross-attention k and v from the ViT-g's."""
    def rand(i, o):
        return (torch.randn((i, o), generator=gen, device=dev)
                * 0.02).to(dtype)

    wq, wo = rand(WIDTH, WIDTH), rand(WIDTH, WIDTH)
    wk, wv = rand(ENC_WIDTH, WIDTH), rand(ENC_WIDTH, WIDTH)
    wks, wvs = rand(WIDTH, WIDTH), rand(WIDTH, WIDTH)
    return wq, wks, wvs, wk, wv, wo


def layer(attn, x, enc, w, cross):
    wq, wks, wvs, wk, wv, wo = w
    x = x + attn(x @ wq, x @ wks, x @ wvs) @ wo
    if cross:
        x = x + attn(x @ wq, enc @ wk, enc @ wv) @ wo
    return x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--frames", type=int, default=256,
                    help="batch * nframe at serving batch 64")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions of the kernels")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.frames, QUERIES, WIDTH), generator=gen,
                    device=dev).to(torch.bfloat16)
    enc = torch.randn((args.frames, KV, ENC_WIDTH), generator=gen,
                      device=dev).to(torch.bfloat16)
    w = weights(dev, gen)
    out = {}
    with torch.no_grad():
        for cross in (False, True):
            tag = "self+cross" if cross else "self-only "
            ref = layer(attn_a, x, enc, w, cross).float()
            for name, attn in VARIANTS.items():
                def run(attn=attn):
                    y = x
                    for _ in range(args.layers):
                        y = layer(attn, y, enc, w, cross)
                    return y.float().sum()

                ms = timed(run, iters=args.iters)[0] * 1e3 / args.layers
                d = float((layer(attn, x, enc, w, cross).float()
                           - ref).abs().max())
                out[(tag.strip(), name[0])] = {"ms": ms, "max_abs_vs_a": d}
                print(f"{tag} {name} {ms:8.3f} ms/layer  "
                      f"max_abs_vs_a={d:.2e} on {dev}", flush=True)
    return out


if __name__ == "__main__":
    main()
