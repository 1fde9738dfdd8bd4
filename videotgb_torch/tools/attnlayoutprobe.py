"""Attention-layout probe: flash attention on (B, S, H, D) projections,
kernel A on (B, H, S, D) views against kernel G read and written in
(B, S, H, D).

The counterpart of the JAX package's ``tools/attnlayoutprobe.py``. Each
variant runs a stack of mini-layers (q/k/v projections, attention, output
projection, residual) at ViT-g serving shapes (frames x 264 tokens x 16
heads x 88, bf16):

  a) kernel A (``csrc/flash_fwd.cu``) on the (B, H, S, D) transposes of the
     projections. On the card these transposes are stride views that kernel
     A reads in place (no copy, unlike the TPU's layout moves).
  b) kernel G (``csrc/flash_bshd.cu``): the projections read and the output
     written in (B, S, H, D), through kernel A's bodies (the tensor-core
     body in bf16), a block per (frame, head, 128 queries).
  c) plain attention from (B, S, H, D) (``flash_bshd_reference``).

It prints each variant's ms per layer and (b)'s max abs difference from
(a).

    python -m videotgb_torch.tools.attnlayoutprobe [--frames 128]
        [--layers 4] [--iters 5] [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from videotgb_torch.device import resolve_device
from videotgb_torch.ops import kernels
from videotgb_torch.ops.attention import (
    _DTYPE_CODES,
    BODY_CODES,
    dot_product_attention,
    flash_attention,
    flash_body,
)
from videotgb_torch.tools import timed

HEADS, HEAD_DIM, TOKENS = 16, 88, 264


def flash_bshd_reference(q, k, v, scale):
    """Plain version of ``flash_bshd``: (B, S, H, D) -> (B, S, H, D)."""
    out = dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale=scale)
    return out.transpose(1, 2)


def flash_bshd_cuda(q, k, v, scale):
    """Launch ``flash_bshd`` on CUDA tensors (any batch, sequence and head
    strides; the last dim contiguous)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_bshd: {name} is not on q's CUDA device")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"flash_bshd: {name} {tuple(t.shape)}; q, k, v "
                             "must be one (B, S, H, D) shape")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"flash_bshd: {name} dtype {t.dtype}; the kernel "
                             "takes float32 or bfloat16, all alike")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_bshd: {name}'s last dim must be "
                             "contiguous")
    b, s, h, d = q.shape
    if d > 128:
        raise ValueError(f"flash_bshd: head dim {d} > 128")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    body = flash_body(q, k, v)
    lib = kernels.library("flash_bshd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_bshd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, s, h, d,
                        *(t.stride(i) for t in (q, k, v, out)
                          for i in range(3)),
                        float(scale), _DTYPE_CODES[q.dtype],
                        BODY_CODES[body], stream)
    kernels.check_launch("flash_bshd", rc)
    kernels.count("flash_bshd", body)
    return out


def flash_bshd(q, k, v, scale):
    """softmax(q k^T * scale) v over (B, S, H, D) tensors, without bias:
    kernel G on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_bshd_reference(q, k, v, scale)
    return flash_bshd_cuda(q, k, v, scale)


def make_weights(width, dtype, device, generator):
    return [(torch.randn((width, width), generator=generator, device=device)
             * 0.02).to(dtype) for _ in range(4)]


def _project(x, w, heads):
    b, s, e = x.shape
    return [(x @ wi).reshape(b, s, heads, e // heads) for wi in w[:3]]


def layer_a(x, w, heads):
    q, k, v = (t.transpose(1, 2) for t in _project(x, w, heads))
    ctx = flash_attention(q, k, v, scale=q.shape[-1] ** -0.5)
    return x + ctx.transpose(1, 2).reshape(x.shape) @ w[3]


def layer_b(x, w, heads):
    q, k, v = _project(x, w, heads)
    ctx = flash_bshd(q, k, v, q.shape[-1] ** -0.5)
    return x + ctx.reshape(x.shape) @ w[3]


def layer_c(x, w, heads):
    q, k, v = _project(x, w, heads)
    ctx = flash_bshd_reference(q, k, v, q.shape[-1] ** -0.5)
    return x + ctx.reshape(x.shape) @ w[3]


LAYERS = {"a": layer_a, "b": layer_b, "c": layer_c}


def stack(layer, x, w, layers, heads):
    for _ in range(layers):
        x = layer(x, w, heads)
    return x


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--layers", type=int, default=4,
                    help="stack depth so per-layer noise averages out")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    width = HEADS * HEAD_DIM  # 1408
    x = torch.randn((args.frames, TOKENS, width), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = make_weights(width, x.dtype, dev, gen)
    out = {}
    with torch.no_grad():
        for v, label in (("a", "kernel A, BHSD views"),
                         ("c", "plain, from BSHD"), ("b", "kernel G, BSHD")):
            ms = timed(lambda v=v: stack(LAYERS[v], x, w, args.layers, HEADS),
                       args.iters) * 1e3 / args.layers
            out[f"layer_{v}"] = ms
            pad = " " * (22 - len(label))
            line = f"layer_{v} ({label}){pad}{ms:8.3f} ms/layer"
            if v == "b":
                d_ab = float((layer_a(x, w, HEADS).float()
                              - layer_b(x, w, HEADS).float()).abs().max())
                out["b_vs_a"] = d_ab
                line += f"  max_abs_vs_a={d_ab:.2e}"
            print(line + f" on {dev}", flush=True)
    return out


if __name__ == "__main__":
    main()
