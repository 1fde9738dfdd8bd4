"""LayerNorm probe: the ViT layer's residual-add + LayerNorm passes, eager
PyTorch against kernel F, the fused add + LayerNorm written in Triton.

The counterpart of the JAX package's ``tools/lnprobe.py``. Each ViT layer
runs two (residual add -> LayerNorm) sequences,

    x = x + attn(h) ; h = LN(x) ;  x = x + mlp(h) ; h = LN(x)

and the probe times a stack of such mini-layers (q/k/v/out projections,
kernel A's flash attention, GELU MLP) at ViT-g widths (264 tokens, 16
heads x 88, MLP 6144, bf16) three ways:

  a) the port's LayerNorm with eager adds (``models/common.py``)
  b) kernel F's ``add_ln`` at both positions: (res, delta) ->
     (res + delta, LN(res + delta)) in one pass
  c) kernel F's ``ln`` (the same kernel without the add), eager adds

It then times the isolated norms at the same (rows, 1408) shape, the
library's ``F.layer_norm`` and a bf16 add + reduce floor.

Both kernels compute f32 statistics in one pass, var = max(E[s^2] -
E[s]^2, 0), eps 1e-6, f32 gamma and beta, and normalise the f32 sum
f32(res) + f32(delta); the sum is written, rounded to bf16, as its own
output. ``add_ln_reference`` and ``ln_reference`` are their plain versions.

    python -m videotgb_torch.tools.lnprobe [--frames 256] [--layers 4]
        [--iters 5] [--block 4] [--device cuda]
"""

import argparse

import torch
import torch.nn.functional as F

from videotgb_torch.device import resolve_device
from videotgb_torch.models.common import LayerNorm
from videotgb_torch.ops import kernels
from videotgb_torch.ops.attention import flash_attention
from videotgb_torch.tools import timed

HEADS, HEAD_DIM, TOKENS, MLP = 16, 88, 264, 6144
_TRITON = {}


def _normalize(s, g, b, eps):
    """f32 single-pass LayerNorm of the f32 rows ``s``."""
    mean = s.mean(dim=-1, keepdim=True)
    meansq = (s * s).mean(dim=-1, keepdim=True)
    var = torch.clamp(meansq - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (s - mean) * (inv * g.float()) + b.float()


def add_ln_reference(res, delta, g, b, eps: float = 1e-6):
    """Plain version of ``add_ln``: (res + delta, LN(res + delta)) in
    res's dtype, the norm taken of the f32 sum."""
    s = res.float() + delta.float()
    return s.to(res.dtype), _normalize(s, g, b, eps).to(res.dtype)


def ln_reference(x, g, b, eps: float = 1e-6):
    """Plain version of ``ln``."""
    return _normalize(x.float(), g, b, eps).to(x.dtype)


def _triton_kernel():
    """Kernel F, compiled by Triton at its first launch. Triton is imported
    here, so the module imports where there is none."""
    if _TRITON:
        return _TRITON["kernel"], _TRITON["triton"]
    global tl  # the kernel body reads ``tl`` as a module global
    import triton
    import triton.language as tl

    @triton.jit
    def add_ln_kernel(r_ptr, d_ptr, g_ptr, b_ptr, sum_ptr, out_ptr, n_rows,
                      eps, WIDTH: tl.constexpr, BLOCK_W: tl.constexpr,
                      BLOCK_ROWS: tl.constexpr, HAS_ADD: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_ROWS + tl.arange(0, BLOCK_ROWS)
        cols = tl.arange(0, BLOCK_W)
        cmask = cols < WIDTH
        mask = (rows < n_rows)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * WIDTH + cols[None, :]
        s = tl.load(r_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        if HAS_ADD:
            s += tl.load(d_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            tl.store(sum_ptr + offs, s.to(sum_ptr.dtype.element_ty),
                     mask=mask)
        mean = tl.sum(s, axis=1) / WIDTH
        meansq = tl.sum(s * s, axis=1) / WIDTH
        var = tl.maximum(meansq - mean * mean, 0.0)
        inv = tl.rsqrt(var + eps)
        g = tl.load(g_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        out = (s - mean[:, None]) * (inv[:, None] * g[None, :]) + b[None, :]
        tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty), mask=mask)

    _TRITON.update(kernel=add_ln_kernel, triton=triton)
    return add_ln_kernel, triton


def _launch(name, x, delta, g, b, eps, block_rows):
    for t in (x, delta, g, b):
        if t is not None and (not t.is_cuda or t.device != x.device):
            raise ValueError(f"{name}: tensors must be on one CUDA device")
    width = x.shape[-1]
    if delta is not None and (delta.shape != x.shape
                              or delta.dtype != x.dtype):
        raise ValueError(f"{name}: delta {tuple(delta.shape)} {delta.dtype} "
                         f"!= res {tuple(x.shape)} {x.dtype}")
    if g.shape != (width,) or b.shape != (width,):
        raise ValueError(f"{name}: gamma/beta must be ({width},)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: dtype {x.dtype}; the kernel takes "
                         "float32 or bfloat16")
    if block_rows <= 0 or block_rows & (block_rows - 1):
        raise ValueError(f"{name}: block_rows {block_rows} is not a power "
                         "of two")
    kernel, triton = _triton_kernel()
    x2 = x.contiguous().reshape(-1, width)
    d2 = x2 if delta is None else delta.contiguous().reshape(-1, width)
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    summed = torch.empty_like(x2) if delta is not None else out
    grid = (triton.cdiv(rows, block_rows),)
    kernel[grid](x2, d2, g.float().contiguous(), b.float().contiguous(),
                 summed, out, rows, eps, WIDTH=width,
                 BLOCK_W=triton.next_power_of_2(width),
                 BLOCK_ROWS=block_rows, HAS_ADD=delta is not None,
                 num_warps=8)
    kernels.count(name)
    return summed.reshape(x.shape), out.reshape(x.shape)


def add_ln(res, delta, g, b, eps: float = 1e-6, block_rows: int = 4):
    """(res, delta) -> (res + delta, LN(res + delta)), both in res's dtype:
    kernel F on CUDA tensors, the plain version on CPU tensors."""
    if res.device.type == "cpu":
        return add_ln_reference(res, delta, g, b, eps)
    return _launch("add_ln", res, delta, g, b, eps, block_rows)


def ln(x, g, b, eps: float = 1e-6, block_rows: int = 4):
    """LN(x) in x's dtype: kernel F without the add on CUDA tensors, the
    plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ln_reference(x, g, b, eps)
    return _launch("ln", x, None, g, b, eps, block_rows)[1]


# ------------------------------------------------------------ the mini layer
def make_weights(width, mlp, dtype, device, generator):
    def randn(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    return {"wq": randn(width, width), "wk": randn(width, width),
            "wv": randn(width, width), "wo": randn(width, width),
            "wi": randn(width, mlp), "wo2": randn(mlp, width),
            "g1": torch.full((width,), 1.1, device=device),
            "b1": torch.full((width,), 0.01, device=device)}


def attn(h, w, heads):
    """Projections, kernel A on (B, H, S, D) views, output projection."""
    b, s, e = h.shape
    q, k, v = ((h @ w[n]).reshape(b, s, heads, e // heads).transpose(1, 2)
               for n in ("wq", "wk", "wv"))
    ctx = flash_attention(q, k, v, scale=(e // heads) ** -0.5)
    return ctx.transpose(1, 2).reshape(b, s, e) @ w["wo"]


def mlp(h, w):
    return F.gelu(h @ w["wi"], approximate="tanh") @ w["wo2"]


def layer_a(x, w, norm, heads):
    x = x + attn(norm(x), w, heads)
    return x + mlp(norm(x), w)


def layer_b(carry, w, heads, block_rows=4):
    x, h = carry
    x, h = add_ln(x, attn(h, w, heads), w["g1"], w["b1"],
                  block_rows=block_rows)
    return add_ln(x, mlp(h, w), w["g1"], w["b1"], block_rows=block_rows)


def layer_c(x, w, heads, block_rows=4):
    x = x + attn(ln(x, w["g1"], w["b1"], block_rows=block_rows), w, heads)
    return x + mlp(ln(x, w["g1"], w["b1"], block_rows=block_rows), w)


def port_norm(width, w, dtype, device):
    """The port's LayerNorm module with the probe's gamma and beta."""
    norm = LayerNorm(width, eps=1e-6, dtype=dtype, device=device)
    with torch.no_grad():
        norm.weight.copy_(w["g1"])
        norm.bias.copy_(w["b1"])
    return norm


def stacks(x, w, layers, heads, block_rows):
    """The three variants as stacks of ``layers`` mini-layers; each returns
    its last residual stream."""
    norm = port_norm(x.shape[-1], w, x.dtype, x.device)

    def a():
        y = x
        for _ in range(layers):
            y = layer_a(y, w, norm, heads)
        return y

    def b():
        carry = (x, norm(x))
        for _ in range(layers):
            carry = layer_b(carry, w, heads, block_rows)
        return carry[0]

    def c():
        y = x
        for _ in range(layers):
            y = layer_c(y, w, heads, block_rows)
        return y

    return {"a": a, "b": b, "c": c}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--block", type=int, default=4,
                    help="rows per Triton program (a power of two)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    width = HEADS * HEAD_DIM  # 1408
    x = torch.randn((args.frames, TOKENS, width), generator=gen,
                    device=dev).to(torch.bfloat16)
    w = make_weights(width, MLP, torch.bfloat16, dev, gen)
    runs = stacks(x, w, args.layers, HEADS, args.block)
    one = stacks(x, w, 1, HEADS, args.block)
    with torch.no_grad():
        ra, rb, rc = (one[v]().float() for v in "abc")
        da = float((ra - rb).abs().max())
        dc = float((ra - rc).abs().max())
        print(f"exactness: b_vs_a={da:.2e}  c_vs_a={dc:.2e} on {dev}",
              flush=True)
        out = {"b_vs_a": da, "c_vs_a": dc}
        for v, label in (("a", "port LN"), ("b", "Triton add+LN"),
                         ("c", "Triton LN")):
            ms = timed(runs[v], args.iters) * 1e3 / args.layers
            out[f"layer_{v}"] = ms
            print(f"layer_{v} ({label}){' ' * (16 - len(label))}"
                  f"{ms:8.3f} ms/layer", flush=True)

        g, b = w["g1"], w["b1"]
        norm = port_norm(width, w, x.dtype, dev)
        delta = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
        g_lib, b_lib = g.to(x.dtype), b.to(x.dtype)
        iso = {
            "iso LN port": lambda: norm(x),
            "iso LN triton": lambda: ln(x, g, b, block_rows=args.block),
            "iso add+LN triton": lambda: add_ln(x, delta, g, b,
                                                block_rows=args.block)[1],
            "iso F.layer_norm": lambda: F.layer_norm(x, (width,), g_lib,
                                                     b_lib, 1e-6),
            "iso bf16 add+reduce": lambda: x + 1.0,
        }
        for name, fn in iso.items():
            ms = timed(fn, args.iters) * 1e3
            out[name] = ms
            print(f"{name:24s}{ms:8.3f} ms", flush=True)
    return out


if __name__ == "__main__":
    main()
