"""RAFT's query-minor correlation pyramid and its lookup kernel.

The module keeps the JAX package's name (its Pallas kernel lived in
``videotgb_tpu/ops/correlation_pallas.py``) so each part has an obvious
counterpart. Here:

* :func:`build_corr_pyramid_t` - the (B, Hl*Wl, Q) pyramid: one matmul
  plus floor avg-pooling, plain PyTorch (no hand kernel needed);
* :func:`lookup_corr_pyramid_t` - the radius-r windowed bilinear lookup:
  the CUDA kernel ``csrc/corr_lookup.cu`` on CUDA tensors (the Hopper
  counterpart of the Pallas ``_lookup_kernel``), the plain version
  :func:`lookup_corr_pyramid_t_plain` on CPU tensors. Its gradient goes
  through the plain dense version, as the JAX package's custom vjp does.

Both versions return the lookup in the pyramid's dtype with f32 sums.
"""

from __future__ import annotations

import ctypes

import torch

from videotgb_torch.ops import kernels
from videotgb_torch.ops.correlation import _pool_levels, lookup_corr_pyramid_dense

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build_corr_pyramid_t(fmap1, fmap2, num_levels: int = 4):
    """fmaps (B, H, W, C) -> [(B, Hl*Wl, Q)] * num_levels in fmap1's dtype:
    the correlation volume with the QUERY axis minor, pooled over keys."""
    b, h, w, c = fmap1.shape
    f1 = fmap1.reshape(b, h * w, c).float()
    f2 = fmap2.reshape(b, h * w, c).float()
    corr = torch.matmul(f2, f1.transpose(1, 2))  # (B, keys, queries)
    corr = (corr / torch.sqrt(torch.tensor(float(c)))).to(fmap1.dtype)
    q = h * w

    def to_map(level, hh, ww):
        return level.reshape(b, hh, ww, q)

    def from_map(cur, hh, ww):
        return cur.reshape(b, hh * ww, q).to(fmap1.dtype)

    return _pool_levels(corr, h, w, num_levels, to_map, from_map)


def level_sizes(h: int, w: int, n_levels: int) -> list[tuple[int, int]]:
    """(Hl, Wl) of each level: floor-halving from (h, w), clamped at 1."""
    sizes = []
    hh, ww = h, w
    for _ in range(n_levels):
        sizes.append((hh, ww))
        hh, ww = max(hh // 2, 1), max(ww // 2, 1)
    return sizes


def lookup_corr_pyramid_t_plain(pyramid_t, coords, radius: int = 4):
    """Plain version: reshape each level to (B, Q, Hl, Wl) and run the dense
    hat-weight lookup; (B, H, W, L*(2r+1)^2) in the pyramid's dtype."""
    b, h, w, _ = coords.shape
    std = [lvl.reshape(b, hh, ww, -1).permute(0, 3, 1, 2)
           for lvl, (hh, ww) in zip(pyramid_t, level_sizes(h, w, len(pyramid_t)))]
    return lookup_corr_pyramid_dense(std, coords, radius).to(pyramid_t[0].dtype)


def corr_lookup_cuda(pyramid_t, coords, radius: int = 4):
    """Launch ``corr_lookup`` on CUDA tensors."""
    pyramid_t = list(pyramid_t)
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"corr lookup: coords must be (P, H, W, 2), got "
                         f"{tuple(coords.shape)}")
    p, h, w, _ = coords.shape
    q = h * w
    dtype = pyramid_t[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"corr lookup: pyramid dtype {dtype}; the kernel "
                         "takes float32 or bfloat16")
    if not coords.is_cuda or coords.dtype != torch.float32:
        raise ValueError("corr lookup: coords must be a float32 CUDA tensor")
    if not 0 < len(pyramid_t) <= 8:
        raise ValueError(f"corr lookup: {len(pyramid_t)} levels; 1 to 8")
    sizes = level_sizes(h, w, len(pyramid_t))
    for lvl, (hh, ww) in zip(pyramid_t, sizes):
        if lvl.shape != (p, hh * ww, q) or lvl.dtype != dtype:
            raise ValueError(f"corr lookup: level {tuple(lvl.shape)} "
                             f"{lvl.dtype}, expected {(p, hh * ww, q)} {dtype}")
        if not lvl.is_cuda or lvl.device != coords.device:
            raise ValueError("corr lookup: levels must be on coords' device")
        if not lvl.is_contiguous():
            raise ValueError("corr lookup: levels must be contiguous")
    coords = coords.contiguous()
    k = 2 * radius + 1
    out = torch.empty((p, h, w, len(pyramid_t) * k * k), dtype=dtype,
                      device=coords.device)
    n = len(pyramid_t)
    ptrs = (ctypes.c_void_p * n)(*[lvl.data_ptr() for lvl in pyramid_t])
    hl = (ctypes.c_int * n)(*[s[0] for s in sizes])
    wl = (ctypes.c_int * n)(*[s[1] for s in sizes])
    lib = kernels.library("corr_lookup")
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    rc = lib.corr_lookup(ctypes.cast(ptrs, ctypes.c_void_p),
                         ctypes.cast(hl, ctypes.c_void_p),
                         ctypes.cast(wl, ctypes.c_void_p), n,
                         coords.data_ptr(), out.data_ptr(), p, q, radius,
                         _DTYPE_CODES[dtype], stream)
    kernels.check_launch("corr_lookup", rc)
    kernels.LAUNCHES["corr_lookup"] += 1
    return out


class _CorrLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, radius, coords, *levels):
        ctx.radius = radius
        ctx.save_for_backward(coords, *levels)
        return corr_lookup_cuda(levels, coords, radius)

    @staticmethod
    def backward(ctx, g):
        coords, *levels = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (coords, *levels)]
            out = lookup_corr_pyramid_t_plain(ins[1:], ins[0], ctx.radius)
            grads = torch.autograd.grad(out, ins, g.to(out.dtype),
                                        allow_unused=True)
        return (None, *grads)


def lookup_corr_pyramid_t(pyramid_t, coords, radius: int = 4):
    """Windowed bilinear lookup on a query-minor pyramid: coords
    (B, H, W, 2) pixel (x, y) -> (B, H, W, L*(2r+1)^2) in the pyramid's
    dtype. The CUDA kernel on CUDA tensors, the plain version on CPU."""
    pyramid_t = list(pyramid_t)
    if coords.device.type == "cpu":
        return lookup_corr_pyramid_t_plain(pyramid_t, coords, radius)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (coords, *pyramid_t)):
        return _CorrLookup.apply(radius, coords, *pyramid_t)
    return corr_lookup_cuda(pyramid_t, coords, radius)
