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

The kernel has two bodies: the tile body (``csrc/corr_lookup_tile.cuh``,
shared with kernel E), which stages whole scanlines of a block of queries
by TMA, and the gather body, for the inputs TMA cannot copy.
:func:`lookup_body` picks one, :func:`lookup_tile` the tile body's block;
:func:`lookup_window` mirrors the rows a block stages.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from videotgb_torch.ops import kernels
from videotgb_torch.ops.correlation import _pool_levels, lookup_corr_pyramid_dense

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}
BODY_CODES = {"gather": 0, "tile": 1}
# host time of the tile body's TMA descriptor encodes in corr_lookup, ns
ENCODE_NS = {"corr_lookup": 0}

# csrc/corr_lookup_tile.cuh
_TILE_ALIGN = 128          # staged rows and the output tile start so aligned
TILE_STAGES = 2            # the ring
_TILE_RED_BYTES = 2 * 13 * 4  # the block's min and max cy, one a warp
SMEM_PER_BLOCK = 232448    # bytes a block may have on sm_90
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024       # the runtime's share of each block's
SMS = 132                  # an H100 SXM's SMs
_MIN_STAGE_ROWS = 8        # scanlines a stage before two blocks share an SM


class LookupTile(NamedTuple):
    """A block of the tile body: ``qb`` consecutive queries, a ring of
    two stages of ``stage_bytes`` bytes of staged scanlines."""

    qb: int
    stage_bytes: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lookup_row_bytes(w: int, qb: int, esize: int) -> int:
    """Shared bytes of one staged scanline, ``w`` positions of ``qb``
    queries, padded to 128 (``corr_lookup_tile.cuh::row_bytes``)."""
    return _round_up(w * qb * esize, _TILE_ALIGN)


def lookup_tile_bytes(qb: int, n_levels: int, radius: int, esize: int,
                      stage_bytes: int) -> int:
    """Shared bytes of a tile-body block, all of them dynamic: alignment
    slack, the block's outputs of every level, the two stages, two
    mbarriers a stage and the cy reduction
    (``corr_lookup_tile.cuh::smem_bytes``)."""
    k = 2 * radius + 1
    return (_TILE_ALIGN + _round_up(qb * n_levels * k * k * esize, _TILE_ALIGN)
            + TILE_STAGES * (stage_bytes + 16) + _TILE_RED_BYTES)


@functools.lru_cache(maxsize=256)
def lookup_tile(pairs: int, h: int, w: int, n_levels: int, radius: int,
                dtype, qb: int | None = None) -> LookupTile | None:
    """The tile body's block for ``pairs`` (h, w) query maps, or None where
    the body takes no block of this shape (or dtype: f32 and bf16 only).

    ``qb`` (default: 64 queries where that still gives every SM a block,
    else 32) must be a multiple of 32 up to 128. A stage holds as many
    level-0 scanlines (at most the map's) as fit two blocks an SM where
    that is at least 8 (or the map), else as many as fit one block an SM,
    at least 2 (on an H100, qb 128 ran faster at one block an SM with 8
    scanlines a stage than at two with 2: a window of many chunks). The
    ring has two stages (``TILE_STAGES``)."""
    esize = _ESIZE.get(dtype)
    if esize is None or not 0 <= radius <= 4 or w > 256 or pairs > 65535 or \
            pairs * h * w > 2 ** 31 - 1:
        return None
    if qb is None:
        qb = 64 if pairs * -(-(h * w) // 64) >= SMS else 32
    if qb % 32 or not 32 <= qb <= 128:
        return None
    row = lookup_row_bytes(w, qb, esize)
    fixed = lookup_tile_bytes(qb, n_levels, radius, esize, 0)
    two, one = (min(max(h, 2), (budget - fixed) // TILE_STAGES // row)
                for budget in (SMEM_PER_SM // 2 - SMEM_RESERVED,
                               SMEM_PER_BLOCK))
    if two >= min(max(h, 2), _MIN_STAGE_ROWS):
        return LookupTile(qb, two * row)
    if one >= 2:
        return LookupTile(qb, one * row)
    return None


def lookup_body(pyramid_t, coords, radius: int = 4) -> str:
    """``"tile"`` where the tile body takes the lookup: f32 or bf16 levels,
    each 16-byte aligned, the queries of a position a multiple of 16 bytes
    (TMA's row pitch) and a block from :func:`lookup_tile`; else
    ``"gather"``. A pure function of the tensors' dtype, shapes and
    addresses, on any device."""
    pyramid_t = list(pyramid_t)
    dtype = pyramid_t[0].dtype
    if dtype not in _DTYPE_CODES:
        return "gather"
    p, h, w, _ = coords.shape
    esize = pyramid_t[0].element_size()
    if (h * w * esize) % 16 or any(lvl.data_ptr() % 16 for lvl in pyramid_t):
        return "gather"
    if lookup_tile(p, h, w, len(pyramid_t), radius, dtype) is None:
        return "gather"
    return "tile"


def lookup_window(ymin: float, ymax: float, level: int, radius: int,
                  hl: int) -> tuple[int, int]:
    """The rows [lo, hi] of level ``level`` (``hl`` rows) that a tile-body
    block stages when its queries' y coordinates lie in [ymin, ymax]: a
    query at cy reads rows floor(cy / 2^l) - r .. floor(cy / 2^l) + r + 1,
    clipped to the map; lo > hi where none is on it. Mirrors
    ``corr_lookup_tile.cuh::window``, whose f32 steps are all exact (2^-l is
    a power of two) for f32 inputs."""
    sc = 2.0 ** -level
    lo = min(max(math.floor(ymin * sc) - radius, 0), hl)
    hi = min(max(math.floor(ymax * sc) + radius + 1, -1), hl - 1)
    return lo, hi


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


def lookup_launch_args(name: str, pyramid_t, coords, radius: int):
    """Check a lookup's CUDA inputs and allocate its output. Returns the
    output, the leading arguments that ``corr_lookup`` and
    ``corr_lookup_blocked`` share (levels*, hl*, wl*, n_levels, coords,
    out, P, Q, radius), and the host objects those pointers refer to."""
    pyramid_t = list(pyramid_t)
    if coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"{name}: coords must be (P, H, W, 2), got "
                         f"{tuple(coords.shape)}")
    p, h, w, _ = coords.shape
    q = h * w
    dtype = pyramid_t[0].dtype
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: pyramid dtype {dtype}; the kernel "
                         "takes float32 or bfloat16")
    if not coords.is_cuda or coords.dtype != torch.float32:
        raise ValueError(f"{name}: coords must be a float32 CUDA tensor")
    if not 0 < len(pyramid_t) <= 8:
        raise ValueError(f"{name}: {len(pyramid_t)} levels; 1 to 8")
    sizes = level_sizes(h, w, len(pyramid_t))
    for lvl, (hh, ww) in zip(pyramid_t, sizes):
        if lvl.shape != (p, hh * ww, q) or lvl.dtype != dtype:
            raise ValueError(f"{name}: level {tuple(lvl.shape)} {lvl.dtype}"
                             f", expected {(p, hh * ww, q)} {dtype}")
        if not lvl.is_cuda or lvl.device != coords.device:
            raise ValueError(f"{name}: levels must be on coords' device")
        if not lvl.is_contiguous():
            raise ValueError(f"{name}: levels must be contiguous")
    coords = coords.contiguous()
    k = 2 * radius + 1
    out = torch.empty((p, h, w, len(pyramid_t) * k * k), dtype=dtype,
                      device=coords.device)
    n = len(pyramid_t)
    ptrs = (ctypes.c_void_p * n)(*[lvl.data_ptr() for lvl in pyramid_t])
    hl = (ctypes.c_int * n)(*[s[0] for s in sizes])
    wl = (ctypes.c_int * n)(*[s[1] for s in sizes])
    # the host arrays and the contiguous coords must outlive the launch: the
    # caller holds them through the third element
    args = (ctypes.cast(ptrs, ctypes.c_void_p),
            ctypes.cast(hl, ctypes.c_void_p), ctypes.cast(wl, ctypes.c_void_p),
            n, coords.data_ptr(), out.data_ptr(), p, q, radius)
    return out, args, (ptrs, hl, wl, coords)


def corr_lookup_cuda(pyramid_t, coords, radius: int = 4,
                     body: str | None = None):
    """Launch ``corr_lookup`` on CUDA tensors: on the body
    :func:`lookup_body` picks, or ``body``; the tile body with
    :func:`lookup_tile`'s block. The C entry refuses a body that does not
    take the inputs."""
    pyramid_t = list(pyramid_t)
    out, args, _keep = lookup_launch_args("corr lookup", pyramid_t, coords,
                                          radius)
    body = body or lookup_body(pyramid_t, coords, radius)
    if body not in BODY_CODES:
        raise ValueError(f"corr lookup: body {body!r}; one of "
                         f"{sorted(BODY_CODES)}")
    ring = (0, 0)
    if body == "tile":
        p, h, w, _ = coords.shape
        ring = lookup_tile(p, h, w, len(pyramid_t), radius, out.dtype)
        if ring is None:
            raise ValueError(f"corr lookup: the tile body takes no block of "
                             f"{p} x {h} x {w} queries at radius {radius}")
    lib = kernels.library("corr_lookup")
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    encode_ns = ctypes.c_longlong(0)
    rc = lib.corr_lookup(*args, BODY_CODES[body], *ring,
                         _DTYPE_CODES[out.dtype], ctypes.byref(encode_ns),
                         stream)
    kernels.check_launch("corr_lookup", rc)
    kernels.count("corr_lookup", body)
    with kernels.LOCK:
        ENCODE_NS["corr_lookup"] += encode_ns.value
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
