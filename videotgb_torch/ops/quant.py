"""Dynamic W8A8 int8 matmul for serving, on kernel H.

The counterpart of ``videotgb_tpu/ops/quant.py``, with the same f32
arithmetic in the same order:

  * weights: symmetric per-output-channel int8 scales (amax over the input
    dim, floored at 1e-8, over 127), computed on every call from the
    parameters in their compute dtype, so a checkpoint is unchanged and
    nothing is calibrated (as in the JAX package, nothing is cached: the
    quantize pass reads every weight once per call);
  * activations: symmetric per-row (per-token) scales at run time;
  * the int8 x int8 product accumulated in int32, then dequantized as
    ``acc.f32 * x_scale * w_scale``, left to right.

Rounding is half to even (``torch.round``, as ``jnp.round``).

Kernel H (``csrc/int8_mm.cu``, ``csrc/bf16_mm.cu`` over the warp-specialised
wgmma + TMA main loop of ``csrc/wgmma_gemm.cuh``):

* :func:`int8_mm` - x (M, K) int8 times w_t (N, K) int8 -> (M, N) int32
  (the serving path) or bf16 (the probe's epilogue); the kernel on CUDA
  tensors, :func:`int8_mm_reference` on CPU tensors;
* :func:`bf16_mm` - x (M, K) bf16 times w_t (N, K) bf16 -> (M, N) bf16 with
  an f32 accumulator; the kernel on CUDA tensors, :func:`bf16_mm_reference`
  on CPU tensors.

Both take the second operand as (N, K), K contiguous: wgmma reads 8-bit
operands only K-major from shared memory, and the port's dense weights are
stored (out, in). ``TILES`` names the block tilings the CUDA source
instantiates; :func:`gemm_tile` picks one from the shape, and ``tile=None``
(the default) takes its pick.
"""

from __future__ import annotations

import ctypes
import math

import torch

from videotgb_torch.ops import kernels

_EPS = 1e-8
# wgmma_gemm.cuh::dispatch, by index: rows x columns of a block's output
# tile, and the blocks each SM runs at once
TILES = ("128x128", "128x256", "64x128")
_TILE_SHAPES = ((128, 128, 1), (128, 256, 1), (64, 128, 2))
# The tiling rule's constants, fitted to kernel H's device times at the
# eight shapes chip_smoke.py phase 12 times (H100 SXM): each tiling's rate
# per consumer warpgroup relative to 128 x 128 (128 x 256 loads fewer bytes
# per product; two 64 x 128 blocks share an SM's tensor cores), and its
# fixed cost per tile (pipeline fill, epilogue) in bytes of K.
_TILE_RATES = (1.0, 1.32, 0.75)
_TILE_FIXED = (1400, 2300, 1200)
SMS = 132  # streaming multiprocessors of an H100 SXM
_OUT_KINDS = {torch.int32: 0, torch.bfloat16: 1}
# host nanoseconds spent encoding kernel H's two TMA descriptors, summed
# over the calls (a caller resets them)
ENCODE_NS = {"int8_mm": 0, "bf16_mm": 0}


def gemm_tile(m: int, n: int, k: int, dtype=torch.int8) -> int:
    """The index into ``TILES`` of kernel H's tiling for an (m, k) x (k, n)
    product of ``dtype`` (int8 or bfloat16): the least modelled time. The
    persistent grid runs SMS x (blocks a SM) tiles at once, so the tiles
    take ceil(tiles / slots) rounds (wave quantisation); a round lasts one
    consumer warpgroup's 64-row share of a tile, its bytes of K plus the
    tile's fixed cost, over the tiling's rate."""
    kbytes = k * (1 if dtype == torch.int8 else 2)

    def cost(i):
        bm, bn, blocks = _TILE_SHAPES[i]
        tiles = math.ceil(m / bm) * math.ceil(n / bn)
        return (math.ceil(tiles / (SMS * blocks)) * 64 * bn
                * (kbytes + _TILE_FIXED[i]) / _TILE_RATES[i])

    return min(range(len(TILES)), key=cost)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8: x (..., K) -> (q int8 (..., K), scale
    (..., 1) f32)."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax.float().clamp_min(_EPS) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def quantize_cols(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: w (K, N) -> (q (K, N), scale
    (1, N) f32). The result keeps ``w``'s memory layout, so for the (K, N)
    view of an (N, K) weight ``q.T`` is contiguous."""
    amax = w.abs().amax(dim=0, keepdim=True)
    scale = amax.float().clamp_min(_EPS) / 127.0
    q = torch.clamp(torch.round(w.float() / scale), -127, 127)
    return q.to(torch.int8), scale


def _check_operands(name, x, w_t, dtype, k_multiple):
    if x.dim() != 2 or w_t.dim() != 2 or x.shape[1] != w_t.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w_t "
                         f"{tuple(w_t.shape)} must be (M, K) and (N, K)")
    if x.dtype != dtype or w_t.dtype != dtype:
        raise ValueError(f"{name}: dtypes {x.dtype}, {w_t.dtype}; the kernel "
                         f"takes {dtype}")
    if x.device != w_t.device:
        raise ValueError(f"{name}: operands on {x.device} and {w_t.device}")
    if x.shape[1] % k_multiple:
        raise ValueError(f"{name}: K = {x.shape[1]} is not a multiple of "
                         f"{k_multiple} (16-byte copies)")


def int8_mm_reference(x, w_t, out_dtype=torch.int32):
    """Plain version of :func:`int8_mm`. int8 products wrap in torch, so it
    widens: int32 on the CPU; on the card, where torch has no integer
    matmul but ``torch._int_mm``, float64, which is exact while
    127^2 * K < 2^53. The bf16 output rounds int32 -> f32 -> bf16."""
    _check_operands("int8_mm_reference", x, w_t, torch.int8, 1)
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"int8_mm: out_dtype {out_dtype}; int32 or bfloat16")
    wide = torch.int32 if x.device.type == "cpu" else torch.float64
    acc = (x.to(wide) @ w_t.to(wide).T).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    return acc.to(torch.float32).to(torch.bfloat16)


def _kernel_call(name, x, w_t, out_dtype, tile, *extra):
    if not x.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors")
    if tile is None:
        tile = gemm_tile(x.shape[0], w_t.shape[0], x.shape[1], x.dtype)
    if not 0 <= tile < len(TILES):
        raise ValueError(f"{name}: tile {tile}; one of 0..{len(TILES) - 1} "
                         f"({', '.join(TILES)})")
    x, w_t = x.contiguous(), w_t.contiguous()
    if x.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError(f"{name}: operands must start on 16-byte boundaries")
    m, k = x.shape
    n = w_t.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = kernels.library(name)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    encode_ns = ctypes.c_longlong(0)
    rc = getattr(lib, name)(x.data_ptr(), w_t.data_ptr(), out.data_ptr(), m,
                            n, k, *extra, tile, ctypes.byref(encode_ns),
                            stream)
    kernels.check_launch(name, rc)
    kernels.count(name)
    with kernels.LOCK:
        ENCODE_NS[name] += encode_ns.value
    return out


def int8_mm(x, w_t, out_dtype=torch.int32, tile: int | None = None):
    """x (M, K) int8 times w_t (N, K) int8 -> (M, N) ``out_dtype`` (int32:
    the accumulator; bfloat16: rounded through f32). Kernel H on CUDA
    tensors (K a multiple of 16, ``tile`` an index into ``TILES``, None for
    :func:`gemm_tile`'s pick), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return int8_mm_reference(x, w_t, out_dtype)
    _check_operands("int8_mm", x, w_t, torch.int8, 16)
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"int8_mm: out_dtype {out_dtype}; int32 or bfloat16")
    return _kernel_call("int8_mm", x, w_t, out_dtype, tile,
                        _OUT_KINDS[out_dtype])


def bf16_mm_reference(x, w_t):
    """Plain version of :func:`bf16_mm`: an f32 product rounded to bf16."""
    _check_operands("bf16_mm_reference", x, w_t, torch.bfloat16, 1)
    return (x.float() @ w_t.float().T).to(torch.bfloat16)


def bf16_mm(x, w_t, tile: int | None = None):
    """x (M, K) bf16 times w_t (N, K) bf16 -> (M, N) bf16, accumulated in
    f32. Kernel H's bf16 body on CUDA tensors (K a multiple of 8, ``tile``
    as for :func:`int8_mm`), the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return bf16_mm_reference(x, w_t)
    _check_operands("bf16_mm", x, w_t, torch.bfloat16, 8)
    return _kernel_call("bf16_mm", x, w_t, torch.bfloat16, tile)


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values (8 significant bits) at |t|, in f32: the
    unit of the bf16 GEMM's tolerance against its plain version."""
    _, e = torch.frexp(t.float().abs().clamp_min(2.0 ** -126))
    return torch.exp2((e - 8).float())


def int8_matmul(x, w, out_dtype=None, kernel: bool = True):
    """x (..., K) @ w (K, N) through the int8 product with dynamic scales.

    Equal to ``x @ w`` up to the quantization error (~0.5% relative on
    gaussian data); no gradient (serving only). ``w`` may be the (K, N)
    view of an (N, K) weight: its quantized transpose is then contiguous and
    reaches the kernel without a copy. ``kernel=False`` takes the int8
    product's plain version on any device (an exact int32 product, so the
    result is the same)."""
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    xq, xs = quantize_rows(x.reshape(-1, x.shape[-1]))
    wq, ws = quantize_cols(w)
    if kernel:
        acc = int8_mm(xq, wq.T, torch.int32, tile=gemm_tile(
            xq.shape[0], wq.shape[1], xq.shape[1], torch.int8))
    else:
        acc = int8_mm_reference(xq, wq.T, torch.int32)
    out = acc.float() * xs * ws
    return out.reshape(*lead, w.shape[-1]).to(out_dtype)
