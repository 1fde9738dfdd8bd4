"""Fused frame selection: TGB span logits -> Gumbel top-k spans -> frames.

The counterpart of ``videotgb_tpu/ops/select_pallas.py`` (the Pallas
``_select_kernel``). One call does everything downstream of the span
logits: top_k perturbed-argmax (start, end) draws, span sanitization, the
flow -> frame rescale, the union of the ranges over ``num_frames`` (up to
``MAX_FRAMES``) candidate frames, and the duplicate / midpoint re-sampling
to ``nframe`` indices (the semantics of :mod:`videotgb_torch.ops.select`).

* :func:`select_frames_pallas` - the CUDA kernel ``csrc/select_frames.cu``
  on CUDA tensors, the plain version on CPU tensors;
* :func:`select_frames_cuda` - the launch, which ``VideoTGB.select_frames``
  takes on the card: the logits read through their strides (the TGB head's
  (B, L, 2) views), the seed from a device tensor (:func:`draw_seed`), the
  indices written in the caller's dtype;
* :func:`select_frames_pallas_reference` - the plain version.

At ``noise_scale=0``, or with the same handed-in ``noise``, the kernel
equals the plain version exactly. Otherwise the kernel draws its Gumbel
noise from Philox4x32-10 keyed by the seed, so it matches the plain version
(torch's generator) and the TPU kernel (the TPU's hardware generator) only
in distribution.
"""

from __future__ import annotations

import torch

from videotgb_torch.ops import kernels
from videotgb_torch.ops.select import (
    gumbel_noise,
    gumbel_span_sample,
    select_frames_from_spans,
)

# the kernel spreads a row's frame mask over a warp's 32 lanes, up to 32
# words of 32 frames a lane in registers
MAX_FRAMES = 32 * 32 * 32
MAX_NFRAME = 1024
_RESCALE_CODES = {"minus1": 0, "ratio": 1}
_LENGTH_CODES = {torch.int32: 0, torch.int64: 1}
_OUT_CODES = {torch.int32: 0, torch.int64: 1}


def _check(rescale: str, num_frames: int) -> None:
    if rescale not in _RESCALE_CODES:
        raise ValueError(f"unknown rescale rule: {rescale!r}")
    if not 0 < num_frames <= MAX_FRAMES:
        raise ValueError(f"num_frames {num_frames}: the selection kernel "
                         f"takes 1 to {MAX_FRAMES} candidate frames")


def select_frames_pallas_reference(start_logits, end_logits, video_length,
                                   num_frames: int = 32, nframe: int = 4,
                                   top_k: int = 2, noise_scale: float = 1.0,
                                   inclusive_end: bool = False,
                                   rescale: str = "minus1", generator=None,
                                   noise=None):
    """Plain version: (B, nframe) int32 frame indices.

    At ``noise_scale=0`` the argmax spans, tiled top_k times; otherwise
    ``noise_scale`` times Gumbel noise (top_k, 2, B, L) from ``generator``,
    or the ``noise`` the caller hands in, is added before each argmax."""
    _check(rescale, num_frames)
    if noise_scale == 0.0:
        # broadcasts over (B, L): every draw is the plain argmax
        noise = torch.zeros((top_k, 2, 1, 1), device=start_logits.device)
    elif noise is None:
        noise = gumbel_noise((top_k, 2, *start_logits.shape), generator,
                             start_logits.device)
    starts, ends = gumbel_span_sample(start_logits, end_logits, top_k=top_k,
                                      noise=noise_scale * noise)
    return select_frames_from_spans(
        starts, ends, video_length, num_frames, nframe,
        inclusive_end=inclusive_end, rescale=rescale).to(torch.int32)


def draw_seed(generator, device):
    """Kernel D's seed: an int32 (1,) tensor on ``device``, drawn from
    ``generator`` (the device's default generator when None) on the
    generator's own device. A CUDA generator makes it one launch on the
    card, with no host integer in between."""
    where = device if generator is None else generator.device
    seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=where, dtype=torch.int32)
    return seed.to(device)


def select_launch_args(start_logits, end_logits, video_length, seed,
                       num_frames: int, nframe: int, top_k: int,
                       noise_scale: float, inclusive_end: bool, rescale: str,
                       noise=None, out_dtype=torch.int32, row_offset: int = 0):
    """Check kernel D's inputs and allocate its output. Returns the output,
    the C entry's arguments but the stream, and the tensors its pointers
    refer to (the caller holds them through the launch).

    The logits go as they lie, with their row and element strides (f32;
    another dtype is cast once); the lengths as int32 or int64 (another
    dtype is cast to int32, truncating as the plain ``.long()`` does); the
    seed as a device int32 tensor's pointer or, given an int, by value;
    ``noise`` (top_k, 2, B, L) as a contiguous f32 copy on the device;
    ``row_offset``, the global index of the first row, keys the Philox
    draw (a data-parallel rank's rows draw what they draw at world 1)."""
    _check(rescale, num_frames)
    if start_logits.dim() != 2 or end_logits.shape != start_logits.shape:
        raise ValueError(f"select_frames: logits must be two (B, L) tensors, "
                         f"got {tuple(start_logits.shape)} and "
                         f"{tuple(end_logits.shape)}")
    b, l = start_logits.shape
    dev = start_logits.device
    if not (end_logits.device == dev and video_length.device == dev):
        raise ValueError("select_frames: inputs on different devices")
    if video_length.shape != (b,):
        raise ValueError(f"select_frames: video_length "
                         f"{tuple(video_length.shape)}, expected ({b},)")
    if (not 0 < nframe <= MAX_NFRAME or top_k <= 0 or b <= 0 or l <= 0
            or row_offset < 0):
        raise ValueError(f"select_frames: B {b}, L {l}, nframe {nframe} "
                         f"(1 to {MAX_NFRAME}), top_k {top_k}, row_offset "
                         f"{row_offset}")
    if out_dtype not in _OUT_CODES:
        raise ValueError(f"select_frames: out_dtype {out_dtype}; int32 or "
                         "int64")
    start, end = (x if x.dtype == torch.float32 else x.float()
                  for x in (start_logits, end_logits))
    length = (video_length if video_length.dtype in _LENGTH_CODES
              else video_length.to(torch.int32)).contiguous()
    if isinstance(seed, torch.Tensor):
        if seed.device != dev or seed.dtype != torch.int32 or \
                seed.numel() != 1:
            raise ValueError(f"select_frames: a seed tensor must be one "
                             f"int32 on {dev}, got {seed.dtype} "
                             f"{tuple(seed.shape)} on {seed.device}")
        seed_ptr, seed_value = seed.data_ptr(), 0
    else:
        seed_ptr, seed_value = None, int(seed) & 0xFFFFFFFF
    noise_ptr = None
    if noise is not None:
        if tuple(noise.shape) != (top_k, 2, b, l):
            raise ValueError(f"select_frames: noise {tuple(noise.shape)}, "
                             f"expected {(top_k, 2, b, l)}")
        noise = noise.to(device=dev, dtype=torch.float32).contiguous()
        noise_ptr = noise.data_ptr()
    out = torch.empty((b, nframe), dtype=out_dtype, device=dev)
    args = (start.data_ptr(), end.data_ptr(), start.stride(0),
            start.stride(1), end.stride(0), end.stride(1), length.data_ptr(),
            _LENGTH_CODES[length.dtype], noise_ptr, seed_ptr, seed_value,
            out.data_ptr(), _OUT_CODES[out_dtype], b, int(row_offset), l,
            num_frames, nframe,
            top_k, float(noise_scale), int(inclusive_end),
            _RESCALE_CODES[rescale])
    return out, args, (start, end, length, noise, seed)


def select_frames_cuda(start_logits, end_logits, video_length, seed,
                       num_frames: int, nframe: int, top_k: int,
                       noise_scale: float, inclusive_end: bool,
                       rescale: str, noise=None, out_dtype=torch.int32,
                       row_offset: int = 0):
    """Launch ``select_frames`` on CUDA tensors -> (B, nframe) indices of
    ``out_dtype``. ``seed``: an int, or a device int32 tensor
    (:func:`draw_seed`); ``noise`` replaces the Philox draw; the rows are
    rows ``row_offset`` on of the draw."""
    out, args, _keep = select_launch_args(
        start_logits, end_logits, video_length, seed, num_frames, nframe,
        top_k, noise_scale, inclusive_end, rescale, noise, out_dtype,
        row_offset)
    lib = kernels.library("select_frames")
    stream = torch.cuda.current_stream(out.device).cuda_stream
    kernels.check_launch("select_frames", lib.select_frames(*args, stream))
    kernels.count("select_frames")
    return out


def select_frames_pallas(start_logits, end_logits, video_length, seed,
                         num_frames: int = 32, nframe: int = 4,
                         top_k: int = 2, noise_scale: float = 1.0,
                         inclusive_end: bool = False,
                         rescale: str = "minus1"):
    """Fused selection -> (B, nframe) int32 frame indices.

    The CUDA kernel on CUDA tensors (Gumbel noise from Philox keyed by
    ``seed``, an int or a device int32 tensor); on CPU tensors the plain
    version, its noise from a torch generator seeded with ``seed``."""
    if start_logits.device.type == "cpu":
        gen = torch.Generator().manual_seed(int(seed))
        return select_frames_pallas_reference(
            start_logits, end_logits, video_length, num_frames, nframe, top_k,
            noise_scale, inclusive_end, rescale, generator=gen)
    return select_frames_cuda(start_logits, end_logits, video_length, seed,
                              num_frames, nframe, top_k, noise_scale,
                              inclusive_end, rescale)
