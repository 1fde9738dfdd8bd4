"""Fused frame selection: TGB span logits -> Gumbel top-k spans -> frames.

The counterpart of ``videotgb_tpu/ops/select_pallas.py`` (the Pallas
``_select_kernel``). One call does everything downstream of the span
logits: top_k perturbed-argmax (start, end) draws, span sanitization, the
flow -> frame rescale, the union of the ranges over ``num_frames`` <= 128
candidate frames, and the duplicate / midpoint re-sampling to ``nframe``
indices (the semantics of :mod:`videotgb_torch.ops.select`).

* :func:`select_frames_pallas` - the CUDA kernel ``csrc/select_frames.cu``
  on CUDA tensors, the plain version on CPU tensors;
* :func:`select_frames_pallas_reference` - the plain version.

At ``noise_scale=0`` the kernel equals the plain version exactly. With
noise the kernel draws its Gumbel noise from Philox4x32-10 keyed by
``seed``, so it matches the plain version (torch's generator) and the TPU
kernel (the TPU's hardware generator) only in distribution.
"""

from __future__ import annotations

import torch

from videotgb_torch.ops import kernels
from videotgb_torch.ops.select import (
    gumbel_noise,
    gumbel_span_sample,
    select_frames_from_spans,
)

MAX_FRAMES = 128  # the kernel keeps the frame mask in four 32-bit words
_RESCALE_CODES = {"minus1": 0, "ratio": 1}


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


def select_frames_cuda(start_logits, end_logits, video_length, seed: int,
                       num_frames: int, nframe: int, top_k: int,
                       noise_scale: float, inclusive_end: bool,
                       rescale: str):
    """Launch ``select_frames`` on CUDA tensors."""
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
    if not 0 < nframe <= 1024 or top_k <= 0 or l <= 0:
        raise ValueError(f"select_frames: nframe {nframe}, top_k {top_k}, "
                         f"L {l}")
    start = start_logits.float().contiguous()
    end = end_logits.float().contiguous()
    length = video_length.to(torch.int32).contiguous()
    out = torch.empty((b, nframe), dtype=torch.int32, device=dev)
    lib = kernels.library("select_frames")
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.select_frames(start.data_ptr(), end.data_ptr(),
                           length.data_ptr(), out.data_ptr(), b, l,
                           num_frames, nframe, top_k, int(seed) & 0xFFFFFFFF,
                           float(noise_scale), int(inclusive_end),
                           _RESCALE_CODES[rescale], stream)
    kernels.check_launch("select_frames", rc)
    kernels.LAUNCHES["select_frames"] += 1
    return out


def select_frames_pallas(start_logits, end_logits, video_length, seed,
                         num_frames: int = 32, nframe: int = 4,
                         top_k: int = 2, noise_scale: float = 1.0,
                         inclusive_end: bool = False,
                         rescale: str = "minus1"):
    """Fused selection -> (B, nframe) int32 frame indices.

    The CUDA kernel on CUDA tensors (Gumbel noise from Philox keyed by
    ``seed``); on CPU tensors the plain version, its noise from a torch
    generator seeded with ``seed``."""
    _check(rescale, num_frames)
    seed = int(seed)
    if start_logits.device.type == "cpu":
        gen = torch.Generator().manual_seed(seed)
        return select_frames_pallas_reference(
            start_logits, end_logits, video_length, num_frames, nframe, top_k,
            noise_scale, inclusive_end, rescale, generator=gen)
    return select_frames_cuda(start_logits, end_logits, video_length, seed,
                              num_frames, nframe, top_k, noise_scale,
                              inclusive_end, rescale)
