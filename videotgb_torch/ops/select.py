"""Question-conditioned frame selection as a fixed-size gather.

1. Draw top_k (start, end) candidates from the TGB span logits by
   Gumbel-perturbed argmax (the argmax of gumbel_softmax; tau cancels).
2. Sanitize each candidate (beyond the flow length, or the degenerate
   (0, 0) pair, falls back to the full span).
3. Rescale flow-domain indices into the candidate-frame domain and take the
   union of the ranges.
4. Empty -> all frames; fewer than nframe -> duplicate every element; more
   -> interval-midpoint re-sampling, all as closed-form index arithmetic over
   a frame mask (the same derivation as ``videotgb_tpu/ops/select.py``).
"""

from __future__ import annotations

import math

import torch

from videotgb_torch.parallel.sharding import global_draw, local_rows


def gumbel_noise(shape, generator=None, device=None):
    """Standard Gumbel samples, -log(-log(U)), f32."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    exponential = -torch.log(u.clamp(min=tiny))
    return -torch.log(exponential.clamp(min=tiny))


def gumbel_span_sample(start_logits, end_logits, generator=None,
                       top_k: int = 2, tau: float = 0.5, noise=None):
    """(B, L) logits -> (starts, ends), each (B, top_k) int32.

    ``noise`` (top_k, 2, B, L) replaces the draw from ``generator``: torch
    cannot reproduce JAX's Threefry bits, so a test hands both versions the
    same noise. Under a data-parallel split the noise is this rank's rows
    of the global batch's (drawn, or handed in whole)."""
    del tau
    if noise is None:
        noise = global_draw(
            lambda shape: gumbel_noise(shape, generator, start_logits.device),
            (top_k, 2, *start_logits.shape), axis=2)
    noise = local_rows(noise, start_logits.shape[0], axis=2)
    noise = noise.to(device=start_logits.device, dtype=torch.float32)
    starts = torch.argmax(start_logits[None].float() + noise[:, 0], dim=-1)
    ends = torch.argmax(end_logits[None].float() + noise[:, 1], dim=-1)
    return starts.T.to(torch.int32), ends.T.to(torch.int32)


def select_frames_from_spans(starts, ends, video_length, num_frames: int,
                             nframe: int, inclusive_end: bool = True,
                             rescale: str = "minus1"):
    """starts/ends (B, K) flow-domain indices, video_length (B,) ->
    (B, nframe) int64 indices into the num_frames candidate frames.

    ``rescale`` "minus1" is int(idx*(F-1)/(L-1)); "ratio" is int(idx/L*F) in
    f32 with the reference's operation order (divide, multiply, trunc).
    ``inclusive_end`` unions range(s, e+1) instead of range(s, e)."""
    if rescale not in ("minus1", "ratio"):
        raise ValueError(f"unknown rescale rule: {rescale!r}")
    dev = starts.device
    starts = starts.long()
    ends = ends.long()
    length = video_length.long()[:, None]

    invalid = (starts >= length) | (ends >= length) | ((starts == 0) & (ends == 0))
    starts = torch.where(invalid, torch.zeros_like(starts), starts)
    ends = torch.where(invalid, (length - 1).expand_as(ends), ends)

    if rescale == "minus1":
        denom = torch.clamp(length - 1, min=1)
        s = torch.div(starts * (num_frames - 1), denom, rounding_mode="floor")
        e = torch.div(ends * (num_frames - 1), denom, rounding_mode="floor")
    else:
        lf = length.float()
        s = torch.floor(starts.float() / lf * num_frames).long()
        e = torch.floor(ends.float() / lf * num_frames).long()

    frame_ids = torch.arange(num_frames, device=dev)
    upper = (frame_ids[None, None, :] <= e[:, :, None] if inclusive_end
             else frame_ids[None, None, :] < e[:, :, None])
    mask = torch.any((frame_ids[None, None, :] >= s[:, :, None]) & upper, dim=1)
    empty = ~torch.any(mask, dim=-1, keepdim=True)
    mask = mask | empty

    m = mask.sum(dim=-1)
    cand = torch.sort(torch.where(mask, frame_ids[None, :],
                                  num_frames + frame_ids[None, :]), dim=-1).values
    cand = torch.where(cand >= num_frames, torch.zeros_like(cand), cand)

    max_d = max(int(math.ceil(math.log2(max(nframe, 1)))) + 1, 1)
    d = torch.zeros_like(m)
    md = m
    for _ in range(max_d):
        need = md < nframe
        d = torch.where(need, d + 1, d)
        md = torch.where(need, md * 2, md)

    x = torch.arange(nframe + 1, device=dev)
    intv = torch.div(x[None, :] * md[:, None], nframe, rounding_mode="floor")
    pos = torch.div(intv[:, :-1] + intv[:, 1:] - 1, 2, rounding_mode="floor")
    orig_pos = torch.div(pos, (2 ** d)[:, None], rounding_mode="floor")
    return torch.gather(cand, 1, orig_pos)


def select_frames(start_logits, end_logits, video_length, num_frames: int,
                  nframe: int, generator=None, top_k: int = 2,
                  tau: float = 0.5, inclusive_end: bool = True,
                  rescale: str = "minus1", noise=None):
    """Gumbel span sampling + fixed-size gather indices."""
    starts, ends = gumbel_span_sample(start_logits, end_logits, generator,
                                      top_k, tau, noise)
    return select_frames_from_spans(starts, ends, video_length, num_frames,
                                    nframe, inclusive_end=inclusive_end,
                                    rescale=rescale)
