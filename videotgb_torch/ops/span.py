"""Pseudo-label span extraction: the largest rectangle under the score
histogram (counterpart of ``videotgb_tpu/ops/span.py``).

The self-refinement recipe scores each candidate frame by how well the MLLM
answers from that frame alone (rouge_n recall), then turns the per-frame
score profile into a (start, end) span with the monotone-stack
largest-rectangle algorithm:

    score <- score - min(score); pad a 0 sentinel on both sides
    classic largest-rectangle-in-histogram; the first rectangle of the
    largest area (strict ``>``) gives the span [stack_top, i - 2] in the
    original indices.

The algorithm is invariant to a uniform scaling of the scores. Both
functions compute in f32: :func:`largest_rectangle_span_np` runs the stack
on the host, :func:`largest_rectangle_span` its closed form on a (B, F)
tensor where the SF train step runs (no host read, so the step can be
captured in a CUDA graph).
"""

from __future__ import annotations

import numpy as np
import torch


def largest_rectangle_span_np(scores) -> tuple[int, int]:
    """scores (F,) -> (start, end); a flat profile gives (0, F - 1)."""
    scores = np.asarray(scores, dtype=np.float32)
    f = len(scores)
    best = np.float32(0.0)
    start, end = 0, f - 1
    padded = np.concatenate([np.zeros(1, np.float32), scores - scores.min(),
                             np.zeros(1, np.float32)])
    stack: list[int] = []
    for i in range(len(padded)):
        while stack and padded[stack[-1]] > padded[i]:
            top = stack.pop()
            left = stack[-1] if stack else -1
            area = np.float32(i - left - 1) * padded[top]
            if area > best:
                best = area
                start, end = left, i - 2
        stack.append(i)
    return start, end


def largest_rectangle_span(scores: torch.Tensor, device=None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """scores (B, F) -> (starts (B,), ends (B,)) int64 on ``device`` (the
    scores' own device when it is None), computed there without a host
    read (the JAX package runs its loop inside the jitted SF step; this is
    a CUDA-graph safe closed form of the same stack). Bar t of the padded
    profile h is popped at r(t), the first i > t with h[i] < h[t], and its
    rectangle spans from l(t), the last i < t with h[i] <= h[t]; the stack
    pops in order of (r, -t), and the first rectangle of the largest area
    (f32, strictly above 0) wins. Equal to :func:`largest_rectangle_span_np`
    row by row."""
    device = scores.device if device is None else device
    s = scores.detach().to(device, torch.float32)
    b, f = s.shape
    n = f + 2
    zero = torch.zeros((b, 1), dtype=torch.float32, device=device)
    h = torch.cat([zero, s - s.min(dim=1, keepdim=True).values, zero], 1)
    idx = torch.arange(n, device=device)
    later = idx[None, :] > idx[:, None]  # (t, i): i > t
    right = torch.where(later & (h[:, None, :] < h[:, :, None]), idx,
                        n).amin(dim=2)
    left = torch.where(later.T & (h[:, None, :] <= h[:, :, None]), idx,
                       -1).amax(dim=2)
    area = (right - left - 1).float() * h
    area = torch.where((h > 0) & (right < n), area, torch.zeros_like(area))
    best = area.amax(dim=1, keepdim=True)
    order = torch.where(area == best, right * n + (n - 1 - idx),
                        n * n * 2)  # earliest pop first
    top = order.argmin(dim=1, keepdim=True)
    found = best[:, 0] > 0
    starts = torch.where(found, left.gather(1, top)[:, 0], 0)
    ends = torch.where(found, right.gather(1, top)[:, 0] - 2, f - 1)
    return starts, ends


def rescale_index(idx, src_len, dst_len):
    """Map an index between frame domains: int(idx * (dst - 1) / (src - 1))
    by integer floor division, with src - 1 held at 1 or more. Tensors or
    ints; the result is int64 (host ints stay on the host: no copy)."""
    idx = torch.as_tensor(idx).long()

    def prep(x):
        return x.to(idx.device, torch.int64) if torch.is_tensor(x) else int(x)

    src, dst = prep(src_len) - 1, prep(dst_len) - 1
    src = src.clamp(min=1) if torch.is_tensor(src) else max(src, 1)
    return torch.div(idx * dst, src, rounding_mode="floor")
