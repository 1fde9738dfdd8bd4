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
functions run on the host in f32 (the scores come from the host's rouge
pass, and F is 32): :func:`largest_rectangle_span` takes a (B, F) tensor
and returns int64 tensors on the device the caller names, moved there in
one copy.
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
    scores' own device when it is None). A CUDA tensor is read back in one
    copy; the stack runs on the host."""
    device = scores.device if device is None else device
    host = scores.detach().to("cpu", torch.float32).numpy()
    spans = np.array([largest_rectangle_span_np(row) for row in host],
                     np.int64).reshape(-1, 2)
    out = torch.from_numpy(spans).to(device)
    return out[:, 0], out[:, 1]


def rescale_index(idx, src_len, dst_len):
    """Map an index between frame domains: int(idx * (dst - 1) / (src - 1))
    by integer floor division, with src - 1 held at 1 or more. Tensors or
    ints; the result is int64."""
    src = torch.as_tensor(src_len, dtype=torch.int64)
    dst = torch.as_tensor(dst_len, dtype=torch.int64)
    idx = torch.as_tensor(idx, dtype=torch.int64)
    src = (src.to(idx.device) - 1).clamp(min=1)
    dst = dst.to(idx.device) - 1
    return torch.div(idx * dst, src, rounding_mode="floor")
