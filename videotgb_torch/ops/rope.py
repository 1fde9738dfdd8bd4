"""RoFormer (interleaved) rotary position embeddings, used by the Temporal
Grounding Bridge over the frame axis. Plain PyTorch; no kernel needed."""

from __future__ import annotations

import torch


def roformer_sincos_table(max_len: int, dim: int, base: float = 10000.0,
                          device=None):
    """[sin(pos * f_0..f_{d/2-1}) | cos(...)], shape (max_len, dim), f32,
    with inv_freq_k = base^(-2k/dim)."""
    half = dim // 2
    exponent = -2.0 * torch.arange(half, dtype=torch.float32, device=device) / dim
    inv_freq = torch.pow(torch.tensor(base, dtype=torch.float32, device=device),
                         exponent)
    angles = (torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
              * inv_freq[None, :])
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def roformer_rope(x, sincos):
    """Interleaved rotary embedding. x (..., seq, dim); sincos (seq, dim).
    sin/cos halves are duplicated into [s0,s0,s1,s1,...]; rotate-half is
    [-x1,x0,-x3,x2,...]. Computed in f32, returned in x's dtype."""
    dim = x.shape[-1]
    half = dim // 2
    sin, cos = sincos[..., :half], sincos[..., half:]
    sin_pos = torch.stack([sin, sin], dim=-1).reshape(*sincos.shape[:-1], dim)
    cos_pos = torch.stack([cos, cos], dim=-1).reshape(*sincos.shape[:-1], dim)
    pairs = x.reshape(*x.shape[:-1], half, 2)
    rotated = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)
    return (x.float() * cos_pos + rotated.float() * sin_pos).to(x.dtype)
