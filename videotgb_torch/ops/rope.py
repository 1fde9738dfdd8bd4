"""Rotary position embeddings, both flavours of the JAX package's
``ops/rope.py``. Plain PyTorch; no kernel needed.

* RoFormer (interleaved): the Temporal Grounding Bridge, over the frame
  axis. Pairs are adjacent lanes (x0, x1), (x2, x3), ...
* LLaMA (half-split): the Vicuna-7B decoder. Pairs are (x_i, x_{i+d/2}).
"""

from __future__ import annotations

import torch


def roformer_sincos_table(max_len: int, dim: int, base: float = 10000.0,
                          device=None):
    """[sin(pos * f_0..f_{d/2-1}) | cos(...)], shape (max_len, dim), f32,
    with inv_freq_k = base^(-2k/dim)."""
    half = dim // 2
    exponent = -2.0 * torch.arange(half, dtype=torch.float32, device=device) / dim
    # the base filled on the device (no host copy: CUDA-graph safe)
    inv_freq = torch.pow(torch.full((), base, dtype=torch.float32,
                                    device=device), exponent)
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


def llama_rope_tables(positions, dim: int, base: float = 10000.0):
    """cos and sin (B, 1, S, dim/2), f32, of the half-split rotation at
    per-row absolute positions (B, S), with inv_freq_k = base^(-k/(dim/2)).
    A LLaMA forward makes them once and every layer's q and k use them."""
    half = dim // 2
    inv_freq = base ** (-torch.arange(half, dtype=torch.float32,
                                      device=positions.device) / half)
    angles = positions[:, None, :, None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_llama_rope(x, cos, sin):
    """Rotate x (B, H, S, D) by :func:`llama_rope_tables`: pairs (x_i,
    x_{i+D/2}), computed in f32, returned in x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def llama_rope(x, positions, base: float = 10000.0):
    """Half-split rotary embedding (LLaMA / Vicuna layout). x (B, H, S, D),
    the attention's own layout (the JAX function takes (B, S, H, D));
    positions (B, S) absolute positions, per row (a cached decode passes its
    offset)."""
    return apply_llama_rope(x, *llama_rope_tables(positions, x.shape[-1],
                                                  base))
