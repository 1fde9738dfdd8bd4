"""Attention: the plain PyTorch version and the flash-attention kernel.

* :func:`dot_product_attention` - plain attention with the JAX package's
  casts: f32 scores, f32 softmax, probabilities cast to ``v.dtype`` before
  the PV product (f32 accumulation), output in ``q.dtype``.
* :func:`flash_attention` - the CUDA kernel ``csrc/flash_fwd.cu`` on CUDA
  tensors (the Hopper counterpart of the Pallas ``_flash_kernel``), the
  plain version on CPU tensors. On a CUDA tensor it launches the kernel or
  raises; there is no fallback.

Shapes follow (batch, heads, seq, head_dim); biases are additive, f32, and
broadcastable to (B, H, Sq, Skv).
"""

from __future__ import annotations

import torch

from videotgb_torch.ops import kernels

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dot_product_attention(q, k, v, bias=None, scale=None):
    """q (B,H,Sq,D), k/v (B,H,Skv,D), bias broadcastable to (B,H,Sq,Skv).
    Returns (B,H,Sq,D) in q.dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _strides3(t):
    return t.stride(0), t.stride(1), t.stride(2)


def flash_forward_cuda(q, k, v, bias, scale):
    """Launch ``flash_fwd`` on CUDA tensors. Inputs may be strided views
    (the last dim must be contiguous); the output is a (B,H,Sq,D) view of a
    (B,Sq,H,D) buffer, so merging heads afterwards is free."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is not a CUDA tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} dtype {t.dtype}; the "
                             "kernel takes float32 or bfloat16, all alike")
        if t.device != q.device:
            raise ValueError("flash_attention: q/k/v on different devices")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             "contiguous")
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    if k.shape != (b, h, s_kv, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if d > 128:
        raise ValueError(f"flash_attention: head dim {d} > 128")
    if bias is not None:
        if not bias.is_cuda or bias.device != q.device:
            raise ValueError("flash_attention: bias is not on q's device")
        if bias.dim() != 4:
            raise ValueError(f"flash_attention: bias must be 4-D, got "
                             f"{tuple(bias.shape)}")
        bias = bias.float().expand(b, h, s_q, s_kv)
        b_strides = bias.stride()
        bias_ptr = bias.data_ptr()
    else:
        b_strides = (0, 0, 0, 0)
        bias_ptr = None
    out = torch.empty((b, s_q, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lib = kernels.library("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        b, h, s_q, s_kv, d, *_strides3(q), *_strides3(k), *_strides3(v),
        *_strides3(out), *b_strides, float(scale), _DTYPE_CODES[q.dtype],
        stream)
    kernels.check_launch("flash_fwd", rc)
    kernels.LAUNCHES["flash_fwd"] += 1
    return out


def flash_attention(q, k, v, bias=None, scale=None):
    """Flash-attention forward: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors (numerically the same function). The kernel has
    no backward yet (the Pallas backward, kernel C, comes with training)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, bias, scale)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        raise NotImplementedError("flash_attention has no backward on CUDA "
                                  "yet; call it under torch.no_grad()")
    return flash_forward_cuda(q, k, v, bias, scale)


def make_padding_bias(mask, dtype=torch.float32):
    """(B, S) 1/0 key mask -> (B, 1, 1, S) additive bias."""
    return ((1.0 - mask.to(dtype)) * NEG_INF)[:, None, None, :]


def make_causal_bias(s_q, s_kv=None, dtype=torch.float32, device=None):
    """(1, 1, S_q, S_kv) causal additive bias; allows k_pos <= q_pos + offset
    where offset aligns the ends (for KV-cache decode suffixes)."""
    s_kv = s_kv if s_kv is not None else s_q
    offset = s_kv - s_q
    q_pos = torch.arange(s_q, device=device)[:, None]
    k_pos = torch.arange(s_kv, device=device)[None, :]
    allowed = k_pos <= q_pos + offset
    bias = torch.where(allowed, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), NEG_INF, dtype=dtype, device=device))
    return bias[None, None]
