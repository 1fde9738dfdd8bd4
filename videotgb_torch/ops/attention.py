"""Attention: the plain PyTorch version and the flash-attention kernels.

* :func:`dot_product_attention` - plain attention with the JAX package's
  casts: f32 scores, f32 softmax, probabilities cast to ``v.dtype`` before
  the PV product (f32 accumulation), output in ``q.dtype``.
* :func:`flash_attention` - kernel A, ``csrc/flash_fwd.cu``, on CUDA tensors
  (the Hopper counterpart of the Pallas ``_flash_kernel``), the plain
  version on CPU tensors. On a CUDA tensor it launches the kernel or raises;
  there is no fallback. Its gradient is kernel C, ``csrc/flash_bwd.cu``
  (the counterpart of ``_flash_bwd_kernel``), which takes any sequence
  length.
* :func:`flash_body` - which of the two bodies a launch of kernel A or C
  runs: the tensor-core body (``mma.sync``: ``csrc/flash_mma.cuh`` for A,
  with P kept in registers; ``csrc/flash_bwd_mma.cuh`` for C) for bf16
  inputs with 16-byte rows, every shape the port's paths hand them; the
  CUDA-core body (plain FMAs: ``csrc/flash_fma.cuh``, and the kernels of
  ``csrc/flash_bwd.cu``) for f32 inputs, which the tensor cores would take
  only as TF32, and for unaligned bf16 rows. Kernel G
  (``tools/attnlayoutprobe.py``) follows the same rule.
* :func:`flash_bwd_passes` - how many launches C's tensor-core body takes
  at a shape: one where a head's keys, P and dS fit one block (the T5-xl
  encoder's 160 x 160), else a rows pass and a columns pass.
* :func:`flash_backward_reference` - the plain version of that backward.

On the H100 attention at the ViT-g and T5-xl shapes is bound by memory (~130
FLOP per byte, under the card's ~295); the tensor-core body keeps the score
matrix in registers and reads q, k and v once per 64-row query tile.

Shapes follow (batch, heads, seq, head_dim); biases are additive, f32, and
broadcastable to (B, H, Sq, Skv).
"""

from __future__ import annotations

import torch

from videotgb_torch.ops import kernels

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BODY_CODES = {"fma": 0, "mma": 1}  # the C entries' ``body`` argument


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


def flash_body(*tensors) -> str:
    """``"mma"`` (the tensor-core body) for bf16 inputs whose rows are 16
    bytes aligned: the head dim a multiple of 8, every base pointer a
    multiple of 16 bytes and the first three strides multiples of 8
    elements; else ``"fma"`` (the CUDA-core body). Kernels A and G pass q,
    k and v, kernel C also dO. A pure function of the tensors' dtype, shape,
    strides and addresses, on any device."""
    q = tensors[0]
    if q.dtype != torch.bfloat16 or q.shape[-1] % 8:
        return "fma"
    for t in tensors:
        if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
            return "fma"
    return "mma"


# kernel C's tensor-core body (csrc/flash_bwd_mma.cuh::one_pass): one block
# per head holds every key's S and dP in registers up to this many keys
_BWD_ONE_PASS_KEYS = 160
_SMEM_PER_BLOCK = 232448  # bytes a block may have on sm_90


def flash_bwd_one_pass_bytes(s_q: int, s_kv: int, d: int) -> int:
    """Shared bytes of kernel C's one-pass block at (Sq, Skv, head dim): the
    head's Q, dO, K and V (rows of 2 DP + 16 bytes, DP the head dim padded to
    16, 32, 64, 96 or 128) and its bf16 P and dS (rows of 2 Skv + 16 bytes),
    every row count rounded up to 16."""
    dp = next(p for p in (16, 32, 64, 96, 128) if d <= p)
    qp, kp = -(-s_q // 16) * 16, -(-s_kv // 16) * 16
    return 2 * (qp + kp) * (2 * dp + 16) + 2 * qp * (2 * kp + 16)


def flash_bwd_passes(s_q: int, s_kv: int, d: int) -> int:
    """Launches of kernel C's tensor-core body at (Sq, Skv, head dim): 1
    where Skv <= 160 and :func:`flash_bwd_one_pass_bytes` fit one block,
    else 2 (a rows pass and a columns pass)."""
    fits = flash_bwd_one_pass_bytes(s_q, s_kv, d) <= _SMEM_PER_BLOCK
    return 1 if s_kv <= _BWD_ONE_PASS_KEYS and fits else 2


def _check_inputs(q, k, v, bias, g=None):
    """Raise on what the kernels do not take; returns the bias as an f32
    (B, H, Sq, Skv) broadcast view, or None."""
    named = [("q", q), ("k", k), ("v", v)] + ([("grad", g)] if g is not None
                                              else [])
    for name, t in named:
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
    return bias


def _bias_args(bias):
    """The bias pointer and its 4 strides (0 on broadcast dims)."""
    if bias is None:
        return None, (0, 0, 0, 0)
    return bias.data_ptr(), bias.stride()


def flash_forward_cuda(q, k, v, bias, scale):
    """Launch ``flash_fwd`` on CUDA tensors. Inputs may be strided views
    (the last dim must be contiguous); the output is a (B,H,Sq,D) view of a
    (B,Sq,H,D) buffer, so merging heads afterwards is free."""
    bias = _check_inputs(q, k, v, bias)
    bias_ptr, b_strides = _bias_args(bias)
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    out = torch.empty((b, s_q, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    body = flash_body(q, k, v)
    lib = kernels.library("flash_fwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        b, h, s_q, s_kv, d, *_strides3(q), *_strides3(k), *_strides3(v),
        *_strides3(out), *b_strides, float(scale), _DTYPE_CODES[q.dtype],
        BODY_CODES[body], stream)
    kernels.check_launch("flash_fwd", rc)
    kernels.count("flash_fwd", body)
    return out


def _reduce_to(ds, shape, dtype):
    """Sum the (B, H, Sq, Skv) cotangent over every broadcast dim of a bias
    of ``shape`` (the reduction ``_flash_backward_pallas`` does outside its
    kernel)."""
    for axis in range(4):
        if shape[axis] == 1:
            ds = ds.sum(dim=axis, keepdim=True)
    return ds.to(dtype)


def flash_backward_reference(q, k, v, bias, g, scale, bias_needs_grad=True):
    """Plain version of the fused backward (the Pallas ``_flash_bwd_kernel``):
    recompute the f32 softmax from q/k/v/bias, then
    dv = p^T dO, dp = dO v^T, ds = p (dp - rowsum(dp p)),
    dq = ds k * scale, dk = ds^T q * scale, with p rounded to v's dtype for
    dv and ds to q's dtype for dq/dk (f32 accumulation throughout).
    Returns (dq, dk, dv, dbias) with dbias reduced to the bias's own shape,
    or None when there is no bias or ``bias_needs_grad`` is False."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True)
    gf = g.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(q.dtype).float()
    dq = torch.matmul(dsb, k.float()) * scale
    dk = torch.matmul(dsb.transpose(-1, -2), q.float()) * scale
    dbias = None
    if bias is not None and bias_needs_grad:
        dbias = _reduce_to(ds, bias.shape, bias.dtype)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def flash_backward_cuda(q, k, v, bias, g, scale, bias_needs_grad=True):
    """Launch ``flash_bwd`` on CUDA tensors; returns (dq, dk, dv, dbias or
    None) like :func:`flash_backward_reference`. The body is
    :func:`flash_body` of q, k, v and g. q/k/v/g may be strided views (a ``g``
    whose last dim is not contiguous is copied); dq/dk/dv are (B,H,S,D)
    views of (B,S,H,D) buffers, the layout of the projections they flow
    back into."""
    b, h, s_q, d = q.shape
    s_kv = k.shape[2]
    if g.shape != q.shape:
        raise ValueError(f"flash_backward: grad {tuple(g.shape)} != q "
                         f"{tuple(q.shape)}")
    if g.stride(-1) != 1:
        g = g.contiguous()
    need_ds = bias is not None and bias_needs_grad
    bias_f32 = _check_inputs(q, k, v, bias, g=g)
    bias_ptr, b_strides = _bias_args(bias_f32)
    dq = torch.empty((b, s_q, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty((b, s_kv, h, d), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    body = flash_body(q, k, v, g)
    # per-row softmax max, sum and rowsum(dp * p) of the two-pass launches
    stats = torch.empty((3, b * h, s_q), dtype=torch.float32, device=q.device)
    ds = (torch.empty((b, h, s_q, s_kv), dtype=torch.float32, device=q.device)
          if need_ds else None)
    lib = kernels.library("flash_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, g.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if ds is None else ds.data_ptr(), stats.data_ptr(),
        b, h, s_q, s_kv, d, *_strides3(q), *_strides3(k), *_strides3(v),
        *_strides3(g), *_strides3(dq), *_strides3(dk), *_strides3(dv),
        *b_strides, float(scale), _DTYPE_CODES[q.dtype], BODY_CODES[body],
        stream)
    kernels.check_launch("flash_bwd", rc)
    kernels.count("flash_bwd", body)
    dbias = None if ds is None else _reduce_to(ds, bias.shape, bias.dtype)
    return dq, dk, dv, dbias


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the JAX ``_flash_attention`` custom VJP: the forward
    kernel saves q/k/v/bias (no probabilities, no output); the backward
    kernel recomputes the softmax, and writes ds only when autograd needs
    the bias's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias)
        return flash_forward_cuda(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv, dbias = flash_backward_cuda(
            q, k, v, bias, g, ctx.scale,
            bias_needs_grad=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None


def flash_attention(q, k, v, bias=None, scale=None):
    """Flash attention: the CUDA kernels on CUDA tensors (forward, and the
    fused backward when autograd asks for one), the plain version with
    autograd's backward on CPU tensors (numerically the same function)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return dot_product_attention(q, k, v, bias, scale)
    return _FlashAttention.apply(q, k, v, bias, scale)


def make_padding_bias(mask, dtype=torch.float32):
    """(B, S) 1/0 key mask -> (B, 1, 1, S) additive bias."""
    return ((1.0 - mask.to(dtype)) * NEG_INF)[:, None, None, :]


def make_causal_bias(s_q, s_kv=None, dtype=torch.float32, device=None,
                     q_positions=None):
    """(1, 1, S_q, S_kv) causal additive bias: key k is open to a query at
    position p where k <= p. The queries' positions are ``q_positions``
    (S_q,) when given (a rank's tokens of a split stream, a cached call's
    tokens), else arange(S_q) + S_kv - S_q: the ends aligned (for KV-cache
    decode suffixes)."""
    s_kv = s_kv if s_kv is not None else s_q
    if q_positions is None:
        q_positions = torch.arange(s_q, device=device) + (s_kv - s_q)
    k_pos = torch.arange(s_kv, device=device)[None, :]
    allowed = k_pos <= q_positions[:, None]
    bias = torch.where(allowed, torch.zeros((), dtype=dtype, device=device),
                       torch.full((), NEG_INF, dtype=dtype, device=device))
    return bias[None, None]
