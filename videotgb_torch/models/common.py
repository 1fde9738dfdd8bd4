"""Shared building blocks of every tower.

Parameters mirror the JAX package's modules (``videotgb_tpu/models/
common.py``) so that ``videotgb_torch.convert`` maps a flax tree onto a
``state_dict`` by name: a dense layer holds ``weight`` (out, in) and
``bias``, a norm ``weight`` (and ``bias``), an embedding ``weight``.

Dtype policy as in the JAX package: a module holds its parameters in
``param_dtype`` and computes in ``dtype`` (inputs and parameters are cast at
each product); norms compute in f32 and return ``dtype``.

Attention is one module reused by all towers (ViT, Q-Former, T5, TGB) with
hooks for a cross-attention K/V source, RoPE, an additive bias, T5's
unscaled scores, and a KV cache written in place at ``cache_index`` (a
``{"k", "v"}`` dict of (B, H, S_max, D) tensors; updating in place saves
the copy the functional JAX cache makes; the index may be a device tensor,
as inside a CUDA-graphed decode).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from videotgb_torch.ops.attention import dot_product_attention, flash_attention
from videotgb_torch.ops.quant import int8_matmul
from videotgb_torch.parallel.sharding import global_draw


# ------------------------------------------------------------ initialisation
def _fill_normal(param, std, generator):
    with torch.no_grad():
        sample = torch.randn(param.shape, generator=generator,
                             device=param.device, dtype=torch.float32)
        param.copy_(sample * std)


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from ``seed``, drawn on the module's own device:
    every submodule with a ``reset_parameters_from(generator)`` fills its
    own parameters, in module order."""
    first = next(module.parameters())
    gen = torch.Generator(device=first.device)
    gen.manual_seed(seed)
    for m in module.modules():
        fill = getattr(m, "reset_parameters_from", None)
        if fill is not None:
            fill(gen)
    return module


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Dense(nn.Module):
    """Linear layer computing in ``dtype`` (flax ``nn.Dense`` semantics).

    ``quant="int8"`` is the JAX package's ``QuantDense``: the product goes
    through ``ops.quant.int8_matmul`` (W8A8 dynamic, kernel H on the card)
    and the bias is added after the dequant, in ``dtype``. The parameters,
    and so the ``state_dict``, are the same either way. ``use_kernel`` (an
    attribute, True) lets the int8 product take kernel H; set it False to
    run its plain version on any device."""

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32, param_dtype=torch.float32, device=None,
                 quant=None):
        super().__init__()
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant {quant!r}: None or 'int8'")
        self.dtype = dtype
        self.quant = quant
        self.use_kernel = True
        self.weight = _param((out_features, in_features), param_dtype, device)
        self.bias = (_param((out_features,), param_dtype, device)
                     if use_bias else None)

    def reset_parameters_from(self, gen):
        _fill_normal(self.weight, 0.02, gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if self.quant is None:
            return F.linear(x.to(dt), self.weight.to(dt), bias)
        y = int8_matmul(x.to(dt), self.weight.to(dt).T, out_dtype=dt,
                        kernel=self.use_kernel)
        return y if bias is None else y + bias


class Embed(nn.Module):
    def __init__(self, num, features, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param((num, features), param_dtype, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.weight, 0.02, gen)

    def forward(self, ids):
        return F.embedding(ids, self.weight).to(self.dtype)


class RMSNorm(nn.Module):
    """T5LayerNorm: no mean subtraction, no bias; f32 statistics."""

    def __init__(self, dim, eps=1e-6, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _param((dim,), param_dtype, device)

    def reset_parameters_from(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        normed = x32 * torch.rsqrt(var + self.eps)
        return (normed * self.weight.float()).to(self.dtype)


class LayerNorm(nn.Module):
    """LayerNorm with the JAX package's single-pass statistics: E[x] and
    E[x^2] in f32, var = max(E[x^2] - E[x]^2, 0)."""

    def __init__(self, dim, eps=1e-12, dtype=torch.float32,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _param((dim,), param_dtype, device)
        self.bias = _param((dim,), param_dtype, device)

    def reset_parameters_from(self, gen):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        x32 = x.float()
        mean = torch.mean(x32, dim=-1, keepdim=True)
        meansq = torch.mean(x32 * x32, dim=-1, keepdim=True)
        var = torch.clamp(meansq - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        out = (x32 - mean) * (inv * self.weight.float()) + self.bias.float()
        return out.to(self.dtype)


def init_kv_cache(batch, heads, max_len, head_dim, dtype, device):
    return {
        "k": torch.zeros((batch, heads, max_len, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, heads, max_len, head_dim), dtype=dtype,
                         device=device),
    }


def cache_start(cache_index):
    """The first position a cached forward writes: 0 for None, a host int,
    or a 0-dim int64 device tensor (no host read)."""
    if torch.is_tensor(cache_index):
        return cache_index.long()
    return 0 if cache_index is None else int(cache_index)


def write_cache(cache, k, v, cache_index=None):
    """Write the new K/V (B, H, S, D) into the cache buffers at positions
    [cache_index : +S] in place (the JAX package's
    ``dynamic_update_slice``). ``cache_index`` is None (0), a host int, or
    a 0-dim int tensor on the cache's device, which keeps the write free of
    host reads (a CUDA-graph capture)."""
    s = k.shape[2]
    start = cache_start(cache_index)
    if not torch.is_tensor(start):
        cache["k"][:, :, start:start + s] = k
        cache["v"][:, :, start:start + s] = v
        return
    pos = start + torch.arange(s, device=k.device)
    cache["k"].index_copy_(2, pos, k.to(cache["k"].dtype))
    cache["v"].index_copy_(2, pos, v.to(cache["v"].dtype))


class MultiHeadAttention(nn.Module):
    """Attention used by every tower. ``kv_features`` is the width of the
    cross-attention source (the query stream's width by default).
    ``use_flash`` (an attribute, True) lets long sequences take the flash
    kernel; set it False to run the plain version everywhere. ``quant``
    ("int8") routes the q/k/v/o projections through the int8 product; the
    scores and values stay in ``dtype``. ``lora_rank`` > 0 adds a LoRA
    delta (``models.lora.LoRADelta``, modules ``q_lora`` / ``v_lora``) to
    the outputs of the projections named in ``lora_targets``."""

    def __init__(self, features, num_heads, head_dim, kv_features=None,
                 out_features=None, use_bias=True, scale=None,
                 dtype=torch.float32, param_dtype=torch.float32, device=None,
                 quant=None, lora_rank=0, lora_alpha=32.0,
                 lora_targets=("q", "v")):
        super().__init__()
        inner = num_heads * head_dim
        kv_features = kv_features or features
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  device=device, quant=quant)
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.scale = scale
        self.use_flash = True
        self.q = Dense(features, inner, **kw)
        self.k = Dense(kv_features, inner, **kw)
        self.v = Dense(kv_features, inner, **kw)
        self.o = Dense(inner, out_features or features, **kw)
        if lora_rank > 0:
            from videotgb_torch.models.lora import LoRADelta

            widths = {"q": features, "k": kv_features, "v": kv_features}
            for name in lora_targets:
                self.add_module(f"{name}_lora", LoRADelta(
                    widths[name], inner, lora_rank, lora_alpha, dtype=dtype,
                    param_dtype=param_dtype, device=device))

    def _proj(self, name, x):
        """The ``name`` projection (B, S, H*D), with its LoRA delta."""
        y = getattr(self, name)(x)
        delta = self._modules.get(f"{name}_lora")
        return y if delta is None else y + delta(x)

    def _heads(self, y):
        # (B, S, H*D) -> (B, H, S, D) view
        return y.unflatten(-1, (self.num_heads, self.head_dim)).transpose(1, 2)

    def forward(self, x_q, x_kv=None, bias=None, rope_q=None, rope_k=None,
                cache=None, cache_index=None, cross_cached=False,
                return_kv=False):
        """Returns (out (B, Sq, out_features), cache or None).

        * self-attention decode (``cache`` given): the new K/V are written
          into the cache at [cache_index : +Sq] and attention spans the whole
          buffer (the caller's bias masks the unwritten positions);
        * cross-attention read (``cross_cached``): the cache holds the
          encoder K/V; ``x_kv`` is ignored;
        * cross-attention prefill (``return_kv``, no cache): the projected
          K/V are returned as a cache for later reads.
        """
        x_kv = x_q if x_kv is None else x_kv
        q = self._heads(self._proj("q", x_q))
        if cache is not None and cross_cached:
            k, v = cache["k"], cache["v"]
            new_cache = cache
        else:
            k = self._heads(self._proj("k", x_kv))
            v = self._heads(self._proj("v", x_kv))
            if rope_k is not None:
                k = rope_k(k)
            new_cache = None
            if cache is not None:
                write_cache(cache, k, v, cache_index)
                new_cache = cache
                k, v = cache["k"], cache["v"]
            elif return_kv:
                new_cache = {"k": k, "v": v}
        if rope_q is not None:
            q = rope_q(q)

        scale = self.scale if self.scale is not None else self.head_dim ** -0.5
        small = q.shape[2] * k.shape[2] <= 128 * 128
        if self.use_flash and not small:
            ctx = flash_attention(q, k, v, bias=bias, scale=scale)
        else:
            ctx = dot_product_attention(q, k, v, bias=bias, scale=scale)
        ctx = ctx.transpose(1, 2).reshape(*x_q.shape[:-1],
                                          self.num_heads * self.head_dim)
        return self.o(ctx), new_cache


def dropout(x, rate, generator=None, deterministic=True):
    """flax ``nn.Dropout``: keep each entry with probability 1 - rate and
    scale it by 1 / (1 - rate), the mask drawn from ``generator``; the
    identity when ``deterministic`` or ``rate == 0``. ``x`` leads with
    batch rows: under a data-parallel split the mask is this rank's rows of
    the global batch's (``parallel.sharding.global_draw``)."""
    if deterministic or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = global_draw(
        lambda shape: torch.rand(shape, generator=generator, device=x.device),
        x.shape) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


_ACTS = {"gelu": "none", "gelu_new": "tanh"}  # F.gelu's approximate=


class Mlp(nn.Module):
    """Transformer FFN, as the ViT, Q-Former and TGB use it. ``act`` is
    "gelu" (exact erf, HF ``nn.GELU``) or "gelu_new" (the tanh
    approximation); ``quant`` ("int8") routes both products through the
    int8 product."""

    def __init__(self, features, hidden, use_bias=True, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, act="gelu",
                 quant=None):
        super().__init__()
        if act not in _ACTS:
            raise ValueError(f"unknown act {act!r}: one of {sorted(_ACTS)}")
        self.approximate = _ACTS[act]
        kw = dict(use_bias=use_bias, dtype=dtype, param_dtype=param_dtype,
                  device=device, quant=quant)
        self.wi = Dense(features, hidden, **kw)
        self.wo = Dense(hidden, features, **kw)

    def forward(self, x):
        return self.wo(F.gelu(self.wi(x), approximate=self.approximate))


class PatchConv(nn.Module):
    """Non-overlapping patch embedding (conv kernel = stride = patch, VALID)
    of NHWC input, computing in ``dtype``; returns (N, patches, out)."""

    def __init__(self, in_ch, out_ch, patch, dtype, param_dtype, device):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.weight = _param((out_ch, in_ch, patch, patch), param_dtype, device)
        self.bias = _param((out_ch,), param_dtype, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.weight, 0.02, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     self.bias.to(dt), stride=self.patch)
        return y.flatten(2).transpose(1, 2)
