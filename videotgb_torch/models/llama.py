"""LLaMA / Vicuna-7B decoder-only LM (counterpart of
``videotgb_tpu/models/llama.py``): pre-RMSNorm blocks, half-split RoPE on q
and k, bias-free projections, SwiGLU MLP, separate lm_head.

``LlamaModel`` takes ``inputs_embeds`` so the InstructBLIP wrapper can put
the Q-Former's visual tokens in front of the prompt's embeddings. Two
forwards:

* without caches: causal + padding bias over the sequence;
* with caches (a list of per-layer ``{"k", "v"}`` (B, H, S_max, D)
  buffers): the new K/V are written in place at ``cache_index`` and every
  query attends over the whole buffer under the bias ``k_pos <= q_pos``
  plus ``cache_positions_valid`` (B, S_max).

Attention is ``models.common.MultiHeadAttention`` with its dispatch rule:
a prefill with Sq * Skv > 128^2 takes the flash kernel (kernel A on the
card), a single-token decode step the plain version.

``lora_rank`` > 0 puts LoRA deltas on every attention's q and v
projections. The JAX config's ``scan_layers`` / ``remat`` (stacked layers,
the pipeline forward) have no counterpart yet and raise.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videotgb_torch.models.common import (
    Dense,
    Embed,
    MultiHeadAttention,
    RMSNorm,
    cache_start,
    init_kv_cache,
)
from videotgb_torch.ops.attention import NEG_INF, make_causal_bias, make_padding_bias
from videotgb_torch.ops.rope import apply_llama_rope, llama_rope_tables


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    intermediate_size: int = 11008
    rms_norm_eps: float = 1e-6
    rope_base: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    lora_rank: int = 0
    lora_alpha: float = 32.0
    scan_layers: bool = False
    remat: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def vicuna_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=384, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        d, inner = cfg.hidden_size, cfg.intermediate_size
        self.input_ln = RMSNorm(d, cfg.rms_norm_eps, **kw)
        self.attn = MultiHeadAttention(d, cfg.num_heads, cfg.head_dim,
                                       use_bias=False,
                                       lora_rank=cfg.lora_rank,
                                       lora_alpha=cfg.lora_alpha, **kw)
        self.post_ln = RMSNorm(d, cfg.rms_norm_eps, **kw)
        self.gate_proj = Dense(d, inner, use_bias=False, **kw)
        self.up_proj = Dense(d, inner, use_bias=False, **kw)
        self.down_proj = Dense(inner, d, use_bias=False, **kw)

    def forward(self, x, rope_tables, bias, cache=None, cache_index=None):
        """``rope_tables``: the (cos, sin) of ``llama_rope_tables`` at this
        forward's positions."""
        def rope(t):
            return apply_llama_rope(t, *rope_tables)

        attn, new_cache = self.attn(self.input_ln(x), bias=bias, rope_q=rope,
                                    rope_k=rope, cache=cache,
                                    cache_index=cache_index)
        x = x + attn
        h = self.post_ln(x)
        x = x + self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))
        return x, new_cache


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        if cfg.scan_layers or cfg.remat:
            raise NotImplementedError(
                "scan_layers / remat (stacked layers, the pipeline forward) "
                "are not ported: ROADMAP.md queue 1 item 5")
        self.config = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.layers = nn.ModuleList(LlamaBlock(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, **kw)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, use_bias=False,
                             **kw)

    def embed(self, input_ids):
        return self.embed_tokens(input_ids)

    def forward(self, input_ids=None, inputs_embeds=None, attention_mask=None,
                positions=None, caches=None, cache_index=None,
                cache_positions_valid=None):
        """Returns (logits (B, S, V) f32, caches or None). ``positions``
        (B, S) default to ``cache_index`` (0 without caches) + arange(S);
        ``cache_index`` is a host integer or a 0-dim device tensor, from
        which the cache write, the positions and the mask are computed on
        the device."""
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        x = inputs_embeds.to(self.config.dtype)
        b, s = x.shape[:2]
        dev = x.device
        start = cache_start(cache_index)
        if positions is None:
            positions = (start + torch.arange(s, device=dev))[None].expand(
                b, s)
        rope = llama_rope_tables(positions, self.config.head_dim,
                                 self.config.rope_base)
        if caches is None:
            bias = make_causal_bias(s, s, device=dev)
            if attention_mask is not None:
                bias = bias + make_padding_bias(attention_mask)
            for layer in self.layers:
                x, _ = layer(x, rope, bias)
            new_caches = None
        else:
            s_max = caches[0]["k"].shape[-2]
            q_pos = start + torch.arange(s, device=dev)
            k_pos = torch.arange(s_max, device=dev)
            bias = torch.where(k_pos[None, :] <= q_pos[:, None], 0.0,
                               NEG_INF)[None, None]
            if cache_positions_valid is not None:
                bias = bias + make_padding_bias(cache_positions_valid)
            new_caches = []
            for layer, cache in zip(self.layers, caches):
                x, cache = layer(x, rope, bias, cache=cache,
                                 cache_index=start)
                new_caches.append(cache)
        return self.lm_head(self.final_ln(x)).float(), new_caches

    def init_caches(self, batch: int, max_len: int):
        cfg = self.config
        dev = self.embed_tokens.weight.device
        return [init_kv_cache(batch, cfg.num_heads, max_len, cfg.head_dim,
                              cfg.dtype, dev)
                for _ in range(cfg.num_layers)]
