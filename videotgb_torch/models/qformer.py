"""Q-Former: 32 learned queries compress the ViT patches (counterpart of
``videotgb_tpu/models/qformer.py``). Queries self-attend (together with
instruction text in the instruction-aware variant); every
``cross_attention_frequency`` layers the query positions cross-attend into
the image embeddings; the FFN is split between query and text positions.
Returns the query slice (B, Q, hidden).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videotgb_torch.models.common import (
    Embed,
    LayerNorm,
    Mlp,
    MultiHeadAttention,
    _fill_normal,
    _param,
)
from videotgb_torch.ops.attention import make_padding_bias


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    num_query_tokens: int = 32
    cross_attention_frequency: int = 2
    encoder_hidden_size: int = 1408
    max_position_embeddings: int = 512
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, encoder_hidden_size: int = 64) -> "QFormerConfig":
        return cls(vocab_size=384, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, num_query_tokens=8,
                   encoder_hidden_size=encoder_hidden_size)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool,
                 instruction: bool, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        d = cfg.hidden_size
        self.self_attn = MultiHeadAttention(d, cfg.num_heads, cfg.head_dim, **kw)
        self.self_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.cross_attn = self.cross_ln = None
        if has_cross_attention:
            self.cross_attn = MultiHeadAttention(
                d, cfg.num_heads, cfg.head_dim,
                kv_features=cfg.encoder_hidden_size, **kw)
            self.cross_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.mlp_query = Mlp(d, cfg.intermediate_size, **kw)
        self.ffn_query_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.mlp_text = self.ffn_text_ln = None
        if instruction:
            self.mlp_text = Mlp(d, cfg.intermediate_size, **kw)
            self.ffn_text_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)

    def forward(self, x, self_bias, encoder_hidden_states, encoder_bias,
                query_length):
        attn, _ = self.self_attn(x, bias=self_bias)
        x = self.self_ln(x + attn)
        query = x[:, :query_length]
        if self.cross_attn is not None and encoder_hidden_states is not None:
            cross, _ = self.cross_attn(query, x_kv=encoder_hidden_states,
                                       bias=encoder_bias)
            query = self.cross_ln(query + cross)
        query = self.ffn_query_ln(query + self.mlp_query(query))
        if x.shape[1] > query_length:
            text = x[:, query_length:]
            text = self.ffn_text_ln(text + self.mlp_text(text))
            return torch.cat([query, text], dim=1)
        return query


class QFormerModel(nn.Module):
    """``input_ids=None`` is the BLIP2 variant; instruction token ids give
    the instruction-aware variant (built with ``instruction=True``)."""

    def __init__(self, cfg: QFormerConfig, instruction: bool = False,
                 device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.word_embeddings = self.position_embeddings = None
        if instruction:
            self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, **kw)
            self.position_embeddings = _param(
                (cfg.max_position_embeddings, cfg.hidden_size),
                cfg.param_dtype, device)
        self.embeddings_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0,
                         instruction, device)
            for i in range(cfg.num_layers))

    def reset_parameters_from(self, gen):
        if self.position_embeddings is not None:
            _fill_normal(self.position_embeddings, 0.02, gen)

    def forward(self, query_embeds, encoder_hidden_states,
                encoder_attention_mask=None, input_ids=None,
                attention_mask=None):
        cfg = self.config
        b, q_len = query_embeds.shape[:2]
        dev = query_embeds.device
        x = query_embeds.to(cfg.dtype)
        self_mask = torch.ones((b, q_len), dtype=torch.float32, device=dev)
        if input_ids is not None:
            tok = self.word_embeddings(input_ids)
            tok = tok + self.position_embeddings[None, :tok.shape[1]].to(cfg.dtype)
            x = torch.cat([x, tok], dim=1)
            text_mask = (attention_mask.float() if attention_mask is not None
                         else torch.ones(input_ids.shape, dtype=torch.float32,
                                         device=dev))
            self_mask = torch.cat([self_mask, text_mask], dim=1)
        x = self.embeddings_ln(x)
        self_bias = make_padding_bias(self_mask)
        encoder_bias = (None if encoder_attention_mask is None
                        else make_padding_bias(encoder_attention_mask))
        enc = encoder_hidden_states.to(cfg.dtype)
        for layer in self.layers:
            x = layer(x, self_bias, enc, encoder_bias, q_len)
        return x[:, :q_len]
