"""Temporal Grounding Bridge (TGB): the RoPE-BERT span predictor over
optical flow (counterpart of ``videotgb_tpu/models/tgb.py`` ``TGBModel``).

One 768-d token per flow frame (16x16/s16 patch conv, then a learned
Linear(196 -> 1) over the patches), learned BOS/EOS (EOS written at the true
length), frame-position embeddings; RoPE over the frame axis in
self-attention; layers >= ``fusion_layer`` cross-attend into the question
embeddings; the MRC head gives per-frame start/end logits. ``mode`` picks
the layer range: text/vision = [0, fusion), fusion = [fusion, N),
multi_modal = [0, N). Flow enters NHWC, (B, L, H, W, 2).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videotgb_torch.models.common import (
    Dense,
    Embed,
    LayerNorm,
    Mlp,
    MultiHeadAttention,
    PatchConv,
    _fill_normal,
    _param,
    dropout,
)
from videotgb_torch.ops.attention import make_padding_bias
from videotgb_torch.ops.rope import roformer_rope, roformer_sincos_table


@dataclasses.dataclass(frozen=True)
class TGBConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    fusion_layer: int = 6
    encoder_width: int = 768
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    patch_size: int = 16
    flow_size: int = 224
    hidden_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.flow_size // self.patch_size) ** 2

    @classmethod
    def tiny(cls) -> "TGBConfig":
        return cls(vocab_size=384, hidden_size=32, num_layers=4, num_heads=2,
                   intermediate_size=64, fusion_layer=2, encoder_width=32,
                   flow_size=32, max_position_embeddings=128)


class TemporalOFEmbedding(nn.Module):
    def __init__(self, cfg: TGBConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.projection = PatchConv(2, cfg.hidden_size, cfg.patch_size, **kw)
        self.fc = Dense(cfg.num_patches, 1, **kw)
        self.bos = _param((cfg.hidden_size,), cfg.param_dtype, device)
        self.eos = _param((cfg.hidden_size,), cfg.param_dtype, device)
        self.frame_pos_embed = Embed(cfg.max_position_embeddings,
                                     cfg.hidden_size, **kw)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)

    def reset_parameters_from(self, gen):
        # the reference leaves bos/eos as torch.empty; initialise explicitly
        _fill_normal(self.bos, 0.02, gen)
        _fill_normal(self.eos, 0.02, gen)

    def forward(self, flow, flow_mask, deterministic=True, generator=None):
        """flow (B, L, H, W, 2), flow_mask (B, L+2) -> (B, L+2, hidden)."""
        cfg = self.config
        dt = cfg.dtype
        b, l = flow.shape[:2]
        x = self.projection(flow.reshape(b * l, *flow.shape[2:]))
        x = self.fc(x.transpose(1, 2)).reshape(b, l, cfg.hidden_size)
        bos = self.bos.to(dt).expand(b, 1, cfg.hidden_size)
        x = torch.cat([bos, x, torch.zeros((b, 1, cfg.hidden_size), dtype=dt,
                                           device=x.device)], dim=1)
        ends = flow_mask.long().sum(dim=1) - 1
        onehot = F.one_hot(ends, l + 2).to(dt)
        x = x * (1 - onehot)[..., None] + onehot[..., None] * self.eos.to(dt)
        pos = self.frame_pos_embed(torch.arange(l + 2, device=x.device))[None]
        return dropout(self.ln(x + pos), cfg.hidden_dropout, generator,
                       deterministic)


class TGBLayer(nn.Module):
    def __init__(self, cfg: TGBConfig, has_cross_attention: bool, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        d = cfg.hidden_size
        self.self_attn = MultiHeadAttention(d, cfg.num_heads, cfg.head_dim, **kw)
        self.self_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.cross_attn = self.cross_ln = None
        if has_cross_attention:
            self.cross_attn = MultiHeadAttention(
                d, cfg.num_heads, cfg.head_dim, kv_features=cfg.encoder_width,
                **kw)
            self.cross_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.mlp = Mlp(d, cfg.intermediate_size, **kw)
        self.ffn_ln = LayerNorm(d, cfg.layer_norm_eps, **kw)

    def forward(self, x, self_bias, text, text_bias, sincos_self, sincos_cross):
        def rope_self(t):
            return roformer_rope(t, sincos_self)

        attn, _ = self.self_attn(x, bias=self_bias, rope_q=rope_self,
                                 rope_k=rope_self)
        x = self.self_ln(x + attn)
        if self.cross_attn is not None:
            cross, _ = self.cross_attn(
                x, x_kv=text, bias=text_bias, rope_q=rope_self,
                rope_k=lambda t: roformer_rope(t, sincos_cross))
            x = self.cross_ln(x + cross)
        return self.ffn_ln(x + self.mlp(x))


class TGBModel(nn.Module):
    """forward(flow, flow_mask, question_ids, question_mask, mode) ->
    (sequence_output (B, L+2, hidden), span_logits (B, L, 2) f32).
    ``deterministic=False`` turns on the two dropout sites (after the flow
    embedding and after the text LayerNorm), masks drawn from
    ``generator``."""

    def __init__(self, cfg: TGBConfig, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.temporal_embeddings = TemporalOFEmbedding(cfg, device)
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, **kw)
        self.token_type_embeddings = Embed(cfg.type_vocab_size,
                                           cfg.hidden_size, **kw)
        self.text_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, **kw)
        self.layers = nn.ModuleList(
            TGBLayer(cfg, i >= cfg.fusion_layer, device)
            for i in range(cfg.num_layers))
        self.mrc_head = Dense(cfg.hidden_size, 2, **kw)

    def forward(self, flow, flow_mask, question_ids, question_mask=None,
                mode="fusion", deterministic=True, generator=None):
        cfg = self.config
        l = flow.shape[1]
        dev = flow.device
        x = self.temporal_embeddings(flow, flow_mask, deterministic, generator)
        tok = self.word_embeddings(question_ids)
        typ = self.token_type_embeddings(torch.zeros_like(question_ids))
        text = dropout(self.text_ln(tok + typ), cfg.hidden_dropout, generator,
                       deterministic)

        self_bias = make_padding_bias(flow_mask)
        text_bias = (make_padding_bias(question_mask)
                     if question_mask is not None else None)
        sincos_self = roformer_sincos_table(l + 2, cfg.head_dim, device=dev)
        sincos_cross = roformer_sincos_table(question_ids.shape[1],
                                             cfg.head_dim, device=dev)
        if mode in ("text", "vision"):
            layer_range = range(0, cfg.fusion_layer)
        elif mode == "fusion":
            layer_range = range(cfg.fusion_layer, cfg.num_layers)
        elif mode == "multi_modal":
            layer_range = range(0, cfg.num_layers)
        else:
            raise ValueError(f"invalid mode: {mode}")
        for i in layer_range:
            x = self.layers[i](x, self_bias, text, text_bias, sincos_self,
                               sincos_cross)
        logits = self.mrc_head(x[:, 1:-1])
        return x, logits.float()
