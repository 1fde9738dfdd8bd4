"""BLIP-2's frozen EVA ViT-g vision tower (counterpart of
``videotgb_tpu/models/vit.py``): 14x14/s14 patch embedding + CLS + learned
positions, pre-LN layers (1408 wide, 39 deep, 16 heads, MLP 6144), final
post-layernorm. Input NHWC (B, H, W, 3).

The token axis is padded once after the embeddings to a multiple of 8
(257 -> 264) with the pad keys masked by a (1, 1, 1, S) f32 bias; every
layer's attention then runs through the flash kernel at S = 264 with that
bias, and real-token outputs are those of the unpadded sequence.

``ViTConfig.quant="int8"`` is the W8A8 serving configuration of the JAX
package: every q/k/v/o and MLP projection goes through
``ops.quant.int8_matmul`` (kernel H on the card, 6 launches per layer),
attention scores and values stay in ``dtype``. ``act`` picks the MLP's gelu
("gelu_new" is the tanh approximation). The JAX config's ``scan_layers``
has no counterpart: eager PyTorch runs the layers in a Python loop either
way, and the parameters keep one ``layers.{i}`` scope per layer.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videotgb_torch.models.common import (
    LayerNorm,
    Mlp,
    MultiHeadAttention,
    PatchConv,
    _fill_normal,
    _param,
)
from videotgb_torch.ops.attention import NEG_INF


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1408
    num_layers: int = 39
    num_heads: int = 16
    intermediate_size: int = 6144
    layer_norm_eps: float = 1e-6
    act: str = "gelu"  # or "gelu_new" (tanh approximation)
    quant: str | None = None  # "int8": W8A8 projections (serving only)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=56, patch_size=14, hidden_size=64, num_layers=2,
                   num_heads=4, intermediate_size=128)


class ViTEmbeddings(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.config = cfg
        self.patch_embed = PatchConv(3, cfg.hidden_size, cfg.patch_size,
                                     cfg.dtype, cfg.param_dtype, device)
        self.cls_token = _param((1, 1, cfg.hidden_size), cfg.param_dtype, device)
        self.position_embedding = _param((1, cfg.seq_len, cfg.hidden_size),
                                         cfg.param_dtype, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.cls_token, 0.02, gen)
        _fill_normal(self.position_embedding, 0.02, gen)

    def forward(self, pixel_values):
        dt = self.config.dtype
        patches = self.patch_embed(pixel_values)
        b = patches.shape[0]
        cls = self.cls_token.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, patches], dim=1)
        return x + self.position_embedding.to(dt)


class ViTLayer(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        d = cfg.hidden_size
        self.ln1 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.attn = MultiHeadAttention(d, cfg.num_heads, d // cfg.num_heads,
                                       quant=cfg.quant, **kw)
        self.ln2 = LayerNorm(d, cfg.layer_norm_eps, **kw)
        self.mlp = Mlp(d, cfg.intermediate_size, act=cfg.act,
                       quant=cfg.quant, **kw)

    def forward(self, x, bias=None):
        attn, _ = self.attn(self.ln1(x), bias=bias)
        x = x + attn
        return x + self.mlp(self.ln2(x))


class ViTModel(nn.Module):
    """Returns last_hidden_state (B, 1+P, hidden) after post-layernorm."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.config = cfg
        self.embeddings = ViTEmbeddings(cfg, device)
        self.layers = nn.ModuleList(ViTLayer(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.post_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                        cfg.dtype, cfg.param_dtype, device)

    def forward(self, pixel_values):
        x = self.embeddings(pixel_values.to(self.config.dtype))
        seq = x.shape[1]
        pad = (-seq) % 8
        bias = None
        if pad:
            x = torch.nn.functional.pad(x, (0, 0, 0, pad))
            keys = torch.arange(seq + pad, device=x.device)
            bias = torch.where(keys < seq, 0.0, NEG_INF).float()[None, None, None, :]
        for layer in self.layers:
            x = layer(x, bias)
        if pad:
            x = x[:, :seq]
        return self.post_layernorm(x)
