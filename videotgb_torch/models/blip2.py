"""BLIP2-Flan-T5: ViT-g -> Q-Former -> language projection -> T5
(counterpart of ``videotgb_tpu/models/blip2.py``), with the reserved
``temporal_projection`` kept for checkpoint-shape parity."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videotgb_torch.models.common import Dense, _fill_normal, _param
from videotgb_torch.models.qformer import QFormerConfig, QFormerModel
from videotgb_torch.models.t5 import T5Config, T5Model
from videotgb_torch.models.vit import ViTConfig, ViTModel


@dataclasses.dataclass(frozen=True)
class Blip2Config:
    vit: ViTConfig = ViTConfig()
    qformer: QFormerConfig = QFormerConfig()
    t5: T5Config = T5Config()
    qformer_instruction: bool = False

    @classmethod
    def tiny(cls, qformer_instruction: bool = False) -> "Blip2Config":
        vit = ViTConfig.tiny()
        return cls(vit=vit, qformer=QFormerConfig.tiny(vit.hidden_size),
                   t5=T5Config.tiny(), qformer_instruction=qformer_instruction)


class Blip2Model(nn.Module):
    def __init__(self, cfg: Blip2Config, device=None):
        super().__init__()
        self.config = cfg
        self.vision_model = ViTModel(cfg.vit, device)
        self.qformer = QFormerModel(cfg.qformer, cfg.qformer_instruction, device)
        self.query_tokens = _param(
            (1, cfg.qformer.num_query_tokens, cfg.qformer.hidden_size),
            cfg.qformer.param_dtype, device)
        kw = dict(dtype=cfg.t5.dtype, param_dtype=cfg.t5.param_dtype,
                  device=device)
        self.language_projection = Dense(cfg.qformer.hidden_size,
                                         cfg.t5.d_model, **kw)
        self.temporal_projection = Dense(cfg.qformer.hidden_size,
                                         cfg.t5.d_model, **kw)
        self.language_model = T5Model(cfg.t5, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.query_tokens, 0.02, gen)

    def encode_frames(self, pixel_values, mean_pool_groups=None,
                      qformer_input_ids=None, qformer_attention_mask=None):
        """pixel_values (N, H, W, 3) -> (N, Q, d_model), or with
        ``mean_pool_groups=B`` the Q-Former outputs mean-pooled over each
        group of N/B frames -> (B, Q, d_model)."""
        image_embeds = self.vision_model(pixel_values)
        n = image_embeds.shape[0]
        query = self.query_tokens.to(self.config.qformer.dtype).expand(
            n, -1, -1)
        query_out = self.qformer(query, image_embeds,
                                 input_ids=qformer_input_ids,
                                 attention_mask=qformer_attention_mask)
        if mean_pool_groups is not None:
            b = mean_pool_groups
            query_out = query_out.reshape(b, n // b,
                                          *query_out.shape[1:]).mean(dim=1)
        return self.language_projection(query_out)

    def encoder_inputs(self, visual_tokens, question_ids, question_mask):
        """[visual | question] embeddings and their mask for the T5 encoder."""
        text = self.language_model.embed(question_ids)
        embeds = torch.cat([visual_tokens.to(text.dtype), text], dim=1)
        vis_mask = torch.ones(visual_tokens.shape[:2], dtype=question_mask.dtype,
                              device=question_mask.device)
        return embeds, torch.cat([vis_mask, question_mask], dim=1)
