"""InstructBLIP-Vicuna: ViT-g -> instruction-aware Q-Former -> Vicuna-7B
(counterpart of ``videotgb_tpu/models/instructblip.py``). The Q-Former
also reads the tokenized instruction; the LLM is decoder-only, so the
projected visual tokens go in front of the prompt's embeddings. The reserved
``temporal_projection`` is kept for checkpoint-shape parity.

  encode_frames   frames (N, H, W, 3) -> projected visual tokens (N, Q, d)
  decoder_inputs  visual tokens + prompt embeds -> (embeds, mask) for LLaMA

The training loss pass (the JAX ``__call__`` with
``pack_text_input_output``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videotgb_torch.models.common import Dense, _fill_normal, _param
from videotgb_torch.models.llama import LlamaConfig, LlamaModel
from videotgb_torch.models.qformer import QFormerConfig, QFormerModel
from videotgb_torch.models.vit import ViTConfig, ViTModel


@dataclasses.dataclass(frozen=True)
class InstructBlipConfig:
    vit: ViTConfig = ViTConfig()
    qformer: QFormerConfig = QFormerConfig()
    llm: LlamaConfig = LlamaConfig()

    @classmethod
    def tiny(cls) -> "InstructBlipConfig":
        vit = ViTConfig.tiny()
        return cls(vit=vit, qformer=QFormerConfig.tiny(vit.hidden_size),
                   llm=LlamaConfig.tiny())


class InstructBlipModel(nn.Module):
    def __init__(self, cfg: InstructBlipConfig, device=None):
        super().__init__()
        self.config = cfg
        self.vision_model = ViTModel(cfg.vit, device)
        self.qformer = QFormerModel(cfg.qformer, True, device)
        self.query_tokens = _param(
            (1, cfg.qformer.num_query_tokens, cfg.qformer.hidden_size),
            cfg.qformer.param_dtype, device)
        kw = dict(dtype=cfg.llm.dtype, param_dtype=cfg.llm.param_dtype,
                  device=device)
        self.language_projection = Dense(cfg.qformer.hidden_size,
                                         cfg.llm.hidden_size, **kw)
        self.temporal_projection = Dense(cfg.qformer.hidden_size,
                                         cfg.llm.hidden_size, **kw)
        self.language_model = LlamaModel(cfg.llm, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.query_tokens, 0.02, gen)

    def encode_frames(self, pixel_values, qformer_input_ids=None,
                      qformer_attention_mask=None, mean_pool_groups=None):
        """pixel_values (N, H, W, 3) and the instruction (N, Tq) -> (N, Q,
        d_llm), or with ``mean_pool_groups=B`` the Q-Former outputs
        mean-pooled over each group of N/B frames -> (B, Q, d_llm)."""
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

    def decoder_inputs(self, visual_tokens, prompt_ids, prompt_mask):
        """[visual | prompt] embeddings (B, Q + T, d) and their mask; the
        prompt is right-padded, the visual prefix always attended."""
        text = self.language_model.embed(prompt_ids)
        embeds = torch.cat([visual_tokens.to(text.dtype), text], dim=1)
        vis_mask = torch.ones(visual_tokens.shape[:2], dtype=prompt_mask.dtype,
                              device=prompt_mask.device)
        return embeds, torch.cat([vis_mask, prompt_mask], dim=1)

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "the InstructBLIP-Vicuna training forward is not ported: "
            "ROADMAP.md queue 1 item 4")
