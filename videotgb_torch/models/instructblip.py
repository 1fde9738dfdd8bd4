"""InstructBLIP-Vicuna: ViT-g -> instruction-aware Q-Former -> Vicuna-7B
(counterpart of ``videotgb_tpu/models/instructblip.py``). The Q-Former
also reads the tokenized instruction; the LLM is decoder-only, so the
projected visual tokens go in front of the prompt's embeddings. The reserved
``temporal_projection`` is kept for checkpoint-shape parity.

  encode_frames   frames (N, H, W, 3) -> projected visual tokens (N, Q, d)
  decoder_inputs  visual tokens + prompt embeds -> (embeds, mask) for LLaMA
  forward         the training loss pass: the visual prefix before the
                  packed prompt + answer (``data.datasets.
                  pack_text_input_output``), causal CE on the answer
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videotgb_torch.models.blip2 import cross_entropy_ignore
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

    def decoder_inputs(self, visual_tokens, prompt_ids, prompt_mask,
                       visual_valid=None):
        """[visual | prompt] embeddings (B, Q + T, d) and their mask; the
        prompt is right-padded, the visual prefix attended unless
        ``visual_valid`` (B,) is 0 for a row (text-only: the shape stays)."""
        text = self.language_model.embed(prompt_ids)
        embeds = torch.cat([visual_tokens.to(text.dtype), text], dim=1)
        vis_mask = torch.ones(visual_tokens.shape[:2], dtype=prompt_mask.dtype,
                              device=prompt_mask.device)
        if visual_valid is not None:
            vis_mask = vis_mask * visual_valid[:, None].to(vis_mask.dtype)
        return embeds, torch.cat([vis_mask, prompt_mask], dim=1)

    def forward(self, pixel_values, instruction_ids, instruction_mask, labels,
                qformer_input_ids=None, qformer_attention_mask=None,
                mean_pool=False, visual_valid=None):
        """Training loss pass over frames (B, F, H, W, 3) and the packed
        prompt + answer (B, T) with its labels (-100 on the prompt and the
        pads) -> (scalar CE loss, logits (B, V + T, vocab) f32 over the
        visual prefix of V tokens and the text). ``mean_pool=False`` gives
        the E2E/SF prefix of F*Q tokens, True the Q tokens mean-pooled over
        the frames. ``visual_valid`` (B,) 0 marks a text-only row, whose
        prefix is masked out of attention. The loss is next-token CE on the
        text suffix only."""
        b, f = pixel_values.shape[:2]
        q_ids = q_mask = None
        if qformer_input_ids is not None:
            q_ids = qformer_input_ids.repeat_interleave(f, 0)
            if qformer_attention_mask is not None:
                q_mask = qformer_attention_mask.repeat_interleave(f, 0)
        visual = self.encode_frames(
            pixel_values.reshape(b * f, *pixel_values.shape[2:]), q_ids,
            q_mask, mean_pool_groups=b if mean_pool else None)
        if not mean_pool:
            visual = visual.reshape(b, f * visual.shape[1], -1)
        embeds, mask = self.decoder_inputs(visual, instruction_ids,
                                           instruction_mask, visual_valid)
        logits, _ = self.language_model(inputs_embeds=embeds,
                                        attention_mask=mask)
        text_logits = logits[:, -instruction_ids.shape[1]:]
        loss = cross_entropy_ignore(text_logits[:, :-1], labels[:, 1:])
        return loss, logits
