"""BLIP2-Flan-T5: ViT-g -> Q-Former -> language projection -> T5
(counterpart of ``videotgb_tpu/models/blip2.py``), with the reserved
``temporal_projection`` kept for checkpoint-shape parity.

  encode_frames   frames (N, H, W, 3) -> projected visual tokens (N, Q, d)
  encoder_inputs  visual tokens + question embeds -> (embeds, mask) for T5
  forward         the training loss pass: seq2seq CE, pad labels ignored
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videotgb_torch.models.common import Dense, _fill_normal, _param
from videotgb_torch.models.qformer import QFormerConfig, QFormerModel
from videotgb_torch.models.t5 import T5Config, T5Model
from videotgb_torch.models.vit import ViTConfig, ViTModel
from videotgb_torch.parallel.sharding import global_count

IGNORE_INDEX = -100


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

    def encoder_inputs(self, visual_tokens, question_ids, question_mask,
                       visual_valid=None):
        """[visual | question] embeddings and their mask for the T5 encoder.
        ``visual_valid`` (B,) 0 marks a text-only row: its visual prefix is
        masked out of attention, the shape stays."""
        text = self.language_model.embed(question_ids)
        embeds = torch.cat([visual_tokens.to(text.dtype), text], dim=1)
        vis_mask = torch.ones(visual_tokens.shape[:2], dtype=question_mask.dtype,
                              device=question_mask.device)
        if visual_valid is not None:
            vis_mask = vis_mask * visual_valid[:, None].to(vis_mask.dtype)
        return embeds, torch.cat([vis_mask, question_mask], dim=1)

    def forward(self, pixel_values, question_ids, question_mask, answer_ids,
                mean_pool=False, visual_valid=None, qformer_input_ids=None,
                qformer_attention_mask=None):
        """Training loss pass over the selected frames (B, F, H, W, 3) ->
        (scalar CE loss, logits (B, Ta, V) f32). ``mean_pool=False`` gives
        the E2E/SF visual prefix of F*Q tokens, True the Q tokens mean-pooled
        over the frames. Teacher forcing shifts the answers right behind
        ``decoder_start_token_id``; pad labels are ignored."""
        t5 = self.config.t5
        b, f = pixel_values.shape[:2]
        qf_kwargs = {}
        if qformer_input_ids is not None:
            qf_kwargs = dict(
                qformer_input_ids=qformer_input_ids.repeat_interleave(f, 0),
                qformer_attention_mask=(
                    qformer_attention_mask.repeat_interleave(f, 0)
                    if qformer_attention_mask is not None else None))
        visual = self.encode_frames(
            pixel_values.reshape(b * f, *pixel_values.shape[2:]),
            mean_pool_groups=b if mean_pool else None, **qf_kwargs)
        if not mean_pool:
            visual = visual.reshape(b, f * visual.shape[1], -1)
        embeds, mask = self.encoder_inputs(visual, question_ids, question_mask,
                                           visual_valid)
        start = torch.full((b, 1), t5.decoder_start_token_id,
                           dtype=answer_ids.dtype, device=answer_ids.device)
        decoder_input_ids = torch.cat([start, answer_ids[:, :-1]], dim=1)
        logits = self.language_model(embeds, mask, decoder_input_ids)
        labels = torch.where(answer_ids == t5.pad_token_id,
                             torch.full_like(answer_ids, IGNORE_INDEX),
                             answer_ids)
        return cross_entropy_ignore(logits, labels), logits


def cross_entropy_ignore(logits, labels):
    """Mean CE over labels != -100 (torch CrossEntropyLoss semantics), in
    f32; 0 when every label is ignored. The mean is over the valid labels
    of the global batch under a data-parallel split
    (``parallel.sharding.global_count``)."""
    valid = labels != IGNORE_INDEX
    logp = F.log_softmax(logits.float(), dim=-1)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (torch.where(valid, nll, torch.zeros_like(nll)).sum()
            / global_count(valid.sum()).clamp(min=1))
