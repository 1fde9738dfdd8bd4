"""Training recipes as loss functions (counterpart of
``videotgb_tpu/training/recipes.py``, the TG and E2E stages):

  TG  - stage 2: the TGB alone, span CE against precomputed pseudo-label
        spans;
  E2E - end to end: frames picked uniformly ("uniform", the BLIP2 recipe)
        or by the current TGB's Gumbel spans ("tgb", stop-gradient), then
        the BLIP2-T5 LM loss; TGB and Q-Former (with its projection) train,
        RAFT, ViT and the LLM are frozen.

A recipe's ``loss_fn(model, batch, generator, deterministic)`` returns
(loss, aux); ``generator`` draws the dropout masks and the Gumbel noise,
``deterministic=True`` turns dropout off (evaluation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from videotgb_torch.training.optim import path_freeze_filter


def span_ce_loss(start_logits, end_logits, start_targets, end_targets):
    """(CE(start) + CE(end)) / 2 over (B, L) logits with ignore index L:
    targets are clamped into [0, L] and index L contributes nothing."""
    l = start_logits.shape[1]

    def one(logits, targets):
        targets = targets.long().clamp(0, l)
        valid = targets < l
        safe = torch.where(valid, targets, torch.zeros_like(targets))
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
        return (torch.where(valid, nll, torch.zeros_like(nll)).sum()
                / valid.sum().clamp(min=1))

    return 0.5 * (one(start_logits, start_targets)
                  + one(end_logits, end_targets))


@dataclasses.dataclass(frozen=True)
class TGRecipe:
    """Trains temporal_encoder only; the backbone is out of the loss path."""

    mode: str = "fusion"

    @property
    def filter_fn(self) -> Callable[[str], bool]:
        return path_freeze_filter(train_prefixes=("temporal_encoder",))

    def loss_fn(self, model, batch, generator=None, deterministic=False):
        _, start_logits, end_logits = model.span_logits(
            batch["flow"], batch["flow_mask"], batch["sampler_question_ids"],
            batch["sampler_question_mask"], mode=self.mode,
            deterministic=deterministic, generator=generator)
        loss = span_ce_loss(start_logits, end_logits, batch["starts"],
                            batch["ends"])
        return loss, {"loss": loss, "start_logits": start_logits,
                      "end_logits": end_logits}


def uniform_candidates(num_frames: int, nframe: int) -> list[int]:
    """Interval midpoints of np.linspace(0, F, nframe + 1) cut to ints."""
    step = num_frames / nframe
    intv = [int(i * step) for i in range(nframe)] + [num_frames]
    return [(intv[x] + intv[x + 1] - 1) // 2 for x in range(nframe)]


@dataclasses.dataclass(frozen=True)
class E2ERecipe:
    """``selection="tgb"``: Gumbel spans of the current TGB scored against
    ``video_length = num_frames + 2``, exclusive span ends, the ratio
    rescale int(i/L*F); ``selection="uniform"``: the interval midpoints of
    all num_frames candidates. Only the LM loss backpropagates."""

    mode: str = "multi_modal"
    selection: str = "tgb"

    @property
    def filter_fn(self) -> Callable[[str], bool]:
        return path_freeze_filter(
            freeze_prefixes=("of_extractor", "model/vision_model",
                             "model/language_model"))

    def loss_fn(self, model, batch, generator=None, deterministic=False,
                noise=None):
        """``noise`` (top_k, 2, B, L) replaces the Gumbel draw of the "tgb"
        selection (tests hand both packages the same noise)."""
        cfg = model.config
        frames = batch["frames"]
        b = frames.shape[0]
        if self.selection == "uniform":
            idx = uniform_candidates(cfg.num_frames, cfg.nframe)
            cand = torch.tensor(idx, device=frames.device).expand(b, -1)
            start_logits = end_logits = None
        else:
            _, start_logits, end_logits = model.span_logits(
                batch["flow"], batch["flow_mask"],
                batch["sampler_question_ids"], batch["sampler_question_mask"],
                mode=self.mode, deterministic=deterministic,
                generator=generator)
            vlen = torch.full_like(batch["video_length"], cfg.num_frames + 2)
            cand = model.select_frames(
                start_logits.detach(), end_logits.detach(), vlen, generator,
                inclusive_end=False, rescale="ratio", noise=noise)
        sel = frames[torch.arange(b, device=frames.device)[:, None], cand]
        lm_loss, _ = backbone_forward(model, sel, batch)
        return lm_loss, {"loss": lm_loss, "cand": cand,
                         "start_logits": start_logits,
                         "end_logits": end_logits}


def backbone_forward(model, frames, batch, mean_pool=False):
    """The BLIP2-T5 LM loss on selected frames (B, F, H, W, 3) -> (loss,
    logits). A ``widths`` entry (0 = text-only row) masks the visual
    prefix."""
    visual_valid = None
    if "widths" in batch:
        visual_valid = (batch["widths"] > 0).float()
    qf_ids = qf_mask = None
    if model.config.instruction_aware:
        qf_ids = batch.get("qformer_input_ids")
        qf_mask = batch.get("qformer_attention_mask")
    return model.model(frames, batch["question_ids"], batch["question_mask"],
                       batch["answer_ids"], mean_pool=mean_pool,
                       visual_valid=visual_valid, qformer_input_ids=qf_ids,
                       qformer_attention_mask=qf_mask)


RECIPES = {"tg": TGRecipe, "e2e": E2ERecipe}
