"""Training recipes as loss functions (counterpart of
``videotgb_tpu/training/recipes.py``, the TG, SF, E2E, IV and IVT stages):

  TG  - stage 2: the TGB alone, span CE against precomputed pseudo-label
        spans;
  SF  - self-refinement: per-frame scores (B, F) from the pseudo-label pass
        (``pseudo_label_generate``, then rouge_n on the host) become a span
        by the largest rectangle, the TGB learns it (span CE) jointly with
        the LM loss on the frames its Gumbel spans select; everything but
        the ViT and RAFT trains;
  E2E - end to end: frames picked uniformly ("uniform", the BLIP2 recipe)
        or by the current TGB's Gumbel spans ("tgb", stop-gradient), then
        the LM loss; TGB and Q-Former (with its projection) train, RAFT, ViT
        and the LLM are frozen.

The LM loss is the backbone's: seq2seq CE for the T5 backbones (BLIP2 and
InstructBLIP-Flan-T5), the packed causal CE for InstructBLIP-Vicuna.

A recipe's ``loss_fn(model, batch, generator, deterministic)`` returns
(loss, aux); ``generator`` draws the dropout masks and the Gumbel noise,
``deterministic=True`` turns dropout off (evaluation).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

from videotgb_torch.ops.span import largest_rectangle_span, rescale_index
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


@dataclasses.dataclass(frozen=True)
class SFRecipe:
    """Self-refinement: ``batch["scores"]`` (B, F) from the pseudo-label
    pass -> the largest-rectangle span in the candidate-frame domain ->
    rescaled into the flow domain -> span CE on the TGB's logits
    (``mrc_loss``); the detached logits select frames (the training rule:
    inclusive ends, "minus1"), and the LM loss on them is ``lm_loss``.
    Freezes the ViT and RAFT only. ``online_flow=True`` (the LSTP_SF_small
    recipe) computes ``batch["flow"]`` from ``batch["flow_frames"]`` (B,
    L+1, H, W, 3) in [0, 255] with RAFT, without gradient."""

    mode: str = "fusion"
    online_flow: bool = False

    @property
    def filter_fn(self) -> Callable[[str], bool]:
        return path_freeze_filter(freeze_prefixes=("model/vision_model",
                                                   "of_extractor"))

    def loss_fn(self, model, batch, generator=None, deterministic=False,
                noise=None):
        """``noise`` (top_k, 2, B, L) replaces the selection's Gumbel draw
        (tests hand both packages the same noise)."""
        cfg = model.config
        if self.online_flow:
            if "flow_frames" not in batch:
                raise KeyError(
                    "online_flow needs batch['flow_frames'] (B, L+1, H, W, 3) "
                    "RGB in [0, 255]; the synthetic and VideoInstruct "
                    "collates carry precomputed flow only")
            with torch.no_grad():
                flow = model.flow_features(batch["flow_frames"])
            batch = {**batch, "flow": flow}
        frames = batch["frames"]
        dev = frames.device
        flow_len = batch["video_length"]
        starts_f, ends_f = largest_rectangle_span(batch["scores"], dev)
        start_targets = rescale_index(starts_f, cfg.num_frames, flow_len)
        end_targets = rescale_index(ends_f, cfg.num_frames, flow_len)

        _, start_logits, end_logits = model.span_logits(
            batch["flow"], batch["flow_mask"], batch["sampler_question_ids"],
            batch["sampler_question_mask"], mode=self.mode,
            deterministic=deterministic, generator=generator)
        mrc_loss = span_ce_loss(start_logits, end_logits, start_targets,
                                end_targets)
        cand = model.select_frames(start_logits.detach(), end_logits.detach(),
                                   flow_len, generator, noise=noise)
        b = frames.shape[0]
        sel = frames[torch.arange(b, device=dev)[:, None], cand]
        lm_loss, _ = backbone_forward(model, sel, batch)
        loss = lm_loss + mrc_loss
        return loss, {"loss": loss, "lm_loss": lm_loss, "mrc_loss": mrc_loss,
                      "start_targets": start_targets,
                      "end_targets": end_targets, "cand": cand}


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
    """The backbone's LM loss on selected frames (B, F, H, W, 3) -> (loss,
    logits): seq2seq for the T5 backbones (the Q-Former reads the
    instruction where the config is instruction-aware), the packed causal
    LM for InstructBLIP-Vicuna. A ``widths`` entry (0 = text-only row)
    masks the visual prefix."""
    visual_valid = None
    if "widths" in batch:
        visual_valid = (batch["widths"] > 0).float()
    if model.config.backbone == "blip2":
        qf_ids = qf_mask = None
        if model.config.instruction_aware:
            qf_ids = batch.get("qformer_input_ids")
            qf_mask = batch.get("qformer_attention_mask")
        return model.model(frames, batch["question_ids"],
                           batch["question_mask"], batch["answer_ids"],
                           mean_pool=mean_pool, visual_valid=visual_valid,
                           qformer_input_ids=qf_ids,
                           qformer_attention_mask=qf_mask)
    return model.model(frames, batch["instruction_ids"],
                       batch["instruction_mask"], batch["labels"],
                       qformer_input_ids=batch.get("qformer_input_ids"),
                       qformer_attention_mask=batch.get(
                           "qformer_attention_mask"),
                       mean_pool=mean_pool, visual_valid=visual_valid)


STAGE3_TRAIN = ("model/qformer", "model/language_projection",
                "model/query_tokens")


@dataclasses.dataclass(frozen=True)
class IVRecipe:
    """Stage 3 with a fixed sampler: the Q-Former (with its projection and
    query tokens) trains, everything else is frozen
    (LSTP_Blip2_IV_module.py:560-568). Frames arrive pre-selected."""

    @property
    def filter_fn(self) -> Callable[[str], bool]:
        return path_freeze_filter(train_prefixes=STAGE3_TRAIN)

    def loss_fn(self, model, batch, generator=None, deterministic=False):
        # no dropout in the backbone towers and no selection: the generator
        # and ``deterministic`` are taken for the recipes' common interface
        lm_loss, _ = backbone_forward(model, batch["frames"], batch,
                                      mean_pool=True)
        return lm_loss, {"loss": lm_loss}


@dataclasses.dataclass(frozen=True)
class IVTRecipe:
    """Stage 3 with LoRA: the adapters train with the Q-Former
    (LSTP_Blip2_IVT_module.py:184-188). Build the LLM with ``lora_rank``
    (8 in the reference) for this recipe."""

    @property
    def filter_fn(self) -> Callable[[str], bool]:
        return path_freeze_filter(train_prefixes=STAGE3_TRAIN,
                                  train_lora_only=True)

    loss_fn = IVRecipe.loss_fn


RECIPES = {"tg": TGRecipe, "sf": SFRecipe, "e2e": E2ERecipe, "iv": IVRecipe,
           "ivt": IVTRecipe}


# ---------------------------------------------- the SF pseudo-label pass
@torch.no_grad()
def pseudo_label_generate(model, frames, question_ids, question_mask,
                          max_new_tokens: int = 32, qformer_input_ids=None,
                          qformer_attention_mask=None):
    """Per-frame greedy answers for self-refinement scoring: each of the
    B*F candidate frames (B, F, H, W, 3) is encoded alone and answers the
    question, with the instruction repeated per frame where the Q-Former is
    instruction-aware. Returns token ids (B*F, max_new_tokens). The pass
    takes no gradient and draws no random numbers; it reads the model's
    live parameters. The host then scores rouge_n(decode(ids), answer)."""
    from videotgb_torch.models.videotgb import (
        llama_generate_from_embeds, t5_generate_from_encoder)
    from videotgb_torch.ops.decode import DecodeConfig

    cfg = model.config
    b, f = frames.shape[:2]
    flat = frames.reshape(b * f, *frames.shape[2:])

    def rep(x):
        return None if x is None else x.repeat_interleave(f, 0)

    qf_ids = rep(qformer_input_ids) if cfg.instruction_aware else None
    qf_mask = rep(qformer_attention_mask) if cfg.instruction_aware else None
    q_ids, q_mask = rep(question_ids), rep(question_mask)
    visual = model.model.encode_frames(flat, qformer_input_ids=qf_ids,
                                       qformer_attention_mask=qf_mask)
    if cfg.backbone != "blip2":
        llm = cfg.instructblip.llm
        embeds, mask = model.model.decoder_inputs(visual, q_ids, q_mask)
        dcfg = DecodeConfig(max_new_tokens=max_new_tokens,
                            eos_token_id=llm.eos_token_id,
                            pad_token_id=llm.pad_token_id)
        return llama_generate_from_embeds(model, embeds, mask, dcfg)
    t5 = cfg.blip2.t5
    embeds, mask = model.model.encoder_inputs(visual, q_ids, q_mask)
    enc_hidden = model.model.language_model.encode(embeds, mask)
    dcfg = DecodeConfig(max_new_tokens=max_new_tokens,
                        eos_token_id=t5.eos_token_id,
                        pad_token_id=t5.pad_token_id)
    return t5_generate_from_encoder(model, enc_hidden, mask, dcfg)
