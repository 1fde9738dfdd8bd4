"""VideoTGB, BLIP2-Flan-T5 backbone: RAFT -> TGB -> Gumbel span selection ->
frame gather -> ViT -> Q-Former -> T5 (counterpart of the BLIP2 part of
``videotgb_tpu/models/videotgb.py``). Submodule names follow the JAX
package: ``temporal_encoder`` (TGB), ``of_extractor`` (RAFT), ``model``
(BLIP2).

Generation is driven by free functions; the T5 decode loop threads the KV
caches through ``VideoTGB.t5_decode_step``:

  frames        (B, F=32, H, W, 3)    candidate frames (CLIP-normalized)
  flow          (B, L, Hf, Wf, 2)     TGB input (``flow_features``)
  cand_index    (B, nframe)           fixed-size gather (ops.select)
  visual tokens (B, 32, d)            mean-pooled over the selected frames

Entry points run on the CUDA device unless the model was built with
``device="cpu"``. Selection noise comes from a ``torch.Generator``, or from
an explicit ``noise`` tensor (top_k, 2, B, L), which is how tests share the
JAX package's Gumbel draws.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videotgb_torch.data.constants import CLIP_MEAN, CLIP_STD
from videotgb_torch.device import resolve_device
from videotgb_torch.models.blip2 import Blip2Config, Blip2Model
from videotgb_torch.models.common import init_params
from videotgb_torch.models.qformer import QFormerConfig
from videotgb_torch.models.raft import RAFT, RAFTConfig
from videotgb_torch.models.t5 import T5Config
from videotgb_torch.models.tgb import TGBConfig, TGBModel
from videotgb_torch.models.vit import ViTConfig
from videotgb_torch.ops.decode import DecodeConfig, decode
from videotgb_torch.ops.select import select_frames


@dataclasses.dataclass(frozen=True)
class VideoTGBConfig:
    blip2: Blip2Config = Blip2Config()
    tgb: TGBConfig = TGBConfig()
    raft: RAFTConfig = RAFTConfig()
    nframe: int = 4
    num_frames: int = 32
    top_k: int = 2
    gumbel_tau: float = 0.5

    @property
    def instruction_aware(self) -> bool:
        return self.blip2.qformer_instruction

    @classmethod
    def small(cls) -> "VideoTGBConfig":
        """Flagship structure and token counts at reduced width/depth."""
        vit = ViTConfig(image_size=224, patch_size=14, hidden_size=256,
                        num_layers=4, num_heads=8, intermediate_size=512)
        qf = QFormerConfig(hidden_size=256, num_layers=4, num_heads=8,
                           intermediate_size=512, num_query_tokens=32,
                           encoder_hidden_size=256)
        t5 = T5Config(d_model=256, d_kv=32, num_heads=8, d_ff=512,
                      num_encoder_layers=4, num_decoder_layers=4)
        tgb = TGBConfig(hidden_size=256, num_layers=4, num_heads=8,
                        intermediate_size=512, fusion_layer=2,
                        encoder_width=256)
        return cls(blip2=Blip2Config(vit=vit, qformer=qf, t5=t5), tgb=tgb,
                   raft=RAFTConfig(iters=4), nframe=4, num_frames=32)

    @classmethod
    def flagship(cls) -> "VideoTGBConfig":
        """ViT-g + Q-Former + Flan-T5-xl + TGB (BERT-base) + RAFT."""
        return cls()

    @classmethod
    def tiny(cls) -> "VideoTGBConfig":
        return cls(blip2=Blip2Config.tiny(), tgb=TGBConfig.tiny(),
                   raft=RAFTConfig.tiny(), nframe=2, num_frames=4)


def bf16_param_config(cfg: VideoTGBConfig) -> VideoTGBConfig:
    """bf16 parameters for ViT / Q-Former / T5 / TGB; RAFT stays f32."""
    def rep(sub):
        return dataclasses.replace(sub, param_dtype=torch.bfloat16)

    blip2 = dataclasses.replace(cfg.blip2, vit=rep(cfg.blip2.vit),
                                qformer=rep(cfg.blip2.qformer),
                                t5=rep(cfg.blip2.t5))
    return dataclasses.replace(cfg, blip2=blip2, tgb=rep(cfg.tgb))


class VideoTGB(nn.Module):
    """Built directly on ``device`` (None = the CUDA device) with random
    weights from ``seed``; load real weights with ``load_state_dict``
    (``videotgb_torch.convert`` maps a JAX parameter tree)."""

    def __init__(self, config: VideoTGBConfig, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.temporal_encoder = TGBModel(config.tgb, device)
        self.of_extractor = RAFT(config.raft, device)
        self.model = Blip2Model(config.blip2, device)
        init_params(self, seed)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.model.query_tokens.device

    # ------------------------------------------------------------- RAFT flow
    def compute_flow(self, flow_frames):
        """(B, L, H, W, 3) in [0, 255] -> (B, L, H, W, 2): consecutive-pair
        flow with the last repeated."""
        flow = self.of_extractor.consecutive(flow_frames)
        return torch.cat([flow, flow[:, -1:]], dim=1)

    def flow_features(self, flow_frames):
        """(B, L+1, H, W, 3) -> (B, L, H, W, 2) max-radius-normalized flow."""
        flow = self.compute_flow(flow_frames)[:, :-1]
        rad = torch.sqrt(torch.sum(flow ** 2, dim=-1))
        rad_max = torch.amax(rad, dim=(1, 2, 3), keepdim=True)[..., None]
        return flow / (rad_max + 1e-5)

    def flow_features_timeline(self, flow_frames, valid):
        """(B, L, H, W, 3) with pad frames masked by ``valid`` (B, L) ->
        (B, L, H, W, 2); pads never rescale the real flow."""
        flow = self.compute_flow(flow_frames)
        rad = torch.sqrt(torch.sum(flow ** 2, dim=-1))
        rad = rad * valid[:, :, None, None].to(rad.dtype)
        rad_max = torch.amax(rad, dim=(1, 2, 3), keepdim=True)[..., None]
        return flow / (rad_max + 1e-5)

    # ----------------------------------------------------------------- TGB
    def span_logits(self, flow, flow_mask, question_ids, question_mask,
                    mode="fusion"):
        feat, logits = self.temporal_encoder(flow, flow_mask, question_ids,
                                             question_mask, mode=mode)
        return feat, logits[..., 0], logits[..., 1]

    # ------------------------------------------------------------- selection
    def select_frames(self, start_logits, end_logits, video_length,
                      generator=None, noise=None):
        """The inference rule of the BLIP2 family: exclusive span ends,
        int(i*(F-1)/(L-1)) rescale."""
        cfg = self.config
        return select_frames(start_logits, end_logits, video_length,
                             cfg.num_frames, cfg.nframe, generator, cfg.top_k,
                             cfg.gumbel_tau, inclusive_end=False,
                             rescale="minus1", noise=noise)

    # ------------------------------------------------- backbone entry points
    def encode_selected(self, frames, cand_index, qformer_input_ids=None,
                        qformer_attention_mask=None):
        """Gather the selected frames, run ViT + Q-Former (mean-pooled over
        each request's frames) + projection -> (B, Q, d_model)."""
        cfg = self.config
        b = frames.shape[0]
        idx = cand_index.long().to(frames.device)
        sel = frames[torch.arange(b, device=frames.device)[:, None], idx]
        flat = sel.reshape(b * cfg.nframe, *frames.shape[2:])
        kwargs = {}
        if cfg.instruction_aware and qformer_input_ids is not None:
            kwargs = dict(
                qformer_input_ids=qformer_input_ids.repeat_interleave(
                    cfg.nframe, 0),
                qformer_attention_mask=(
                    qformer_attention_mask.repeat_interleave(cfg.nframe, 0)
                    if qformer_attention_mask is not None else None))
        return self.model.encode_frames(flat, mean_pool_groups=b, **kwargs)

    def prepare_t5_inference(self, frames, flow, flow_mask, video_length,
                             sampler_question_ids, sampler_question_mask,
                             question_ids, question_mask, generator=None,
                             noise=None, qformer_input_ids=None,
                             qformer_attention_mask=None):
        """TGB -> select -> ViT/Q-Former -> T5 encoder.
        Returns (enc_hidden, enc_mask, cand_index)."""
        _, start_logits, end_logits = self.span_logits(
            flow, flow_mask, sampler_question_ids, sampler_question_mask,
            "fusion")
        cand = self.select_frames(start_logits, end_logits, video_length,
                                  generator, noise)
        visual = self.encode_selected(
            frames, cand, qformer_input_ids=qformer_input_ids,
            qformer_attention_mask=qformer_attention_mask)
        embeds, mask = self.model.encoder_inputs(visual, question_ids,
                                                 question_mask)
        enc_hidden = self.model.language_model.encode(embeds, mask)
        return enc_hidden, mask, cand

    def t5_decode_step(self, tokens, enc_hidden, enc_mask, caches, index,
                       cache_positions_valid, cross_prefill=False):
        logits, caches = self.model.language_model.decode(
            tokens, enc_hidden, enc_mask, caches=caches, cache_index=index,
            cache_positions_valid=cache_positions_valid,
            cross_prefill=cross_prefill)
        return logits[:, -1], caches

    def init_t5_caches(self, batch, max_len, encoder_len):
        return self.model.language_model.init_caches(batch, max_len,
                                                     encoder_len)


def _on(model, batch):
    return {k: (v.to(model.device) if torch.is_tensor(v) else v)
            for k, v in batch.items()}


# ----------------------------------------------------------------- generate
@torch.no_grad()
def generate_blip2(model: VideoTGB, batch, decode_config: DecodeConfig,
                   generator=None, stop_sequences=(), noise=None):
    """Batched BLIP2-Flan-T5 QA generation. ``batch`` holds frames, flow,
    flow_mask, video_length, sampler_question_ids/_mask and
    question_ids/_mask. Returns (token_ids (B, T), cand_index)."""
    cfg = model.config
    batch = _on(model, batch)
    enc_hidden, enc_mask, cand = model.prepare_t5_inference(
        batch["frames"], batch["flow"], batch["flow_mask"],
        batch["video_length"], batch["sampler_question_ids"],
        batch["sampler_question_mask"], batch["question_ids"],
        batch["question_mask"], generator=generator, noise=noise,
        qformer_input_ids=(batch.get("qformer_input_ids")
                           if cfg.instruction_aware else None),
        qformer_attention_mask=(batch.get("qformer_attention_mask")
                                if cfg.instruction_aware else None))
    out = t5_generate_from_encoder(model, enc_hidden, enc_mask, decode_config,
                                   generator, stop_sequences)
    return out, cand


@torch.no_grad()
def t5_generate_from_encoder(model: VideoTGB, enc_hidden, enc_mask,
                             decode_config: DecodeConfig, generator=None,
                             stop_sequences=()):
    """Greedy / sampling T5 decode from a computed encoder state. Step 0 is
    the prefill: it writes token 0's self K/V and every layer's cross K/V."""
    t5cfg = model.config.blip2.t5
    b = enc_hidden.shape[0]
    max_new = decode_config.max_new_tokens
    dev = enc_hidden.device
    caches = model.init_t5_caches(b, max_new, enc_hidden.shape[1])
    start = torch.full((b,), t5cfg.decoder_start_token_id, dtype=torch.long,
                       device=dev)
    steps = torch.arange(max_new, device=dev)

    def step_fn(tokens, caches, index):
        valid = (steps[None] <= index).float().expand(b, max_new)
        return model.t5_decode_step(tokens, enc_hidden, enc_mask, caches,
                                    index, valid, cross_prefill=index == 0)

    return decode(step_fn, caches, start, decode_config, generator=generator,
                  stop_sequences=stop_sequences)


# ------------------------------------------- two-phase (bandwidth-aware) mode
@torch.no_grad()
def select_phase_blip2(model: VideoTGB, flow_rgb_u8, batch, generator=None,
                       noise=None):
    """Phase 1: RAFT + TGB ("fusion" mode) + Gumbel selection from the
    flow frames only, (B, L+1, Hf, Wf, 3) uint8. Returns cand_index
    (B, nframe)."""
    batch = _on(model, batch)
    flow = model.flow_features(flow_rgb_u8.to(model.device).float())
    _, sl, el = model.span_logits(flow, batch["flow_mask"],
                                  batch["sampler_question_ids"],
                                  batch["sampler_question_mask"], "fusion")
    return model.select_frames(sl, el, batch["video_length"], generator,
                               noise)


@torch.no_grad()
def answer_phase_blip2(model: VideoTGB, selected_frames_u8, batch,
                       decode_config: DecodeConfig, generator=None):
    """Phase 2: CLIP normalization on the device, ViT -> Q-Former
    (mean-pooled) -> T5 encode + decode. Frames (B, nframe, H, W, 3) uint8."""
    batch = _on(model, batch)
    dev = model.device
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
    frames = (selected_frames_u8.to(dev).float() / 255.0 - mean) / std
    b, nf = frames.shape[:2]
    qf_ids = qf_mask = None
    if model.config.instruction_aware:
        qf_ids = batch.get("qformer_input_ids")
        qf_mask = batch.get("qformer_attention_mask")
        if qf_ids is not None:
            qf_ids = qf_ids.repeat_interleave(nf, 0)
            qf_mask = (qf_mask.repeat_interleave(nf, 0)
                       if qf_mask is not None else None)
    visual = model.model.encode_frames(
        frames.reshape(b * nf, *frames.shape[2:]), mean_pool_groups=b,
        qformer_input_ids=qf_ids, qformer_attention_mask=qf_mask)
    embeds, mask = model.model.encoder_inputs(visual, batch["question_ids"],
                                              batch["question_mask"])
    enc_hidden = model.model.language_model.encode(embeds, mask)
    return t5_generate_from_encoder(model, enc_hidden, mask, decode_config,
                                    generator)
