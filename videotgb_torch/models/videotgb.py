"""VideoTGB: RAFT -> TGB -> Gumbel span selection -> frame gather -> ViT ->
Q-Former -> LLM (counterpart of ``videotgb_tpu/models/videotgb.py``). The
LLM is Flan-T5 (``backbone="blip2"``; the instruction-aware "instructblip_t5"
variant included) or Vicuna-7B (``backbone="instructblip"``). Submodule
names follow the JAX package: ``temporal_encoder`` (TGB), ``of_extractor``
(RAFT), ``model`` (BLIP2 or InstructBLIP).

Generation is driven by free functions; the decode loops thread the KV
caches through ``VideoTGB.t5_decode_step`` / ``VideoTGB.llama_step``:

  frames        (B, F=32, H, W, 3)    candidate frames (CLIP-normalized)
  flow          (B, L, Hf, Wf, 2)     TGB input (``flow_features``)
  cand_index    (B, nframe)           fixed-size gather (ops.select; kernel
                                      D, ops.select_pallas, on the card)
  visual tokens (B, 32, d)            mean-pooled over the selected frames

The T5 backbones select in TGB "fusion" mode with the "minus1" rule, Vicuna
in "multi_modal" mode with the "ratio" rule, as in the JAX package.

Entry points run on the CUDA device unless the model was built with
``device="cpu"``. On the card, ``select_phase_blip2``, the two answer
phases, ``generate_blip2`` / ``generate_instructblip`` and the two decode
entry points are CUDA-graph programs (``utils/graphs.py``, the JAX
package's ``jax.jit``): captured at the second call of a signature and
replayed after, the decode as a prefix graph and a chunk graph the host
replays until every row has finished; beam search and the W8A8 ViT-g
stay eager. Each one's ``.eager`` is the plain function. Selection noise
comes from a ``torch.Generator`` (on the card, as the seed of kernel D's
Philox draw), or from an explicit ``noise`` tensor (top_k, 2, B, L),
which is how tests share the JAX package's Gumbel draws.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from videotgb_torch.data.constants import CLIP_MEAN, CLIP_STD
from videotgb_torch.device import resolve_device
from videotgb_torch.models.blip2 import Blip2Config, Blip2Model
from videotgb_torch.models.common import init_params
from videotgb_torch.models.instructblip import InstructBlipConfig, InstructBlipModel
from videotgb_torch.models.llama import LlamaConfig
from videotgb_torch.models.qformer import QFormerConfig
from videotgb_torch.models.raft import RAFT, RAFTConfig
from videotgb_torch.models.t5 import T5Config
from videotgb_torch.models.tgb import TGBConfig, TGBModel
from videotgb_torch.models.vit import ViTConfig
from videotgb_torch.ops.decode import DecodeConfig, beam_search, decode
from videotgb_torch.ops.select import select_frames
from videotgb_torch.ops.select_pallas import draw_seed, select_frames_cuda
from videotgb_torch.parallel.sharding import local_rows, row_offset
from videotgb_torch.utils.graphs import graphed


@dataclasses.dataclass(frozen=True)
class VideoTGBConfig:
    backbone: str = "blip2"  # "blip2" | "instructblip"
    blip2: Blip2Config | None = Blip2Config()
    instructblip: InstructBlipConfig | None = None
    tgb: TGBConfig = TGBConfig()
    raft: RAFTConfig = RAFTConfig()
    nframe: int = 4
    num_frames: int = 32
    top_k: int = 2
    gumbel_tau: float = 0.5

    @property
    def instruction_aware(self) -> bool:
        """True when the Q-Former reads instruction text (InstructBLIP-Vicuna
        or the instructblip_t5 variant)."""
        return (self.backbone == "instructblip"
                or (self.blip2 is not None and self.blip2.qformer_instruction))

    @property
    def vit(self) -> ViTConfig:
        """The backbone's ViT config."""
        return (self.blip2 if self.blip2 is not None
                else self.instructblip).vit

    @classmethod
    def small(cls, backbone: str = "blip2") -> "VideoTGBConfig":
        """Flagship structure and token counts at reduced width/depth."""
        vit = ViTConfig(image_size=224, patch_size=14, hidden_size=256,
                        num_layers=4, num_heads=8, intermediate_size=512)
        qf = QFormerConfig(hidden_size=256, num_layers=4, num_heads=8,
                           intermediate_size=512, num_query_tokens=32,
                           encoder_hidden_size=256)
        t5 = T5Config(d_model=256, d_kv=32, num_heads=8, d_ff=512,
                      num_encoder_layers=4, num_decoder_layers=4)
        llm = LlamaConfig(hidden_size=256, num_layers=4, num_heads=8,
                          intermediate_size=512)
        tgb = TGBConfig(hidden_size=256, num_layers=4, num_heads=8,
                        intermediate_size=512, fusion_layer=2,
                        encoder_width=256)
        instr_t5 = backbone == "instructblip_t5"
        if instr_t5:
            backbone = "blip2"
        return cls(
            backbone=backbone,
            blip2=Blip2Config(vit=vit, qformer=qf, t5=t5,
                              qformer_instruction=instr_t5)
            if backbone == "blip2" else None,
            instructblip=InstructBlipConfig(vit=vit, qformer=qf, llm=llm)
            if backbone == "instructblip" else None,
            tgb=tgb, raft=RAFTConfig(iters=4), nframe=4, num_frames=32)

    @classmethod
    def flagship(cls, backbone: str = "blip2") -> "VideoTGBConfig":
        """ViT-g + Q-Former + Flan-T5-xl (or Vicuna-7B) + TGB (BERT-base) +
        RAFT. "instructblip_t5" is the T5 composition with the
        instruction-aware Q-Former."""
        if backbone == "instructblip_t5":
            return cls(blip2=Blip2Config(qformer_instruction=True))
        return cls(
            backbone=backbone,
            blip2=Blip2Config() if backbone == "blip2" else None,
            instructblip=InstructBlipConfig()
            if backbone == "instructblip" else None)

    @classmethod
    def tiny(cls, backbone: str = "blip2") -> "VideoTGBConfig":
        if backbone == "instructblip_t5":
            blip2, backbone = Blip2Config.tiny(qformer_instruction=True), \
                "blip2"
        else:
            blip2 = Blip2Config.tiny() if backbone == "blip2" else None
        return cls(
            backbone=backbone, blip2=blip2,
            instructblip=(InstructBlipConfig.tiny()
                          if backbone == "instructblip" else None),
            tgb=TGBConfig.tiny(), raft=RAFTConfig.tiny(), nframe=2,
            num_frames=4)


def bf16_param_config(cfg: VideoTGBConfig) -> VideoTGBConfig:
    """bf16 parameters for ViT / Q-Former / LM (T5 or LLaMA) / TGB; RAFT
    stays f32."""
    def rep(sub):
        return dataclasses.replace(sub, param_dtype=torch.bfloat16)

    blip2, iblip = cfg.blip2, cfg.instructblip
    if blip2 is not None:
        blip2 = dataclasses.replace(blip2, vit=rep(blip2.vit),
                                    qformer=rep(blip2.qformer),
                                    t5=rep(blip2.t5))
    if iblip is not None:
        iblip = dataclasses.replace(iblip, vit=rep(iblip.vit),
                                    qformer=rep(iblip.qformer),
                                    llm=rep(iblip.llm))
    return dataclasses.replace(cfg, blip2=blip2, instructblip=iblip,
                               tgb=rep(cfg.tgb))


def with_lora(cfg: VideoTGBConfig, rank: int) -> VideoTGBConfig:
    """``cfg`` with LoRA adapters of ``rank`` on its LLM's attention q and
    v projections: T5 on the blip2 backbone (the instructblip_t5 variant
    included), LLaMA on instructblip."""
    if cfg.backbone == "blip2":
        t5 = dataclasses.replace(cfg.blip2.t5, lora_rank=rank)
        return dataclasses.replace(
            cfg, blip2=dataclasses.replace(cfg.blip2, t5=t5))
    llm = dataclasses.replace(cfg.instructblip.llm, lora_rank=rank)
    return dataclasses.replace(
        cfg, instructblip=dataclasses.replace(cfg.instructblip, llm=llm))


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
        if config.backbone == "blip2":
            self.model = Blip2Model(config.blip2, device)
        elif config.backbone == "instructblip":
            self.model = InstructBlipModel(config.instructblip, device)
        else:
            raise ValueError(f"unknown backbone {config.backbone!r}")
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
                    mode="fusion", deterministic=True, generator=None):
        """``deterministic=False`` turns the TGB's dropout on, its masks
        drawn from ``generator``."""
        feat, logits = self.temporal_encoder(
            flow, flow_mask, question_ids, question_mask, mode=mode,
            deterministic=deterministic, generator=generator)
        return feat, logits[..., 0], logits[..., 1]

    # ------------------------------------------------------------- selection
    def select_frames(self, start_logits, end_logits, video_length,
                      generator=None, inclusive_end=True, rescale="minus1",
                      noise=None):
        """Gumbel spans -> (B, nframe) frame indices. ``inclusive_end`` and
        ``rescale`` default to the training rule; the BLIP2 inference rule
        is ``inclusive_end=False`` with "minus1" int(i*(F-1)/(L-1)), the
        E2E "tgb" rule ``inclusive_end=False`` with "ratio" int(i/L*F).

        On CUDA logits this is kernel D, one launch after a seed drawn on
        the device from ``generator`` (none with ``noise``, which gives the
        CPU route's indices bit for bit); on CPU logits the plain version.
        Either returns (B, nframe) int64. Under a data-parallel split the
        rows are this rank's of the global batch, and select what they
        select at world 1 (D's Philox counter starts at the rank's first
        global row; handed ``noise`` may hold the global batch)."""
        cfg = self.config
        if start_logits.device.type == "cpu":
            return select_frames(start_logits, end_logits, video_length,
                                 cfg.num_frames, cfg.nframe, generator,
                                 cfg.top_k, cfg.gumbel_tau,
                                 inclusive_end=inclusive_end,
                                 rescale=rescale, noise=noise)
        rows = start_logits.shape[0]
        if noise is not None:
            noise = local_rows(noise, rows, axis=2)
        seed = 0 if noise is not None else draw_seed(generator,
                                                     start_logits.device)
        return select_frames_cuda(
            start_logits, end_logits, video_length, seed, cfg.num_frames,
            cfg.nframe, cfg.top_k, 1.0, inclusive_end, rescale, noise=noise,
            out_dtype=torch.int64, row_offset=row_offset(rows))

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
                                  generator, inclusive_end=False, noise=noise)
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

    def prepare_llama_inference(self, frames, flow, flow_mask, video_length,
                                sampler_question_ids, sampler_question_mask,
                                prompt_ids, prompt_mask, generator=None,
                                noise=None, qformer_input_ids=None,
                                qformer_attention_mask=None):
        """The Vicuna inference prefix: TGB in "multi_modal" mode ->
        exclusive-end selection with the "ratio" rule int(i/L*F) ->
        instruction-aware Q-Former mean-pooled to Q tokens -> [visual |
        prompt] embeddings. Returns (embeds (B, Q+T, d), mask, cand_index)."""
        _, start_logits, end_logits = self.span_logits(
            flow, flow_mask, sampler_question_ids, sampler_question_mask,
            "multi_modal")
        cand = self.select_frames(start_logits, end_logits, video_length,
                                  generator, inclusive_end=False,
                                  rescale="ratio", noise=noise)
        visual = self.encode_selected(
            frames, cand, qformer_input_ids=qformer_input_ids,
            qformer_attention_mask=qformer_attention_mask)
        embeds, mask = self.model.decoder_inputs(visual, prompt_ids,
                                                 prompt_mask)
        return embeds, mask, cand

    def llama_step(self, tokens=None, inputs_embeds=None, positions=None,
                   caches=None, cache_index=None, cache_positions_valid=None):
        return self.model.language_model(
            input_ids=tokens, inputs_embeds=inputs_embeds, positions=positions,
            caches=caches, cache_index=cache_index,
            cache_positions_valid=cache_positions_valid)

    def init_llama_caches(self, batch, max_len):
        return self.model.language_model.init_caches(batch, max_len)


def _on(model, batch):
    return {k: (v.to(model.device) if torch.is_tensor(v) else v)
            for k, v in batch.items()}


def _uses_beams(arguments) -> bool:
    """Beam search stays eager: the host steers its loop every step."""
    return arguments["decode_config"].num_beams > 1


def _eager_route(arguments) -> bool:
    """Beam search, and the W8A8 ViT-g (kernel H encodes its TMA
    descriptors on the host at every call), stay eager."""
    return (_uses_beams(arguments)
            or arguments["model"].config.vit.quant == "int8")


# ----------------------------------------------------------------- generate
@graphed(eager_when=_eager_route)
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


@graphed(eager_when=_uses_beams)
@torch.no_grad()
def t5_generate_from_encoder(model: VideoTGB, enc_hidden, enc_mask,
                             decode_config: DecodeConfig, generator=None,
                             stop_sequences=()):
    """Greedy / sampling / beam T5 decode from a computed encoder state.
    Step 0 is the prefill: it writes token 0's self K/V and every layer's
    cross K/V. With ``num_beams`` k > 1 the encoder state is repeated per
    beam and the caches hold B * k rows."""
    t5cfg = model.config.blip2.t5
    b = enc_hidden.shape[0]
    beams = decode_config.num_beams
    if beams > 1:
        enc_hidden = enc_hidden.repeat_interleave(beams, 0)
        enc_mask = enc_mask.repeat_interleave(beams, 0)
    bk = enc_hidden.shape[0]
    max_new = decode_config.max_new_tokens
    dev = enc_hidden.device
    caches = model.init_t5_caches(bk, max_new, enc_hidden.shape[1])
    start = torch.full((b,), t5cfg.decoder_start_token_id, dtype=torch.long,
                       device=dev)
    steps = torch.arange(max_new, device=dev)

    def step_fn(tokens, caches, index):
        # ``index``: a host int (step 0, beams) or a device tensor (decode)
        valid = (steps[None] <= index).float().expand(bk, max_new)
        prefill = not torch.is_tensor(index) and index == 0
        return model.t5_decode_step(tokens, enc_hidden, enc_mask, caches,
                                    index, valid, cross_prefill=prefill)

    if beams > 1:
        return beam_search(step_fn, caches, start, decode_config)
    return decode(step_fn, caches, start, decode_config, generator=generator,
                  stop_sequences=stop_sequences)


# ------------------------------------------- two-phase (bandwidth-aware) mode
@graphed
@torch.no_grad()
def select_phase_blip2(model: VideoTGB, flow_rgb_u8, batch, generator=None,
                       noise=None, mode="fusion", rescale="minus1"):
    """Phase 1: RAFT + TGB + Gumbel selection from the flow frames only,
    (B, L+1, Hf, Wf, 3) uint8. ``mode`` / ``rescale`` are "fusion" /
    "minus1" for the T5 backbones, "multi_modal" / "ratio" for Vicuna.
    Returns cand_index (B, nframe)."""
    batch = _on(model, batch)
    flow = model.flow_features(flow_rgb_u8.to(model.device).float())
    _, sl, el = model.span_logits(flow, batch["flow_mask"],
                                  batch["sampler_question_ids"],
                                  batch["sampler_question_mask"], mode)
    return model.select_frames(sl, el, batch["video_length"], generator,
                               inclusive_end=False, rescale=rescale,
                               noise=noise)


_CLIP: dict = {}


def _clip_constants(device):
    """CLIP's mean and std (3,) f32 on ``device``, made once per device (a
    graphed phase copies nothing from the host)."""
    key = str(device)
    if key not in _CLIP:
        _CLIP[key] = tuple(torch.tensor(c, dtype=torch.float32, device=device)
                           for c in (CLIP_MEAN, CLIP_STD))
    return _CLIP[key]


def _encode_selected_u8(model: VideoTGB, selected_frames_u8, batch):
    """CLIP normalization on the device, then ViT -> Q-Former (reading the
    batch's ``qformer_input_ids`` where the config is instruction-aware) ->
    projection, mean-pooled over each request's frames -> (B, Q, d)."""
    dev = model.device
    mean, std = _clip_constants(dev)
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
    return model.model.encode_frames(
        frames.reshape(b * nf, *frames.shape[2:]), mean_pool_groups=b,
        qformer_input_ids=qf_ids, qformer_attention_mask=qf_mask)


@graphed(eager_when=_eager_route)
@torch.no_grad()
def answer_phase_blip2(model: VideoTGB, selected_frames_u8, batch,
                       decode_config: DecodeConfig, generator=None):
    """Phase 2: CLIP normalization on the device, ViT -> Q-Former
    (mean-pooled) -> T5 encode + decode. Frames (B, nframe, H, W, 3) uint8."""
    batch = _on(model, batch)
    visual = _encode_selected_u8(model, selected_frames_u8, batch)
    embeds, mask = model.model.encoder_inputs(visual, batch["question_ids"],
                                              batch["question_mask"])
    enc_hidden = model.model.language_model.encode(embeds, mask)
    return t5_generate_from_encoder(model, enc_hidden, mask, decode_config,
                                    generator)


@graphed(eager_when=_eager_route)
@torch.no_grad()
def answer_phase_instructblip(model: VideoTGB, selected_frames_u8, batch,
                              decode_config: DecodeConfig, generator=None,
                              stop_sequences=()):
    """Phase 2 for the Vicuna backbone: CLIP normalization on the device,
    instruction-aware Q-Former mean-pooled to Q tokens, [visual | prompt]
    embeddings, decoder-only generate. Frames (B, nframe, H, W, 3) uint8."""
    batch = _on(model, batch)
    visual = _encode_selected_u8(model, selected_frames_u8, batch)
    embeds, mask = model.model.decoder_inputs(visual, batch["question_ids"],
                                              batch["question_mask"])
    return llama_generate_from_embeds(model, embeds, mask, decode_config,
                                      generator, stop_sequences)


@graphed(eager_when=_eager_route)
@torch.no_grad()
def generate_instructblip(model: VideoTGB, batch, decode_config: DecodeConfig,
                          generator=None, stop_sequences=(), noise=None):
    """Batched InstructBLIP-Vicuna QA generation in one call; ``batch`` as
    for :func:`generate_blip2`, with ``qformer_input_ids``/``_mask`` for the
    instruction-aware Q-Former. Returns (token_ids (B, T), cand_index)."""
    batch = _on(model, batch)
    embeds, mask, cand = model.prepare_llama_inference(
        batch["frames"], batch["flow"], batch["flow_mask"],
        batch["video_length"], batch["sampler_question_ids"],
        batch["sampler_question_mask"], batch["question_ids"],
        batch["question_mask"], generator=generator, noise=noise,
        qformer_input_ids=batch.get("qformer_input_ids"),
        qformer_attention_mask=batch.get("qformer_attention_mask"))
    out = llama_generate_from_embeds(model, embeds, mask, decode_config,
                                     generator, stop_sequences)
    return out, cand


@torch.no_grad()
def generate_iv(model: VideoTGB, batch, decode_config: DecodeConfig,
                generator=None, stop_sequences=()):
    """Stage-3 IV/IVT generation: the frames (B, nframe, H, W, 3) arrive
    pre-selected and CLIP-normalized from ``collate_iv`` (no RAFT, TGB or
    selection) and mean-pool to the Q-token visual prefix (the Q-Former
    reads the instruction, repeated per frame, where the config is
    instruction-aware); a text-only row (``widths`` 0) masks the prefix out
    of attention. T5: the encoder over [visual | question], then greedy
    decode; LLaMA: [visual | prompt] embeddings, then decoder-only decode.
    Returns token_ids (B, max_new)."""
    cfg = model.config
    batch = _on(model, batch)
    frames = batch["frames"]
    b, nf = frames.shape[:2]
    vis_valid = None
    if "widths" in batch:
        vis_valid = (batch["widths"] > 0).float()
    qf_ids = qf_mask = None
    if cfg.instruction_aware:
        qf_ids = batch.get("qformer_input_ids")
        qf_mask = batch.get("qformer_attention_mask")
        if qf_ids is not None:
            qf_ids = qf_ids.repeat_interleave(nf, 0)
            qf_mask = (qf_mask.repeat_interleave(nf, 0)
                       if qf_mask is not None else None)
    visual = model.model.encode_frames(
        frames.reshape(b * nf, *frames.shape[2:]), mean_pool_groups=b,
        qformer_input_ids=qf_ids, qformer_attention_mask=qf_mask)
    if cfg.backbone == "blip2":
        embeds, mask = model.model.encoder_inputs(
            visual, batch["question_ids"], batch["question_mask"], vis_valid)
        enc_hidden = model.model.language_model.encode(embeds, mask)
        return t5_generate_from_encoder(model, enc_hidden, mask,
                                        decode_config, generator,
                                        stop_sequences)
    embeds, mask = model.model.decoder_inputs(
        visual, batch["question_ids"], batch["question_mask"], vis_valid)
    return llama_generate_from_embeds(model, embeds, mask, decode_config,
                                      generator, stop_sequences)


@graphed(eager_when=_uses_beams)
@torch.no_grad()
def llama_generate_from_embeds(model: VideoTGB, embeds, mask,
                               decode_config: DecodeConfig, generator=None,
                               stop_sequences=()):
    """Greedy / sampling / beam LLaMA decode from a right-padded [visual |
    prompt] prefix (B, S, d) with its mask (B, S).

    The prefill writes the prompt's K/V into buffers of S + max_new slots,
    at per-row RoPE positions that count only the real tokens; each row's
    first token comes from the logits at its last real token. The token of
    step t-1 is written at slot S + t - 1 with RoPE position length + t - 1,
    and the validity mask opens that slot. With ``num_beams`` k > 1 the
    prefix is repeated per beam before the prefill and beam search reorders
    the caches; a sample's k rows share one mask row and one length, so the
    reorder, which stays within a sample's rows, leaves ``valid`` and
    ``lengths`` right."""
    b_orig = embeds.shape[0]
    beams = decode_config.num_beams
    if beams > 1:
        embeds = embeds.repeat_interleave(beams, 0)
        mask = mask.repeat_interleave(beams, 0)
    b, s = embeds.shape[:2]
    max_new = decode_config.max_new_tokens
    dev = embeds.device
    mask_f = mask.float()
    lengths = mask_f.sum(dim=1).long()
    prompt_pos = (mask_f.cumsum(dim=1).long() - 1).clamp(min=0)
    caches = model.init_llama_caches(b, s + max_new)
    valid = torch.cat([mask_f, torch.zeros((b, max_new), device=dev)], dim=1)
    logits, caches = model.llama_step(
        inputs_embeds=embeds, positions=prompt_pos, caches=caches,
        cache_index=0, cache_positions_valid=valid)
    first_logits = logits[torch.arange(b, device=dev), lengths - 1]

    def step_fn(tokens, caches, t):
        # ``t``: a host int (step 0, beams) or a device tensor (decode)
        if not torch.is_tensor(t) and t == 0:
            return first_logits, caches
        slot = s + t - 1
        if torch.is_tensor(slot):
            valid.index_fill_(1, slot.view(1), 1.0)
        else:
            valid[:, slot] = 1.0
        logits, caches = model.llama_step(
            tokens=tokens, positions=(lengths + t - 1)[:, None],
            caches=caches, cache_index=slot, cache_positions_valid=valid)
        return logits[:, -1], caches

    start = torch.zeros((b_orig,), dtype=torch.long, device=dev)
    if beams > 1:
        return beam_search(step_fn, caches, start, decode_config,
                           penalty_length_offset=1)
    return decode(step_fn, caches, start, decode_config, generator=generator,
                  stop_sequences=stop_sequences)
