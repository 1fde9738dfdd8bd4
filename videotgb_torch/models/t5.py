"""Flan-T5 encoder-decoder with a KV-cache decoder (counterpart of
``videotgb_tpu/models/t5.py``): RMS norms, pre-norm blocks, bias-free dense
layers, unscaled attention scores, one bucketed relative-position bias per
stack (bidirectional in the encoder, causal in the decoder), gated-gelu FFN,
separate lm_head. ``lora_rank`` > 0 puts LoRA deltas on the q and v
projections of every attention (encoder self, decoder self and cross).

Decoder caches are a list of per-layer ``{"self": {k, v}, "cross": {k, v}}``
dicts; the self K/V are written in place at ``cache_index`` (a host int, or
a 0-dim device tensor from which the positions, the relative-position bias
and the causal mask are computed on the device), the cross K/V are
computed once by the first cached call (``cross_prefill=True``).

Under sequence parallelism (``sp``, set by ``parallel.sequence.shard_sp``)
the encoder's input stream (the JAX sites ``t5.py:327,343``; BLIP2's
``encoder_inputs`` site, ``blip2.py:120``, is the same tensor) and the
no-cache decoder's (``:375,404``) are split over the ``sp`` ranks and
gathered after their final norms: the encoder's output is whole before any
cross-attention reads it. The relative-position bias is made for the
rank's query positions against every key (``RelativePositionBias``), the
decoder's causal mask at global positions. Cached decode steps stay whole.

``scan_layers`` keeps the per-layer ``encoder_blocks.{i}`` /
``decoder_blocks.{i}`` parameters (``convert.py`` unstacks a JAX scanned
tree) and marks the stacks as ones that may be staged: under pipeline
parallelism (``pp``, set by ``parallel.pipeline.shard_pp``) ``encode`` and
the teacher-forced ``decode`` run their blocks through
``parallel.pipeline.pipeline_apply`` (the JAX sites ``t5.py:282-314,
328-338,387-397``), the bias, the encoder states and the cross bias as
side inputs; the cached decode and ``cross_prefill`` stay sequential.
``remat`` recomputes each block's forward in the backward of a pass
without caches (``torch.utils.checkpoint``, the JAX ``nn.remat``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from videotgb_torch.models.common import (
    Dense,
    Embed,
    MultiHeadAttention,
    RMSNorm,
    _fill_normal,
    _param,
    cache_start,
    init_kv_cache,
    remat_call,
)
from videotgb_torch.ops.attention import make_causal_bias, make_padding_bias
from videotgb_torch.parallel.pipeline import active_pp_mesh, stage_stack
from videotgb_torch.parallel.sequence import stream


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    num_heads: int = 32
    d_ff: int = 5120
    num_encoder_layers: int = 24
    num_decoder_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    eos_token_id: int = 1
    lora_rank: int = 0
    lora_alpha: float = 32.0
    # the stacks may be staged over pp; each block recomputed in the backward
    scan_layers: bool = False
    remat: bool = False
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def flan_t5_xl(cls) -> "T5Config":
        return cls()

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=384, d_model=32, d_kv=8, num_heads=4, d_ff=64,
                   num_encoder_layers=2, num_decoder_layers=2)


def relative_position_bucket(relative_position, bidirectional: bool,
                             num_buckets: int, max_distance: int):
    """T5's log-spaced distance buckets (HF semantics), computed in f32 like
    the JAX package. relative_position = key_pos - query_pos (int64)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).long() * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    val_if_large = max_exact + (
        torch.log(torch.clamp(n, min=1).float() / max_exact)
        / log_ratio * (num_buckets - max_exact)).to(torch.int64)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class RelativePositionBias(nn.Module):
    def __init__(self, cfg: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.config = cfg
        self.bidirectional = bidirectional
        self.rel_embedding = _param(
            (cfg.relative_attention_num_buckets, cfg.num_heads),
            cfg.param_dtype, device)

    def reset_parameters_from(self, gen):
        _fill_normal(self.rel_embedding, 1.0, gen)

    def forward(self, q_positions, k_positions):
        """-> (1, heads, len(q), len(k)) f32."""
        cfg = self.config
        rel = k_positions[None, :] - q_positions[:, None]
        buckets = relative_position_bucket(
            rel, self.bidirectional, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        bias = self.rel_embedding[buckets]  # (q, k, heads)
        return bias.permute(2, 0, 1)[None].float()


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, device=None):
        super().__init__()
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        mha = dict(num_heads=cfg.num_heads, head_dim=cfg.d_kv,
                   out_features=cfg.d_model, use_bias=False, scale=1.0,
                   lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha, **kw)
        d = cfg.d_model
        self.is_decoder = is_decoder
        self.self_ln = RMSNorm(d, cfg.layer_norm_eps, **kw)
        self.self_attn = MultiHeadAttention(d, **mha)
        self.cross_ln = self.cross_attn = None
        if is_decoder:
            self.cross_ln = RMSNorm(d, cfg.layer_norm_eps, **kw)
            self.cross_attn = MultiHeadAttention(d, **mha)
        self.ffn_ln = RMSNorm(d, cfg.layer_norm_eps, **kw)
        self.wi_0 = Dense(d, cfg.d_ff, use_bias=False, **kw)
        self.wi_1 = Dense(d, cfg.d_ff, use_bias=False, **kw)
        self.wo = Dense(cfg.d_ff, d, use_bias=False, **kw)

    def forward(self, x, self_bias, encoder_hidden=None, cross_bias=None,
                cache=None, cache_index=None, cross_prefill=False, sp=None):
        """``sp``: ``x`` is this rank's tokens of a split stream (no cache)
        and ``self_bias`` holds their rows."""
        new_cache = {}
        attn, self_kv = self.self_attn(
            self.self_ln(x), bias=self_bias,
            cache=None if cache is None else cache["self"],
            cache_index=cache_index, sp=sp)
        if self_kv is not None:
            new_cache["self"] = self_kv
        x = x + attn
        if self.is_decoder:
            cached = cache is not None and not cross_prefill
            attn, cross_kv = self.cross_attn(
                self.cross_ln(x), x_kv=encoder_hidden, bias=cross_bias,
                cache=cache["cross"] if cached else None,
                cross_cached=cached,
                return_kv=cache is not None and cross_prefill, sp=sp)
            if cache is not None:
                new_cache["cross"] = cross_kv if cross_prefill else cache["cross"]
            x = x + attn
        h = self.ffn_ln(x)
        # flan-T5's gated act is gelu_new (tanh approximation)
        h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        return x + self.wo(h), (new_cache or None)


class T5Model(nn.Module):
    """Methods: embed / encode / decode / init_caches / forward."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.config = cfg
        kw = dict(dtype=cfg.dtype, param_dtype=cfg.param_dtype, device=device)
        self.shared = Embed(cfg.vocab_size, cfg.d_model, **kw)
        self.enc_rel_bias = RelativePositionBias(cfg, True, device)
        self.dec_rel_bias = RelativePositionBias(cfg, False, device)
        self.encoder_blocks = nn.ModuleList(
            T5Block(cfg, False, device) for _ in range(cfg.num_encoder_layers))
        self.decoder_blocks = nn.ModuleList(
            T5Block(cfg, True, device) for _ in range(cfg.num_decoder_layers))
        self.encoder_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps, **kw)
        self.decoder_final_ln = RMSNorm(cfg.d_model, cfg.layer_norm_eps, **kw)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, use_bias=False, **kw)
        self.sp = None  # parallel.sequence.SPGroup under shard_sp
        self.pp = None  # parallel.pipeline.PPGroup under shard_pp

    def embed(self, input_ids):
        return self.shared(input_ids)

    def _layer_fn(self, block, tree):
        """One block on a pipeline tree (x, *side inputs)."""
        return (remat_call(self.config.remat, block, *tree)[0], *tree[1:])

    def encode(self, inputs_embeds, attention_mask):
        """inputs_embeds (B, S, d_model) -> encoder hidden (B, S, d_model)."""
        s = inputs_embeds.shape[1]
        pos = torch.arange(s, device=inputs_embeds.device)
        x = inputs_embeds.to(self.config.dtype)
        sp = stream(self.sp, x)
        q_pos = pos
        if sp is not None:
            x = sp.split(x)
            q_pos = sp.positions(s, pos.device)
        # contiguous, so that the flash kernels read a row of keys per query
        # (as a permuted view its key stride is the head count)
        bias = (self.enc_rel_bias(q_pos, pos).contiguous()
                + make_padding_bias(attention_mask))
        if active_pp_mesh(self) is not None:
            x = stage_stack(self, self.encoder_blocks, self._layer_fn,
                            (x, bias))
        else:
            for block in self.encoder_blocks:
                x, _ = remat_call(self.config.remat, block, x, bias, sp=sp)
        x = self.encoder_final_ln(x)
        return x if sp is None else sp.gather(x)

    def decode(self, decoder_input_ids, encoder_hidden, encoder_mask,
               caches=None, cache_index=None, cache_positions_valid=None,
               cross_prefill=False):
        """Teacher-forced when ``caches`` is None; incremental otherwise
        (self-attention spans the whole cache buffer, its valid prefix given
        by ``cache_positions_valid`` (B, S_max)). The first cached call
        passes ``cross_prefill=True``. Returns (logits f32, caches)."""
        cfg = self.config
        s = decoder_input_ids.shape[1]
        dev = decoder_input_ids.device
        x = self.shared(decoder_input_ids).to(cfg.dtype)
        cross_bias = make_padding_bias(encoder_mask)
        sp = stream(self.sp, x) if caches is None else None
        if caches is None:
            k_pos = q_pos = torch.arange(s, device=dev)
            if sp is not None:
                x = sp.split(x)
                q_pos = sp.positions(s, dev)
            valid = None
        else:
            k_pos = torch.arange(caches[0]["self"]["k"].shape[-2], device=dev)
            q_pos = cache_start(cache_index) + torch.arange(s, device=dev)
            valid = cache_positions_valid
        self_bias = self.dec_rel_bias(q_pos, k_pos) + make_causal_bias(
            len(q_pos), len(k_pos), device=dev, q_positions=q_pos)
        if valid is not None:
            self_bias = self_bias + make_padding_bias(valid)
        if caches is None and active_pp_mesh(self) is not None:
            x = stage_stack(self, self.decoder_blocks, self._layer_fn,
                            (x, self_bias, encoder_hidden, cross_bias))
            new_caches = None
        elif caches is None:
            for block in self.decoder_blocks:
                x, _ = remat_call(self.config.remat, block, x, self_bias,
                                  encoder_hidden, cross_bias, sp=sp)
            new_caches = None
        else:
            new_caches = []
            for block, cache in zip(self.decoder_blocks, caches):
                x, new_cache = block(x, self_bias, encoder_hidden, cross_bias,
                                     cache=cache, cache_index=cache_index,
                                     cross_prefill=cross_prefill)
                new_caches.append(new_cache)
        x = self.decoder_final_ln(x)
        if sp is not None:
            x = sp.gather(x)
        return self.lm_head(x).float(), new_caches

    def init_caches(self, batch, max_len, encoder_len):
        """Caches of this rank's heads (all of them outside tensor
        parallelism)."""
        cfg = self.config
        device = self.shared.weight.device
        heads = self.decoder_blocks[0].self_attn.num_heads
        return [{"self": init_kv_cache(batch, heads, max_len, cfg.d_kv,
                                       cfg.dtype, device),
                 "cross": init_kv_cache(batch, heads, encoder_len,
                                        cfg.d_kv, cfg.dtype, device)}
                for _ in range(cfg.num_decoder_layers)]

    def forward(self, encoder_embeds, encoder_mask, decoder_input_ids):
        enc = self.encode(encoder_embeds, encoder_mask)
        logits, _ = self.decode(decoder_input_ids, enc, encoder_mask)
        return logits
