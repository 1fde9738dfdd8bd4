"""Released torch / HF state dicts -> the port's VideoTGB parameters (the
port's copy of ``videotgb_tpu/training/convert.py``).

The reference loads released torch checkpoints: the BLIP2 / InstructBLIP HF
weights, bert-base-uncased for the TGB init, raft-sintel.pth and the
trained sampler.pth. Each converter maps a torch ``state_dict`` (as
{name: np.ndarray}) onto the flat flax-named dict that the JAX converters
give, {path tuple: array}, the same arrays; ``videotgb_torch.convert``
carries that layout to the port's ``state_dict`` names, and :func:`graft`
copies it into a model. Sources a checkpoint does not cover (the TGB's
cross-attention when initialised from vanilla BERT) keep the model's
random init, as the reference's ``from_pretrained`` does with its added
modules. ``convert_reference_albert_tgb`` waits for ``AlbertTGBModel``
(ROADMAP.md queue 1).

Conventions: torch Linear weight (out, in) -> flax kernel (in, out);
torch Conv2d (out, in, kh, kw) -> flax NHWC kernel (kh, kw, in, out).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Flat = dict[tuple, np.ndarray]


def _lin(sd: Mapping, name: str, dst: Flat, path: tuple, bias: bool = True):
    dst[path + ("kernel",)] = np.asarray(sd[f"{name}.weight"]).T
    if bias and f"{name}.bias" in sd:
        dst[path + ("bias",)] = np.asarray(sd[f"{name}.bias"])


def _conv(sd: Mapping, name: str, dst: Flat, path: tuple, bias: bool = True):
    dst[path + ("kernel",)] = np.asarray(sd[f"{name}.weight"]).transpose(2, 3, 1, 0)
    if bias and f"{name}.bias" in sd:
        dst[path + ("bias",)] = np.asarray(sd[f"{name}.bias"])


def _ln(sd: Mapping, name: str, dst: Flat, path: tuple):
    dst[path + ("scale",)] = np.asarray(sd[f"{name}.weight"])
    dst[path + ("bias",)] = np.asarray(sd[f"{name}.bias"])


def _rms(sd: Mapping, name: str, dst: Flat, path: tuple):
    dst[path + ("scale",)] = np.asarray(sd[f"{name}.weight"])


def _emb(sd: Mapping, name: str, dst: Flat, path: tuple):
    dst[path + ("embedding",)] = np.asarray(sd[f"{name}.weight"])


# --------------------------------------------------------------------- ViT
def convert_blip2_vision(sd: Mapping, num_layers: int, prefix: str = "") -> Flat:
    """HF Blip2VisionModel state dict -> models.vit.ViTModel params."""
    out: Flat = {}
    p = prefix
    out[("embeddings", "cls_token")] = np.asarray(sd[f"{p}embeddings.class_embedding"])
    out[("embeddings", "position_embedding")] = np.asarray(
        sd[f"{p}embeddings.position_embedding"]
    )
    _conv(sd, f"{p}embeddings.patch_embedding", out, ("embeddings", "patch_embed"))
    for i in range(num_layers):
        lp = f"{p}encoder.layers.{i}."
        dst = (f"layer_{i}",)
        _ln(sd, f"{lp}layer_norm1", out, dst + ("ln1",))
        _ln(sd, f"{lp}layer_norm2", out, dst + ("ln2",))
        # HF blip2 packs qkv into one projection; split thirds
        qkv_w = np.asarray(sd[f"{lp}self_attn.qkv.weight"])  # (3d, d)
        d = qkv_w.shape[1]
        for j, name in enumerate(("q", "k", "v")):
            out[dst + ("attn", name, "kernel")] = qkv_w[j * d : (j + 1) * d].T
            bkey = f"{lp}self_attn.qkv.bias"
            if bkey in sd:
                out[dst + ("attn", name, "bias")] = np.asarray(sd[bkey])[
                    j * d : (j + 1) * d
                ]
        _lin(sd, f"{lp}self_attn.projection", out, dst + ("attn", "o"))
        _lin(sd, f"{lp}mlp.fc1", out, dst + ("mlp", "wi"))
        _lin(sd, f"{lp}mlp.fc2", out, dst + ("mlp", "wo"))
    _ln(sd, f"{p}post_layernorm", out, ("post_layernorm",))
    return out


# ------------------------------------------------------------------ QFormer
def convert_blip2_qformer(
    sd: Mapping, num_layers: int, cross_freq: int = 2, prefix: str = "",
    instruct: bool = False,
) -> Flat:
    """HF Blip2QFormerModel / InstructBlipQFormerModel -> QFormerModel params."""
    out: Flat = {}
    p = prefix
    if instruct:
        _emb(sd, f"{p}embeddings.word_embeddings", out, ("word_embeddings",))
        out[("position_embeddings",)] = np.asarray(
            sd[f"{p}embeddings.position_embeddings.weight"]
        )
        _ln(sd, f"{p}embeddings.layernorm", out, ("embeddings_ln",))
    else:
        _ln(sd, f"{p}layernorm", out, ("embeddings_ln",))
    for i in range(num_layers):
        lp = f"{p}encoder.layer.{i}."
        dst = (f"layer_{i}",)
        for j, name in enumerate(("q", "k", "v")):
            hf = ("query", "key", "value")[j]
            _lin(sd, f"{lp}attention.attention.{hf}", out,
                 dst + ("self_attn", name))
        _lin(sd, f"{lp}attention.output.dense", out, dst + ("self_attn", "o"))
        _ln(sd, f"{lp}attention.output.LayerNorm", out, dst + ("self_ln",))
        if i % cross_freq == 0:
            for j, name in enumerate(("q", "k", "v")):
                hf = ("query", "key", "value")[j]
                _lin(sd, f"{lp}crossattention.attention.{hf}", out,
                     dst + ("cross_attn", name))
            _lin(sd, f"{lp}crossattention.output.dense", out,
                 dst + ("cross_attn", "o"))
            _ln(sd, f"{lp}crossattention.output.LayerNorm", out,
                dst + ("cross_ln",))
        _lin(sd, f"{lp}intermediate_query.dense", out, dst + ("mlp_query", "wi"))
        _lin(sd, f"{lp}output_query.dense", out, dst + ("mlp_query", "wo"))
        _ln(sd, f"{lp}output_query.LayerNorm", out, dst + ("ffn_query_ln",))
        if f"{lp}intermediate.dense.weight" in sd:
            _lin(sd, f"{lp}intermediate.dense", out, dst + ("mlp_text", "wi"))
            _lin(sd, f"{lp}output.dense", out, dst + ("mlp_text", "wo"))
            _ln(sd, f"{lp}output.LayerNorm", out, dst + ("ffn_text_ln",))
    return out


# ---------------------------------------------------------------------- T5
def convert_t5(sd: Mapping, num_enc: int, num_dec: int, prefix: str = "") -> Flat:
    """HF T5ForConditionalGeneration -> models.t5.T5Model params."""
    out: Flat = {}
    p = prefix
    _emb(sd, f"{p}shared", out, ("shared",))
    out[("enc_rel_bias", "rel_embedding")] = np.asarray(
        sd[f"{p}encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    )
    out[("dec_rel_bias", "rel_embedding")] = np.asarray(
        sd[f"{p}decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    )
    for i in range(num_enc):
        lp = f"{p}encoder.block.{i}."
        dst = (f"encoder_{i}",)
        for name in ("q", "k", "v", "o"):
            _lin(sd, f"{lp}layer.0.SelfAttention.{name}", out,
                 dst + ("self_attn", name), bias=False)
        _rms(sd, f"{lp}layer.0.layer_norm", out, dst + ("self_ln",))
        _lin(sd, f"{lp}layer.1.DenseReluDense.wi_0", out, dst + ("wi_0",), bias=False)
        _lin(sd, f"{lp}layer.1.DenseReluDense.wi_1", out, dst + ("wi_1",), bias=False)
        _lin(sd, f"{lp}layer.1.DenseReluDense.wo", out, dst + ("wo",), bias=False)
        _rms(sd, f"{lp}layer.1.layer_norm", out, dst + ("ffn_ln",))
    for i in range(num_dec):
        lp = f"{p}decoder.block.{i}."
        dst = (f"decoder_{i}",)
        for name in ("q", "k", "v", "o"):
            _lin(sd, f"{lp}layer.0.SelfAttention.{name}", out,
                 dst + ("self_attn", name), bias=False)
        _rms(sd, f"{lp}layer.0.layer_norm", out, dst + ("self_ln",))
        for name in ("q", "k", "v", "o"):
            _lin(sd, f"{lp}layer.1.EncDecAttention.{name}", out,
                 dst + ("cross_attn", name), bias=False)
        _rms(sd, f"{lp}layer.1.layer_norm", out, dst + ("cross_ln",))
        _lin(sd, f"{lp}layer.2.DenseReluDense.wi_0", out, dst + ("wi_0",), bias=False)
        _lin(sd, f"{lp}layer.2.DenseReluDense.wi_1", out, dst + ("wi_1",), bias=False)
        _lin(sd, f"{lp}layer.2.DenseReluDense.wo", out, dst + ("wo",), bias=False)
        _rms(sd, f"{lp}layer.2.layer_norm", out, dst + ("ffn_ln",))
    _rms(sd, f"{p}encoder.final_layer_norm", out, ("encoder_final_ln",))
    _rms(sd, f"{p}decoder.final_layer_norm", out, ("decoder_final_ln",))
    if f"{p}lm_head.weight" in sd:
        _lin(sd, f"{p}lm_head", out, ("lm_head",), bias=False)
    return out


# ------------------------------------------------------------------- LLaMA
def convert_llama(sd: Mapping, num_layers: int, prefix: str = "") -> Flat:
    """HF LlamaForCausalLM -> models.llama.LlamaModel params."""
    out: Flat = {}
    p = prefix
    _emb(sd, f"{p}model.embed_tokens", out, ("embed_tokens",))
    for i in range(num_layers):
        lp = f"{p}model.layers.{i}."
        dst = (f"layer_{i}",)
        for name in ("q", "k", "v", "o"):
            _lin(sd, f"{lp}self_attn.{name}_proj", out,
                 dst + ("attn", name), bias=False)
        _rms(sd, f"{lp}input_layernorm", out, dst + ("input_ln",))
        _rms(sd, f"{lp}post_attention_layernorm", out, dst + ("post_ln",))
        for name in ("gate_proj", "up_proj", "down_proj"):
            _lin(sd, f"{lp}mlp.{name}", out, dst + (name,), bias=False)
    _rms(sd, f"{p}model.norm", out, ("final_ln",))
    _lin(sd, f"{p}lm_head", out, ("lm_head",), bias=False)
    return out


# ------------------------------------------------------------- BERT -> TGB
def convert_bert_to_tgb(sd: Mapping, num_layers: int, prefix: str = "") -> Flat:
    """bert-base-uncased -> TGBModel self-attention path. Cross-attention,
    temporal embedding, and the MRC head stay at random init (the reference's
    from_pretrained adds them fresh, xropebert.py:929-960)."""
    out: Flat = {}
    p = prefix
    _emb(sd, f"{p}embeddings.word_embeddings", out, ("word_embeddings",))
    _emb(sd, f"{p}embeddings.token_type_embeddings", out,
         ("token_type_embeddings",))
    _ln(sd, f"{p}embeddings.LayerNorm", out, ("text_ln",))
    for i in range(num_layers):
        lp = f"{p}encoder.layer.{i}."
        dst = (f"layer_{i}",)
        for j, name in enumerate(("q", "k", "v")):
            hf = ("query", "key", "value")[j]
            _lin(sd, f"{lp}attention.self.{hf}", out, dst + ("self_attn", name))
        _lin(sd, f"{lp}attention.output.dense", out, dst + ("self_attn", "o"))
        _ln(sd, f"{lp}attention.output.LayerNorm", out, dst + ("self_ln",))
        _lin(sd, f"{lp}intermediate.dense", out, dst + ("mlp", "wi"))
        _lin(sd, f"{lp}output.dense", out, dst + ("mlp", "wo"))
        _ln(sd, f"{lp}output.LayerNorm", out, dst + ("ffn_ln",))
    return out


# -------------------------------------------- reference TGB (sampler.pth)
def convert_reference_tgb(sd: Mapping, num_layers: int, fusion_layer: int) -> Flat:
    """The reference's trained RopeBertModel state dict (e.g.
    ckpts/sampler/sampler.pth, LSTP_Blip2_IV_module.py:142-150) -> TGBModel
    params, including the temporal embedding, cross-attention, and MRC head."""
    out: Flat = convert_bert_to_tgb(sd, num_layers)
    te = "temporal_embeddings"
    _conv(sd, f"{te}.projection", out, (te, "projection"))
    _lin(sd, f"{te}.fc", out, (te, "fc"))
    out[(te, "bos")] = np.asarray(sd[f"{te}.bos"])
    out[(te, "eos")] = np.asarray(sd[f"{te}.eos"])
    _emb(sd, f"{te}.frame_pos_embed", out, (te, "frame_pos_embed"))
    _ln(sd, f"{te}.ln", out, (te, "ln"))
    for i in range(fusion_layer, num_layers):
        lp = f"encoder.layer.{i}."
        dst = (f"layer_{i}",)
        for j, name in enumerate(("q", "k", "v")):
            hf = ("query", "key", "value")[j]
            _lin(sd, f"{lp}crossattention.self.{hf}", out,
                 dst + ("cross_attn", name))
        _lin(sd, f"{lp}crossattention.output.dense", out, dst + ("cross_attn", "o"))
        _ln(sd, f"{lp}crossattention.output.LayerNorm", out, dst + ("cross_ln",))
    _lin(sd, "mrc_head", out, ("mrc_head",))
    return out


# -------------------------------------------------------------------- RAFT
def convert_raft(sd: Mapping) -> Flat:
    """raft-sintel.pth (DataParallel prefixes already stripped,
    raft_utils/utils.py:85-91) -> models.raft.RAFT params."""
    out: Flat = {}

    def encoder(src: str, dst_root: str):
        _conv(sd, f"{src}.conv1", out, (dst_root, "conv1"))
        if f"{src}.norm1.weight" in sd:  # batch norm (cnet)
            _bn(sd, f"{src}.norm1", out, (dst_root, "norm1", "norm"))
        for li in (1, 2, 3):
            for bi in (0, 1):
                sp = f"{src}.layer{li}.{bi}"
                dp = (dst_root, f"layer{li}_{bi}")
                _conv(sd, f"{sp}.conv1", out, dp + ("conv1",))
                _conv(sd, f"{sp}.conv2", out, dp + ("conv2",))
                for ni in (1, 2):
                    if f"{sp}.norm{ni}.weight" in sd:
                        _bn(sd, f"{sp}.norm{ni}", out, dp + (f"norm{ni}", "norm"))
                if f"{sp}.downsample.0.weight" in sd:
                    _conv(sd, f"{sp}.downsample.0", out, dp + ("downsample",))
                    if f"{sp}.downsample.1.weight" in sd:
                        _bn(sd, f"{sp}.downsample.1", out, dp + ("norm3", "norm"))
        _conv(sd, f"{src}.conv2", out, (dst_root, "conv2"))

    def _bn(sd, name, out, path):
        out[path + ("scale",)] = np.asarray(sd[f"{name}.weight"])
        out[path + ("bias",)] = np.asarray(sd[f"{name}.bias"])
        out[path + ("mean",)] = np.asarray(sd[f"{name}.running_mean"])
        out[path + ("var",)] = np.asarray(sd[f"{name}.running_var"])

    encoder("fnet", "fnet")
    encoder("cnet", "cnet")
    ub = "update_block"
    for name in ("convc1", "convc2", "convf1", "convf2", "conv"):
        _conv(sd, f"{ub}.encoder.{name}", out, (ub, "encoder", name))
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        _conv(sd, f"{ub}.gru.{name}", out, (ub, "gru", name))
    _conv(sd, f"{ub}.flow_head.conv1", out, (ub, "flow_head_conv1"))
    _conv(sd, f"{ub}.flow_head.conv2", out, (ub, "flow_head_conv2"))
    _conv(sd, f"{ub}.mask.0", out, (ub, "mask_conv1"))
    _conv(sd, f"{ub}.mask.2", out, (ub, "mask_conv2"))
    return out



def with_subtree(flat: Flat, *root: str) -> Flat:
    """Re-root a converted flat dict under a subtree path."""
    return {tuple(root) + path: value for path, value in flat.items()}


def graft(model: torch.nn.Module, flat: Flat, strict: bool = True) -> int:
    """Copy a converted flat dict into ``model`` (cast to each parameter's
    dtype), shape-checking every entry; with ``strict``, an entry without a
    home raises ``KeyError``. Parameters it does not cover keep their
    values. Returns the number of tensors copied."""
    from videotgb_torch.convert import flat_to_state_dict

    own = model.state_dict()
    converted = flat_to_state_dict(flat)
    homeless = sorted(set(converted) - set(own))
    if homeless and strict:
        raise KeyError(f"no destination for: {homeless[:10]} "
                       f"(+{max(len(homeless) - 10, 0)} more)")
    copied = 0
    with torch.no_grad():
        for key, value in converted.items():
            if key not in own:
                continue
            dst = own[key]
            if tuple(dst.shape) != tuple(value.shape):
                raise ValueError(f"shape mismatch at {key}: checkpoint "
                                 f"{tuple(value.shape)} vs model "
                                 f"{tuple(dst.shape)}")
            dst.copy_(value.to(device=dst.device, dtype=dst.dtype))
            copied += 1
    return copied
