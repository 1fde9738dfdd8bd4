"""The port's RAFT and TGB parameters under the reference's torch names
(raft-sintel.pth's and sampler.pth's): the inverse of
``hf_convert.convert_raft`` and ``convert_reference_tgb``, carried across by
``videotgb_torch.convert``. The released files are not in the repository,
so the converter's tests and ``chip_smoke.py`` write such files from a
seeded model with these. Imports only torch, so it also runs where JAX is
not installed."""

from __future__ import annotations

import re
from typing import Mapping

import torch

_RAFT_NAMES = ((r"layer(\d)_(\d)", r"layer\1.\2"),
               (r"\.norm3\.", ".downsample.1."),
               (r"\.downsample\.(weight|bias)$", r".downsample.0.\1"),
               (r"flow_head_conv", "flow_head.conv"),
               (r"mask_conv1", "mask.0"), (r"mask_conv2", "mask.2"))
_QKV = {"q": "query", "k": "key", "v": "value"}
_TGB_NAMES = (
    (r"^word_embeddings", "embeddings.word_embeddings"),
    (r"^token_type_embeddings", "embeddings.token_type_embeddings"),
    (r"^text_ln", "embeddings.LayerNorm"),
    (r"^layers\.(\d+)\.self_attn\.([qkv])\.", lambda m: (
        f"encoder.layer.{m[1]}.attention.self.{_QKV[m[2]]}.")),
    (r"^layers\.(\d+)\.cross_attn\.([qkv])\.", lambda m: (
        f"encoder.layer.{m[1]}.crossattention.self.{_QKV[m[2]]}.")),
    (r"^layers\.(\d+)\.self_attn\.o\.", r"encoder.layer.\1.attention.output.dense."),
    (r"^layers\.(\d+)\.self_ln\.", r"encoder.layer.\1.attention.output.LayerNorm."),
    (r"^layers\.(\d+)\.cross_attn\.o\.",
     r"encoder.layer.\1.crossattention.output.dense."),
    (r"^layers\.(\d+)\.cross_ln\.",
     r"encoder.layer.\1.crossattention.output.LayerNorm."),
    (r"^layers\.(\d+)\.mlp\.wi\.", r"encoder.layer.\1.intermediate.dense."),
    (r"^layers\.(\d+)\.mlp\.wo\.", r"encoder.layer.\1.output.dense."),
    (r"^layers\.(\d+)\.ffn_ln\.", r"encoder.layer.\1.output.LayerNorm."),
)


def _rename(state_dict: Mapping, prefix: str, rules) -> dict:
    out = {}
    for key, value in state_dict.items():
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        out[name] = value.detach().cpu().clone()
    return out


def raft_to_reference(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """The RAFT parameters of a port ``VideoTGB`` state dict (keys under
    ``of_extractor.``) under raft-sintel.pth's names: the inverse of
    ``hf_convert.convert_raft`` carried across by ``videotgb_torch.convert``."""
    return _rename(state_dict, "of_extractor.", _RAFT_NAMES)


def tgb_to_reference(state_dict: Mapping) -> dict[str, torch.Tensor]:
    """The TGB parameters of a port ``VideoTGB`` state dict (keys under
    ``temporal_encoder.``) under the reference sampler.pth's names: the
    inverse of ``hf_convert.convert_reference_tgb``."""
    return _rename(state_dict, "temporal_encoder.", _TGB_NAMES)
