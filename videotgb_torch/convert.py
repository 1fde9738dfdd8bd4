"""Carry a JAX parameter tree across to the port's ``state_dict``.

Input: the flax tree of ``videotgb_tpu`` (nested dicts of numpy arrays, as
``jax.device_get`` gives them, with or without the outer ``"params"``), for
the whole ``VideoTGB`` or any of its towers. Output: a ``state_dict`` for
the matching ``videotgb_torch`` module. The port's modules carry the JAX
module names, so the mapping is:

* dense kernels (in, out) -> ``weight`` (out, in);
* conv kernels HWIO -> ``weight`` OIHW;
* norm ``scale`` and embedding ``embedding`` -> ``weight``;
* RAFT's frozen batch norms ``normN/norm/{scale,bias,mean,var}`` ->
  ``normN.{weight,bias,running_mean,running_var}``;
* per-layer scopes ``layer_{i}`` (TGB, ViT, Q-Former, LLaMA) ->
  ``layers.{i}``,
  T5's ``encoder_{i}`` / ``decoder_{i}`` -> ``encoder_blocks.{i}`` /
  ``decoder_blocks.{i}``;
* everything else (biases, ``bos``/``eos``, ``cls_token``,
  ``position_embedding(s)``, ``query_tokens``, ``rel_embedding``) by name;
  so do the LoRA adapters, ``<q|v>_lora/lora_a`` (in, r) and ``lora_b``
  (r, out), which the port keeps in the JAX layout.

The InstructBLIP-Vicuna tree needs no rule of its own: LLaMA's
``embed_tokens/embedding``, the RMS norms' ``scale``, the bias-free
projections' ``kernel`` and ``language_model/layer_{i}`` all fall under the
rules above. Trees built with ``scan_layers`` are unstacked first (the
inverse of the JAX package's ``training.convert.stack_layers``): a leaf
under ``layers/layer`` (ViT, LLaMA) or ``encoder_layers/block`` /
``decoder_layers/block`` (T5) carries a leading layer axis and becomes one
leaf per ``layer_{i}`` / ``encoder_{i}`` / ``decoder_{i}``.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layer_(\d+)$")
_T5_BLOCK = re.compile(r"^(encoder|decoder)_(\d+)$")
_BN_NORM = re.compile(r"^norm\d$")
_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _flatten(tree: Mapping, prefix=()) -> dict[tuple, Any]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = value
    return out


# a scanned stack's scope -> (its inner scope, the per-layer scope)
_STACKED = {"layers": ("layer", "layer_{}"),
            "encoder_layers": ("block", "encoder_{}"),
            "decoder_layers": ("block", "decoder_{}")}


def unstack_layers(flat: Mapping[tuple, Any]) -> dict[tuple, Any]:
    """Split every stacked (``scan_layers``) leaf of a flat flax dict along
    its leading layer axis into per-layer paths; other leaves pass
    through."""
    out = {}
    for path, value in flat.items():
        for i, scope in enumerate(path[:-2]):
            inner, per_layer = _STACKED.get(scope, (None, None))
            if path[i + 1] == inner:
                arr = np.asarray(value)
                for j in range(arr.shape[0]):
                    out[path[:i] + (per_layer.format(j),) + path[i + 2:]] = (
                        arr[j])
                break
        else:
            out[path] = value
    return out


def _map_path(path: tuple) -> tuple[str, str]:
    """(port key, leaf kind) for one flax path."""
    parts = []
    leaf = path[-1]
    scopes = list(path[:-1])
    kind = leaf
    if len(scopes) >= 2 and scopes[-1] == "norm" and _BN_NORM.match(scopes[-2]):
        scopes = scopes[:-1]
        leaf = _BN_LEAVES[leaf]
        kind = "raw"
    for scope in scopes:
        m = _LAYER.match(scope)
        t5 = _T5_BLOCK.match(scope)
        if m:
            parts += ["layers", m.group(1)]
        elif t5:
            parts += [f"{t5.group(1)}_blocks", t5.group(2)]
        else:
            parts.append(scope)
    if kind in ("kernel", "scale", "embedding"):
        leaf = "weight"
    return ".".join(parts + [leaf]), kind


def flax_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """Map a flax parameter tree onto the port's ``state_dict`` keys."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    return flat_to_state_dict(_flatten(tree))


def flat_to_state_dict(flat: Mapping[tuple, Any]) -> dict[str, torch.Tensor]:
    """Map a flat flax dict ({path tuple: array}, stacked or per-layer) onto
    the port's ``state_dict`` keys."""
    out = {}
    for path, value in unstack_layers(flat).items():
        arr = np.asarray(value)
        key, kind = _map_path(path)
        if kind == "kernel":
            if arr.ndim == 4:  # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:  # (in, out) -> (out, in)
                arr = arr.T
            else:
                raise ValueError(f"kernel of rank {arr.ndim} at {path}")
        if arr.dtype != np.float32:  # bf16 / f64 leaves; bf16 -> f32 is exact
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out


def load_flax_params(module: torch.nn.Module,
                     tree: Mapping) -> torch.nn.Module:
    """Copy a flax tree into ``module`` (cast to each parameter's dtype and
    device). Every parameter of the module must be covered, every converted
    entry must have a home, and shapes must agree."""
    sd = flax_to_state_dict(tree)
    own = module.state_dict()
    unknown = sorted(set(sd) - set(own))
    missing = sorted(set(own) - set(sd))
    if unknown or missing:
        raise KeyError(f"unmatched parameters: no home for {unknown[:8]}, "
                       f"not covered {missing[:8]}")
    with torch.no_grad():
        for key, value in sd.items():
            dst = own[key]
            if tuple(dst.shape) != tuple(value.shape):
                raise ValueError(f"shape mismatch at {key}: tree "
                                 f"{tuple(value.shape)} vs module "
                                 f"{tuple(dst.shape)}")
            dst.copy_(value.to(device=dst.device, dtype=dst.dtype))
    return module
