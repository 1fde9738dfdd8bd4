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
* per-layer scopes ``layer_{i}`` (TGB, ViT, Q-Former) -> ``layers.{i}``,
  T5's ``encoder_{i}`` / ``decoder_{i}`` -> ``encoder_blocks.{i}`` /
  ``decoder_blocks.{i}``;
* everything else (biases, ``bos``/``eos``, ``cls_token``,
  ``position_embedding(s)``, ``query_tokens``, ``rel_embedding``) by name.

Trees built with ``scan_layers`` (stacked layer axes) are not supported.
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


def _map_path(path: tuple) -> tuple[str, str]:
    """(port key, leaf kind) for one flax path."""
    if any(p in ("encoder_layers", "decoder_layers") for p in path) or (
            path[:2] == ("layers", "layer")):
        raise NotImplementedError(
            f"stacked (scan_layers) parameters are not supported: {path}")
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
    out = {}
    for path, value in _flatten(tree).items():
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
