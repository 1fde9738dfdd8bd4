"""Hydra-style composable configuration (the port's copy of
``videotgb_tpu/config/core.py``, the same configs from the same files).

The reference composes its run configs with Hydra 1.3 (reference:
configs/train.yaml:6-53, src/train.py:108). Hydra is not available in this
environment, so this module implements the subset the recipe tree needs:

  * ``defaults`` lists in a root yaml that pull in group configs
    (``data: videoinstruct`` loads ``configs/data/videoinstruct.yaml``
    under the ``data`` key);
  * ``experiment/*.yaml`` global overlays (hydra's ``@package _global_``);
  * dotted command-line overrides (``model.optimizer.lr=1e-4``,
    ``experiment=LSTP_TG``, ``+new.key=3``);
  * ``${interp}``-style interpolation for sibling keys and ``${paths.*}``;
  * ``_target_`` instantiation of python objects (with ``_partial_``).

Configs are plain nested dicts wrapped in :class:`Config` for attribute
access, so they remain picklable and json-serializable. The YAML files are
read by :mod:`videotgb_torch.config.yaml_lite`, which resolves scalars as
PyYAML's ``safe_load`` does; the port does not depend on PyYAML.
"""

from __future__ import annotations

import ast
import datetime
import functools
import importlib
import os
import re
from typing import Any, Iterable, Mapping

from videotgb_torch.config import yaml_lite

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")

# ``${now:%Y-%m-%d}`` resolver timestamp (hydra's run-dir templating,
# reference configs/hydra/default.yaml:9-14). Frozen once per compose() so
# every occurrence in one config tree renders the same instant — a run dir
# assembled from several ${now:...} pieces must not straddle a second.
_NOW: datetime.datetime | None = None


class Config(dict):
    """A dict with attribute access and nested wrapping."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - defensive
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __getitem__(self, key: str) -> Any:
        value = super().__getitem__(key)
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            super().__setitem__(key, value)
        return value

    def get(self, key: str, default: Any = None) -> Any:
        if key in self:
            return self[key]
        return default


def load_yaml(path: str | os.PathLike) -> Config:
    with open(path) as f:
        data = yaml_lite.load(f.read()) or {}
    if not isinstance(data, dict):
        raise ValueError(f"top-level yaml must be a mapping: {path}")
    return Config(data)


def merge(base: Mapping, overlay: Mapping) -> Config:
    """Deep-merge ``overlay`` onto ``base`` (overlay wins, dicts recurse)."""
    out = Config({k: v for k, v in base.items()})
    for key, value in overlay.items():
        if key in out and isinstance(out[key], Mapping) and isinstance(value, Mapping):
            out[key] = merge(out[key], value)
        else:
            out[key] = value
    return out


def _parse_value(text: str) -> Any:
    """Parse an override value: python literal if possible, else string."""
    lowered = text.strip()
    if lowered in ("null", "None", "~"):
        return None
    if lowered in ("true", "True"):
        return True
    if lowered in ("false", "False"):
        return False
    try:
        return ast.literal_eval(lowered)
    except (ValueError, SyntaxError):
        return text


def _set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        if key not in node or not isinstance(node[key], dict):
            node[key] = {}
        node = node[key]
    node[keys[-1]] = value


def parse_overrides(args: Iterable[str]) -> Config:
    """Parse ``key.path=value`` strings (leading ``+``/``++`` tolerated)."""
    out: Config = Config()
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"override must look like key=value, got: {arg}")
        key, _, raw = arg.partition("=")
        key = key.lstrip("+")
        _set_dotted(out, key, _parse_value(raw))
    return out


def _resolve_interp(value: Any, root: Mapping) -> Any:
    if isinstance(value, str):
        matches = _INTERP_RE.findall(value)
        if not matches:
            return value
        # whole-string interpolation preserves the referenced value's type
        whole = _INTERP_RE.fullmatch(value.strip())
        if whole:
            return _lookup(root, whole.group(1))

        def repl(m: re.Match) -> str:
            return str(_lookup(root, m.group(1)))

        return _INTERP_RE.sub(repl, value)
    if isinstance(value, Mapping):
        return Config({k: _resolve_interp(v, root) for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve_interp(v, root) for v in value]
    return value


def _lookup(root: Mapping, dotted: str) -> Any:
    if dotted.startswith("now:"):
        # ${now:%Y-%m-%d} — hydra's dynamic run-dir timestamp
        stamp = _NOW if _NOW is not None else datetime.datetime.now()
        return stamp.strftime(dotted[len("now:"):])
    if dotted.startswith("oc.env:"):
        # ${oc.env:VAR,default}
        body = dotted[len("oc.env:") :]
        name, _, default = body.partition(",")
        return os.environ.get(name.strip(), default.strip() or None)
    node: Any = root
    for key in dotted.split("."):
        if not isinstance(node, Mapping) or key not in node:
            raise KeyError(f"interpolation target not found: ${{{dotted}}}")
        node = node[key]
    return node


def resolve(cfg: Mapping) -> Config:
    """Resolve all ``${...}`` interpolations against the config root."""
    resolved = cfg
    # iterate to fixpoint so chained interpolations resolve (bounded depth)
    for _ in range(8):
        nxt = _resolve_interp(resolved, resolved)
        if nxt == resolved:
            return Config(nxt)
        resolved = nxt
    return Config(resolved)


def compose(
    config_dir: str,
    config_name: str = "train",
    overrides: Iterable[str] | None = None,
) -> Config:
    """Compose a run config the way the reference's hydra tree does.

    Order (reference configs/train.yaml:6-21): root defaults -> experiment
    overlay -> command-line overrides -> interpolation resolution.
    """
    global _NOW
    _NOW = datetime.datetime.now()
    overrides = list(overrides or [])
    # group selections from command line (e.g. experiment=..., trainer=ddp)
    selections: dict[str, str] = {}
    value_overrides: list[str] = []
    for arg in overrides:
        key, _, raw = arg.partition("=")
        group_path = os.path.join(config_dir, key.lstrip("+"), f"{raw}.yaml")
        if "." not in key and os.path.exists(group_path):
            selections[key.lstrip("+")] = raw
        else:
            value_overrides.append(arg)

    root = load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults = root.pop("defaults", [])
    cfg: Config = Config()

    def apply_group(cfg: Config, group: str, name: str) -> Config:
        group_cfg = load_yaml(os.path.join(config_dir, group, f"{name}.yaml"))
        if group_cfg.pop("_global_", False) or group == "experiment":
            # global overlays patch the whole tree (hydra @package _global_),
            # first applying their own "override /group: name" sub-defaults
            sub_defaults = group_cfg.pop("defaults", [])
            for sub in sub_defaults:
                if isinstance(sub, Mapping):
                    for g, n in sub.items():
                        g = g.removeprefix("override ").strip("/")
                        if n in (None, "null"):
                            cfg.pop(g, None)
                            continue
                        sub_cfg = load_yaml(os.path.join(config_dir, g, f"{n}.yaml"))
                        cfg = merge(cfg, Config({g: sub_cfg}))
            return merge(cfg, group_cfg)
        return merge(cfg, Config({group: group_cfg}))

    for entry in defaults:
        if entry == "_self_":
            cfg = merge(cfg, root)
            continue
        if isinstance(entry, str):
            group, name = entry, None
        else:
            (group, name), = entry.items()
        name = selections.pop(group, name)
        if name in (None, "null"):
            continue
        cfg = apply_group(cfg, group, name)

    if "_self_" not in defaults:
        cfg = merge(cfg, root)

    # remaining group selections that were not in defaults
    for group, name in selections.items():
        cfg = apply_group(cfg, group, name)

    cfg = merge(cfg, parse_overrides(value_overrides))
    return resolve(cfg)


def _import_target(path: str) -> Any:
    module_name, _, attr = path.rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, attr)


def instantiate(node: Any, **kwargs: Any) -> Any:
    """Instantiate ``_target_`` nodes recursively (hydra.utils.instantiate)."""
    if isinstance(node, Mapping) and "_target_" in node:
        target = _import_target(node["_target_"])
        partial = bool(node.get("_partial_", False))
        call_kwargs = {
            k: instantiate(v)
            for k, v in node.items()
            if k not in ("_target_", "_partial_")
        }
        call_kwargs.update(kwargs)
        if partial:
            return functools.partial(target, **call_kwargs)
        return target(**call_kwargs)
    if isinstance(node, Mapping):
        return Config({k: instantiate(v) for k, v in node.items()})
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def to_dict(cfg: Any) -> Any:
    if isinstance(cfg, Mapping):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    return cfg
