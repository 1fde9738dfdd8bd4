from videotgb_torch.config.core import (
    Config,
    compose,
    instantiate,
    load_yaml,
    merge,
    parse_overrides,
    resolve,
    to_dict,
)

__all__ = [
    "Config",
    "compose",
    "instantiate",
    "load_yaml",
    "merge",
    "parse_overrides",
    "resolve",
    "to_dict",
]
