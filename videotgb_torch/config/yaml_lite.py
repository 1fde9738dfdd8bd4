"""A reader and a writer for the subset of YAML that ``configs/`` uses.

The port does not depend on PyYAML, so the run configs are read here:
block mappings and sequences (``- item``, ``- key: value``), flow
sequences and mappings (``[a, b]``, ``{}``), ``#`` comments, single- and
double-quoted scalars and plain scalars. Plain scalars resolve as PyYAML's
``safe_load`` resolves them under YAML 1.1: ``5.0e-5`` is a float but
``1e-4`` (no dot) and ``0o17`` are strings, ``017`` is octal, ``1:30`` is
sexagesimal, ``yes``/``on``/``off`` are booleans, ``~`` and an empty value
are null and ``2024-01-02`` is a date.

:func:`dump` writes nested dicts, lists and scalars in block style so that
``load`` (and ``yaml.safe_load``) read back the same values; it writes the
run snapshot ``.hydra/config.yaml``.
"""

from __future__ import annotations

import datetime
import json
import math
import re
from typing import Any

_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_BOOL_RE = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                      r"|on|On|ON|off|Off|OFF")
_NULL_RE = re.compile(r"~|null|Null|NULL|")
_INT_RE = re.compile(r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_FLOAT_RE = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_DATE_RE = re.compile(r"([0-9]{4})-([0-9]{2})-([0-9]{2})")
_TIMESTAMP_RE = re.compile(
    r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt]|[ \t]+)[0-9]{1,2}:[0-9]{2}:"
    r"[0-9]{2}(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9]{1,2}(?::[0-9]{2})?))?")


def _sexagesimal(text: str, cast) -> Any:
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _construct_int(text: str) -> int:
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def resolve_plain(text: str) -> Any:
    """The value of an unquoted scalar, as PyYAML's ``safe_load`` gives it."""
    if _NULL_RE.fullmatch(text):
        return None
    if _BOOL_RE.fullmatch(text):
        return _BOOL[text.lower()]
    if _INT_RE.fullmatch(text):
        return _construct_int(text)
    if _FLOAT_RE.fullmatch(text):
        return _construct_float(text)
    if _DATE_RE.fullmatch(text):
        return datetime.date(*map(int, _DATE_RE.fullmatch(text).groups()))
    if _TIMESTAMP_RE.fullmatch(text):
        raise ValueError(f"timestamps are outside the supported YAML subset: "
                         f"{text!r}")
    return text


# ------------------------------------------------------------------ reading
def _strip_comment(line: str) -> str:
    """The line without a trailing ``# comment`` (a ``#`` at the start or
    after a blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _quoted(text: str, i: int) -> tuple[str, int]:
    """A quoted scalar starting at ``text[i]``: (value, index after it)."""
    q = text[i]
    j = i + 1
    out = []
    while j < len(text):
        ch = text[j]
        if q == "'" and ch == "'":
            if text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            code = text[j + 1]
            if code in _HEX_ESCAPES:
                end = j + 2 + _HEX_ESCAPES[code]
                out.append(chr(int(text[j + 2:end], 16)))
                j = end
            else:
                out.append(_ESCAPES[code])
                j += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise ValueError(f"unterminated quoted scalar: {text!r}")


def _flow(text: str, i: int) -> tuple[Any, int]:
    """A flow node (``[...]``, ``{...}`` or a scalar inside one) at
    ``text[i]``: (value, index after it)."""
    while text[i] == " ":
        i += 1
    if text[i] in "[{":
        close = "]" if text[i] == "[" else "}"
        seq = text[i] == "["
        out: Any = [] if seq else {}
        i += 1
        while True:
            while text[i] in " ,":
                i += 1
            if text[i] == close:
                return out, i + 1
            if seq:
                item, i = _flow(text, i)
                out.append(item)
            else:
                key, i = _flow(text, i)
                while text[i] == " ":
                    i += 1
                if text[i] != ":":
                    raise ValueError(f"expected ':' in flow mapping: {text!r}")
                value, i = _flow(text, i + 1)
                out[key] = value
    if text[i] in "'\"":
        return _quoted(text, i)
    j = i
    while j < len(text) and text[j] not in ",]}" and not (
            text[j] == ":" and text[j + 1:j + 2] in (" ", "")):
        j += 1
    return resolve_plain(text[i:j].strip()), j


def _scalar(text: str) -> Any:
    """A value written after ``key:`` or ``-`` on one line."""
    text = text.strip()
    if text[:1] in ("[", "{", "'", '"'):
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after a value: {text!r}")
        return value
    return resolve_plain(text)


def _split_key(text: str) -> tuple[Any, str] | None:
    """``key: rest`` -> (key, rest); None when the line is not a mapping
    entry."""
    if text[:1] in "'\"":
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip()
        return (key, rest[1:]) if rest.startswith(":") else None
    m = re.search(r":(?: |$)", text)
    if m is None or text[:1] in "[{":
        return None
    return resolve_plain(text[:m.start()].strip()), text[m.end():]


class _Lines:
    def __init__(self, text: str):
        self.items: list[tuple[int, str]] = []
        for raw in text.splitlines():
            if raw.strip() in ("---", "..."):
                continue
            line = _strip_comment(raw).rstrip()
            if line.strip():
                if "\t" in line[:len(line) - len(line.lstrip())]:
                    raise ValueError("tabs are not allowed in YAML indentation")
                self.items.append((len(line) - len(line.lstrip()),
                                   line.strip()))


def _block(lines: list[tuple[int, str]], i: int, indent: int
           ) -> tuple[Any, int]:
    """The block node whose lines start at ``lines[i]`` with ``indent``."""
    if lines[i][1] == "-" or lines[i][1].startswith("- "):
        return _sequence(lines, i, indent)
    entry = _split_key(lines[i][1])
    if entry is None:
        if i + 1 < len(lines) and lines[i + 1][0] >= indent:
            raise ValueError(f"multi-line plain scalars are outside the "
                             f"supported YAML subset: {lines[i][1]!r}")
        return _scalar(lines[i][1]), i + 1
    return _mapping(lines, i, indent)


def _value(lines, i, indent, rest):
    """The value after ``key:`` / ``-``: inline, or the nested block below."""
    if rest.strip():
        return _scalar(rest), i + 1
    if i + 1 < len(lines) and lines[i + 1][0] > indent:
        return _block(lines, i + 1, lines[i + 1][0])
    if (i + 1 < len(lines) and lines[i + 1][0] == indent
            and lines[i + 1][1].startswith("-")
            and not lines[i][1].startswith("-")):
        # a block sequence may sit at its key's own indent
        return _sequence(lines, i + 1, indent)
    return None, i + 1


def _mapping(lines, i, indent):
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        entry = _split_key(lines[i][1])
        if entry is None:
            if lines[i][1].startswith("-"):
                break
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = entry
        out[key], i = _value(lines, i, indent, rest)
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def _sequence(lines, i, indent):
    out: list = []
    while i < len(lines) and lines[i][0] == indent and (
            lines[i][1] == "-" or lines[i][1].startswith("- ")):
        body = lines[i][1][1:]
        if not body.strip():
            item, i = _value(lines, i, indent, "")
        else:
            # "- key: v" opens a mapping whose keys sit after the dash
            inner = indent + 1 + len(body) - len(body.lstrip())
            lines[i] = (inner, body.strip())
            item, i = _block(lines, i, inner)
        out.append(item)
    return out, i


def load(text: str) -> Any:
    """Parse one YAML document of the supported subset (None when empty)."""
    lines = _Lines(text).items
    if not lines:
        return None
    value, end = _block(lines, 0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unparsed YAML from {lines[end][1]!r}")
    return value


# ------------------------------------------------------------------ writing
_PLAIN_RE = re.compile(r"[A-Za-z_/][A-Za-z0-9_./ -]*")


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text:  # YAML 1.1 floats need a dot: 1e-05 -> 1.0e-05
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        return text
    if isinstance(value, datetime.date):
        return value.isoformat()
    text = str(value)
    if (_PLAIN_RE.fullmatch(text) and text == text.strip()
            and resolve_plain(text) == text):
        return text
    return json.dumps(text)  # a JSON string is a YAML double-quoted scalar


def _dump(node: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(node, dict):
        for key, value in node.items():
            head = f"{pad}{_dump_scalar(key)}:"
            if isinstance(value, (dict, list)) and value:
                out.append(head)
                _dump(value, indent + 2, out)
            else:
                out.append(f"{head} {_inline(value)}")
    else:
        for value in node:
            if isinstance(value, (dict, list)) and value:
                out.append(f"{pad}-")
                _dump(value, indent + 2, out)
            else:
                out.append(f"{pad}- {_inline(value)}")


def _inline(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _dump_scalar(value)


def dump(node: Any) -> str:
    """Block-style YAML for nested dicts / lists / scalars."""
    if isinstance(node, (dict, list)) and node:
        out: list[str] = []
        _dump(node, 0, out)
        return "\n".join(out) + "\n"
    return _inline(node) + "\n"
