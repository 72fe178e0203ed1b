"""Minimal OmegaConf-compatible configuration (the port's own copy).

Same semantics as ``gloria_tpu.configs``: attribute and item access, missing
keys read as ``None``, the dict protocol, recursive merge and dotted paths.

PyYAML is not a dependency of the port, so :func:`loads_config` reads the
subset of YAML the experiment configs use (``configs/*.yaml``) with its own
reader: block mappings nested by indentation, plain, single- and
double-quoted scalars, and ``#`` comments.  Plain scalars resolve by
YAML 1.1's rules, as ``yaml.safe_load`` resolves them: ``1e-6`` has no dot,
so it stays the *string* ``'1e-6'``, while ``0.00005`` is a float, ``16`` an
int, ``true`` / ``off`` bools and an empty value ``None``.  Anything else
(sequences, flow collections, anchors, aliases, tags, block scalars,
timestamps) raises :class:`ConfigSyntaxError`.  A document that starts with
``{`` is JSON: :func:`save_config` writes JSON whose floats always carry a
dot or an exponent with a mantissa dot, which this reader and
``yaml.safe_load`` read as the same values.
"""

from __future__ import annotations

import copy
import json
import math
import re
from typing import Any, Iterator, Mapping


class Config(dict):
    """A recursive attribute-dict. Missing keys read as ``None``."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: dict = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __getitem__(self, key: str) -> Any:
        return super().get(key, None)

    def __getattr__(self, key: str) -> Any:
        if key.startswith("__") and key.endswith("__"):
            raise AttributeError(key)
        return super().get(key, None)

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __delattr__(self, key: str) -> None:
        if key in self:
            del self[key]

    def get(self, key: str, default: Any = None) -> Any:
        return super().get(key, default)

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        def unwrap(value: Any) -> Any:
            if isinstance(value, Config):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)

    def merge(self, other: Mapping[str, Any] | None) -> "Config":
        """Recursively merge ``other`` on top of ``self`` (in place)."""
        if other is None:
            return self
        for key, value in other.items():
            if isinstance(value, Mapping) and isinstance(self.get(key), Config):
                self[key].merge(value)
            else:
                self[key] = value
        return self

    def set_path(self, dotted: str, value: Any) -> None:
        """Set ``a.b.c`` style path, creating intermediate nodes."""
        node = self
        parts = dotted.split(".")
        for part in parts[:-1]:
            if not isinstance(node.get(part), Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Config) or part not in node:
                return default
            node = node[part]
        return node


# ---------------------------------------------------------------------------
# The YAML subset reader
# ---------------------------------------------------------------------------

class ConfigSyntaxError(ValueError):
    """The text uses YAML beyond the subset this reader takes."""


# YAML 1.1 implicit resolvers, as PyYAML's ``Resolver`` states them
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_UNSUPPORTED_START = set("[]{}&*!|>%@`,")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _resolve_plain(text: str, where: str) -> Any:
    """A plain scalar's value by YAML 1.1's implicit rules."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        if ":" in text:
            raise ConfigSyntaxError(f"{where}: sexagesimal number {text!r} is not supported")
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        if ":" in text:
            raise ConfigSyntaxError(f"{where}: sexagesimal number {text!r} is not supported")
        digits = text.replace("_", "").lower()
        sign = -1.0 if digits[0] == "-" else 1.0
        body = digits.lstrip("+-")
        if body == ".inf":
            return sign * math.inf
        if body == ".nan":
            return math.nan
        return float(digits)
    if _TIMESTAMP.match(text):
        raise ConfigSyntaxError(f"{where}: timestamp {text!r} is not supported")
    return text


def _double_quoted(body: str, where: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        code = body[i + 1] if i + 1 < len(body) else ""
        if code in _ESCAPES:
            out.append(_ESCAPES[code])
            i += 2
        elif code in _HEX_ESCAPES:
            n = _HEX_ESCAPES[code]
            digits = body[i + 2 : i + 2 + n]
            if len(digits) != n or not all(c in "0123456789abcdefABCDEF" for c in digits):
                raise ConfigSyntaxError(f"{where}: bad escape \\{code}{digits}")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            raise ConfigSyntaxError(f"{where}: unknown escape \\{code}")
    return "".join(out)


def _quoted(text: str, where: str) -> tuple[str, str]:
    """(value, rest of the line) of a scalar that starts with a quote."""
    quote = text[0]
    i = 1
    while i < len(text):
        if quote == "'" and text[i] == "'":
            if text[i + 1 : i + 2] == "'":
                i += 2
                continue
            return text[1:i].replace("''", "'"), text[i + 1 :]
        if quote == '"':
            if text[i] == "\\":
                i += 2
                continue
            if text[i] == '"':
                return _double_quoted(text[1:i], where), text[i + 1 :]
        i += 1
    raise ConfigSyntaxError(f"{where}: unterminated or multi-line quoted scalar")


def _strip_comment(text: str) -> str:
    """A plain scalar ends at `` #``."""
    for i, ch in enumerate(text):
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _scalar(text: str, where: str) -> Any:
    """The value of one scalar (a key or a mapping value), comments removed."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, where)
        rest = rest.strip()
        if rest and not rest.startswith("#"):
            raise ConfigSyntaxError(f"{where}: text after a quoted scalar: {rest!r}")
        return value
    text = _strip_comment(text).rstrip()
    if text[:1] in _UNSUPPORTED_START or text[:2] in ("- ", "? ") or text in ("-", "?"):
        raise ConfigSyntaxError(f"{where}: {text!r} is outside the supported YAML subset "
                                "(block mappings and scalars only)")
    if ": " in text or text.endswith(":"):
        raise ConfigSyntaxError(f"{where}: {text!r} is not a scalar")
    return _resolve_plain(text, where)


def _split_key(line: str, where: str) -> tuple[Any, str]:
    """(key, text after its colon) of a ``key: value`` line."""
    if line[:1] in ("'", '"'):
        key, rest = _quoted(line, where)
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            raise ConfigSyntaxError(f"{where}: expected ': ' after a quoted key")
        return key, rest[1:]
    match = re.search(r":(?: |$)", line)
    if match is None:
        raise ConfigSyntaxError(f"{where}: expected 'key: value'")
    return _scalar(line[: match.start()], where), line[match.end() :]


def _read_block(text: str) -> dict:
    root: dict = {}
    stack: list[tuple[int, dict]] = []  # (indentation, mapping) of the open blocks
    pending: tuple[dict, Any, int] | None = None  # a key whose value may be a nested block
    for number, raw in enumerate(text.splitlines(), 1):
        where = f"line {number}"
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith("\t"):
            raise ConfigSyntaxError(f"{where}: tab in indentation")
        if stripped.startswith(("---", "...")) or stripped.startswith("%"):
            raise ConfigSyntaxError(f"{where}: documents and directives are not supported")
        indent = len(body) - len(stripped)
        if not stack:
            stack.append((indent, root))
        if pending is not None:
            parent, key, parent_indent = pending
            pending = None
            if indent > parent_indent:
                child: dict = {}
                parent[key] = child
                stack.append((indent, child))
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ConfigSyntaxError(f"{where}: indentation does not match an enclosing block")
        mapping = stack[-1][1]
        key, rest = _split_key(stripped, where)
        rest = rest.strip()
        mapping[key] = None
        if rest and not rest.startswith("#"):
            mapping[key] = _scalar(rest, where)
        else:  # null, unless the next line opens a nested block
            pending = (mapping, key, indent)
    return root


def loads_config(text: str) -> Config:
    """A :class:`Config` from YAML (the subset above) or JSON text."""
    stripped = text.lstrip()
    if stripped.startswith("{"):
        data = json.loads(stripped)
    else:
        if stripped.startswith("["):
            raise ConfigSyntaxError("a config is a mapping, not a sequence")
        data = _read_block(text)
    if not isinstance(data, dict):
        raise ConfigSyntaxError("a config is a mapping")
    return Config(data)


def load_config(path: str) -> Config:
    with open(path, "r", encoding="utf-8") as fh:
        return loads_config(fh.read())


def _json_float(x: float) -> str:
    if not math.isfinite(x):
        raise ValueError(f"{x} has no form that both JSON and YAML read")
    text = repr(x)
    mantissa, e, exponent = text.partition("e")
    if e and "." not in mantissa:  # YAML 1.1 needs the dot: 1e-06 would read as a string
        text = f"{mantissa}.0e{exponent}"
    return text


def dumps_json(value: Any, indent: int = 0) -> str:
    """JSON that ``json.loads``, :func:`loads_config` and ``yaml.safe_load``
    all read as ``value`` (str keys; None, bools, ints, finite floats,
    strings, lists and mappings)."""
    pad, inner = "  " * indent, "  " * (indent + 1)
    if isinstance(value, Mapping):
        if not value:
            return "{}"
        items = []
        for k, v in value.items():
            if not isinstance(k, str):
                raise TypeError(f"config keys must be strings, got {k!r}")
            items.append(f"{inner}{json.dumps(k)}: {dumps_json(v, indent + 1)}")
        return "{\n" + ",\n".join(items) + f"\n{pad}}}"
    if isinstance(value, (list, tuple)):
        if not value:
            return "[]"
        return "[\n" + ",\n".join(f"{inner}{dumps_json(v, indent + 1)}" for v in value) + f"\n{pad}]"
    if isinstance(value, bool) or value is None or isinstance(value, (int, str)):
        return json.dumps(value)
    if isinstance(value, float):
        return _json_float(value)
    raise TypeError(f"cannot write {type(value).__name__} to a config")


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as JSON (YAML that ``yaml.safe_load`` reads too)."""
    data = cfg.to_dict() if isinstance(cfg, Config) else dict(cfg)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dumps_json(data) + "\n")


def merge_configs(*cfgs: Mapping[str, Any] | None) -> Config:
    out = Config()
    for cfg in cfgs:
        out.merge(cfg)
    return out


def iter_leaves(cfg: Config, prefix: str = "") -> Iterator[tuple[str, Any]]:
    for key, value in cfg.items():
        dotted = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Config):
            yield from iter_leaves(value, dotted)
        else:
            yield dotted, value
