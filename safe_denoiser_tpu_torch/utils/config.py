"""Config files of the runners: the JSON base config, the task YAML, and the
``config.yaml`` a run leaves behind.

Counterpart of ``safe_denoiser_tpu/utils/config.py``. The machine with the
GPU has no ``yaml`` package, so this module reads the YAML subset the task
configs use (block mappings and sequences, flow ``[...]``/``{...}`` of
scalars, quoted and plain scalars with YAML 1.1 resolution as PyYAML's
``safe_load`` does it, comments) and writes ``config.yaml`` in block style
that ``yaml.safe_load`` reads back to the same values.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Mapping


def read_json(filename: str) -> Mapping[str, Any]:
    """The JSON object at ``filename``."""
    with open(filename) as fp:
        return json.load(fp)


# ------------------------------------------------------------------ reading
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's implicit resolvers for int and float (YAML 1.1), without the
# sexagesimal forms
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _resolve_plain(text: str):
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t.startswith("-") else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t.endswith(".nan"):
            return math.nan
        return float(t)
    return text


def _unquote(text: str) -> str:
    if text[0] == "'":
        return text[1:-1].replace("''", "'")
    return json.loads(text)        # double-quoted: JSON's escapes suffice


def _split_flow(body: str) -> list[str]:
    """Split the inside of a flow collection at top-level commas."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
            continue
        cur += ch
    if cur.strip():
        parts.append(cur.strip())
    return parts


def _split_key(text: str):
    """'key: value' -> (key, value) at the first ': ' (or a trailing ':')
    outside quotes; None when the text is no mapping entry."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].strip()
            if key[:1] in "\"'":
                key = _unquote(key)
            return key, text[i + 1:].strip()
    return None


def _scalar(text: str):
    if not text:
        return None
    if text[0] in "\"'":
        return _unquote(text)
    if text[0] == "[":
        return [_scalar(p) for p in _split_flow(text[1:-1])]
    if text[0] == "{":
        out = {}
        for p in _split_flow(text[1:-1]):
            key, val = _split_key(p) or (p, "")
            out[key] = _scalar(val)
        return out
    if text[0] in "|>&*!%@`":
        raise ValueError(f"YAML feature not supported here: {text!r}")
    return _resolve_plain(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " :[{,-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _lines(text: str) -> list[tuple[int, str]]:
    out = []
    for raw in text.splitlines():
        line = _strip_comment(raw)
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        out.append((len(line) - len(line.lstrip()), line.strip()))
    return out


def _block(lines, i: int, indent: int):
    """Parse the block whose lines start at ``lines[i]`` with ``indent``;
    returns (value, next line index)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        seq = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            rest = lines[i][1][1:].strip()
            if not rest:
                val, i = _block(lines, i + 1, lines[i + 1][0])
            elif rest.startswith("- ") or (_split_key(rest) is not None
                                           and rest[0] not in "\"'[{"):
                # a mapping or sequence whose first entry shares the dash's
                # line
                sub = [(indent + 2, rest)]
                j = i + 1
                while j < len(lines) and lines[j][0] > indent:
                    sub.append(lines[j])
                    j += 1
                val, _ = _block(sub, 0, indent + 2)
                i = j
            else:
                val, i = _scalar(rest), i + 1
            seq.append(val)
        return seq, i
    out = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"not a mapping entry: {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _scalar(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def load_yaml(file_path: str):
    """Load a task-config YAML (the subset described above)."""
    with open(file_path) as f:
        lines = _lines(f.read())
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"{file_path}: could not parse line "
                         f"{lines[i][1]!r}")
    return value


# ------------------------------------------------------------------ writing
def _plain_ok(s: str) -> bool:
    """Whether s can be written unquoted and reads back as the same str."""
    return (bool(re.fullmatch(r"[A-Za-z_./][A-Za-z0-9_./-]*", s))
            and isinstance(_resolve_plain(s), str))


def _emit_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:                   # 1e-08 -> 1.0e-08 (YAML 1.1)
            mant, _, exp = r.partition("e")
            r = f"{mant}.0" + (f"e{exp}" if exp else "")
        return r
    s = str(v)
    return s if _plain_ok(s) else json.dumps(s)


def _emit(value, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for k, v in value.items():
            key = _emit_scalar(str(k))
            if isinstance(v, (dict, list, tuple)) and v:
                out.append(f"{pad}{key}:")
                _emit(v, indent + (0 if isinstance(v, (list, tuple))
                                   else 2), out)
            else:
                out.append(f"{pad}{key}: {_emit_inline(v)}")
    else:
        for v in value:
            if isinstance(v, (dict, list, tuple)) and v:
                out.append(f"{pad}-")
                _emit(v, indent + 2, out)
            else:
                out.append(f"{pad}- {_emit_inline(v)}")


def _emit_inline(v) -> str:
    if isinstance(v, dict):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[]"
    return _emit_scalar(v)


def dump_yaml(value) -> str:
    """Block YAML of nested dicts and lists of scalars, which ``load_yaml``
    and ``yaml.safe_load`` read back as ``value``."""
    out: list[str] = []
    _emit(value, 0, out)
    return "\n".join(out) + "\n"


def _yamlable(v):
    if isinstance(v, (str, int, float, bool, type(None), list, dict, tuple)):
        return v
    return str(v)


def save_combined_config(args, file_path: str,
                         task_config: dict | None = None) -> None:
    """Write the run's argparse values merged with the task config (task
    keys win on a clash) as block YAML; values YAML cannot hold are
    written as their str()."""
    combined = {arg: _yamlable(getattr(args, arg)) for arg in vars(args)}
    if task_config is not None:
        combined = {**combined, **task_config}
    combined = dict(sorted(combined.items()))   # yaml.dump's key order
    with open(file_path, "w") as f:
        f.write(dump_yaml(combined))
    print(f"Combined configuration saved to {file_path}")
