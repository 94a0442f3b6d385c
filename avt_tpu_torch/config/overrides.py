"""Override grammar: parsing and sweep expansion, and the YAML reader.

Counterpart of avt_tpu/config/overrides.py (`Override`, `parse_value`,
`parse_override`, `parse_overrides_file`, `expand_sweeps`):
  key=value             assign (key must exist unless prefixed +)
  +key=value            add a new key
  group=option          switch a config group (key exists in defaults)
  group@key=option      compose a group instance at a different key
  +group@key=option     same, key may be new
  ~key                  delete a key
Values parse as YAML; a value with top-level commas is a sweep: the config
expands to one variant per element (cartesian across swept keys).

The JAX package parses with PyYAML. The port reads YAML with its own
reader (`yaml_load`), which gives PyYAML's `safe_load` answers (YAML 1.1
resolution) on the subset that conf/ and expts/ use: block mappings and
sequences, flow sequences and mappings, plain, single- and double-quoted
scalars, comments. So `1e-6` (no dot) is a string, `0.000001` a float,
`yes`/`on` booleans, `~` null, `012` octal. Anchors, aliases, tags, block
scalars, multi-line scalars and directives are outside the subset and
raise `YAMLSubsetError`.
"""
from __future__ import annotations

import datetime
import itertools
import math
import re
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple


class YAMLSubsetError(ValueError):
    """Text that PyYAML would refuse, or that lies outside the subset."""


class _QuotedStr(str):
    """A scalar that was quoted in the source: it opts out of the
    sci-notation coercion at any depth (hydra keeps quoted scalars as
    strings)."""


# PyYAML's implicit resolvers for plain scalars (yaml/resolver.py, YAML 1.1)
_BOOL_RE = re.compile(r"yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF")
_FLOAT_RE = re.compile(
    r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN)")
_INT_RE = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+")
_NULL_RE = re.compile(r"~|null|Null|NULL|")
_DATE_RE = re.compile(r"([0-9]{4})-([0-9]{2})-([0-9]{2})")
_TIMESTAMP_RE = re.compile(
    r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
    r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?")
_SPACE = " \t"
_FLOW_INDICATORS = ",[]{}"


def _sexagesimal(value: str) -> float:
    digits = [float(part) for part in value.split(":")]
    digits.reverse()
    base, total = 1, 0.0
    for d in digits:
        total += d * base
        base *= 60
    return total


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under PyYAML's SafeLoader."""
    if _NULL_RE.fullmatch(text):
        return None
    if _BOOL_RE.fullmatch(text):
        return text.lower() in ("yes", "true", "on")
    if _INT_RE.fullmatch(text):
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
            return sign * int(_sexagesimal(value))
        return sign * int(value)
    if _FLOAT_RE.fullmatch(text):
        value = text.replace("_", "").lower()
        sign = -1 if value[0] == "-" else 1
        if value[0] in "+-":
            value = value[1:]
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value)
        return sign * float(value)
    m = _DATE_RE.fullmatch(text)
    if m:
        return datetime.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))
    if _TIMESTAMP_RE.fullmatch(text) or text in ("=", "<<"):
        raise YAMLSubsetError(f"timestamps, '=' and merge keys are outside the subset: {text!r}")
    return text


_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/",
            "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    """One text line: its position, what comes before its comment."""

    def __init__(self, s: str, pos: int = 0):
        self.s, self.pos = s, pos

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.s[i] if i < len(self.s) else ""

    def skip_space(self) -> None:
        while self.peek() and self.peek() in _SPACE:
            self.pos += 1

    def at_end(self) -> bool:
        """Only whitespace or a comment remains."""
        rest = self.s[self.pos:].lstrip(_SPACE)
        return not rest or rest[0] == "#"

    def error(self, msg: str):
        return YAMLSubsetError(f"{msg} at column {self.pos} of {self.s!r}")


def _quoted(line: _Line) -> _QuotedStr:
    quote = line.peek()
    line.pos += 1
    out = []
    while True:
        ch = line.peek()
        if not ch:
            raise line.error("unterminated quoted scalar (multi-line scalars are outside the "
                             "subset)")
        line.pos += 1
        if ch == quote:
            if quote == "'" and line.peek() == "'":
                out.append("'")
                line.pos += 1
                continue
            return _QuotedStr("".join(out))
        if ch == "\\" and quote == '"':
            esc = line.peek()
            line.pos += 1
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                code = line.s[line.pos:line.pos + n]
                if len(code) != n or any(c not in "0123456789abcdefABCDEF" for c in code):
                    raise line.error("bad escape")
                out.append(chr(int(code, 16)))
                line.pos += n
            else:
                raise line.error(f"unknown escape \\{esc}")
        else:
            out.append(ch)


def _plain_text(line: _Line, flow: bool) -> str:
    """Scans a plain scalar as PyYAML's scan_plain does on one line: it ends
    at ': ' (or ':' before a flow indicator in flow context), at ' #', at the
    end, and in flow context at ',?[]{}'; inner spaces are kept."""
    ch, nxt = line.peek(), line.peek(1)
    if not ch or (ch in "-?:,[]{}#&*!|>'\"%@`" and not (
            nxt and nxt not in _SPACE and (ch == "-" or (not flow and ch in "?:")))):
        raise line.error(f"{ch!r} cannot start a plain scalar in the subset")
    start = end = line.pos
    while True:
        ch = line.peek()
        if not ch or ch in _SPACE:
            end = line.pos
            line.skip_space()
            ch = line.peek()
            if not ch or ch == "#":
                break
            continue
        nxt = line.peek(1)
        if ch == ":" and (not nxt or nxt in _SPACE or (flow and nxt in _FLOW_INDICATORS)):
            end = line.pos if line.s[line.pos - 1] not in _SPACE else end
            break
        if flow and ch in ",?[]{}":
            end = line.pos if line.s[line.pos - 1] not in _SPACE else end
            break
        line.pos += 1
        end = line.pos
    text = line.s[start:end]
    line.pos = max(line.pos, end)
    return text


def _flow_node(line: _Line) -> Any:
    line.skip_space()
    ch = line.peek()
    if ch == "[":
        return _flow_seq(line)
    if ch == "{":
        return _flow_map(line)
    if ch in ("'", '"'):
        return _quoted(line)
    return resolve_plain(_plain_text(line, flow=True))


def _is_value_indicator(line: _Line, flow: bool) -> bool:
    nxt = line.peek(1)
    return line.peek() == ":" and (not nxt or nxt in _SPACE
                                   or (flow and nxt in _FLOW_INDICATORS))


def _hashable(key, line: _Line):
    if isinstance(key, (list, dict)):
        raise line.error("a collection as a mapping key is outside the subset")
    return key


def _flow_seq(line: _Line) -> list:
    line.pos += 1  # [
    items = []
    while True:
        line.skip_space()
        if line.peek() == "]":
            line.pos += 1
            return items
        if not line.peek():
            raise line.error("unterminated flow sequence (multi-line flows are outside the subset)")
        item = _flow_node(line)
        line.skip_space()
        if _is_value_indicator(line, flow=True):  # [a: b] is [{a: b}]
            line.pos += 1
            line.skip_space()
            value = None if line.peek() in ",]" else _flow_node(line)
            item = {_hashable(item, line): value}
            line.skip_space()
        items.append(item)
        if line.peek() == ",":
            line.pos += 1
        elif line.peek() != "]":
            raise line.error("expected ',' or ']'")


def _flow_map(line: _Line) -> dict:
    line.pos += 1  # {
    out = {}
    while True:
        line.skip_space()
        if line.peek() == "}":
            line.pos += 1
            return out
        if not line.peek():
            raise line.error("unterminated flow mapping (multi-line flows are outside the subset)")
        key = _hashable(_flow_node(line), line)
        line.skip_space()
        value = None
        if _is_value_indicator(line, flow=True):
            line.pos += 1
            line.skip_space()
            if line.peek() not in ",}":
                value = _flow_node(line)
            line.skip_space()
        out[key] = value
        if line.peek() == ",":
            line.pos += 1
        elif line.peek() != "}":
            raise line.error("expected ',' or '}'")


def _inline_node(line: _Line) -> Any:
    """A block-context value that fits on its line: a flow collection, a
    quoted or a plain scalar, with nothing but a comment after it."""
    line.skip_space()
    ch = line.peek()
    if ch in ("[", "{", "'", '"'):
        value = _flow_node(line)
    else:
        value = resolve_plain(_plain_text(line, flow=False))
    if not line.at_end():
        raise line.error("mapping values are not allowed here")
    return value


def _split_key(line: _Line) -> Optional[Tuple[Any, int]]:
    """(key, column of the value) when the line holds `key: ...` in block
    context, else None; the line's position is left where it was."""
    start = line.pos
    try:
        ch = line.peek()
        if ch in ("'", '"'):
            key = _quoted(line)
        elif ch in ("[", "{"):
            return None
        else:
            try:
                key = _plain_text(line, flow=False)
            except YAMLSubsetError:
                return None
            key = resolve_plain(key)
        line.skip_space()
        if not _is_value_indicator(line, flow=False):
            return None
        return key, line.pos + 1
    finally:
        line.pos = start


def _logical_lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of every line that holds more than a comment."""
    out = []
    for raw in text.splitlines():
        body = raw.rstrip()
        stripped = body.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped[0] == "\t" or (stripped.startswith(("---", "...")) and
                                   stripped[3:4] in ("", " ")) or stripped[0] == "%":
            raise YAMLSubsetError(f"tabs, documents and directives are outside the subset: {raw!r}")
        out.append((len(body) - len(stripped), stripped))
    return out


class _Block:
    """The block structure over logical lines."""

    def __init__(self, lines: List[Tuple[int, str]]):
        self.lines = lines
        self.i = 0

    def _is_seq(self, k: int) -> bool:
        content = self.lines[k][1]
        return content == "-" or content.startswith("- ")

    def node(self) -> Any:
        indent, content = self.lines[self.i]
        if self._is_seq(self.i):
            return self.seq(indent)
        if _split_key(_Line(content)) is not None:
            return self.mapping(indent)
        value = _inline_node(_Line(content))
        self.i += 1
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YAMLSubsetError(
                f"multi-line plain scalars are outside the subset: {self.lines[self.i][1]!r}")
        return value

    def _nested(self, indent: int, allow_seq_at_indent: bool) -> Any:
        """The node on the lines after a key or dash with nothing after it."""
        if self.i < len(self.lines):
            nxt_indent = self.lines[self.i][0]
            if nxt_indent > indent:
                return self.node()
            if allow_seq_at_indent and nxt_indent == indent and self._is_seq(self.i):
                return self.seq(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines) and self.lines[self.i][0] == indent:
            line = _Line(self.lines[self.i][1])
            split = _split_key(line)
            if split is None:
                raise YAMLSubsetError(f"expected a 'key:' line: {line.s!r}")
            key, col = split
            line.pos = col
            if line.at_end():
                self.i += 1
                value = self._nested(indent, allow_seq_at_indent=True)
            else:
                value = _inline_node(line)
                self.i += 1
            out[key] = value
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YAMLSubsetError(f"bad indentation: {self.lines[self.i][1]!r}")
        return out

    def seq(self, indent: int) -> list:
        items = []
        while (self.i < len(self.lines) and self.lines[self.i][0] == indent
               and self._is_seq(self.i)):
            content = self.lines[self.i][1]
            rest = content[1:].lstrip(" ")
            if rest and not rest.startswith("#"):
                # the item starts on the dash's line: parse it as a line of
                # its own at the column where it starts
                self.lines[self.i] = (indent + len(content) - len(rest), rest)
                items.append(self.node())
            else:
                self.i += 1
                items.append(self._nested(indent, allow_seq_at_indent=False))
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            raise YAMLSubsetError(f"bad indentation: {self.lines[self.i][1]!r}")
        return items


def yaml_load(text: str) -> Any:
    """The document in `text`, as PyYAML's safe_load reads it (None when it
    is empty); quoted strings come back as `_QuotedStr`. Raises
    YAMLSubsetError on what PyYAML refuses and on what the subset leaves
    out."""
    block = _Block(_logical_lines(text))
    if not block.lines:
        return None
    node = block.node()
    if block.i != len(block.lines):
        raise YAMLSubsetError(f"more than one node at the top: {block.lines[block.i][1]!r}")
    return node


def plain(v: Any) -> Any:
    """`v` with quoted-string markers turned back into str."""
    if isinstance(v, str):
        return str(v)
    if isinstance(v, dict):
        return {plain(k): plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [plain(x) for x in v]
    return v


# ------------------------------------------------------------ overrides
@dataclass
class Override:
    key: str
    value: Any = None
    add: bool = False  # '+' prefix
    delete: bool = False  # '~' prefix
    group: Optional[str] = None  # group path for group@key syntax
    sweep_values: Optional[List[str]] = None  # raw strings when swept


def _split_top_level_commas(s: str) -> List[str]:
    """Split on commas not nested in brackets/braces/quotes."""
    parts, depth, buf, quote = [], 0, [], None
    for ch in s:
        if quote:
            buf.append(ch)
            if ch == quote:
                quote = None
            continue
        if ch in "\"'":
            quote = ch
            buf.append(ch)
        elif ch in "[{(":
            depth += 1
            buf.append(ch)
        elif ch in "]})":
            depth -= 1
            buf.append(ch)
        elif ch == "," and depth == 0:
            parts.append("".join(buf))
            buf = []
        else:
            buf.append(ch)
    parts.append("".join(buf))
    return parts


INTERP_TOKEN_RE = re.compile(r"\$\{[^{}]*\}")
_PLACEHOLDER_RE = re.compile(r"__INTERP_(\d+)__")


def stash_interpolations(text: str) -> Tuple[str, List[str]]:
    """`text` with each innermost ${...} swapped for a placeholder token (YAML
    flow collections reject bare ${a.b}), and the swapped-out tokens."""
    tokens: List[str] = []

    def stash(m):
        tokens.append(m.group(0))
        return f"__INTERP_{len(tokens) - 1}__"

    return INTERP_TOKEN_RE.sub(stash, text), tokens


def restore_interpolations(v: Any, tokens: List[str]) -> Any:
    """`v` (a string, or a tree of them) with the placeholders of
    `stash_interpolations` swapped back for their tokens."""
    if isinstance(v, str):
        return _PLACEHOLDER_RE.sub(lambda m: tokens[int(m.group(1))], v)
    if isinstance(v, dict):
        return {restore_interpolations(k, tokens): restore_interpolations(x, tokens)
                for k, x in v.items()}
    if isinstance(v, list):
        return [restore_interpolations(x, tokens) for x in v]
    return v


def parse_value(raw: str) -> Any:
    """YAML-parse a value; ${...} interpolations survive as strings, and a
    dot-less scientific number that YAML 1.1 leaves a string (`1e-5`) becomes
    a float unless it was quoted, as hydra's grammar reads it. A value the
    YAML reader refuses stays the raw string."""
    raw = raw.strip()
    prepared, tokens = stash_interpolations(raw)
    try:
        parsed = yaml_load(prepared)
    except YAMLSubsetError:
        return raw

    def restore(v, coerce=True):
        if isinstance(v, str):
            was_quoted = isinstance(v, _QuotedStr)
            v = restore_interpolations(v, tokens)
            if coerce and not was_quoted and re.fullmatch(r"[+-]?\d+[eE][+-]?\d+", v):
                return float(v)
            return str(v)
        if isinstance(v, dict):
            return {restore(k, coerce=False): restore(val) for k, val in v.items()}
        if isinstance(v, list):
            return [restore(x) for x in v]
        return v

    return restore(parsed)


def parse_override(line: str) -> Override:
    line = line.strip()
    add = line.startswith("+")
    delete = line.startswith("~")
    if add or delete:
        line = line[1:]
    if delete:
        return Override(key=line, delete=True)
    if "=" not in line:
        raise ValueError(f"Override needs '=': {line!r}")
    key, raw_val = line.split("=", 1)
    key = key.strip()
    group = None
    if "@" in key:
        group, key = key.split("@", 1)
    parts = _split_top_level_commas(raw_val)
    if len(parts) > 1:
        return Override(key=key, add=add, group=group, sweep_values=[p.strip() for p in parts])
    return Override(key=key, value=parse_value(raw_val), add=add, group=group)


def parse_overrides_file(fpath: str) -> List[Override]:
    """Read a TXT experiment file: one override per line, '#' comments."""
    overrides = []
    with open(fpath, "r") as fin:
        for line in fin:
            line = line.split("#")[0].strip()
            if not line:
                continue
            overrides.append(parse_override(line))
    return overrides


def expand_sweeps(overrides: List[Override]) -> List[List[Override]]:
    """Expand swept overrides into the cartesian list of run variants."""
    swept = [o for o in overrides if o.sweep_values is not None]
    if not swept:
        return [overrides]
    choices = [[(o, parse_value(v)) for v in o.sweep_values] for o in swept]
    variants = []
    for combo in itertools.product(*choices):
        combo_map = {id(o): val for o, val in combo}
        variants.append([
            Override(key=o.key, value=combo_map[id(o)], add=o.add, group=o.group)
            if o.sweep_values is not None else o
            for o in overrides])
    return variants
