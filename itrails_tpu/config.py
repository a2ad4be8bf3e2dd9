"""YAML configuration I/O and the best-model checkpoint contract.

The file formats are byte-compatible with the reference (yaml_helpers.py):

* config schema: ``fixed_parameters`` / ``optimized_parameters``
  (``[start, min, max]`` triples) / ``settings``;
* ``<prefix>.best_model.yaml`` is the checkpoint: seeded with -inf
  log-likelihood, overwritten whenever an evaluation improves it, with
  parameters de-scaled by mu (r multiplied, others divided) — it doubles as
  the input config for subsequent viterbi/posterior runs.

The reader and writer below cover the YAML these files use, with PyYAML's
results: :func:`load_yaml` returns what ``yaml.safe_load`` returns (YAML 1.1
scalar resolution included, so ``mu: 1e-8`` loads as the string ``'1e-8'``)
and :func:`dump_yaml` writes what ``yaml.dump`` writes, byte for byte.  The
subset is block mappings, block and flow sequences of scalars, plain and
quoted scalars, comments and empty values.  Anything else (anchors, tags,
flow mappings, block scalars, several documents, ...) raises
:class:`YamlSubsetError`.
"""

from __future__ import annotations

import math
import os
import re
import sys
from math import inf

__all__ = ["FlowSeq", "YamlSubsetError", "dump_yaml", "load_config",
           "load_yaml", "parse_yaml", "seed_best_model", "update_best_model",
           "write_starting_params"]


class FlowSeq(list):
    """List subclass serialized inline ([a, b, c]) in YAML output."""


class YamlSubsetError(ValueError):
    """The document (or value) lies outside the supported YAML subset."""


# --- scalar resolution (YAML 1.1, as PyYAML's resolver) ---------------------

_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_BOOL_RE = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                      r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT_RE = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                       r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                       r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_INT_RE = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                     r"|[-+]?0x[0-9a-fA-F_]+"
                     r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP_RE = re.compile(
    r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)"
    r"[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")


def _resolve(text: str) -> str:
    """Tag a plain scalar resolves to: bool/int/float/null/str, or the
    unsupported timestamp/merge/value tags."""
    if _BOOL_RE.match(text):
        return "bool"
    if _FLOAT_RE.match(text):
        return "float"
    if _INT_RE.match(text):
        return "int"
    if _NULL_RE.match(text):
        return "null"
    if _TIMESTAMP_RE.match(text):
        return "timestamp"
    if text in ("<<", "="):
        return "special"
    return "str"


def _sexagesimal(text: str, conv):
    value = 0
    for digit in text.split(":"):
        value = value * 60 + conv(digit)
    return value


def _construct(text: str):
    """Python value of a plain scalar (PyYAML SafeConstructor rules)."""
    kind = _resolve(text)
    if kind == "str":
        return text
    if kind == "null":
        return None
    if kind == "bool":
        return _BOOL[text.lower()]
    if kind in ("int", "float"):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if kind == "float":
            v = v.lower()
            if v == ".inf":
                return sign * inf
            if v == ".nan":
                return math.nan
            if ":" in v:
                return sign * _sexagesimal(v, float)
            return sign * float(v)
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        return sign * int(v)
    raise YamlSubsetError(f"unsupported scalar {text!r} ({kind})")


# --- reader -------------------------------------------------------------------

_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
               "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
               " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
               "_": "\xa0", "L": " ", "P": " "}


def _fold(parts):
    """Join the lines of a multi-line flow scalar: single breaks fold to a
    space, each further empty line keeps one newline."""
    out, empty = "", 0
    for i, p in enumerate(parts):
        if i == 0:
            out = p
        elif p == "":
            empty += 1
        else:
            out += ("\n" * empty if empty else " ") + p
            empty = 0
    return out + "\n" * empty


def _strip_comment(text: str) -> str:
    """Drop a trailing comment ('#' at the start or after whitespace,
    outside quotes)."""
    i = 0
    while i < len(text):
        ch = text[i]
        if ch in "'\"" and (i == 0 or text[i - 1] in " \t[,:"):
            end = _Reader._quote_end(text, i)
            if end is None:
                break
            i = end + 1
            continue
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


class _Reader:
    def __init__(self, text: str):
        self.lines = []  # (indent, content, lineno)
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if stripped.startswith("\t"):
                raise YamlSubsetError(f"line {n}: tab indentation")
            if not stripped or stripped.startswith("#"):
                self.lines.append((None, "", n))  # blank: may fold a scalar
                continue
            if ((n == 1 and stripped.startswith("%"))
                    or body in ("---", "...")
                    or body.startswith(("--- ", "... "))):
                raise YamlSubsetError(
                    f"line {n}: directives and document markers are not "
                    "supported (one document per file)")
            self.lines.append((len(body) - len(stripped), stripped, n))
        self.i = 0

    def _next(self):
        while self.i < len(self.lines) and self.lines[self.i][0] is None:
            self.i += 1
        return self.lines[self.i] if self.i < len(self.lines) else None

    def document(self):
        first = self._next()
        if first is None:
            return None
        value = self.node(first[0])
        rest = self._next()
        if rest is not None:
            raise YamlSubsetError(f"line {rest[2]}: unexpected content")
        return value

    def node(self, indent):
        ind, content, n = self._next()
        if ind != indent:
            raise YamlSubsetError(f"line {n}: bad indentation")
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if self._split_key(content, n) is not None:
            return self.mapping(indent)
        self.i += 1
        return self.scalar(_strip_comment(content), indent, n)

    def _split_key(self, content, n):
        """(key text, rest) when the line is a ``key: value`` entry."""
        if content[0] in "'\"":
            end = self._quote_end(content, 0)
            if end is None:
                return None
            rest = content[end + 1:]
            if rest == ":" or rest.startswith(": "):
                return content[:end + 1], rest[1:].strip()
            return None
        if content[0] in "[{":
            return None
        if content[0] in "&*!|>%@`" or content in ("?", "-") \
                or content.startswith("? "):
            raise YamlSubsetError(
                f"line {n}: {content[0]!r} (complex keys, anchors, aliases, "
                "tags, block scalars, flow mappings) is not supported")
        m = re.search(r":( |$)", content)
        if m is None or content[0] == "[":
            return None
        key = content[:m.start()]
        if " #" in key:
            return None
        return key, content[m.end():].strip()

    @staticmethod
    def _quote_end(text, start):
        q = text[start]
        i = start + 1
        while i < len(text):
            if q == "'" and text[i] == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 2
                    continue
                return i
            if q == '"':
                if text[i] == "\\":
                    i += 2
                    continue
                if text[i] == '"':
                    return i
            i += 1
        return None

    def _key(self, text, n):
        if text[0] in "'\"":
            return self._quoted(text, n)
        return _construct(text)

    def mapping(self, indent):
        out = {}
        while True:
            line = self._next()
            if line is None or line[0] < indent:
                return out
            ind, content, n = line
            if ind > indent:
                raise YamlSubsetError(f"line {n}: bad indentation")
            split = self._split_key(content, n)
            if split is None:
                raise YamlSubsetError(f"line {n}: expected 'key: value'")
            key, rest = split
            key = self._key(key, n)
            self.i += 1
            rest = _strip_comment(rest)
            if rest:
                out[key] = self.scalar(rest, indent, n)
                continue
            nxt = self._next()
            if nxt is not None and (nxt[0] > indent or (
                    nxt[0] == indent and (nxt[1] == "-"
                                          or nxt[1].startswith("- ")))):
                out[key] = self.node(nxt[0])
            else:
                out[key] = None

    def sequence(self, indent):
        out = []
        while True:
            line = self._next()
            if line is None or line[0] < indent:
                return out
            ind, content, n = line
            if ind > indent or not (content == "-"
                                    or content.startswith("- ")):
                if ind == indent:
                    return out  # an indentless sequence ends at a key
                raise YamlSubsetError(f"line {n}: bad indentation")
            self.i += 1
            item = _strip_comment(content[1:].strip())
            if not item:
                nxt = self._next()
                if nxt is not None and nxt[0] > indent:
                    raise YamlSubsetError(
                        f"line {nxt[2]}: only sequences of scalars are "
                        "supported")
                out.append(None)
                continue
            if item == "-" or item.startswith("- ") or \
                    self._split_key(item, n) is not None:
                raise YamlSubsetError(
                    f"line {n}: only sequences of scalars are supported")
            out.append(self.scalar(item, indent, n))

    def _continuation(self, indent):
        """Following lines that continue a scalar (indented past
        ``indent``), blank lines kept as ''."""
        parts = []
        while self.i < len(self.lines):
            ind, content, n = self.lines[self.i]
            if ind is None:
                parts.append("")
            elif ind > indent:
                if self._split_key(content, n) is not None:
                    raise YamlSubsetError(
                        f"line {n}: mapping values are not allowed here")
                parts.append(content)
            else:
                break
            self.i += 1
        while parts and parts[-1] == "":
            parts.pop()
            self.i -= 1
        return parts

    def scalar(self, text, indent, n):
        if text[0] == "[":
            while self._flow_end(text) is None:
                more = self._continuation(indent)
                if not more:
                    raise YamlSubsetError(f"line {n}: unterminated '['")
                text = text + " " + " ".join(p for p in more if p)
            end = self._flow_end(text)
            if _strip_comment(text[end + 1:]):
                raise YamlSubsetError(f"line {n}: text after a flow sequence")
            return self.flow_sequence(text[:end + 1], n)
        if text[0] in "'\"":
            while self._quote_end(text, 0) is None:
                line = self.lines[self.i] if self.i < len(self.lines) else None
                if line is None or (line[0] is not None and line[0] <= indent):
                    raise YamlSubsetError(f"line {n}: unterminated quote")
                text += "\n" + line[1]
                self.i += 1
            end = self._quote_end(text, 0)
            if _strip_comment(text[end + 1:]):
                raise YamlSubsetError(f"line {n}: text after a quoted scalar")
            return self._quoted(text[:end + 1], n)
        if _strip_comment(text) == "{}":
            return {}
        if text[0] in "&*!|>%@`{":
            raise YamlSubsetError(
                f"line {n}: {text[0]!r} (anchors, aliases, tags, block "
                "scalars, non-empty flow mappings) is not supported")
        if text.startswith("- ") or text == "-":
            raise YamlSubsetError(f"line {n}: nested sequences are not "
                                  "supported")
        if ": " in text or text.endswith(":"):
            raise YamlSubsetError(f"line {n}: nested mappings on one line "
                                  "are not supported")
        more = self._continuation(indent)
        if more:
            return _fold([text] + [_strip_comment(p) for p in more])
        return _construct(text)

    def _quoted(self, text, n):
        q, body = text[0], text[1:-1]
        lines = body.split("\n")
        parts = [p.strip(" \t") if 0 < i < len(lines) - 1 else
                 (p.rstrip(" \t") if i == 0 and len(lines) > 1 else
                  p.lstrip(" \t") if i > 0 else p)
                 for i, p in enumerate(lines)]
        body = _fold(parts) if len(parts) > 1 else parts[0]
        if q == "'":
            return body.replace("''", "'")
        out, i = [], 0
        while i < len(body):
            ch = body[i]
            if ch != "\\":
                out.append(ch)
                i += 1
                continue
            esc = body[i + 1:i + 2]
            if esc in _DQ_ESCAPES:
                out.append(_DQ_ESCAPES[esc])
                i += 2
            elif esc in ("x", "u", "U"):
                width = {"x": 2, "u": 4, "U": 8}[esc]
                out.append(chr(int(body[i + 2:i + 2 + width], 16)))
                i += 2 + width
            else:
                raise YamlSubsetError(f"line {n}: unknown escape \\{esc}")
        return "".join(out)

    @classmethod
    def _flow_items(cls, text):
        """(items, end index) of the flow sequence opening text[0], or
        (None, None) while it is unterminated."""
        items, cur, i = [], "", 1
        while i < len(text):
            ch = text[i]
            if ch in "'\"" and not cur.strip():
                end = cls._quote_end(text, i)
                if end is None:
                    return None, None
                cur = text[i:end + 1]
                i = end + 1
                continue
            if ch in ",]":
                if cur.strip() or ch == ",":
                    items.append(cur.strip())
                if ch == "]":
                    return items, i
                cur = ""
            elif ch in "[{":
                raise YamlSubsetError("only flow sequences of scalars are "
                                      "supported")
            else:
                cur += ch
            i += 1
        return None, None

    def _flow_end(self, text):
        return self._flow_items(text)[1]

    def flow_sequence(self, text, n):
        items, _ = self._flow_items(text)
        if any(not t for t in items):
            raise YamlSubsetError(f"line {n}: empty flow sequence entry")
        return [self._quoted(t, n) if t[:1] in ("'", '"') else _construct(t)
                for t in items]


def parse_yaml(text: str):
    """``yaml.safe_load`` of a document in the supported subset."""
    return _Reader(text).document()


def load_yaml(path):
    with open(path) as f:
        return parse_yaml(f.read())


# --- writer -------------------------------------------------------------------

_WIDTH = 80
_INDENT = 2
_SPACE = "\0 \t\r\n\x85  "


def _analyze(text: str):
    """(allow_flow_plain, allow_block_plain, allow_single_quoted) as
    PyYAML's Emitter.analyze_scalar decides them, for printable ASCII."""
    if any(not (" " <= ch <= "~") for ch in text):
        raise YamlSubsetError(
            f"string {text!r}: only printable ASCII without line breaks is "
            "supported")
    if not text:
        return False, True, True
    flow_ind = block_ind = text.startswith(("---", "..."))
    leading = text[0] == " "
    trailing = text[-1] == " "
    preceded = True
    followed = len(text) == 1 or text[1] in _SPACE
    for i, ch in enumerate(text):
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                flow_ind = block_ind = True
            if ch in "?:":
                flow_ind = True
                block_ind = block_ind or followed
            if ch == "-" and followed:
                flow_ind = block_ind = True
        else:
            if ch in ",?[]{}":
                flow_ind = True
            if ch == ":":
                flow_ind = True
                block_ind = block_ind or followed
            if ch == "#" and preceded:
                flow_ind = block_ind = True
        preceded = ch in _SPACE
        followed = i + 2 >= len(text) or text[i + 2] in _SPACE
    plain = not (leading or trailing)
    return plain and not flow_ind, plain and not block_ind, True


def _float_text(v: float) -> str:
    if v != v:
        return ".nan"
    if v == inf:
        return ".inf"
    if v == -inf:
        return "-.inf"
    text = repr(float(v)).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


class _Writer:
    """The part of PyYAML's Emitter that the subset needs, with its column,
    whitespace and indentation bookkeeping (so long scalars and flow
    sequences wrap where ``yaml.dump`` wraps them)."""

    def __init__(self):
        self.out = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent = None
        self.flow = False

    def write(self, data):
        self.column += len(data)
        self.out.append(data)

    def line_break(self):
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append("\n")

    def write_indent(self):
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def indicator(self, ind, need_space, whitespace=False, indention=False):
        self.write(ind if self.whitespace or not need_space else " " + ind)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    def mapping(self, data):
        if not data:
            self.indicator("{", True, whitespace=True)
            self.indicator("}", False)
            return
        outer = self.indent
        self.indent = 0 if outer is None else outer + _INDENT
        try:
            items = sorted(data.items())
        except TypeError:
            raise YamlSubsetError("mapping keys must be mutually sortable")
        for key, value in items:
            self.write_indent()
            self.scalar(key, simple_key=True)
            self.indicator(":", False)
            self.node(value, mapping=True)
        self.indent = outer

    def node(self, value, mapping=False):
        if isinstance(value, dict):
            self.mapping(value)
        elif isinstance(value, FlowSeq) or (isinstance(value, list)
                                            and not value):
            self.flow_sequence(value)
        elif isinstance(value, list):
            self.block_sequence(value, indentless=mapping and not
                                self.indention)
        else:
            self.scalar(value)

    def block_sequence(self, data, indentless):
        outer = self.indent
        if not indentless:
            self.indent = 0 if outer is None else outer + _INDENT
        for item in data:
            if isinstance(item, (dict, list)):
                raise YamlSubsetError("only sequences of scalars are "
                                      "supported")
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.scalar(item)
        self.indent = outer

    def flow_sequence(self, data):
        self.indicator("[", True, whitespace=True)
        self.flow = True
        outer = self.indent
        self.indent = _INDENT if outer is None else outer + _INDENT
        for i, item in enumerate(data):
            if isinstance(item, (dict, list)):
                raise YamlSubsetError("only flow sequences of scalars are "
                                      "supported")
            if i:
                self.indicator(",", False)
            if self.column > _WIDTH:
                self.write_indent()
            self.scalar(item)
        self.indent = outer
        self.flow = False
        self.indicator("]", False)

    def scalar(self, value, simple_key=False):
        if value is None:
            text, style = "null", ""
        elif isinstance(value, bool):
            text, style = ("true" if value else "false"), ""
        elif isinstance(value, int):
            text, style = str(value), ""
        elif isinstance(value, float):
            text, style = _float_text(value), ""
        elif isinstance(value, str):
            text = value
            flow_plain, block_plain, _ = _analyze(text)
            if simple_key and not 0 < len(text) < 128:
                raise YamlSubsetError(f"key {text[:20]!r}: empty keys and "
                                      "keys of 128 characters or more are "
                                      "not supported")
            plain_ok = flow_plain if self.flow else block_plain
            style = "" if _resolve(text) == "str" and plain_ok else "'"
        else:
            raise YamlSubsetError(
                f"cannot write {type(value).__name__} values")
        outer = self.indent
        self.indent = _INDENT if outer is None else outer + _INDENT
        if style == "":
            self._plain(text, split=not simple_key)
        else:
            self._single_quoted(text, split=not simple_key)
        self.indent = outer

    def _plain(self, text, split):
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def _single_quoted(self, text, split):
        self.indicator("'", True)
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > _WIDTH and split
                            and start != 0 and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch in " '":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
            end += 1
        self.indicator("'", False)


def dump_yaml(data: dict, stream=None):
    """``yaml.dump(data)`` for a mapping in the supported subset (keys
    sorted, block style, ``FlowSeq`` lists inline).  Returns the text when
    ``stream`` is None, else writes it there."""
    if not isinstance(data, dict):
        raise YamlSubsetError("the document must be a mapping")
    w = _Writer()
    w.mapping(data)
    w.line_break()
    text = "".join(w.out)
    if stream is None:
        return text
    stream.write(text)
    return None


# --- config files and the best-model checkpoint -------------------------------


def load_config(config_file):
    try:
        return load_yaml(config_file)
    except Exception as e:  # pragma: no cover - mirrors reference behavior
        print(f"Error loading config file: {e}", file=sys.stderr)
        sys.exit(1)


def seed_best_model(path, fixed_parameters, settings):
    """Write the initial best-model checkpoint with -inf log-likelihood
    (reference workflow_optimize.py:458-466)."""
    data = {
        "fixed_parameters": fixed_parameters,
        "optimized_parameters": {},
        "results": {"log_likelihood": -inf, "iteration": None},
        "settings": settings,
    }
    with open(path, "w") as f:
        dump_yaml(data, f)


def write_starting_params(path, fixed_parameters, optimized_bounds, settings):
    """Write ``<prefix>.starting_params.yaml`` (reference
    workflow_optimize.py:419-456)."""
    data = {
        "fixed_parameters": fixed_parameters,
        "optimized_parameters": {
            k: FlowSeq(v) for k, v in optimized_bounds.items()
        },
        "settings": dict(settings),
    }
    if "species_list" in data["settings"]:
        data["settings"]["species_list"] = FlowSeq(data["settings"]["species_list"])
    with open(path, "w") as f:
        dump_yaml(data, f)


def update_best_model(best_model_yaml, optim_variables, current_optim_params,
                      current_result, iteration):
    """Conditionally update the best-model checkpoint (reference
    yaml_helpers.py:57-118): overwrite only if the new log-likelihood
    improves; parameters are de-scaled by the stored mu."""
    if not os.path.exists(best_model_yaml):
        raise FileNotFoundError(f"Best model file not found: {best_model_yaml}")
    data = load_yaml(best_model_yaml)

    mu = float(data["fixed_parameters"]["mu"])
    prev = data["results"]["log_likelihood"]
    if prev is not None and current_result <= prev:
        return False

    optim = {}
    for i, name in enumerate(optim_variables):
        v = float(current_optim_params[i])
        if name == "r":
            optim[name] = v * mu
        elif name == "m":  # dimensionless admixture proportion
            optim[name] = v
        else:
            optim[name] = v / mu
    data["optimized_parameters"] = optim
    data["results"]["log_likelihood"] = float(current_result)
    data["results"]["iteration"] = iteration
    with open(best_model_yaml, "w") as f:
        dump_yaml(data, f)
    return True
