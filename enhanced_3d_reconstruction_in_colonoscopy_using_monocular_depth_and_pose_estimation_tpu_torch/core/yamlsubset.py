"""A reader and a writer for the subset of YAML that the config files and
the command-line overrides use, so the port needs no PyYAML.

The subset:

- block mappings (``key: value``, ``key:`` with a nested block) and block
  sequences (``- item``, also at the indentation of their parent key, and
  ``- key: value`` items that open a mapping);
- flow sequences on one line (``[0, 1]``, nested, ``[]``) and the empty
  flow mapping ``{}``;
- comments (``#`` at the start of a line or after a space);
- double-quoted (with the usual backslash escapes) and single-quoted
  scalars on one line, and plain scalars on one line.

Plain scalars are resolved by PyYAML's YAML 1.1 rules (what
``yaml.safe_load`` gives): null (``~``, ``null``, empty), bool (``true``,
``yes``, ``on``, ... in three casings), int (decimal with ``_``, ``0b``,
``0x``, a leading-``0`` octal, base 60 with ``:``), float (a dot is
required, and an exponent needs its sign: ``1e-5`` and ``1.0e9`` stay
strings), ``.inf`` and ``.nan``; anything else is a string.

Anything outside the subset raises ``YamlSubsetError`` naming the source
and the line: block scalars (``|``, ``>``), anchors, aliases and tags,
multi-line scalars, flow mappings with entries, complex keys, documents
and directives, merge keys and timestamps.

``dump`` writes YAML that ``yaml.safe_load`` (and ``load``) read back
equal: nested mappings indented by two, sequences at the indentation of
their key, strings quoted wherever the plain form would read back as
something else.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any

_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE",
                          "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE",
                          "off", "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"""[-+]?0b[0-1_]+
                     |[-+]?0[0-7_]+
                     |[-+]?(?:0|[1-9][0-9_]*)
                     |[-+]?0x[0-9a-fA-F_]+
                     |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+""", re.X)
_FLOAT = re.compile(r"""[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                       |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                       |[-+]?\.(?:inf|Inf|INF)
                       |\.(?:nan|NaN|NAN)""", re.X)
_TIMESTAMP = re.compile(r"[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:(?:[Tt]|[ \t]+).*)?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# Characters that may not start a plain scalar here (YAML indicators).
_NOT_PLAIN_START = set("[]{},#&*!|>'\"%@`")


class YamlSubsetError(ValueError):
    """A construct outside the subset, or malformed YAML; the message
    names the source and the line."""


def _sexagesimal(text: str, cast) -> Any:
    value, base = cast(0), 1
    for part in reversed(text.split(":")):
        value += cast(part) * base
        base *= 60
    return value


def _construct_int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _construct_float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1.0 if text[0] == "-" else 1.0
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * math.inf
    if text == ".nan":
        return math.nan
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


def resolve_plain(text: str, where: str = "<string>") -> Any:
    """A plain scalar's value under PyYAML's YAML 1.1 rules."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.fullmatch(text):
        return _construct_float(text)
    if _INT.fullmatch(text):
        return _construct_int(text)
    if text in ("<<", "="):
        raise YamlSubsetError(f"{where}: merge and value keys ({text!r}) "
                              "are outside the subset")
    if _TIMESTAMP.fullmatch(text):
        raise YamlSubsetError(f"{where}: timestamps ({text!r}) are outside "
                              "the subset")
    return text


class _Line:
    __slots__ = ("number", "indent", "text")

    def __init__(self, number: int, indent: int, text: str):
        self.number, self.indent, self.text = number, indent, text


class _Parser:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: list[_Line] = []
        for number, raw in enumerate(text.splitlines(), 1):
            body = raw.rstrip()
            stripped = body.lstrip(" ")
            if stripped.startswith("\t") or (
                    stripped and "\t" in body[:len(body) - len(stripped)]):
                self.fail(number, "tabs in indentation")
            content = self._strip_comment(stripped, number)
            if not content:
                continue
            if content.startswith("%") or (content[:3] in ("---", "...")
                                           and content[3:4] in ("", " ")):
                self.fail(number, "documents and directives are outside the "
                                  "subset")
            self.lines.append(_Line(number, len(body) - len(stripped),
                                    content))

    def fail(self, number: int, message: str):
        raise YamlSubsetError(f"{self.source}:{number}: {message}")

    # ------------------------------------------------------------ lexing

    def _strip_comment(self, text: str, number: int) -> str:
        """``text`` without its comment. A quote opens a quoted scalar only
        where a scalar can start (at the start, or after ``:``, ``-``,
        ``[`` or ``,`` and a space), so ``it's`` stays plain."""
        quote = None
        prev = ""  # last non-space character outside quotes
        i = 0
        while i < len(text):
            c = text[i]
            if quote == '"':
                if c == "\\":
                    i += 1
                elif c == '"':
                    quote = None
            elif quote == "'":
                if c == "'":
                    if text[i + 1:i + 2] == "'":
                        i += 1
                    else:
                        quote = None
            elif c in "'\"" and prev in ("", ":", "-", "[", ",", "?") \
                    and (i == 0 or text[i - 1] in " [,"):
                quote = c
            elif c == "#" and (i == 0 or text[i - 1] in " \t"):
                return text[:i].rstrip()
            if c not in " \t":
                prev = c
            i += 1
        if quote is not None:
            self.fail(number, "unterminated or multi-line quoted scalar")
        return text

    def _quoted(self, text: str, number: int) -> tuple[str, int]:
        """A quoted scalar at the start of ``text``: (value, chars used)."""
        q = text[0]
        out = []
        i = 1
        while i < len(text):
            c = text[i]
            if q == "'" and c == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and c == '"':
                return "".join(out), i + 1
            if q == '"' and c == "\\":
                esc = text[i + 1:i + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    i += 2
                    continue
                if esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    digits = text[i + 2:i + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(number, f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + n
                    continue
                self.fail(number, f"unknown escape \\{esc}")
            out.append(c)
            i += 1
        self.fail(number, "unterminated or multi-line quoted scalar")

    def _split_key(self, text: str, number: int) -> tuple[Any, str] | None:
        """(key, rest) if ``text`` is a mapping entry ``key: rest``."""
        if text[0] in "'\"":
            key, used = self._quoted(text, number)
            rest = text[used:].lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                return None
            return key, rest[1:].strip()
        if text.startswith("? ") or text == "?":
            self.fail(number, "complex keys are outside the subset")
        if text[0] in "[{":
            return None
        m = re.search(r":(?: |$)", text)
        if m is None:
            return None
        key = text[:m.start()].rstrip()
        if not key or key[0] in _NOT_PLAIN_START:
            self.fail(number, f"key {key!r} is outside the subset")
        return resolve_plain(key, f"{self.source}:{number}"), \
            text[m.end():].strip()

    # ----------------------------------------------------------- scalars

    def _inline(self, text: str, number: int) -> Any:
        """The value written after ``key:`` or ``- `` on one line."""
        c = text[0]
        if c == "[":
            value, used = self._flow_list(text, 0, number)
            if text[used:].strip():
                self.fail(number, f"unexpected {text[used:]!r} after a flow "
                                  "sequence")
            return value
        if c == "{":
            if re.fullmatch(r"\{\s*\}", text):
                return {}
            self.fail(number, "flow mappings with entries are outside the "
                              "subset")
        if c in "'\"":
            value, used = self._quoted(text, number)
            if text[used:].strip():
                self.fail(number, f"unexpected {text[used:]!r} after a "
                                  "quoted scalar")
            return value
        if c in "|>":
            self.fail(number, "block scalars are outside the subset")
        if c in "&*!":
            self.fail(number, "anchors, aliases and tags are outside the "
                              "subset")
        if c in "@`%]},#":
            self.fail(number, f"a plain scalar cannot start with {c!r}")
        if re.search(r":(?: |$)", text):
            self.fail(number, "a mapping cannot start on the line of a "
                              "key's value")
        return resolve_plain(text, f"{self.source}:{number}")

    def _flow_list(self, text: str, i: int, number: int) -> tuple[list, int]:
        """A flow sequence starting at ``text[i] == '['``: (list, end)."""
        out: list = []
        i += 1
        while True:
            while i < len(text) and text[i] == " ":
                i += 1
            if i >= len(text):
                self.fail(number, "unterminated or multi-line flow sequence")
            c = text[i]
            if c == "]":
                return out, i + 1
            if c == "[":
                item, i = self._flow_list(text, i, number)
            elif c in "'\"":
                item, used = self._quoted(text[i:], number)
                i += used
            elif c == "{":
                self.fail(number, "flow mappings are outside the subset")
            elif c in "&*!|>@`%,":
                self.fail(number, f"{c!r} inside a flow sequence is outside "
                                  "the subset")
            else:
                j = i
                while j < len(text) and text[j] not in ",[]{}":
                    j += 1
                plain = text[i:j].strip()
                if re.search(r":(?: |$)", plain) or " #" in plain:
                    self.fail(number, "flow mappings are outside the subset")
                item = resolve_plain(plain, f"{self.source}:{number}")
                i = j
            out.append(item)
            while i < len(text) and text[i] == " ":
                i += 1
            if i < len(text) and text[i] == ",":
                i += 1
            elif i >= len(text) or text[i] != "]":
                self.fail(number, "expected ',' or ']' in a flow sequence")

    # ------------------------------------------------------------ blocks

    @staticmethod
    def _is_item(line: _Line) -> bool:
        return line.text == "-" or line.text.startswith("- ")

    def _block(self, i: int, indent: int) -> tuple[Any, int]:
        line = self.lines[i]
        if self._is_item(line):
            return self._sequence(i, indent)
        if self._split_key(line.text, line.number) is not None:
            return self._mapping(i, indent)
        return self._inline(line.text, line.number), i + 1

    def _child(self, i: int, indent: int, seq_at_indent: bool
               ) -> tuple[Any, int]:
        """The nested block after ``key:`` or ``-`` (None if there is
        none)."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > indent or (seq_at_indent and nxt.indent == indent
                                       and self._is_item(nxt)):
                return self._block(i, nxt.indent)
        return None, i

    def _mapping(self, i: int, indent: int) -> tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            if self._is_item(line):
                self.fail(line.number, "a sequence item inside a mapping")
            entry = self._split_key(line.text, line.number)
            if entry is None:
                self.fail(line.number, "expected 'key: value'")
            key, rest = entry
            if rest:
                out[key] = self._inline(rest, line.number)
                i += 1
            else:
                out[key], i = self._child(i + 1, indent, True)
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].number, "unexpected indentation (a "
                      "multi-line scalar is outside the subset)")
        return out, i

    def _sequence(self, i: int, indent: int) -> tuple[list, int]:
        out: list = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and self._is_item(self.lines[i])):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            if not rest:
                item, i = self._child(i + 1, indent, False)
            elif rest == "-" or rest.startswith("- "):
                self.fail(line.number, "compact nested sequences are outside "
                                       "the subset")
            elif self._split_key(rest, line.number) is not None:
                # "- key: value" opens a mapping at the column of "key".
                col = indent + len(line.text) - len(rest)
                self.lines[i] = _Line(line.number, col, rest)
                item, i = self._mapping(i, col)
            else:
                item = self._inline(rest, line.number)
                i += 1
            out.append(item)
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].number, "unexpected indentation")
        return out, i

    def document(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        value, i = self._block(0, first.indent)
        if i < len(self.lines):
            self.fail(self.lines[i].number, "unexpected content after the "
                                            "document's top-level node")
        return value


def load(text: str, source: str = "<string>") -> Any:
    """Parse YAML ``text`` of the subset; ``source`` names it in errors."""
    return _Parser(text, source).document()


def load_file(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return load(f.read(), path)


# ----------------------------------------------------------------- writer

_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_./$][A-Za-z0-9_./$={}+\-]*")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)  # 1e-06 -> 1.0e-06
        return text
    if isinstance(value, str):
        if _PLAIN_SAFE.fullmatch(value) and not value.startswith("-"):
            try:
                if resolve_plain(value) == value:
                    return value
            except YamlSubsetError:
                pass
        return json.dumps(value, ensure_ascii=False)
    raise TypeError(f"cannot write {type(value).__name__} as YAML")


def _dump(value: Any, indent: int, out: list[str]) -> None:
    pad = " " * indent
    if isinstance(value, dict):
        for key, item in value.items():
            head = f"{pad}{_scalar(key)}:"
            if isinstance(item, dict) and item:
                out.append(head)
                _dump(item, indent + 2, out)
            elif isinstance(item, (list, tuple)) and item:
                out.append(head)
                _dump(item, indent, out)
            else:
                out.append(f"{head} {_inline_value(item)}")
    else:
        for item in value:
            if isinstance(item, dict) and item:
                lines: list[str] = []
                _dump(item, indent + 2, lines)
                out.append(f"{pad}- {lines[0][indent + 2:]}")
                out.extend(lines[1:])
            elif isinstance(item, (list, tuple)) and item:
                out.append(f"{pad}-")
                _dump(item, indent + 2, out)
            else:
                out.append(f"{pad}- {_inline_value(item)}")


def _inline_value(value: Any) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar(value)


def dump(value: Any) -> str:
    """YAML text of nested dicts, lists and scalars."""
    if isinstance(value, (dict, list, tuple)) and value:
        out: list[str] = []
        _dump(value, 0, out)
        return "\n".join(out) + "\n"
    return _inline_value(value) + "\n"
