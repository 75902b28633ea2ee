"""A reader for the YAML that the repository's configs and dotted
overrides use, typed as ``yaml.safe_load`` (YAML 1.1) types it.

The subset: block mappings and block sequences (a sequence may sit at
its key's indentation), flow mappings and flow sequences on one line
(``{render_data_name: x, mode: train_pbr}``, ``[1, 5]``), comments,
single- and double-quoted strings, and plain scalars. A plain scalar is
null (``~``, ``null``, empty), a bool (``true`` / ``false``, also YAML
1.1's ``yes`` / ``no`` / ``on`` / ``off``), an int (decimal, ``0x``,
``0b``, leading-0 octal, base 60), a float (it needs a ``.``: ``1.0e-3``
is a float and ``1e-3`` the *string* ``'1e-3'``, as in PyYAML) or a
string. Anything else (anchors, aliases, tags, block scalars, multi-line
scalars, documents, tabs, timestamps, ``<<``) raises ``ValueError``
naming the line: the reader never guesses.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
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
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                        re.X)
# a plain scalar may not start with these (flow and quote starts are
# parsed before this check)
_INDICATORS = "&*!|>%@`?,]}#"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ",
            '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0",
            "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line(NamedTuple):
    no: int        # 1-based line number in the source
    indent: int
    text: str      # without indentation, comment and trailing blanks


def _fail(no: int, what: str):
    return ValueError(f"YAML line {no}: {what} (outside the subset this "
                      "reader takes)")


def safe_load(text: str) -> Any:
    """The document in `text` as ``yaml.safe_load`` reads it, for the
    subset above; None for an empty document."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0].indent)
    if i != len(lines):
        raise _fail(lines[i].no, "unexpected indentation or content")
    return value


# -- lines --------------------------------------------------------------------
def _lines(text: str) -> list:
    out = []
    for no, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw:
            raise _fail(no, "a tab character")
        body = _strip_comment(raw, no)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith(("---", "...")) and (
                len(stripped) == 3 or stripped[3] == " "):
            raise _fail(no, "a document marker")
        if stripped.startswith("%"):
            raise _fail(no, "a directive")
        out.append(_Line(no, len(body) - len(stripped), stripped))
    return out


def _strip_comment(s: str, no: int) -> str:
    """`s` without its comment (a '#' at the start or after a blank,
    outside quotes) and trailing blanks. A quote opens a quoted scalar
    only where a node can start (line start, after a blank, '[', '{' or
    ',')."""
    i, n, quote = 0, len(s), None
    while i < n:
        c = s[i]
        if quote == "'":
            if c == "'":
                if i + 1 < n and s[i + 1] == "'":
                    i += 2
                    continue
                quote = None
        elif quote == '"':
            if c == "\\":
                i += 2
                continue
            if c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or s[i - 1] in " [{,"):
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] == " "):
            return s[:i].rstrip(" ")
        i += 1
    if quote:
        raise _fail(no, "a quoted scalar that does not end on its line")
    return s.rstrip(" ")


# -- block structure ----------------------------------------------------------
def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines: list, i: int, indent: int):
    """The node whose first line is lines[i] (at `indent`); returns
    (value, index of the first line after it)."""
    ln = lines[i]
    if _is_item(ln.text):
        return _sequence(lines, i, indent)
    if _split_key(ln) is not None:
        return _mapping(lines, i, indent)
    return _inline(ln.text, ln.no), i + 1


def _nested(lines: list, i: int, indent: int, seq_same_indent: bool):
    """The value of an entry whose inline part was empty: the block on
    the following deeper lines (or a sequence at the key's indent, for
    a mapping's key), else null."""
    if i < len(lines) and (lines[i].indent > indent or (
            seq_same_indent and lines[i].indent == indent
            and _is_item(lines[i].text))):
        return _block(lines, i, lines[i].indent)
    return None, i


def _sequence(lines: list, i: int, indent: int):
    out = []
    while (i < len(lines) and lines[i].indent == indent
           and _is_item(lines[i].text)):
        ln = lines[i]
        rest = ln.text[1:]
        body = rest.lstrip(" ")
        if not body:
            value, i = _nested(lines, i + 1, indent, False)
        else:
            # the item's node starts at its own column: continue it there
            col = indent + 1 + len(rest) - len(body)
            lines[i] = _Line(ln.no, col, body)
            value, i = _block(lines, i, col)
        out.append(value)
    if i < len(lines) and lines[i].indent > indent:
        raise _fail(lines[i].no, "unexpected indentation")
    return out, i


def _mapping(lines: list, i: int, indent: int):
    out = {}
    while i < len(lines) and lines[i].indent == indent:
        ln = lines[i]
        kv = _split_key(ln)
        if kv is None:
            raise _fail(ln.no, "expected 'key: value'")
        key, rest = kv
        if rest:
            value, i = _inline(rest, ln.no), i + 1
        else:
            value, i = _nested(lines, i + 1, indent, True)
        out[key] = value        # a repeated key: the last wins, as in PyYAML
    if i < len(lines) and lines[i].indent > indent:
        raise _fail(lines[i].no, "unexpected indentation")
    return out, i


def _split_key(ln: _Line):
    """(typed key, text after ': ') when the line is a mapping entry,
    else None."""
    t = ln.text
    if t[0] in "[{" or _is_item(t):
        return None
    if t[0] in "'\"":
        key, end = _quoted(t, 0, ln.no)
        rest = t[end:].lstrip(" ")
        if not rest.startswith(":") or (len(rest) > 1 and rest[1] != " "):
            return None
        return key, rest[1:].strip(" ")
    p = t.find(": ")
    if p < 0:
        if not t.endswith(":"):
            return None
        p = len(t) - 1
    key = t[:p].rstrip(" ")
    if not key or key[0] in _INDICATORS:
        raise _fail(ln.no, f"unsupported key {key!r}")
    return _scalar(key, ln.no), t[p + 1:].strip(" ")


def _inline(text: str, no: int):
    """A node written on one line: flow collection, quoted or plain
    scalar."""
    text = text.strip(" ")
    if text[0] in "[{":
        parser = _Flow(text, no)
        value = parser.node()
        parser.skip()
        if parser.i != len(text):
            raise _fail(no, f"content after a flow collection: {text!r}")
        return value
    if text[0] in "'\"":
        value, end = _quoted(text, 0, no)
        if text[end:].strip(" "):
            raise _fail(no, f"content after a quoted scalar: {text!r}")
        return value
    if _is_item(text):
        raise _fail(no, "a block sequence inside a mapping value")
    if ": " in text or text.endswith(":"):
        raise _fail(no, f"a mapping inside a plain scalar: {text!r}")
    return _scalar(text, no)


# -- scalars ------------------------------------------------------------------
def _scalar(text: str, no: int):
    """A plain scalar typed by YAML 1.1's implicit resolvers."""
    if text[0] in _INDICATORS:
        raise _fail(no, f"unsupported plain scalar {text!r}")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        return _to_int(text)
    if text in ("<<", "=") or _TIMESTAMP.match(text):
        raise _fail(no, f"unsupported plain scalar {text!r}")
    return text


def _sign(v: str):
    return (-1 if v[0] == "-" else 1), v[1:] if v[0] in "+-" else v


def _base60(v: str, cast):
    total = cast(0)
    for part in v.split(":"):
        total = total * 60 + cast(part)
    return total


def _to_int(text: str) -> int:
    sign, v = _sign(text.replace("_", ""))
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _base60(v, int)
    return sign * int(v)


def _to_float(text: str) -> float:
    sign, v = _sign(text.replace("_", "").lower())
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _base60(v, float)
    return sign * float(v)


def _quoted(s: str, i: int, no: int):
    """The quoted scalar starting at s[i]; returns (str, index after the
    closing quote)."""
    q, out, i = s[i], [], i + 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    raise _fail(no, f"bad escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise _fail(no, f"unsupported escape \\{e}")
        out.append(c)
        i += 1
    raise _fail(no, "a quoted scalar that does not end on its line")


# -- flow collections ---------------------------------------------------------
class _Flow:
    """Recursive descent over one line's flow collection."""

    def __init__(self, s: str, no: int):
        self.s, self.i, self.no = s, 0, no

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def expect_separator(self, close: str):
        self.skip()
        c = self.peek()
        if c == ",":
            self.i += 1
        elif c != close:
            raise _fail(self.no, f"expected ',' or {close!r} in "
                                 f"{self.s!r}")

    def node(self):
        self.skip()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c in "'\"" and c:
            value, self.i = _quoted(self.s, self.i, self.no)
            return value
        return self.plain()

    def plain(self):
        start, s = self.i, self.s
        while self.i < len(s):
            c = s[self.i]
            if c in ",[]{}":
                break
            if c == ":" and (self.i + 1 == len(s)
                             or s[self.i + 1] in " ,[]{}"):
                break
            self.i += 1
        text = s[start:self.i].strip(" ")
        if not text:
            raise _fail(self.no, f"an empty flow entry in {s!r}")
        return _scalar(text, self.no)

    def sequence(self):
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.peek() == "]":
                self.i += 1
                return out
            if not self.peek():
                raise _fail(self.no, "a flow sequence that does not end on "
                                     "its line")
            out.append(self.node())
            self.skip()
            if self.peek() == ":":
                raise _fail(self.no, "a mapping inside a flow sequence")
            self.expect_separator("]")

    def mapping(self):
        self.i += 1
        out = {}
        while True:
            self.skip()
            if self.peek() == "}":
                self.i += 1
                return out
            if not self.peek():
                raise _fail(self.no, "a flow mapping that does not end on "
                                     "its line")
            if self.peek() in "[{":
                raise _fail(self.no, "a collection as a mapping key")
            key = self.node()
            self.skip()
            if self.peek() != ":":
                raise _fail(self.no, f"a flow mapping entry without ': ' in "
                                     f"{self.s!r}")
            self.i += 1
            self.skip()
            out[key] = None if self.peek() in ",}" else self.node()
            self.expect_separator("}")
