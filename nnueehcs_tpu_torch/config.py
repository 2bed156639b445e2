r"""A reader for the YAML subset that the repository's configs use.

The JAX package reads its configs with PyYAML, which the port does not
depend on (it needs torch, numpy and the standard library only). This
module reads the subset that every committed config
(``examples/**/*.yaml``, ``experiments/*/config*.yaml``) is written in,
and gives what ``yaml.safe_load`` gives for it:

- block mappings and block sequences, nested by indentation (spaces only),
  a sequence under a key at the key's own indentation or deeper, and a
  mapping that starts on a sequence item's line (``- name: x``);
- flow sequences of scalars (``[5, 128]``) and the empty flow mapping
  ``{}`` (``yaml.safe_dump`` writes it, for ``ReLU: {}``);
- single-quoted strings (``'[0, 70]'``, ``''`` for a quote) and
  double-quoted strings with the escapes ``\\ \" \/ \t \n \r \0``
  (``yaml.safe_dump`` writes a tab delimiter as ``"\t"``);
- plain scalars: ``true``, ``false``, ``null``, decimal integers, floats
  with a point (``0.95``, ``5.0e-05``; an exponent needs its sign, as in
  PyYAML), and any other string;
- comments, whole-line or after a value, and a ``---`` first line.

Anything outside the subset raises :class:`ConfigError` with its line:
anchors, aliases, tags, block scalars, non-empty flow mappings, nested flow
sequences, multi-line plain scalars, duplicate keys, tabs in indentation,
more than one document, other escapes, and plain scalars that PyYAML would read as
something this reader does not resolve (``yes``, ``True``, ``~``, ``0x1F``,
``010``, ``1e-5``, ``.inf``, ``1:30``, ...). It never guesses.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_INT = re.compile(r'[-+]?(?:0|[1-9][0-9]*)\Z')
_FLOAT = re.compile(r'[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?\Z')
# plain scalars that PyYAML resolves to a bool, a null, a number or a
# timestamp in forms this reader does not take
_UNRESOLVED = re.compile(
    r'(?:yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|True|TRUE|False'
    r'|FALSE|Null|NULL|~|[-+]?\.?[0-9].*|[-+]?\.(?:inf|Inf|INF)'
    r'|\.(?:nan|NaN|NAN)|<<|=)\Z')
_INDICATORS = '&*!|>%@`{}?'
_ESCAPES = {'\\': '\\', '"': '"', '/': '/', 't': '\t', 'n': '\n',
            'r': '\r', '0': '\0'}


class ConfigError(ValueError):
    """The document is outside the subset this reader takes."""


class _Line:
    __slots__ = ('number', 'indent', 'text')

    def __init__(self, number: int, indent: int, text: str):
        self.number = number
        self.indent = indent
        self.text = text


def _fail(line_number: int, message: str):
    raise ConfigError(f'line {line_number}: {message}')


def _strip_comment(text: str, number: int) -> str:
    """``text`` without a trailing comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if i + 1 < len(text) and text[i + 1] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == '\\':
                i += 1                          # the escaped character
            elif c == '"':
                quote = None
        elif c in '\'"' and (i == 0 or text[i - 1] in ' [,'):
            quote = c
        elif c == '#' and (i == 0 or text[i - 1] == ' '):
            return text[:i].rstrip()
        i += 1
    if quote is not None:
        _fail(number, 'unterminated quoted string')
    return text.rstrip()


def _lines(source: str) -> List[_Line]:
    out = []
    for number, raw in enumerate(source.splitlines(), 1):
        body = raw.lstrip(' ')
        if body.startswith('\t'):
            _fail(number, 'tabs in indentation are not supported')
        text = _strip_comment(body, number)
        if not text:
            continue
        if text == '---':
            if out:
                _fail(number, 'only one document is supported')
            continue
        if text.startswith('...') or text.startswith('%'):
            _fail(number, 'document markers and directives are not '
                          'supported')
        out.append(_Line(number, len(raw) - len(body), text))
    return out


def _quoted(text: str, number: int) -> Tuple[str, str]:
    """The quoted string at the start of ``text`` and what follows it."""
    q = text[0]
    i = 1
    chars = []
    while i < len(text):
        c = text[i]
        if q == '"' and c == '\\':
            escape = text[i + 1:i + 2]
            if escape not in _ESCAPES:
                _fail(number, f'escape \\{escape} is not supported')
            chars.append(_ESCAPES[escape])
            i += 2
            continue
        if c == q:
            if q == "'" and i + 1 < len(text) and text[i + 1] == "'":
                chars.append("'")
                i += 2
                continue
            return ''.join(chars), text[i + 1:]
        chars.append(c)
        i += 1
    _fail(number, 'unterminated quoted string')


def _plain(text: str, number: int, flow: bool = False):
    """Resolve a plain scalar."""
    if text[0] in _INDICATORS or (text[0] == '-' and text[1:2] == ' '):
        _fail(number, f'{text!r}: indicator {text[0]!r} is not supported')
    if ': ' in text or text.endswith(':'):
        _fail(number, f'{text!r}: a mapping is not allowed here')
    if flow and any(c in text for c in ',[]{}'):
        _fail(number, f'{text!r}: nested flow collections are not supported')
    if text == 'true':
        return True
    if text == 'false':
        return False
    if text == 'null':
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _UNRESOLVED.match(text):
        _fail(number, f'{text!r}: PyYAML resolves this plain scalar in a '
                      'form this reader does not take; quote it')
    return text


def _scalar(text: str, number: int):
    if text[0] in '\'"':
        value, rest = _quoted(text, number)
        if rest.strip():
            _fail(number, f'unexpected {rest.strip()!r} after a quoted string')
        return value
    return _plain(text, number)


def _value(text: str, number: int):
    """An inline value: a scalar, a flow sequence of scalars or ``{}``."""
    if text == '{}':
        return {}
    if text.startswith('['):
        if not text.endswith(']'):
            _fail(number, f'{text!r}: flow sequence must end the line')
        inner = text[1:-1].strip()
        if not inner:
            return []
        items = []
        rest = inner
        while True:
            rest = rest.lstrip(' ')
            if not rest:
                _fail(number, f'{text!r}: empty flow sequence entry')
            if rest[0] in '\'"':
                item, rest = _quoted(rest, number)
                items.append(item)
                rest = rest.lstrip(' ')
                if rest and rest[0] != ',':
                    _fail(number, f'{text!r}: expected "," in a flow sequence')
            else:
                end = rest.find(',')
                token = (rest if end < 0 else rest[:end]).strip()
                if not token:
                    _fail(number, f'{text!r}: empty flow sequence entry')
                items.append(_plain(token, number, flow=True))
                rest = '' if end < 0 else rest[end:]
            if not rest:
                return items
            rest = rest[1:]                     # the comma
    return _scalar(text, number)


def _split_key(text: str, number: int) -> Optional[Tuple[Any, str]]:
    """``(key, rest)`` when ``text`` is a mapping entry ``key: rest`` (or
    ``key:``), else None."""
    if text[0] in '\'"':
        key, rest = _quoted(text, number)
        if rest == ':' or rest.startswith(': '):
            return key, rest[1:].strip()
        return None
    if text[0] in '[{':
        return None
    m = re.search(r':(?: |\Z)', text)
    if m is None:
        return None
    return _plain(text[:m.start()], number), text[m.end():].strip()


def _is_item(line: _Line) -> bool:
    return line.text == '-' or line.text.startswith('- ')


class _Parser:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self) -> Optional[_Line]:
        return self.lines[self.i] if self.i < len(self.lines) else None

    def block(self, indent: int):
        line = self.peek()
        if _is_item(line):
            return self.sequence(indent)
        if _split_key(line.text, line.number) is None:
            value = _value(line.text, line.number)
            self.i += 1
            nxt = self.peek()
            if nxt is not None and nxt.indent >= indent:
                _fail(nxt.number, 'multi-line plain scalars are not supported')
            return value
        return self.mapping(indent)

    def nested(self, indent: int, number: int, same_level_items: bool):
        """The value of a key or item whose line ended after its
        indicator: a block indented deeper (or a sequence at the key's own
        indentation), else null."""
        nxt = self.peek()
        if nxt is None:
            return None
        if nxt.indent > indent:
            return self.block(nxt.indent)
        if same_level_items and nxt.indent == indent and _is_item(nxt):
            return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                _fail(line.number, 'unexpected indentation')
            if _is_item(line):
                return out
            entry = _split_key(line.text, line.number)
            if entry is None:
                _fail(line.number, f'expected "key: value", got {line.text!r}')
            key, rest = entry
            if key in out:
                _fail(line.number, f'duplicate key {key!r}')
            self.i += 1
            if rest:
                out[key] = _value(rest, line.number)
                nxt = self.peek()
                if nxt is not None and nxt.indent > indent:
                    _fail(nxt.number, 'unexpected indentation (multi-line '
                                      'plain scalars are not supported)')
            else:
                out[key] = self.nested(indent, line.number, True)

    def sequence(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent > indent:
                _fail(line.number, 'unexpected indentation')
            if not _is_item(line):
                return out
            rest = line.text[1:].lstrip(' ')
            if not rest:
                self.i += 1
                out.append(self.nested(indent, line.number, False))
                continue
            if _is_item(_Line(line.number, 0, rest)):
                _fail(line.number, 'nested sequences on one line are not '
                                   'supported')
            column = indent + len(line.text) - len(rest)
            if _split_key(rest, line.number) is not None:
                # a mapping that starts on the item's line: its keys sit at
                # the column after "- "
                self.lines[self.i] = _Line(line.number, column, rest)
                out.append(self.mapping(column))
                continue
            self.i += 1
            out.append(_value(rest, line.number))
            nxt = self.peek()
            if nxt is not None and nxt.indent > indent:
                _fail(nxt.number, 'unexpected indentation')


def safe_load(stream) -> Any:
    """Read one document from a string or a file object, as
    ``yaml.safe_load`` reads a document of the subset."""
    source = stream if isinstance(stream, str) else stream.read()
    lines = _lines(source)
    if not lines:
        return None
    parser = _Parser(lines)
    first = lines[0]
    value = parser.block(first.indent)
    rest = parser.peek()
    if rest is not None:
        _fail(rest.number, 'unexpected content after the document')
    return value


def load_path(path) -> Any:
    """Read the config at ``path``."""
    with open(path) as f:
        return safe_load(f)


# ---------------------------------------------------------------------------
# the writer: the same subset, in PyYAML's block layout
# ---------------------------------------------------------------------------
_DOUBLE = {v: k for k, v in _ESCAPES.items() if k != '/'}


def _dump_str(text: str) -> str:
    """``text`` plain where this reader and PyYAML both read it back as
    the same string, else quoted."""
    plain_ok = (text and text == text.strip() and text.isprintable()
                and '#' not in text and text[0] not in _INDICATORS + '-\'"[],'
                and ': ' not in text and not text.endswith(':'))
    if plain_ok:
        try:
            plain_ok = _plain(text, 0) == text
        except ConfigError:
            plain_ok = False
    if plain_ok:
        return text
    if text.isprintable():
        return "'" + text.replace("'", "''") + "'"
    chars = []
    for c in text:
        if c in _DOUBLE:
            chars.append('\\' + _DOUBLE[c])
        elif not c.isprintable():
            raise ConfigError(f'{text!r}: character {c!r} has no escape in '
                              'the subset')
        else:
            chars.append(c)
    return '"' + ''.join(chars) + '"'


def _dump_scalar(value) -> str:
    if value is None:
        return 'null'
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value or value in (float('inf'), float('-inf')):
            raise ConfigError(f'{value!r}: not in the subset')
        text = repr(value)
        mantissa, e, exponent = text.partition('e')
        if '.' not in mantissa:
            mantissa += '.0'
        return mantissa + e + exponent
    if isinstance(value, str):
        return _dump_str(value)
    raise ConfigError(f'{value!r}: a {type(value).__name__} is not in the '
                      'subset')


def _dump_block(value, indent: int, out: List[str]) -> None:
    """``value`` (a non-empty dict or list) as block lines at ``indent``."""
    pad = ' ' * indent
    if isinstance(value, dict):
        for key, item in value.items():
            if not isinstance(key, str):
                raise ConfigError(f'key {key!r}: only string keys are in '
                                  'the subset')
            head = f'{pad}{_dump_str(key)}:'
            if isinstance(item, (dict, list)) and item:
                out.append(head)
                # a sequence under a key sits at the key's indentation
                _dump_block(item, indent + 2 * isinstance(item, dict), out)
            else:
                out.append(f'{head} {_dump_inline(item)}')
        return
    for item in value:
        if isinstance(item, dict) and item:
            start = len(out)
            _dump_block(item, indent + 2, out)
            out[start] = f'{pad}- {out[start][indent + 2:]}'
        elif isinstance(item, list) and item:
            out.append(f'{pad}-')
            _dump_block(item, indent + 2, out)
        else:
            out.append(f'{pad}- {_dump_inline(item)}')


def _dump_inline(value) -> str:
    if isinstance(value, dict):
        return '{}'
    if isinstance(value, list):
        return '[]'
    return _dump_scalar(value)


def dump(data, stream=None) -> Optional[str]:
    """``data`` (dicts with string keys, lists, strings, numbers, booleans
    and None) as a document of the subset, in PyYAML's block layout, which
    both :func:`safe_load` and ``yaml.safe_load`` read back as ``data``.
    Written to ``stream`` when given, else returned. Raises ConfigError for
    anything outside the subset (other types, nan, infinities, non-string
    keys, control characters without an escape)."""
    if isinstance(data, (dict, list)) and data:
        lines: List[str] = []
        _dump_block(data, 0, lines)
    else:
        lines = [_dump_inline(data)]
    text = '\n'.join(lines) + '\n'
    if stream is None:
        return text
    stream.write(text)
    return None
