"""The run config's YAML, read and written with the standard library.

The card's machine has no PyYAML. ``safe_load`` reads the subset of YAML
that run configs use and returns exactly what ``yaml.safe_load`` returns
for it, YAML 1.1 quirks included (PyYAML's implicit resolvers and
constructors): unquoted ``13:52:45`` is the base-60 int 49965,
``2020-01-30`` a ``datetime.date``, ``yes``/``no``/``on``/``off`` are
booleans, ``1e3`` is a string but ``1.0e+3`` a float, ``017`` is octal and
``0x1F`` hex, ``~`` and an empty value are None.

The subset: block mappings and block sequences (an indentless sequence
under a key, ``- - a`` and ``- k: v`` compact entries), one-line flow
sequences and mappings (``[a, b]``, ``{k: v}``, nested), plain, single- and
double-quoted one-line scalars, and ``#`` comments. Anything else raises
ValueError naming the line: anchors, aliases, tags, block scalars (``|``,
``>``), scalars or flow collections over several lines, complex keys
(``?``), merge keys, directives and document markers (``---``, ``...``,
so never several documents), and tabs in the indentation. Nothing is
guessed.

``dump`` writes block YAML, keys sorted as ``yaml.dump`` sorts them, in a
form that both ``safe_load`` and ``yaml.safe_load`` read back equal.
"""

import datetime as dt
import math
import re

__all__ = ['safe_load', 'dump']

# PyYAML's implicit resolvers (YAML 1.1), in its order of registration, each
# with the first characters it is tried for
_RESOLVERS = (
    ('bool', re.compile(r'^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE'
                        r'|on|On|ON|off|Off|OFF)$'), 'yYnNtTfFoO'),
    ('float', re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X), '-+0123456789.'),
    ('int', re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X), '-+0123456789'),
    ('merge', re.compile(r'^(?:<<)$'), '<'),
    ('null', re.compile(r'^(?:~|null|Null|NULL|)$'), '~nN'),
    ('timestamp', re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''', re.X),
     '0123456789'),
    ('value', re.compile(r'^(?:=)$'), '='),
)
_TIMESTAMP = re.compile(r'''^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$''', re.X)
_ESCAPES = {'0': '\0', 'a': '\x07', 'b': '\x08', 't': '\t', '\t': '\t', 'n': '\n', 'v': '\x0b',
            'f': '\x0c', 'r': '\r', 'e': '\x1b', ' ': ' ', '"': '"', '/': '/', '\\': '\\',
            'N': '\x85', '_': '\xa0', 'L': '\u2028', 'P': '\u2029'}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}
# characters that may not start a plain scalar (PyYAML's check_plain)
_NOT_PLAIN_START = ',[]{}#&*!|>\'"%@`'


class _Error(ValueError):
    pass


def _fail(lineno: int, msg: str):
    raise _Error(f'run-config YAML, line {lineno}: {msg}')


# ------------------------------------------------------------------ scalars

def _sexagesimal(value: str, cast):
    digits = [cast(part) for part in value.split(':')]
    out, base = cast(0), 1
    for digit in reversed(digits):
        out += digit * base
        base *= 60
    return out


def _construct(kind: str, value: str, lineno: int):
    if kind == 'bool':
        return value.lower() in ('yes', 'true', 'on')
    if kind == 'null':
        return None
    if kind == 'int':
        value = value.replace('_', '')
        sign = -1 if value[0] == '-' else 1
        if value[0] in '+-':
            value = value[1:]
        if value == '0':
            return 0
        if value.startswith('0b'):
            return sign * int(value[2:], 2)
        if value.startswith('0x'):
            return sign * int(value[2:], 16)
        if value[0] == '0':
            return sign * int(value, 8)
        if ':' in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if kind == 'float':
        value = value.replace('_', '').lower()
        sign = -1 if value[0] == '-' else 1
        if value[0] in '+-':
            value = value[1:]
        if value == '.inf':
            return sign * math.inf
        if value == '.nan':
            return math.nan
        if ':' in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if kind == 'timestamp':
        m = _TIMESTAMP.match(value)
        year, month, day = (int(m.group(k)) for k in ('year', 'month', 'day'))
        if not m.group('hour'):
            return dt.date(year, month, day)
        fraction = (m.group('fraction') or '')[:6].ljust(6, '0')
        tzinfo = None
        if m.group('tz_sign'):
            delta = dt.timedelta(hours=int(m.group('tz_hour')),
                                 minutes=int(m.group('tz_minute') or 0))
            tzinfo = dt.timezone(-delta if m.group('tz_sign') == '-' else delta)
        elif m.group('tz'):
            tzinfo = dt.timezone.utc
        return dt.datetime(year, month, day, int(m.group('hour')), int(m.group('minute')),
                           int(m.group('second')), int(fraction), tzinfo=tzinfo)
    _fail(lineno, f'the plain scalar {value!r} resolves to a {kind} tag, which this reader '
                  'does not support')


def _resolve(value: str, lineno: int):
    """A plain scalar's value, by PyYAML's implicit resolvers."""
    first = value[:1]
    for kind, regex, starts in _RESOLVERS:
        if (first in starts if first else kind == 'null') and regex.match(value):
            try:
                return _construct(kind, value, lineno)
            except (ValueError, OverflowError) as exc:
                if isinstance(exc, _Error):
                    raise
                _fail(lineno, f'cannot construct the {kind} {value!r}: {exc}')
    return value


class _Line:
    """One line of text and a cursor in it."""

    def __init__(self, text: str, lineno: int, pos: int = 0) -> None:
        self.text, self.lineno, self.pos = text, lineno, pos

    def peek(self, k: int = 0) -> str:
        i = self.pos + k
        return self.text[i] if i < len(self.text) else ''

    def skip_spaces(self) -> None:
        while self.peek() in (' ', '\t'):
            self.pos += 1

    def at_end(self) -> bool:
        """Only spaces and a comment remain."""
        self.skip_spaces()
        return self.peek() in ('', '#')

    def fail(self, msg: str):
        _fail(self.lineno, msg)


def _single_quoted(ln: _Line) -> str:
    ln.pos += 1
    out = []
    while True:
        ch = ln.peek()
        if not ch:
            ln.fail('a single-quoted scalar runs past the end of its line')
        if ch == "'":
            if ln.peek(1) == "'":
                out.append("'")
                ln.pos += 2
                continue
            ln.pos += 1
            return ''.join(out)
        out.append(ch)
        ln.pos += 1


def _double_quoted(ln: _Line) -> str:
    ln.pos += 1
    out = []
    while True:
        ch = ln.peek()
        if not ch:
            ln.fail('a double-quoted scalar runs past the end of its line')
        if ch == '"':
            ln.pos += 1
            return ''.join(out)
        if ch != '\\':
            out.append(ch)
            ln.pos += 1
            continue
        esc = ln.peek(1)
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            ln.pos += 2
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            code = ln.text[ln.pos + 2:ln.pos + 2 + n]
            if len(code) != n or any(c not in '0123456789abcdefABCDEF' for c in code):
                ln.fail(f'a bad escape \\{esc}{code}')
            out.append(chr(int(code, 16)))
            ln.pos += 2 + n
        else:
            ln.fail(f'an escape this reader does not support: \\{esc or "(end of line)"}')


def _plain(ln: _Line, flow: bool) -> str:
    """A plain scalar from the cursor: it ends at ': ' (or ':' at the end),
    at ' #', at the line's end and, in a flow collection, at ',[]{}'."""
    ch, nxt = ln.peek(), ln.peek(1)
    if ch in _NOT_PLAIN_START or (ch in '-?:' and nxt in ('', ' ', '\t')):
        ln.fail(f'{ch!r} here starts a construct this reader does not support '
                '(anchor, alias, tag, block scalar, complex key, directive or reserved '
                'indicator)')
    start = ln.pos
    end = ln.pos
    while True:
        ch = ln.peek()
        if not ch:
            break
        if ch == ':' and ln.peek(1) in ('', ' ', '\t') + ((',', '[', ']', '{', '}') if flow
                                                          else ()):
            break
        if flow and ch in ',[]{}':
            break
        if ch == '#' and ln.pos > start and ln.text[ln.pos - 1] in ' \t':
            break
        if flow and ch == '?':
            ln.fail('"?" in a flow collection')
        ln.pos += 1
        if ch not in ' \t':
            end = ln.pos
    value = ln.text[start:end]
    ln.pos = end
    if flow and ':' in value:
        ln.fail(f'a plain scalar holding ":" in a flow collection ({value!r})')
    return value


def _scalar(ln: _Line, flow: bool):
    ch = ln.peek()
    if ch == "'":
        return _single_quoted(ln)
    if ch == '"':
        return _double_quoted(ln)
    return _resolve(_plain(ln, flow), ln.lineno)


# ---------------------------------------------------------- flow collections

def _flow_node(ln: _Line):
    ln.skip_spaces()
    ch = ln.peek()
    if ch == '[':
        return _flow_seq(ln)
    if ch == '{':
        return _flow_map(ln)
    if ch in ('', ',', ']', '}'):
        ln.fail('an empty entry in a flow collection')
    return _scalar(ln, flow=True)


def _flow_seq(ln: _Line) -> list:
    ln.pos += 1
    out = []
    while True:
        ln.skip_spaces()
        if ln.peek() == ']':
            ln.pos += 1
            return out
        if not ln.peek() or ln.peek() == '#':
            ln.fail('a flow sequence that is not closed on its line')
        out.append(_flow_node(ln))
        ln.skip_spaces()
        if ln.peek() == ':':
            ln.fail('a single-pair mapping inside a flow sequence')
        if ln.peek() == ',':
            ln.pos += 1
        elif ln.peek() != ']':
            ln.fail('expected "," or "]" in a flow sequence')


def _flow_map(ln: _Line) -> dict:
    ln.pos += 1
    out = {}
    while True:
        ln.skip_spaces()
        if ln.peek() == '}':
            ln.pos += 1
            return out
        if not ln.peek() or ln.peek() == '#':
            ln.fail('a flow mapping that is not closed on its line')
        if ln.peek() in '[{':
            ln.fail('a collection as a mapping key')
        key = _flow_node(ln)
        ln.skip_spaces()
        value = None
        if ln.peek() == ':':
            ln.pos += 1
            ln.skip_spaces()
            if ln.peek() not in (',', '}'):
                value = _flow_node(ln)
        _set(out, key, value, ln.lineno)
        ln.skip_spaces()
        if ln.peek() == ',':
            ln.pos += 1
        elif ln.peek() != '}':
            ln.fail('expected "," or "}" in a flow mapping')


def _set(mapping: dict, key, value, lineno: int) -> None:
    try:
        hash(key)
    except TypeError:
        _fail(lineno, f'an unhashable mapping key {key!r}')
    mapping[key] = value


# ------------------------------------------------------------------- blocks

def _inline_value(ln: _Line):
    """A value that starts on a key's or an entry's line: a flow collection
    or a scalar, then nothing but a comment."""
    ch = ln.peek()
    if ch == '[':
        value = _flow_seq(ln)
    elif ch == '{':
        value = _flow_map(ln)
    else:
        value = _scalar(ln, flow=False)
    if not ln.at_end():
        if ln.peek() == ':':
            ln.fail('a mapping value on a line that already has one')
        ln.fail(f'unexpected text after a value: {ln.text[ln.pos:]!r}')
    return value


def _is_entry(text: str) -> bool:
    return text.startswith('-') and text[1:2] in ('', ' ', '\t')


def _key_end(text: str, lineno: int):
    """Where a block mapping key on ``text`` ends (the position of its
    ':'), or None when the line holds no key."""
    ln = _Line(text, lineno)
    if text[:1] in ('[', '{'):
        return None
    if text[:1] in ("'", '"'):
        (_single_quoted if text[0] == "'" else _double_quoted)(ln)
        ln.skip_spaces()
    elif text[:1] == '?' and text[1:2] in ('', ' ', '\t'):
        _fail(lineno, 'a complex key ("?")')
    else:
        while ln.peek():
            if ln.peek() == ':' and ln.peek(1) in ('', ' ', '\t'):
                break
            if ln.peek() == '#' and ln.pos and text[ln.pos - 1] in ' \t':
                return None
            ln.pos += 1
    return ln.pos if ln.peek() == ':' and ln.peek(1) in ('', ' ', '\t') else None


class _Parser:
    def __init__(self, text: str) -> None:
        if text.startswith('\ufeff'):
            text = text[1:]
        self.lines = []   # [lineno, indent, content]
        for lineno, raw in enumerate(text.splitlines(), 1):
            stripped = raw.lstrip(' \t')
            content = stripped.rstrip()
            if content and '\t' in raw[:len(raw) - len(stripped)]:
                _fail(lineno, 'a tab in the indentation')
            if not content or content.startswith('#'):
                continue
            if content.startswith(('---', '...')) and content[3:4] in ('', ' ', '\t'):
                _fail(lineno, 'a document marker (several documents are not supported)')
            if content.startswith('%'):
                _fail(lineno, 'a directive')
            self.lines.append([lineno, len(raw) - len(stripped), content])
        self.i = 0

    def parse(self):
        if not self.lines:
            return None
        node = self.block(self.lines[0][1])
        if self.i < len(self.lines):
            _fail(self.lines[self.i][0], 'text after the document\'s root node')
        return node

    def block(self, indent: int):
        lineno, ind, text = self.lines[self.i]
        if _is_entry(text):
            return self.sequence(ind)
        if _key_end(text, lineno) is not None:
            return self.mapping(ind)
        self.i += 1
        value = _inline_value(_Line(text, lineno))
        self.no_continuation(indent - 1, lineno)
        return value

    def no_continuation(self, parent_indent: int, lineno: int) -> None:
        if self.i < len(self.lines) and self.lines[self.i][1] > parent_indent:
            _fail(self.lines[self.i][0], f'a scalar continued from line {lineno} over several '
                                         'lines, or a misplaced indentation')

    def nested(self, parent_indent: int, allow_entries_at: int = -1):
        """The node on the next lines, indented deeper than the parent (or
        an indentless sequence at ``allow_entries_at``); None when there is
        none."""
        if self.i >= len(self.lines):
            return None
        _, ind, text = self.lines[self.i]
        if ind > parent_indent or (ind == allow_entries_at and _is_entry(text)):
            return self.block(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            lineno, ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                _fail(lineno, 'a misplaced indentation')
            end = _key_end(text, lineno)
            if end is None:
                if _is_entry(text):
                    _fail(lineno, 'a sequence entry inside a mapping')
                _fail(lineno, 'expected a "key: value" line')
            key_line = _Line(text[:end].rstrip(), lineno)
            key = _scalar(key_line, flow=False)
            if not key_line.at_end():
                _fail(lineno, 'unexpected text in a mapping key')
            rest = _Line(text, lineno, end + 1)
            self.i += 1
            if rest.at_end():
                value = self.nested(indent, allow_entries_at=indent)
            else:
                value = _inline_value(rest)
                self.no_continuation(indent, lineno)
            _set(out, key, value, lineno)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            lineno, ind, text = self.lines[self.i]
            if ind != indent or not _is_entry(text):
                if ind > indent:
                    _fail(lineno, 'a misplaced indentation')
                break
            rest = text[1:]
            off = len(rest) - len(rest.lstrip(' '))
            rest = rest.lstrip(' ')
            if not rest or rest.startswith('#'):
                self.i += 1
                out.append(self.nested(indent))
                continue
            # a compact entry: parse the rest of the line as a line of its own
            self.lines[self.i] = [lineno, indent + 1 + off, rest]
            out.append(self.block(indent + 1 + off))
        return out


def safe_load(stream):
    """``yaml.safe_load`` on the subset of YAML the module docstring names;
    ValueError naming the line for anything else."""
    text = stream if isinstance(stream, str) else stream.read()
    if isinstance(text, bytes):
        text = text.decode('utf-8')
    return _Parser(text).parse()


# ------------------------------------------------------------------- writer

_PLAIN_SAFE = re.compile(r'^[A-Za-z0-9_./][A-Za-z0-9_./:+-]*(?: [A-Za-z0-9_./:+-]+)*$')


def _is_printable(s: str) -> bool:
    """No character that YAML must escape (PyYAML's printable set, tab
    excluded)."""
    return all((' ' <= c <= '~') or c == '\x85' or ('\xa0' <= c <= '\ud7ff')
               or ('\ue000' <= c <= '\ufffd' and c != '\ufeff') or c >= '\U00010000'
               for c in s)


def _repr_scalar(value) -> str:
    if value is None:
        return 'null'
    if isinstance(value, bool):
        return 'true' if value else 'false'
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return '.nan'
        if math.isinf(value):
            return '.inf' if value > 0 else '-.inf'
        text = repr(value).lower()
        if '.' not in text and 'e' in text:
            text = text.replace('e', '.0e', 1)
        return text
    if isinstance(value, dt.datetime):
        return value.isoformat(' ')
    if isinstance(value, dt.date):
        return value.isoformat()
    if isinstance(value, str):
        if _PLAIN_SAFE.match(value) and ': ' not in value and ' #' not in value \
                and not value.endswith(':') and _resolve(value, 0) == value \
                and isinstance(_resolve(value, 0), str):
            return value
        if _is_printable(value) and '\n' not in value:
            return "'" + value.replace("'", "''") + "'"
        out = []
        for c in value:
            if c in ('"', '\\'):
                out.append('\\' + c)
            elif c == '\n':
                out.append('\\n')
            elif _is_printable(c) and c != '\t':
                out.append(c)
            elif ord(c) <= 0xff:
                out.append(f'\\x{ord(c):02X}')
            elif ord(c) <= 0xffff:
                out.append(f'\\u{ord(c):04X}')
            else:
                out.append(f'\\U{ord(c):08X}')
        return '"' + ''.join(out) + '"'
    raise TypeError(f'dump: cannot write a {type(value).__name__} ({value!r})')


def _emit(node, indent: int, out: list, prefix: str) -> None:
    """Append the lines of ``node``; ``prefix`` is what stands before it on
    its first line (a key, '- ', or nothing)."""
    pad = ' ' * indent
    if isinstance(node, dict) and node:
        first = True
        for key in sorted(node):
            value = node[key]
            head = (prefix if first else pad) + _repr_scalar(key) + ':'
            first = False
            if isinstance(value, dict) and value:
                out.append(head)
                _emit(value, indent + 2, out, ' ' * (indent + 2))
            elif isinstance(value, (list, tuple)) and value:
                out.append(head)
                _emit(list(value), indent, out, pad)
            else:
                out.append(head + ' ' + _flow_or_scalar(value))
    elif isinstance(node, (list, tuple)) and node:
        first = True
        for item in node:
            head = (prefix if first else pad) + '- '
            first = False
            if (isinstance(item, (dict, list, tuple))) and item:
                _emit(item, indent + 2, out, head)
            else:
                out.append(head + _flow_or_scalar(item))
    else:
        out.append(prefix + _flow_or_scalar(node))


def _flow_or_scalar(value) -> str:
    if isinstance(value, dict):
        return '{}'
    if isinstance(value, (list, tuple)):
        return '[]'
    return _repr_scalar(value)


def dump(data, stream=None):
    """Block YAML for ``data`` (dicts, lists and scalars), keys sorted;
    written to ``stream`` when given, else returned."""
    lines = []
    _emit(data, 0, lines, '')
    text = '\n'.join(lines) + '\n'
    if stream is None:
        return text
    stream.write(text)
    return None
