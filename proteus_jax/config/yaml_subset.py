"""A small YAML loader for the subset the runconfigs and schema use.

Covers block mappings and block sequences (by indentation), flow
sequences (``[a, b]``), plain and quoted scalars, comments, and several
documents in one stream (``---``). Plain scalars resolve as
``yaml.safe_load`` (YAML 1.1) resolves them: null, bool (including
yes/no/on/off), int (decimal, 0x hex, 0-prefixed octal, 0b binary,
underscores), and float (a dot is required; .inf/.nan). Anchors, tags,
flow mappings, block scalars (``|``/``>``), timestamps and multi-line
plain scalars are not supported and raise YamlSubsetError.
"""

import re


class YamlSubsetError(ValueError):
    pass


_BOOL_TRUE = {'yes', 'Yes', 'YES', 'true', 'True', 'TRUE', 'on', 'On', 'ON'}
_BOOL_FALSE = {'no', 'No', 'NO', 'false', 'False', 'FALSE', 'off', 'Off',
               'OFF'}
_NULL = {'', '~', 'null', 'Null', 'NULL'}
_INT_RE = re.compile(r'^[-+]?(?:0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+'
                     r'|0|[1-9][0-9_]*)$')
_FLOAT_RE = re.compile(r'^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?'
                       r'|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?'
                       r'|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$')
_TIMESTAMP_RE = re.compile(r'^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:$|[Tt ])')


def _plain(text):
    """Resolve a plain (unquoted) scalar the way yaml.safe_load does."""
    if text in _NULL:
        return None
    if text in _BOOL_TRUE:
        return True
    if text in _BOOL_FALSE:
        return False
    if _INT_RE.match(text):
        sign = -1 if text[0] == '-' else 1
        digits = text.lstrip('+-').replace('_', '')
        if digits.startswith('0b'):
            return sign * int(digits[2:], 2)
        if digits.startswith('0x'):
            return sign * int(digits[2:], 16)
        if len(digits) > 1 and digits[0] == '0':
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT_RE.match(text):
        low = text.replace('_', '').lower()
        if low.endswith('.inf'):
            return float('-inf') if low[0] == '-' else float('inf')
        if low.endswith('.nan'):
            return float('nan')
        return float(low)
    if _TIMESTAMP_RE.match(text):
        raise YamlSubsetError(f'unsupported timestamp scalar: {text!r}')
    return text


def _strip_comment(line):
    """Drop a trailing ``# comment`` that is outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"' and (i == 0 or line[i - 1] in ' \t[,:-'):
            quote = ch
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
    return line.rstrip()


def _quoted(text):
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise YamlSubsetError(f'unterminated quoted scalar: {text!r}')
    body = text[1:-1]
    if q == "'":
        return body.replace("''", "'")
    out = []
    escapes = {'n': '\n', 't': '\t', '"': '"', '\\': '\\', '/': '/',
               '0': '\0', 'r': '\r'}
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == '\\' and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt not in escapes:
                raise YamlSubsetError(f'unsupported escape \\{nxt}')
            out.append(escapes[nxt])
            i += 2
            continue
        out.append(ch)
        i += 1
    return ''.join(out)


def _split_flow(body):
    items, depth, quote, cur = [], 0, None, ''
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
            continue
        if ch in '\'"':
            quote = ch
        elif ch == '[':
            depth += 1
        elif ch == ']':
            depth -= 1
        elif ch == ',' and depth == 0:
            items.append(cur.strip())
            cur = ''
            continue
        cur += ch
    if cur.strip():
        items.append(cur.strip())
    return items


def _scalar(text):
    text = text.strip()
    if not text:
        return None
    if text[0] in '\'"':
        return _quoted(text)
    if text[0] == '[':
        if text[-1] != ']':
            raise YamlSubsetError(f'unterminated flow sequence: {text!r}')
        return [_scalar(t) for t in _split_flow(text[1:-1])]
    if text[0] in '{&*!|>%@`':
        raise YamlSubsetError(f'unsupported YAML construct: {text!r}')
    return _plain(text)


def _split_key(text):
    """'key: value' -> (key, value-text) or None when not a mapping."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"' and i == 0:
            quote = ch
        elif ch == ':' and (i + 1 == len(text) or text[i + 1] in ' \t'):
            key = text[:i].strip()
            key = _quoted(key) if key[:1] in '\'"' else _plain(key)
            return key, text[i + 1:].strip()
    return None


class _Lines:
    def __init__(self, lines):
        self.lines = lines  # [(indent, text, line_number)]
        self.pos = 0

    def peek(self):
        return self.lines[self.pos] if self.pos < len(self.lines) else None


def _parse_block(lines, indent):
    first = lines.peek()
    if first is None or first[0] < indent:
        return None
    if first[1] == '-' or first[1].startswith('- '):
        return _parse_seq(lines, first[0])
    return _parse_map(lines, first[0])


def _parse_value(lines, value_text, parent_indent):
    if value_text:
        return _scalar(value_text)
    nxt = lines.peek()
    if nxt is None:
        return None
    if nxt[0] > parent_indent:
        return _parse_block(lines, nxt[0])
    # a block sequence may sit at its parent key's own indentation
    if nxt[0] == parent_indent and (nxt[1] == '-'
                                    or nxt[1].startswith('- ')):
        return _parse_seq(lines, nxt[0])
    return None


def _parse_map(lines, indent):
    out = {}
    while True:
        cur = lines.peek()
        if cur is None or cur[0] < indent:
            return out
        if cur[0] > indent:
            raise YamlSubsetError(f'line {cur[2]}: unexpected indentation')
        if cur[1] == '-' or cur[1].startswith('- '):
            return out
        kv = _split_key(cur[1])
        if kv is None:
            raise YamlSubsetError(f'line {cur[2]}: expected "key: value"')
        lines.pos += 1
        key, rest = kv
        out[key] = _parse_value(lines, rest, indent)


def _parse_seq(lines, indent):
    out = []
    while True:
        cur = lines.peek()
        if (cur is None or cur[0] != indent
                or not (cur[1] == '-' or cur[1].startswith('- '))):
            if cur is not None and cur[0] > indent:
                raise YamlSubsetError(
                    f'line {cur[2]}: unexpected indentation')
            return out
        rest = cur[1][1:].strip()
        if not rest:
            lines.pos += 1
            out.append(_parse_value(lines, '', indent))
            continue
        kv = _split_key(rest)
        if kv is None or rest[0] in '\'"[':
            lines.pos += 1
            out.append(_scalar(rest))
            continue
        # "- key: value" opens a mapping whose keys align after "- "
        item_indent = indent + len(cur[1]) - len(cur[1][1:].lstrip())
        lines.lines[lines.pos] = (item_indent, rest, cur[2])
        out.append(_parse_map(lines, item_indent))


def _documents(text):
    docs, cur = [], []
    for n, raw in enumerate(text.splitlines(), 1):
        if raw.rstrip() == '---' or raw.startswith('--- '):
            docs.append(cur)
            cur = []
            rest = raw[3:].strip()
            if rest and not rest.startswith('#'):
                raise YamlSubsetError(f'line {n}: content after ---')
            continue
        if raw.rstrip() == '...':
            continue
        if '\t' in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f'line {n}: tab indentation')
        line = _strip_comment(raw)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(' '))
        cur.append((indent, line.strip(), n))
    docs.append(cur)
    return docs


def _load_doc(lines):
    if not lines:
        return None
    stream = _Lines(lines)
    first = lines[0]
    if (len(lines) == 1 and _split_key(first[1]) is None
            and not first[1].startswith('- ')):
        return _scalar(first[1])
    value = _parse_block(stream, first[0])
    left = stream.peek()
    if left is not None:
        raise YamlSubsetError(f'line {left[2]}: unexpected content')
    return value


def load_all(text):
    """Every document of ``text``, as yaml.safe_load_all returns them."""
    docs = _documents(text)
    # a leading '---' opens the first document rather than ending one
    if docs and not docs[0] and len(docs) > 1:
        docs = docs[1:]
    return [_load_doc(d) for d in docs]


def load(text):
    """The single document of ``text``, as yaml.safe_load returns it."""
    docs = load_all(text)
    if len(docs) > 1:
        raise YamlSubsetError('expected a single document')
    return docs[0] if docs else None


def load_file(path):
    with open(path) as fh:
        return load(fh.read())


def load_all_file(path):
    with open(path) as fh:
        return load_all(fh.read())
