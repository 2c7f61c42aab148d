"""Dependency-free yamale-subset schema validator.

The reference validates runconfigs with the yamale package
(dswx_hls.py:3622-3640); yamale is not available here, so this module
implements the subset of its syntax our schema uses:

    str()  int(min=, max=)  num(min=, max=)  bool()
    enum('a', 'b', ...)     list(<type>, min=N)
    include('name')         + the `required=False` keyword on any of them

Schemas are YAML documents whose leaf values are rule strings; extra
documents (after ``---``) define named includes.
"""

import re

from proteus_jax.config import yaml_subset


class SchemaError(Exception):
    pass


_RULE_RE = re.compile(r"^(\w+)\((.*)\)$")


def _split_args(argstr):
    """Split a rule argument list, respecting quotes and nested parens."""
    args = []
    depth = 0
    quote = None
    cur = ''
    for ch in argstr:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
            continue
        if ch in '\'"':
            quote = ch
            cur += ch
        elif ch == '(':
            depth += 1
            cur += ch
        elif ch == ')':
            depth -= 1
            cur += ch
        elif ch == ',' and depth == 0:
            args.append(cur.strip())
            cur = ''
        else:
            cur += ch
    if cur.strip():
        args.append(cur.strip())
    return args


def _parse_literal(token):
    token = token.strip()
    if len(token) >= 2 and token[0] in '\'"' and token[-1] == token[0]:
        return token[1:-1]
    if token in ('True', 'true'):
        return True
    if token in ('False', 'false'):
        return False
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token)
    except ValueError:
        pass
    return token


class Rule:
    def __init__(self, kind, args, kwargs):
        self.kind = kind
        self.args = args
        self.kwargs = kwargs
        self.required = kwargs.get('required', True)

    @classmethod
    def parse(cls, text):
        m = _RULE_RE.match(text.strip())
        if not m:
            raise SchemaError(f'cannot parse schema rule: {text!r}')
        kind = m.group(1)
        args = []
        kwargs = {}
        for token in _split_args(m.group(2)):
            if not token:
                continue
            if '=' in token and not token.startswith(('"', "'")):
                k, v = token.split('=', 1)
                kwargs[k.strip()] = _parse_literal(v)
            else:
                args.append(token)
        return cls(kind, args, kwargs)

    def validate(self, value, path, includes):
        if value is None:
            if self.required:
                raise SchemaError(f'{path}: required value is missing')
            return
        k = self.kind
        if k == 'str':
            if not isinstance(value, str):
                raise SchemaError(f'{path}: expected str, got '
                                  f'{type(value).__name__}')
        elif k == 'int':
            if isinstance(value, bool) or not isinstance(value, int):
                raise SchemaError(f'{path}: expected int, got '
                                  f'{type(value).__name__}')
            self._check_bounds(value, path)
        elif k == 'num':
            if isinstance(value, bool) or not isinstance(value,
                                                         (int, float)):
                raise SchemaError(f'{path}: expected number, got '
                                  f'{type(value).__name__}')
            self._check_bounds(value, path)
        elif k == 'bool':
            if not isinstance(value, bool):
                raise SchemaError(f'{path}: expected bool, got '
                                  f'{type(value).__name__}')
        elif k == 'enum':
            allowed = [_parse_literal(a) for a in self.args]
            if value not in allowed:
                raise SchemaError(f'{path}: {value!r} not one of {allowed}')
        elif k == 'list':
            if not isinstance(value, list):
                raise SchemaError(f'{path}: expected list, got '
                                  f'{type(value).__name__}')
            min_len = self.kwargs.get('min')
            if min_len is not None and len(value) < min_len:
                raise SchemaError(f'{path}: list shorter than {min_len}')
            if self.args:
                item_rule = Rule.parse(self.args[0])
                for i, item in enumerate(value):
                    item_rule.validate(item, f'{path}[{i}]', includes)
        elif k == 'include':
            name = _parse_literal(self.args[0])
            sub = includes.get(name)
            if sub is None:
                raise SchemaError(f'{path}: unknown include {name!r}')
            _validate_node(value, sub, path, includes)
        elif k == 'any':
            pass
        else:
            raise SchemaError(f'{path}: unsupported rule {k!r}')

    def _check_bounds(self, value, path):
        lo = self.kwargs.get('min')
        hi = self.kwargs.get('max')
        if lo is not None and value < lo:
            raise SchemaError(f'{path}: {value} < min {lo}')
        if hi is not None and value > hi:
            raise SchemaError(f'{path}: {value} > max {hi}')


def _validate_node(data, schema_node, path, includes):
    if isinstance(schema_node, dict):
        if data is None:
            data = {}
        if not isinstance(data, dict):
            raise SchemaError(f'{path}: expected mapping')
        for key, sub in schema_node.items():
            _validate_node(data.get(key), sub, f'{path}.{key}', includes)
    elif isinstance(schema_node, str):
        Rule.parse(schema_node).validate(data, path, includes)
    else:
        raise SchemaError(f'{path}: malformed schema node '
                          f'{type(schema_node).__name__}')


def load_schema(path):
    docs = yaml_subset.load_all_file(path)
    schema = docs[0]
    includes = {}
    for extra in docs[1:]:
        if isinstance(extra, dict):
            includes.update(extra)
    return schema, includes


def validate(data, schema, includes=None):
    """Raise SchemaError if ``data`` does not conform to ``schema``."""
    _validate_node(data, schema, '$', includes or {})


def validate_file(data, schema_path):
    schema, includes = load_schema(schema_path)
    validate(data, schema, includes)
