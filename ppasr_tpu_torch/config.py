"""Config system: YAML file → attribute-access tree.

Counterpart of ppasr_tpu/config.py:19-30. The JAX package reads YAML with
PyYAML; the port carries its own reader for the subset that
``configs/**/*.yml`` use, so that it needs no package beyond torch, numpy
and scipy:

- block mappings nested by indentation, and block sequences (``- item``);
- flow sequences and mappings of scalars on one line (``[ 0, 1 ]``, ``{}``);
- plain, single- and double-quoted scalars, resolved as PyYAML's YAML 1.1
  resolver does (bool, int, float, null, else str);
- ``#`` comments.

Anchors, tags, multi-line scalars and multi-document streams raise.
"""
import json
import os
import re

from ppasr_tpu_torch.utils.common import AttrDict, dict_to_object

REQUIRED_TOP_LEVEL = ("use_model", "dataset_conf", "preprocess_conf", "train_conf")

# PyYAML resolver.py implicit resolvers (YAML 1.1), sexagesimal forms aside
_BOOL = {'yes': True, 'Yes': True, 'YES': True, 'no': False, 'No': False,
         'NO': False, 'true': True, 'True': True, 'TRUE': True,
         'false': False, 'False': False, 'FALSE': False, 'on': True,
         'On': True, 'ON': True, 'off': False, 'Off': False, 'OFF': False}
_NULL = {'', '~', 'null', 'Null', 'NULL'}
_INT = re.compile(r'^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)'
                  r'|[-+]?0x[0-9a-fA-F_]+)$')
_FLOAT = re.compile(r'^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$')


class YamlSubsetError(ValueError):
    pass


def _resolve_plain(s: str):
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        v = s.replace('_', '')
        sign = -1 if v[0] == '-' else 1
        v = v.lstrip('+-')
        if v.startswith('0b'):
            return sign * int(v[2:], 2)
        if v.startswith('0x'):
            return sign * int(v[2:], 16)
        if len(v) > 1 and v[0] == '0':
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(s):
        v = s.replace('_', '').lower()
        if v.endswith('.inf'):
            return float('-inf') if v[0] == '-' else float('inf')
        if v.endswith('.nan'):
            return float('nan')
        return float(v)
    if s[0] in '&*!|>%@`':
        raise YamlSubsetError(f"unsupported YAML construct: {s!r}")
    return s


def _split_flow(s: str) -> list:
    """Split the inside of a one-line flow collection on top-level commas."""
    items, depth, quote, cur = [], 0, None, ''
    for ch in s:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
            cur += ch
        elif ch in '[{':
            depth += 1
            cur += ch
        elif ch in ']}':
            depth -= 1
            cur += ch
        elif ch == ',' and depth == 0:
            items.append(cur.strip())
            cur = ''
        else:
            cur += ch
    if cur.strip():
        items.append(cur.strip())
    return items


def _scalar(s: str):
    s = s.strip()
    if s.startswith("'"):
        if not s.endswith("'") or len(s) < 2:
            raise YamlSubsetError(f"unterminated quoted scalar: {s!r}")
        return s[1:-1].replace("''", "'")
    if s.startswith('"'):
        if not s.endswith('"') or len(s) < 2:
            raise YamlSubsetError(f"unterminated quoted scalar: {s!r}")
        return s[1:-1].encode('latin-1', 'backslashreplace').decode(
            'unicode_escape')
    if s.startswith('['):
        if not s.endswith(']'):
            raise YamlSubsetError(f"multi-line flow sequence: {s!r}")
        return [_scalar(x) for x in _split_flow(s[1:-1])]
    if s.startswith('{'):
        if not s.endswith('}'):
            raise YamlSubsetError(f"multi-line flow mapping: {s!r}")
        out = {}
        for item in _split_flow(s[1:-1]):
            key, sep, val = _split_key(item)
            if not sep:
                raise YamlSubsetError(f"flow mapping item without ':': {item!r}")
            out[key] = _scalar(val)
        return out
    return _resolve_plain(s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"' and (i == 0 or line[i - 1] in ' \t:[{,-'):
            quote = ch
        elif ch == '#' and (i == 0 or line[i - 1] in ' \t'):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(s: str):
    """'key: value' → (key, ':', value); a ':' must be followed by a space
    or end the text to separate a key, as in YAML."""
    quote = None
    for i, ch in enumerate(s):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"' and i == 0:
            quote = ch
        elif ch == ':' and (i + 1 == len(s) or s[i + 1] in ' \t'):
            return _scalar(s[:i]), ':', s[i + 1:].strip()
    return None, '', s


def _parse_block(lines, i, indent):
    """Parse the block whose lines start at ``lines[i]`` with indent
    ``indent``; returns (value, next index)."""
    is_seq = lines[i][1].startswith('- ') or lines[i][1] == '-'
    out = [] if is_seq else {}
    while i < len(lines):
        ind, text = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise YamlSubsetError(f"unexpected indentation: {text!r}")
        if is_seq:
            if not (text.startswith('- ') or text == '-'):
                raise YamlSubsetError(f"mixed sequence/mapping: {text!r}")
            item = text[1:].strip()
            if _split_key(item)[1]:
                raise YamlSubsetError(f"mapping inside a sequence item: {text!r}")
            if item:
                out.append(_scalar(item))
                i += 1
            elif i + 1 < len(lines) and lines[i + 1][0] > indent:
                val, i = _parse_block(lines, i + 1, lines[i + 1][0])
                out.append(val)
            else:
                out.append(None)
                i += 1
            continue
        key, sep, val = _split_key(text)
        if not sep:
            raise YamlSubsetError(f"expected 'key: value': {text!r}")
        if key in out:
            raise YamlSubsetError(f"duplicate key: {key!r}")
        if val:
            out[key] = _scalar(val)
            i += 1
        elif i + 1 < len(lines) and (
                lines[i + 1][0] > indent
                or (lines[i + 1][0] == indent
                    and lines[i + 1][1].startswith('-'))):
            out[key], i = _parse_block(lines, i + 1, lines[i + 1][0])
        else:
            out[key] = None
            i += 1
    return out, i


def parse_yaml_subset(text: str):
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        if '\t' in raw[:len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ('---', '...'):
            raise YamlSubsetError("document markers are not supported")
        lines.append((len(line) - len(line.lstrip(' ')), line.strip()))
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise YamlSubsetError(f"trailing content: {lines[i][1]!r}")
    return value


def load_config(path_or_dict) -> AttrDict:
    """Load a YAML config file (or wrap an existing dict) into an AttrDict."""
    if isinstance(path_or_dict, dict):
        cfg = dict(path_or_dict)
    else:
        with open(path_or_dict, "r", encoding="utf-8") as f:
            cfg = parse_yaml_subset(f.read())
    for key in REQUIRED_TOP_LEVEL:
        if key not in cfg:
            raise ValueError(f"config missing required section/key: {key}")
    return dict_to_object(cfg)


def load_augmentation_config(path: str) -> list:
    """The JSON augmentation pipeline spec (configs/augmentation.json), or
    [] when ``path`` is None or absent (ppasr_tpu/config.py:33-38)."""
    if path is None or not os.path.exists(path):
        return []
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)
