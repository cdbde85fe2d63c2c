"""Rule-based Chinese inverse text normalization: a copy of
ppasr_tpu/utils/itn.py below its docstring (tests/test_torch_itn.py pins
the copy to the original).

The JAX predictor tries WeTextProcessing's ``itn`` package first
(ppasr_tpu/predict.py:678-688); the port calls this module directly, since
that package is not installed where the port runs. Covered patterns:

- cardinal numbers with scales  三百二十五 → 325, 一万二千 → 12000
- digit-by-digit sequences      二零二五 → 2025 (phone/year style)
- decimals                      三点一四 → 3.14
- percentages                   百分之六十 → 60%
- negatives                     负五 → -5

Only maximal runs of numeral characters are rewritten, and a run of one
character, or one led by a big scale (万一), is left alone.
"""
import re

_DIGITS = {'零': 0, '一': 1, '幺': 1, '二': 2, '两': 2, '三': 3, '四': 4,
           '五': 5, '六': 6, '七': 7, '八': 8, '九': 9}
_SCALES = {'十': 10, '百': 100, '千': 1000}
_BIG_SCALES = {'万': 10 ** 4, '亿': 10 ** 8}
_NUM_CHARS = set(_DIGITS) | set(_SCALES) | set(_BIG_SCALES) | {'点'}

_RUN_RE = re.compile('[' + ''.join(_NUM_CHARS) + ']+')
_PERCENT_RE = re.compile('百分之([' + ''.join(_NUM_CHARS) + ']+)')
_NEG_RE = re.compile('负(\\d+(?:\\.\\d+)?)')


def _parse_integer(s: str):
    """Chinese numeral string (no 点) → int, or None if malformed."""
    if not s:
        return None
    if all(ch in _DIGITS for ch in s):
        if len(s) > 1:           # digit-by-digit: 二零二五 → 2025
            return int(''.join(str(_DIGITS[ch]) for ch in s))
        return _DIGITS[s]
    total, section, value = 0, 0, 0
    for ch in s:
        if ch in _DIGITS:
            value = _DIGITS[ch]
        elif ch in _SCALES:
            section += (value if value else 1) * _SCALES[ch]
            value = 0
        elif ch in _BIG_SCALES:
            section = (section + value) or 1
            total += section * _BIG_SCALES[ch]
            section, value = 0, 0
        else:
            return None
    return total + section + value


def _parse_number(s: str):
    """Chinese numeral run (may contain one 点) → decimal string, or None."""
    if '点' in s:
        parts = s.split('点')
        if len(parts) != 2 or not parts[1]:
            return None
        left = _parse_integer(parts[0]) if parts[0] else 0
        if left is None or not all(c in _DIGITS for c in parts[1]):
            return None
        frac = ''.join(str(_DIGITS[c]) for c in parts[1])
        return f'{left}.{frac}'
    val = _parse_integer(s)
    return None if val is None else str(val)


def inverse_normalize(text: str) -> str:
    """Rewrite numeric expressions in ASR output to digit form."""
    # percentages first (the 百 inside would otherwise parse as a scale)
    def pct(m):
        num = _parse_number(m.group(1))
        return f'{num}%' if num is not None else m.group(0)
    text = _PERCENT_RE.sub(pct, text)

    def run(m):
        s = m.group(0)
        # single bare numeral: ambiguous with ordinary prose (一起) — keep
        if len(s) == 1:
            return s
        # runs led by a big scale are almost always prose (万一, 千万别,
        # 百般); real numbers lead with a digit or 十 (十五)
        if s[0] not in _DIGITS and s[0] != '十':
            return s
        num = _parse_number(s)
        return num if num is not None else s
    text = _RUN_RE.sub(run, text)
    # 负 before a converted number → minus sign
    text = _NEG_RE.sub(lambda m: '-' + m.group(1), text)
    return text
