"""The string family and regex on the CPU engine (counterpart of the string
parts of spark_rapids_tpu/plan/cpu.py).

Python strings over ``(values, valid)`` pairs, written apart from the
device's ``exprs/strings.py`` so that each engine checks the other. As the
reference's CPU engine, it works on characters where the device works on
bytes: Length, Upper/Lower (Python's full case mapping), InitCap,
Reverse, Translate, the pads, Overlay and Substring/Left/Right count
characters; Instr, Locate and Ascii read UTF-8 bytes, as the reference's
do; Chr gives the character ``code % 256`` (two UTF-8 bytes from 128). On
ASCII text the two engines agree.

The reference's CPU-only classes run here only: Bin, Md5, Sha1, Sha2,
Crc32 (``hashlib``, ``zlib``), Levenshtein, FormatNumber, StringSpace,
Overlay without a FOR length, and RLIKE with a pattern outside the
device's subset, through Python's ``re`` (as RegexpExtract and
RegexpReplace, which the reference's engine does not evaluate: the port
gives Spark's answers, "" where nothing matches and Java's ``$n`` group
references). Unhex takes hex digits only (a row with any other character
is null, as on the device); UnBase64 is Python's lenient decoder, null
where it fails. Sha2 of a bit length other than 0, 224, 256, 384 and 512
is null (Spark's). A null row is "" (b"" for bytes) or 0 with its valid
flag false.
"""

from __future__ import annotations

import base64
import collections
import decimal
import hashlib
import re
import string
import threading
import weakref
import zlib
from typing import Callable, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import expr as E

Pair = Tuple[np.ndarray, np.ndarray]
_M64 = (1 << 64) - 1
_HEX = frozenset(string.hexdigits)
_SHA2 = {0: hashlib.sha256, 224: hashlib.sha224, 256: hashlib.sha256,
         384: hashlib.sha384, 512: hashlib.sha512}


# the distinct values and codes of recent object arrays, by identity: a
# result of ``_map`` is its distinct results gathered by its input's codes,
# so a function of it evaluates its distinct values without hashing again
_FACTORS: "collections.OrderedDict" = collections.OrderedDict()
_FACTORS_KEPT = 32
_factors_lock = threading.Lock()


def _remember(arr: np.ndarray, uniq: np.ndarray, codes: np.ndarray) -> None:
    key = id(arr)
    # an entry goes with its array (a dict pop needs no lock)
    ref = weakref.ref(arr, lambda _r: _FACTORS.pop(key, None))
    with _factors_lock:
        _FACTORS[key] = (ref, uniq, codes)
        while len(_FACTORS) > _FACTORS_KEPT:
            _FACTORS.popitem(last=False)


def _factor(vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(distinct values, int32 codes) of an array: ``uniq[codes]`` is
    ``vals``."""
    with _factors_lock:
        hit = _FACTORS.get(id(vals))
    if hit is not None and hit[0]() is vals:
        return hit[1], hit[2]
    codes, uniq = pd.factorize(np.asarray(vals), use_na_sentinel=False)
    uniq = np.asarray(uniq, dtype=object)
    codes = codes.astype(np.int32)
    if isinstance(vals, np.ndarray) and vals.dtype == object:
        _remember(vals, uniq, codes)
    return uniq, codes


def _map(vals: np.ndarray, fn: Callable, valid: np.ndarray = None,
         empty="") -> np.ndarray:
    """``fn`` of each value, evaluated once per distinct value; rows where
    ``valid`` is false get ``empty``."""
    uniq, codes = _factor(vals)
    out_u = np.empty(len(uniq) + 1, dtype=object)
    out_u[:-1] = [fn(v) for v in uniq.tolist()]
    out_u[-1] = empty
    if valid is not None and not valid.all():
        codes = np.where(valid, codes, np.int32(len(uniq)))
    out = out_u[codes]
    _remember(out, out_u, codes)
    return out


def _map2(a: np.ndarray, b: np.ndarray, fn: Callable, valid: np.ndarray,
          empty) -> np.ndarray:
    """``fn`` of each row's pair, evaluated once per distinct pair; rows
    where ``valid`` is false get ``empty``."""
    ua, ca = _factor(a)
    ub, cb = _factor(b)
    pair_codes, pairs = pd.factorize(ca.astype(np.int64) * len(ub) + cb)
    out_u = np.empty(len(pairs) + 1, dtype=object)
    out_u[:-1] = [fn(ua[p // len(ub)], ub[p % len(ub)])
                  for p in pairs.tolist()]
    out_u[-1] = empty
    return out_u[np.where(valid, pair_codes, len(pairs))]


def _utf8(x) -> bytes:
    return x if isinstance(x, bytes) else x.encode("utf-8")


def _pad(x: str, length: int, pad: str, left: bool) -> str:
    if len(x) >= length:
        return x[:length]
    fill = (pad * length)[:length - len(x)] if pad else ""
    return fill + x if left else x + fill


def _initcap(x: str) -> str:
    out, prev = [], " "
    for ch in x:
        out.append(ch.upper() if prev == " " else ch.lower())
        prev = ch
    return "".join(out)


def _substring_index(x: str, delim: str, count: int) -> str:
    parts = x.split(delim)
    if count > 0:
        return delim.join(parts[:count]) if len(parts) > count else x
    return delim.join(parts[count:]) if len(parts) > -count else x


def _unhex(x: str):
    if not set(x) <= _HEX:
        return None
    return bytes.fromhex("0" + x if len(x) % 2 else x)


def _unbase64(x) -> object:
    try:
        return base64.b64decode(x)
    except ValueError:
        return None


def _levenshtein(x: str, y: str) -> int:
    prev = list(range(len(y) + 1))
    for i, cx in enumerate(x, 1):
        cur = [i]
        for j, cy in enumerate(y, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (cx != cy)))
        prev = cur
    return prev[-1]


def _java_replacement(repl: str):
    """Java's ``Matcher.replaceAll`` replacement as a function of a match:
    ``$n`` is group n (its text, "" when it did not take part), ``\\x`` is
    x."""
    parts, i = [], 0
    while i < len(repl):
        c = repl[i]
        if c == "\\" and i + 1 < len(repl):
            parts.append(repl[i + 1])
            i += 2
        elif c == "$" and i + 1 < len(repl) and repl[i + 1].isdigit():
            j = i + 1
            while j < len(repl) and repl[j].isdigit():
                j += 1
            parts.append(int(repl[i + 1:j]))
            i = j
        else:
            parts.append(c)
            i += 1
    return lambda m: "".join(p if isinstance(p, str) else (m.group(p) or "")
                             for p in parts)


def _unary(expr: E.Expression) -> Callable:
    """The per-value function of a one-child string function."""
    if isinstance(expr, E.Length):
        return len
    if isinstance(expr, E.OctetLength):  # BitLength too
        mul = 8 if isinstance(expr, E.BitLength) else 1
        return lambda x: len(_utf8(x)) * mul
    if isinstance(expr, (E.Upper, E.Lower)):
        return str.upper if isinstance(expr, E.Upper) else str.lower
    if isinstance(expr, E.StringTrim):  # Left and Right too
        chars = " " if expr.trim_str is None else expr.trim_str
        return {"both": lambda x: x.strip(chars),
                "left": lambda x: x.lstrip(chars),
                "right": lambda x: x.rstrip(chars)}[expr.side]
    if isinstance(expr, E.StringReplace):
        if expr.search == "":
            return lambda x: x
        return lambda x: x.replace(expr.search, expr.replacement)
    if isinstance(expr, E.StringLocate):
        if expr.start < 1:
            return lambda x: 0
        sub = expr.substr.encode("utf-8")
        if not sub:
            return lambda x: max(expr.start, 1)
        return lambda x: _utf8(x).find(sub, expr.start - 1) + 1
    if isinstance(expr, E.StringInstr):
        sub = expr.substr.encode("utf-8")
        return (lambda x: _utf8(x).find(sub) + 1) if sub else (lambda x: 1)
    if isinstance(expr, E.StringLPad):  # StringRPad too
        length = max(expr.length, 0)
        return lambda x: _pad(x, length, expr.pad, expr.side_left)
    if isinstance(expr, E.StringRepeat):
        return lambda x: x * max(expr.times, 0)
    if isinstance(expr, E.StringReverse):
        return lambda x: x[::-1]
    if isinstance(expr, E.StringTranslate):
        table = {}
        for i, ch in enumerate(expr.matching):
            table.setdefault(ord(ch), expr.replace[i]
                             if i < len(expr.replace) else None)
        return lambda x: x.translate(table)
    if isinstance(expr, E.InitCap):
        return _initcap
    if isinstance(expr, E.SubstringIndex):
        if expr.count == 0 or expr.delim == "":
            return lambda x: ""
        return lambda x: _substring_index(x, expr.delim, expr.count)
    if isinstance(expr, (E.Md5, E.Sha1)) and not isinstance(
            expr, (E.Crc32, E.StringSpace)):
        h = hashlib.md5 if type(expr) is E.Md5 else hashlib.sha1
        return lambda x: h(_utf8(x)).hexdigest()
    if isinstance(expr, E.Sha2):
        h = _SHA2.get(expr.bits)
        return lambda x: None if h is None else h(_utf8(x)).hexdigest()
    if isinstance(expr, E.Crc32):
        return lambda x: zlib.crc32(_utf8(x))
    if isinstance(expr, E.Base64):
        return lambda x: base64.b64encode(_utf8(x)).decode("ascii")
    if isinstance(expr, E.UnBase64):
        if isinstance(expr, E.Unhex):
            return _unhex
        return _unbase64
    if isinstance(expr, E.Hex):
        return lambda x: _utf8(x).hex().upper()
    if isinstance(expr, E.FindInSet):
        items = expr.items.split(",")
        return lambda x: (0 if "," in x else
                          items.index(x) + 1 if x in items else 0)
    if isinstance(expr, E.Ascii):
        return lambda x: _utf8(x)[0] if x else 0
    if isinstance(expr, E.RLike):
        prog = re.compile(expr.pattern)
        return lambda x: prog.search(x) is not None
    if isinstance(expr, E.RegexpExtract):
        prog = re.compile(expr.pattern)

        def extract(x):
            m = prog.search(x)
            return (m.group(expr.group) or "") if m else ""
        return extract
    if isinstance(expr, E.RegexpReplace):
        prog = re.compile(expr.pattern)
        repl = _java_replacement(expr.replacement)
        return lambda x: prog.sub(repl, x)
    raise NotImplementedError(
        f"expression {type(expr).__name__} is not in the CPU engine yet")


def _number_fn(expr: E.Expression) -> Callable:
    """The per-value function of a string function of a number."""
    if isinstance(expr, E.Chr):
        return lambda v: chr(int(v) % 256) if v >= 0 else ""
    if isinstance(expr, E.Bin):
        return lambda v: format(int(v) & _M64, "b")
    if isinstance(expr, E.Hex):
        return lambda v: format(int(v) & _M64, "X")
    if isinstance(expr, E.StringSpace):
        return lambda v: " " * max(int(v), 0)
    d, src = expr.d, expr.children[0].dtype  # FormatNumber
    if d < 0:
        return lambda v: None
    if isinstance(src, T.DecimalType):  # the exact value, HALF_EVEN
        return lambda v: f"{decimal.Decimal(int(v)).scaleb(-src.scale):,.{d}f}"
    return lambda v: f"{float(v):,.{d}f}"


def _arrow(vals: np.ndarray, valid: np.ndarray) -> pa.Array:
    return pa.array(vals, pa.string(), mask=~valid)


def eval_string(expr: E.Expression, ev, n: int) -> Pair:
    """A string or regex function over evaluated children: (values,
    valid). A function of one string is evaluated once per distinct
    value; Concat and ConcatWs join with Arrow's
    ``binary_join_element_wise`` (null-emitting and null-skipping)."""
    dt = expr.dtype
    empty = b"" if dt == T.BINARY else "" if dt == T.STRING else 0
    np_t = {T.INT: np.int32, T.LONG: np.int64,
            T.BOOLEAN: np.bool_}.get(dt, object)
    if isinstance(expr, (E.Concat, E.ConcatWs)):
        kids = [ev(c) for c in expr.children]
        skip = isinstance(expr, E.ConcatWs)
        out = pc.binary_join_element_wise(
            *[_arrow(v, m) for v, m in kids], expr.sep if skip else "",
            null_handling="skip" if skip else "emit_null")
        valid = np.asarray(out.is_valid(), dtype=np.bool_)
        return (np.asarray(out.fill_null("").to_numpy(zero_copy_only=False),
                           dtype=object), valid)
    if isinstance(expr, (E.StartsWith, E.EndsWith, E.Contains,
                         E.Levenshtein)):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        fn = {E.StartsWith: str.startswith, E.EndsWith: str.endswith,
              E.Contains: lambda x, y: y in x,
              E.Levenshtein: _levenshtein}[type(expr)]
        valid = am & bm
        return _map2(a, b, fn, valid, empty).astype(np_t), valid
    if isinstance(expr, E.Overlay):
        (a, am), (b, bm) = ev(expr.children[0]), ev(expr.children[1])
        p = max(expr.pos, 1) - 1
        valid = am & bm
        return _map2(a, b, lambda x, y: x[:p] + y + x[p + (
            len(y) if expr.length < 0 else expr.length):], valid, ""), valid
    v, m = ev(expr.children[0])
    if isinstance(expr, (E.StringLeft, E.StringRight)):
        from spark_rapids_tpu_torch.plan.cpu import substring_sql

        k = max(expr.n, 0)
        pos = 1 if type(expr) is E.StringLeft else (-k if k else 1)
        return _map(v, lambda x: substring_sql(x, pos, k), m), m
    if isinstance(expr, (E.Chr, E.Bin, E.StringSpace, E.FormatNumber)) or (
            isinstance(expr, E.Hex)
            and expr.children[0].dtype in T.INTEGRAL_TYPES):
        fn = _number_fn(expr)
    else:
        fn = _unary(expr)
    out = _map(v, fn, m, empty)
    # a function may null a row itself (unhex, unbase64, sha2's bits)
    uniq, codes = _factor(out)
    gone = np.array([x is None for x in uniq.tolist()], np.bool_)
    valid = m
    if gone.any():
        valid = m & ~gone[codes]
        out = _map(out, lambda x: x, valid, empty)
    if np_t is not object:
        out = out.astype(np_t)
    return out, valid
