"""The scalar function families on the CPU engine (counterpart of the
math, rounding, bitwise and hash parts of spark_rapids_tpu/plan/cpu.py).

numpy over ``(values, valid)`` pairs, written apart from the device's
``exprs/math.py`` so that each engine checks the other: the unary math
family through numpy's functions (Cbrt is ``np.cbrt``), hashes and Rand
through numpy's wrapping uint64 arithmetic, BitCount as a SWAR popcount
of uint64 words, logical shifts on uint64, and the decimal cases the
reference places here exactly in Python integers:

- Floor and Ceil of a decimal(p, s): floor or ceiling of the unscaled
  value over 10**s, a decimal(p - s + 1, 0);
- Round and BRound of a decimal at a scale below its own: HALF_UP or
  HALF_EVEN of the unscaled value at 10**(s - scale) (a negative scale
  rounds to tens, hundreds, ... at result scale 0), null past the
  result's precision (``E.round_decimal_type``).

Round and BRound of a double follow the same steps as the device's
``round_fractional`` (the tie point against x itself), so both engines
give Spark's ``BigDecimal(d).setScale`` answer on the same domain.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exprs import expr as E

Pair = Tuple[np.ndarray, np.ndarray]
_M64 = (1 << 64) - 1
_FACTORIALS = np.array([math.factorial(i) for i in range(21)], np.int64)


def _u(c: int) -> np.uint64:
    return np.uint64(c & _M64)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """The engine's splitmix64 finaliser over uint64 words."""
    x = x + _u(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * _u(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * _u(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def as_double(vals: np.ndarray, dt: T.DataType) -> np.ndarray:
    """Values as float64; a decimal's unscaled value over 10**scale."""
    if isinstance(dt, T.DecimalType):
        return np.asarray(vals).astype(np.float64) / 10.0 ** dt.scale
    return np.asarray(vals).astype(np.float64)


def _recip(fn):
    def inv(x):
        with np.errstate(divide="ignore"):
            return 1.0 / fn(x)
    return inv


_UNARY = {E.Sqrt: np.sqrt, E.Cbrt: np.cbrt, E.Exp: np.exp,
          E.Expm1: np.expm1, E.Sin: np.sin, E.Cos: np.cos, E.Tan: np.tan,
          E.Cot: _recip(np.tan), E.Sec: _recip(np.cos),
          E.Csc: _recip(np.sin), E.Asin: np.arcsin, E.Acos: np.arccos,
          E.Atan: np.arctan, E.Sinh: np.sinh, E.Cosh: np.cosh,
          E.Tanh: np.tanh, E.Asinh: np.arcsinh, E.Acosh: np.arccosh,
          E.Atanh: np.arctanh, E.ToDegrees: np.degrees,
          E.ToRadians: np.radians, E.Rint: np.rint, E.Signum: np.sign}
_LOGS = {E.Log: (np.log, 0.0), E.Log10: (np.log10, 0.0),
         E.Log2: (np.log2, 0.0), E.Log1p: (np.log1p, -1.0)}
_BINARY = {E.Atan2: np.arctan2, E.Hypot: np.hypot, E.Pow: np.power}


def _split(a):
    c = 134217729.0 * a
    hi = c - (c - a)
    return hi, a - hi


def round_fractional(x: np.ndarray, scale: int, half_even: bool
                     ) -> np.ndarray:
    """Spark's round/bround of floats or doubles (the device's
    ``round_fractional``'s steps: y = |x| * 10**scale split exactly, the
    tie point h = (k + 1/2) / 10**scale taken as the shortest text where
    it converts to x)."""
    is_f32 = x.dtype == np.float32
    d = x.astype(np.float64)
    with np.errstate(all="ignore"):
        fin = np.isfinite(d)
        a = np.where(fin, np.abs(d), 0.0)
        if scale >= 0:
            p = 10.0 ** scale
            hi = a * p
            ah, al = _split(a)
            bh, bl = _split(np.full_like(a, p))
            lo = ((ah * bh - hi) + ah * bl + al * bh) + al * bl
            k = np.floor(hi)
            frac = (hi - k) + lo
            y = hi
        else:
            q = 10.0 ** -scale
            k = np.floor(a / q)
            frac = (a - k * q) / q
            y = a / q
        under, over = frac < 0, frac >= 1
        k = k - under + over
        frac = frac + under - over
        h = ((2.0 * k + 1.0) / (2.0 * p) if scale >= 0
             else (2.0 * k + 1.0) * q / 2.0)
        tie = (h.astype(np.float32) == a.astype(np.float32) if is_f32
               else h == a)
        up = np.where(tie, (np.mod(k, 2.0) == 1.0) if half_even else True,
                      frac > 0.5)
        r = k + up
        out = r / p if scale >= 0 else r * q
        out = np.where(d < 0, -out, out)
        limit = float(1 << 23) if is_f32 else float(1 << 52)
        out = np.where(~fin | (y >= limit), d, out)
    return out.astype(x.dtype)


def round_integral(x: np.ndarray, scale: int, half_even: bool
                   ) -> np.ndarray:
    """An integer at a negative scale: the nearest multiple of 10**-scale
    (HALF_UP away from zero or HALF_EVEN), wrapped into x's type; past 18
    digits in Python integers."""
    if scale >= 0:
        return x
    q = 10 ** -scale
    if q > 10 ** 18:
        bits = 8 * x.dtype.itemsize
        out = []
        for v in np.asarray(x).tolist():
            fl, rem = divmod(int(v), q)
            if 2 * rem > q or (2 * rem == q and (
                    fl % 2 == 1 if half_even else v > 0)):
                fl += 1
            w = (fl * q) & ((1 << bits) - 1)
            out.append(w - (1 << bits) if w >= 1 << (bits - 1) else w)
        return np.array(out, x.dtype)
    a = np.asarray(x).astype(np.int64)
    fl = np.floor_divide(a, q)
    rem = a - fl * q
    tie = 2 * rem == q
    up = (2 * rem > q) | (tie & ((fl % 2 == 1) if half_even else (a > 0)))
    with np.errstate(over="ignore"):
        return ((fl + up) * np.int64(q)).astype(x.dtype)


def round_decimal(vals, dt: T.DecimalType, scale: int, half_even: bool,
                  out_t: T.DecimalType) -> Tuple[list, np.ndarray]:
    """Unscaled values of a decimal rounded at ``scale`` in ``out_t`` and
    whether each fits its precision."""
    if scale >= dt.scale:
        return [int(v) for v in vals], np.ones(len(vals), np.bool_)
    f = 10 ** (dt.scale - scale)
    back = 10 ** (out_t.scale - scale)
    out = []
    for v in vals:
        q, rem = divmod(int(v), f)
        if 2 * rem > f or (2 * rem == f and (q % 2 == 1 if half_even
                                             else v > 0)):
            q += 1
        out.append(q * back)
    bound = 10 ** out_t.precision
    return out, np.array([abs(v) < bound for v in out], np.bool_)


def _decimal_out(out: list, ok: np.ndarray, dt: T.DecimalType) -> np.ndarray:
    out = [v if k else 0 for v, k in zip(out, ok)]
    if dt.is_wide:
        arr = np.empty(len(out), dtype=object)
        arr[:] = out
        return arr
    return np.array(out, np.int64)


def popcount64(x: np.ndarray) -> np.ndarray:
    """Set bits of uint64 words (SWAR)."""
    x = x - ((x >> np.uint64(1)) & _u(0x5555555555555555))
    x = (x & _u(0x3333333333333333)) + ((x >> np.uint64(2))
                                        & _u(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & _u(0x0F0F0F0F0F0F0F0F)
    return (x * _u(0x0101010101010101)) >> np.uint64(56)


def _float_hash_key(vals: np.ndarray) -> np.ndarray:
    """uint64 key of floats: the float32 words (rounded value, residual) of
    the canonical double (NaN one fixed key, -0.0 as 0.0)."""
    d = np.asarray(vals, np.float64)
    nan = np.isnan(d)
    d = np.where(nan | (d == 0.0), 0.0, d)
    with np.errstate(over="ignore", invalid="ignore"):
        hi = d.astype(np.float32)
        lo = (d - hi.astype(np.float64)).astype(np.float32)
    u = ((hi.view(np.uint32).astype(np.uint64) << np.uint64(32))
         | lo.view(np.uint32).astype(np.uint64))
    return np.where(nan, _u(0x7FF8DEAD7F4A7C15), u)


def _string_word(s: str, variant: int) -> int:
    b = s.encode("utf-8")
    h, p, mult = 0, 1, K._STR_P[variant]
    for byte in b:
        h = (h + (byte + 1) * p) & _M64
        p = (p * mult) & _M64
    x = np.array([h ^ ((len(b) * K._LEN_MIX[variant]) & _M64)], np.uint64)
    return int(splitmix64(x)[0])


def column_hash(vals: np.ndarray, dt: T.DataType, variant: int
                ) -> np.ndarray:
    """One argument's uint64 hash word (the device's ``column_hash``)."""
    salt = _u(K._INT_SALT[variant])
    n = len(vals)
    if dt == T.STRING:
        from spark_rapids_tpu_torch.plan.cpu import _per_value
        words = _per_value(np.asarray(vals, dtype=object), lambda x: np.array(
            [_string_word(s, variant) for s in x], np.uint64))
        return np.asarray(words, np.uint64).reshape(n)
    if dt in T.FRACTIONAL_TYPES:
        return splitmix64(_float_hash_key(vals) ^ salt)
    if T.is_wide_decimal(dt):
        ints = [int(v) for v in vals]
        lo = np.array([v & _M64 for v in ints], np.uint64)
        hi = np.array([(v >> 64) & _M64 for v in ints], np.uint64)
        return splitmix64(splitmix64((lo ^ _u(1 << 63)) ^ salt) + hi)
    words = np.asarray(vals).astype(np.int64).view(np.uint64)
    return splitmix64((words ^ _u(1 << 63)) ^ salt)


def engine_hash(kids, exprs, n: int, variant: int) -> np.ndarray:
    h = np.zeros(n, np.uint64)
    mult = _u(K._COMBINE_MULT[variant])
    for (vals, valid), e in zip(kids, exprs):
        ch = np.where(valid, column_hash(vals, e.dtype, variant),
                      _u(K._NULL_HASH))
        h = splitmix64(h * mult + ch)
    return h.view(np.int64)


def rand(seed: int, n: int) -> np.ndarray:
    idx = np.arange(n, dtype=np.uint64)
    h = splitmix64(idx + _u(seed * 0x9E3779B97F4A7C15))
    return (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _greatest(expr: E.Greatest, kids) -> Pair:
    is_max = not isinstance(expr, E.Least)
    acc, av = kids[0]
    acc = np.asarray(acc)
    for d, v in kids[1:]:
        d = np.asarray(d)
        a, b = acc, d
        if a.dtype.kind == "f":  # NaN above every value
            a = np.where(np.isnan(a), np.inf, a)
            b = np.where(np.isnan(b), np.inf, b)
        newer = np.asarray(b > a if is_max else b < a, np.bool_)
        take = np.where(av, newer & v, v)
        acc = np.where(take, d, acc)
        av = av | v
    return acc, av


def _shift(expr: E.ShiftLeft, x: np.ndarray, n: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    bits = 64 if x.dtype == np.int64 else 32
    sh = (np.asarray(n).astype(np.int64) & (bits - 1)).astype(np.uint64)
    ut = np.uint64 if bits == 64 else np.uint32
    u = x.astype(np.int64).astype(np.uint64)
    if isinstance(expr, E.ShiftRightUnsigned):
        if bits == 32:
            u = u & np.uint64(0xFFFFFFFF)
        out = u >> sh
    elif isinstance(expr, E.ShiftRight):
        return (x.astype(np.int64) >> sh.astype(np.int64)).astype(x.dtype)
    else:
        out = u << sh
    return out.astype(ut).view(np.int64 if bits == 64 else np.int32)


def eval_scalar(expr: E.Expression, ev: Callable, n: int) -> Pair:
    """(values, valid) of a scalar function other than the division family,
    EqualNullSafe, NullIf and Nvl2 (``plan/cpu.py`` has those)."""
    kind = type(expr)
    if kind in _UNARY or kind in _LOGS:
        v, m = ev(expr.child)
        x = as_double(v, expr.child.dtype)
        with np.errstate(all="ignore"):
            if kind in _LOGS:
                fn, least = _LOGS[kind]
                ok = x > least
                return fn(np.where(ok, x, 1.0)), m & ok
            return _UNARY[kind](x), m
    if kind in _BINARY:
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        with np.errstate(all="ignore"):
            return (_BINARY[kind](as_double(a, expr.left.dtype),
                                  as_double(b, expr.right.dtype)), am & bm)
    if isinstance(expr, E.Floor):
        v, m = ev(expr.child)
        ct = expr.child.dtype
        if isinstance(ct, T.DecimalType):
            p = 10 ** ct.scale
            ceil = isinstance(expr, E.Ceil)
            out = [-((-int(x)) // p) if ceil else int(x) // p for x in v]
            ok = np.array([abs(x) < 10 ** expr.dtype.precision
                           for x in out], np.bool_)
            return _decimal_out(out, ok, expr.dtype), m & ok
        v = np.asarray(v)
        if v.dtype.kind != "f":
            return v.astype(np.int64), m
        from spark_rapids_tpu_torch.plan.cpu import _double_to_integral
        f = np.ceil if isinstance(expr, E.Ceil) else np.floor
        with np.errstate(invalid="ignore"):
            return _double_to_integral(f(v.astype(np.float64)),
                                       np.dtype(np.int64)), m
    if isinstance(expr, E.Round):
        v, m = ev(expr.child)
        ct = expr.child.dtype
        if isinstance(ct, T.DecimalType):
            out, ok = round_decimal(v, ct, expr.scale, expr.HALF_EVEN,
                                    expr.dtype)
            return _decimal_out(out, ok, expr.dtype), m & ok
        v = np.asarray(v)
        if v.dtype.kind == "f":
            return round_fractional(v, expr.scale, expr.HALF_EVEN), m
        return round_integral(v, expr.scale, expr.HALF_EVEN), m
    if isinstance(expr, E.Positive):
        return ev(expr.child)
    if isinstance(expr, E.Factorial):
        v, m = ev(expr.child)
        k = np.asarray(v).astype(np.int64)
        ok = (k >= 0) & (k <= 20)
        return _FACTORIALS[np.clip(k, 0, 20)], m & ok
    if isinstance(expr, E.BitCount):
        v, m = ev(expr.child)
        u = np.asarray(v).astype(np.int64).view(np.uint64)
        return popcount64(u).astype(np.int32), m
    if isinstance(expr, E.BitGet):
        (x, xm), (p, pm) = ev(expr.left), ev(expr.right)
        x = np.asarray(x)
        bits = 8 * x.dtype.itemsize
        p = np.asarray(p).astype(np.int64)
        ok = (p >= 0) & (p < bits)
        bit = (x.astype(np.int64) >> np.clip(p, 0, 63)) & 1
        return bit.astype(np.int8), xm & pm & ok
    if isinstance(expr, (E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor)):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        from spark_rapids_tpu_torch.plan.cpu import _np_dtype
        nt = _np_dtype(expr.dtype)
        a, b = np.asarray(a).astype(nt), np.asarray(b).astype(nt)
        out = (a & b if isinstance(expr, E.BitwiseAnd)
               else a | b if isinstance(expr, E.BitwiseOr) else a ^ b)
        return out, am & bm
    if isinstance(expr, E.BitwiseNot):
        v, m = ev(expr.child)
        return ~np.asarray(v), m
    if isinstance(expr, E.ShiftLeft):
        (x, xm), (s, sm) = ev(expr.left), ev(expr.right)
        return _shift(expr, x, s), xm & sm
    if isinstance(expr, E.Murmur3Hash):
        kids = [ev(c) for c in expr.children]
        return (engine_hash(kids, expr.children, n, expr.VARIANT),
                np.ones(n, np.bool_))
    if isinstance(expr, E.Rand):
        return rand(expr.seed, n), np.ones(n, np.bool_)
    if isinstance(expr, E.Greatest):
        return _greatest(expr, [ev(c) for c in expr.children])
    raise NotImplementedError(
        f"expression {kind.__name__} is not in the CPU engine yet")
