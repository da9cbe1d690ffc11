"""The scalar function families on the device (counterpart of the math,
rounding, bitwise and hash branches of spark_rapids_tpu/exprs/eval.py):
torch operations over ``(data, validity)`` values, no hand kernel (the
reference computes all of them in ``jnp``). ``plan/cpu_math.py`` is the
CPU engine's numpy counterpart; the two agree bit for bit except the
transcendental functions, which libdevice, numpy and XLA round within a
few ulps of each other.

- The unary math family reads a number or decimal as its double: Log,
  Log10 and Log2 are null where x <= 0 and Log1p where x <= -1; Sqrt of a
  negative is NaN; Cot, Sec and Csc are 1/tan, 1/cos and 1/sin; Cbrt is
  sign(x) * |x|**(1/3); Signum keeps NaN (``torch.sign`` would give 0).
- Floor and Ceil of a double go through Java's ``(long)``
  (``double_to_integral``: NaN 0, saturating); of an integer they widen.
- Round and BRound of a double round the decimal text of its shortest
  representation, as Spark's ``BigDecimal(d).setScale`` does, without
  formatting it (``round_fractional``); of an integer at a negative scale
  HALF_UP (or HALF_EVEN) to a multiple of 10**-scale in int64, wrapping
  into the type.
- Factorial gathers from a 21-entry table (null outside 0..20); BitCount
  is a SWAR popcount of the value sign-extended to int64 (torch has no
  popcount); shifts mask their count by 31 or 63 first (a shift by the
  width or more is undefined on the card) and ShiftRightUnsigned of a
  BIGINT is an arithmetic shift masked to its low 64 - n bits (torch's CPU
  has no uint64 ``>>``).
- Murmur3Hash and XxHash64 are ``kernels.hash_keys``'s splitmix64 mix of
  each argument (a dictionary string hashes its entries once, gathered by
  code; a null mixes ``_NULL_HASH``), so the hash column of a key equals
  the key hash of a join or an exchange on it.
- Rand is the splitmix64 of (seed * golden ratio + row index in the
  batch), its top 53 bits over 2**53.
- Greatest and Least fold their values (``resolve`` has cast them to one
  type) keeping the first of equals, NaN above every double, DECIMAL128
  by its 128-bit order, nulls skipped.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import int128 as I128
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exprs import expr as E

Pair = Tuple[torch.Tensor, torch.Tensor]

_FACTORIALS = [math.factorial(i) for i in range(21)]
# 2**52: a double at or past it (times 10**scale) has no fraction to round
_NO_FRACTION = float(1 << 52)
_NO_FRACTION_F32 = float(1 << 23)


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c rounded once, as IEEE division is. A Python number divisor
    would not do: torch's CUDA division by a host scalar multiplies by its
    reciprocal, an ulp off (1 / 10**2 is not exact)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def as_double(data: torch.Tensor, dt: T.DataType) -> torch.Tensor:
    """A number or decimal as float64: a decimal's unscaled value over
    10**scale, rounded once (the double nearest the decimal when the
    unscaled value is below 2^53). DECIMAL128 limbs convert their
    magnitude, hi * 2^64 + lo (read unsigned), then take the sign: the
    reference adds the signed limbs, which cancels catastrophically for a
    small negative value (hi = -1, lo near 2^64: -1.5 at scale 2 reads as
    0.0), where the magnitude keeps every value within a few ulps of its
    exact double."""
    if not isinstance(dt, T.DecimalType):
        return data.double()
    if data.dim() == 2:
        hi, lo = I128.abs_(*I128.split(data))
        mag = (hi.double() * 2.0 ** 64 + lo.double()
               + (lo < 0).double() * 2.0 ** 64)
        return divide(torch.where(data[:, 1] < 0, -mag, mag),
                      10.0 ** dt.scale)
    return divide(data.double(), 10.0 ** dt.scale)


def double_to_integral(d: torch.Tensor, dst: T.DataType) -> torch.Tensor:
    """Java's (int)/(long) of a double, Spark's non-ANSI cast: NaN is 0,
    values at or past the type's range saturate at its min/max (infinities
    included), the rest truncate toward zero. The bounds are exact powers
    of two: the type's max itself does not round-trip through a double."""
    info = torch.iinfo(dst.torch_dtype)
    hi = float(2 ** (info.bits - 1))
    over, under = d >= hi, d < -hi
    inside = torch.where(torch.isnan(d) | over | under,
                         torch.zeros_like(d), d)
    out = torch.trunc(inside).to(dst.torch_dtype)
    out = torch.where(over, torch.full_like(out, info.max), out)
    return torch.where(under, torch.full_like(out, info.min), out)


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


_UNARY = {E.Sqrt: torch.sqrt, E.Cbrt: _cbrt, E.Exp: torch.exp,
          E.Expm1: torch.expm1, E.Sin: torch.sin, E.Cos: torch.cos,
          E.Tan: torch.tan, E.Cot: lambda x: 1.0 / torch.tan(x),
          E.Sec: lambda x: 1.0 / torch.cos(x),
          E.Csc: lambda x: 1.0 / torch.sin(x), E.Asin: torch.asin,
          E.Acos: torch.acos, E.Atan: torch.atan, E.Sinh: torch.sinh,
          E.Cosh: torch.cosh, E.Tanh: torch.tanh, E.Asinh: torch.asinh,
          E.Acosh: torch.acosh, E.Atanh: torch.atanh,
          E.ToDegrees: torch.rad2deg, E.ToRadians: torch.deg2rad,
          E.Rint: torch.round}
# logarithms: (function, the least x that has a value)
_LOGS = {E.Log: (torch.log, 0.0), E.Log10: (torch.log10, 0.0),
         E.Log2: (torch.log2, 0.0), E.Log1p: (torch.log1p, -1.0)}
_BINARY = {E.Atan2: torch.atan2, E.Hypot: torch.hypot, E.Pow: torch.pow}


def split(a: torch.Tensor):
    """Dekker's split of a double into two halves of 26 bits."""
    c = 134217729.0 * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: float):
    """a * b as an unevaluated sum hi + lo, exact (no fused multiply-add:
    Dekker's product), for |a * b| below 2**1000."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(torch.full_like(a, b))
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def round_fractional(x: torch.Tensor, scale: int,
                     half_even: bool) -> torch.Tensor:
    """Spark's round/bround of a float or double: the decimal text of x's
    shortest representation (Java's ``Double.toString``, ``Float.toString``
    for a float) rounded at ``scale`` and read back.

    With y = |x| * 10**scale split exactly into k + frac, the text rounds
    as the exact value does unless the tie point h = (k + 1/2) / 10**scale
    converts to x itself: then h is the shortest text (no other decimal of
    its length is that close while |y| < 2**40), and the tie decides by
    the mode. Exact for |y| < 2**40 and scale in [-22, 22] (10**scale a
    double); x with |y| >= 2**52 has no fraction at that scale and is
    returned as it is, as are NaN and the infinities."""
    is_f32 = x.dtype == torch.float32
    d = x.double()
    fin = torch.isfinite(d)
    a = torch.where(fin, d.abs(), torch.zeros_like(d))
    if scale >= 0:
        p = 10.0 ** scale
        hi, lo = _two_prod(a, p)
        k = torch.floor(hi)
        frac = (hi - k) + lo
        y = hi
    else:
        q = 10.0 ** -scale
        k = torch.floor(divide(a, q))
        frac = divide(a - k * q, q)
        y = divide(a, q)
    # frac in [0, 1) after the floor's rounding is corrected
    under, over = frac < 0, frac >= 1
    k = k - under.double() + over.double()
    frac = frac + under.double() - over.double()
    if scale >= 0:
        h = divide(2.0 * k + 1.0, 2.0 * p)
    else:
        h = (2.0 * k + 1.0) * q / 2.0
    if is_f32:
        tie = h.float() == a.float()
    else:
        tie = h == a
    odd = torch.remainder(k, 2.0) == 1.0
    up = torch.where(tie, odd if half_even else torch.ones_like(tie),
                     frac > 0.5)
    r = k + up.double()
    out = divide(r, p) if scale >= 0 else r * q
    out = torch.where(d < 0, -out, out)
    limit = _NO_FRACTION_F32 if is_f32 else _NO_FRACTION
    keep = ~fin | (y >= limit)
    out = torch.where(keep, d, out)
    return out.float() if is_f32 else out


def round_integral(x: torch.Tensor, scale: int,
                   half_even: bool) -> torch.Tensor:
    """An integer rounded at a negative ``scale`` to a multiple of
    10**-scale (HALF_UP away from zero, or HALF_EVEN) in int64, wrapping
    into x's type as Java's ``BigDecimal.longValue`` does."""
    if scale >= 0:
        return x
    a = x.long()
    k = -scale
    if k >= 19:
        # the multiples within reach are 0 and +-10**19, wrapped; only a
        # BIGINT reaches 5 * 10**18 (a tie there goes to 0 under
        # HALF_EVEN)
        if k > 19 or x.dtype != torch.int64:
            return torch.zeros_like(x)
        half = 5 * 10 ** 18
        far = (a > half) | (a < -half)
        if not half_even:
            far = far | (a == half) | (a == -half)
        wrapped = torch.full_like(a, K._s64(10 ** 19))
        return torch.where(far, torch.where(a < 0, -wrapped, wrapped),
                           torch.zeros_like(a))
    q = 10 ** k
    fl = torch.div(a, q, rounding_mode="floor")
    rem = a - fl * q
    tie = 2 * rem == q
    if half_even:
        up = (2 * rem > q) | (tie & (torch.remainder(fl, 2) == 1))
    else:
        up = (2 * rem > q) | (tie & (a > 0))
    return ((fl + up.long()) * q).to(x.dtype)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 bit patterns (SWAR, logical shifts)."""
    x = x - (K._lsr(x, 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + (K._lsr(x, 2) & 0x3333333333333333)
    x = (x + K._lsr(x, 4)) & 0x0F0F0F0F0F0F0F0F
    return K._lsr(x * 0x0101010101010101, 56)


def _shift(expr: E.ShiftLeft, x: torch.Tensor,
           n: torch.Tensor) -> torch.Tensor:
    bits = 64 if x.dtype == torch.int64 else 32
    sh = n.long() & (bits - 1)
    if isinstance(expr, E.ShiftRightUnsigned):
        if bits == 32:
            return ((x.long() & 0xFFFFFFFF) >> sh).to(x.dtype)
        # the low 64 - sh bits of the arithmetic shift (all of them when
        # sh is 0, where the mask's own shift would be by 64)
        width = torch.where(sh == 0, torch.ones_like(sh), 64 - sh)
        mask = torch.where(sh == 0, torch.full_like(sh, -1),
                           ~(torch.full_like(sh, -1) << width))
        return (x >> sh) & mask
    if isinstance(expr, E.ShiftRight):
        return (x.long() >> sh).to(x.dtype)
    return (x.long() << sh).to(x.dtype)


def column_hash(v, dt: T.DataType, variant: int) -> torch.Tensor:
    """One argument's 64-bit hash word as ``kernels.hash_keys`` mixes it
    (before the null word)."""
    salt = K._s64(K._INT_SALT[variant])
    if dt == T.STRING:
        if v.is_dict:
            return K._string_hash(v.dictionary, variant)[v.data.long()]
        return K._string_hash(v, variant)
    if dt in T.FRACTIONAL_TYPES:
        return K._splitmix64(K._float_hash_key(v.data) ^ salt)
    if v.data.dim() == 2:  # DECIMAL128: both limbs
        hi, lo = I128.split(v.data)
        return K._splitmix64(K._splitmix64(K._int_sortable(lo) ^ salt) + hi)
    return K._splitmix64(K._int_sortable(v.data) ^ salt)


def rand(seed: int, n: int, device) -> torch.Tensor:
    """rand(seed) of rows 0..n-1 of a batch."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    h = K._splitmix64(idx + K._s64(seed * 0x9E3779B97F4A7C15))
    return K._lsr(h, 11).double() / float(1 << 53)


def _extreme(expr: E.Greatest, vals) -> Pair:
    is_max = not isinstance(expr, E.Least)
    acc, av = vals[0]
    for d, v in vals[1:]:
        if d.dim() == 2:
            ah, al = I128.split(acc)
            bh, bl = I128.split(d)
            newer = (I128.cmp_lt(ah, al, bh, bl) if is_max
                     else I128.cmp_lt(bh, bl, ah, al))
        else:
            a, b = acc, d
            if a.is_floating_point():  # NaN above every value
                a = torch.where(torch.isnan(a), torch.full_like(a, math.inf),
                                a)
                b = torch.where(torch.isnan(b), torch.full_like(b, math.inf),
                                b)
            newer = b > a if is_max else b < a
        take = torch.where(av, newer & v, v)
        acc = torch.where(take[:, None] if d.dim() == 2 else take, d, acc)
        av = av | v
    return acc, av


def eval_scalar(expr: E.Expression, ev: Callable, n: int, device) -> Pair:
    """(data, validity) of one of the scalar functions that
    ``exprs/eval.py`` hands here (not the division family, EqualNullSafe,
    NullIf and Nvl2, which it evaluates itself)."""
    kind = type(expr)
    if kind in _UNARY or kind in _LOGS or kind is E.Signum:
        d, v = ev(expr.child)
        x = as_double(d, expr.child.dtype)
        if kind in _LOGS:
            fn, least = _LOGS[kind]
            ok = x > least
            return fn(torch.where(ok, x, torch.ones_like(x))), v & ok
        if kind is E.Signum:
            return torch.where(torch.isnan(x), x, torch.sign(x)), v
        return _UNARY[kind](x), v
    if kind in _BINARY:
        (a, av), (b, bv) = ev(expr.left), ev(expr.right)
        return _BINARY[kind](as_double(a, expr.left.dtype),
                             as_double(b, expr.right.dtype)), av & bv
    if isinstance(expr, E.Floor):
        d, v = ev(expr.child)
        if not d.is_floating_point():
            return d.long(), v
        f = torch.ceil if isinstance(expr, E.Ceil) else torch.floor
        return double_to_integral(f(d.double()), T.LONG), v
    if isinstance(expr, E.Round):
        d, v = ev(expr.child)
        if d.is_floating_point():
            return round_fractional(d, expr.scale, expr.HALF_EVEN), v
        return round_integral(d, expr.scale, expr.HALF_EVEN), v
    if isinstance(expr, E.Positive):
        return ev(expr.child)
    if isinstance(expr, E.Factorial):
        d, v = ev(expr.child)
        k = d.long()
        ok = (k >= 0) & (k <= 20)
        table = torch.tensor(_FACTORIALS, dtype=torch.int64, device=device)
        return table[k.clamp(0, 20)], v & ok
    if isinstance(expr, E.BitCount):
        d, v = ev(expr.child)
        return _popcount64(d.long()).int(), v
    if isinstance(expr, E.BitGet):
        (x, xv), (pos, pv) = ev(expr.left), ev(expr.right)
        bits = 8 * x.element_size() if x.dtype != torch.bool else 1
        p = pos.long()
        ok = (p >= 0) & (p < bits)
        bit = (x.long() >> p.clamp(0, 63)) & 1
        return bit.to(torch.int8), xv & pv & ok
    if isinstance(expr, (E.BitwiseAnd, E.BitwiseOr, E.BitwiseXor)):
        (a, av), (b, bv) = ev(expr.left), ev(expr.right)
        dt = expr.dtype.torch_dtype
        a, b = a.to(dt), b.to(dt)
        out = (a & b if isinstance(expr, E.BitwiseAnd)
               else a | b if isinstance(expr, E.BitwiseOr) else a ^ b)
        return out, av & bv
    if isinstance(expr, E.BitwiseNot):
        d, v = ev(expr.child)
        return ~d, v
    if isinstance(expr, E.ShiftLeft):
        (x, xv), (s, sv) = ev(expr.left), ev(expr.right)
        return _shift(expr, x, s), xv & sv
    if isinstance(expr, E.Murmur3Hash):
        h = torch.zeros(n, dtype=torch.int64, device=device)
        for c in expr.children:
            val = ev(c)
            ch = torch.where(val.validity, column_hash(val, c.dtype,
                                                       expr.VARIANT),
                             torch.full_like(h, K._s64(K._NULL_HASH)))
            h = K._splitmix64(h * K._s64(K._COMBINE_MULT[expr.VARIANT])
                              + ch)
        return h, torch.ones(n, dtype=torch.bool, device=device)
    if isinstance(expr, E.Rand):
        return rand(expr.seed, n, device), torch.ones(n, dtype=torch.bool,
                                                      device=device)
    if isinstance(expr, E.Greatest):
        return _extreme(expr, [tuple(ev(c)) for c in expr.children])
    raise NotImplementedError(f"expression {kind.__name__} is not in the "
                              f"port yet")
