"""Expression evaluation over device batches (counterpart of
spark_rapids_tpu/exprs/eval.py for the port's expression nodes).

A value is ``ColVal(data, validity)`` for fixed-width results, or a
string column (dictionary or plain) for string results; string equality
against a literal, ``IN`` over string literals and LIKE compare or match
the dictionary's entries once and gather the answer by code. Equality of
two string columns compares codes when both share one dictionary, and
bytes otherwise (``kernels.strings_equal``). A projected string literal
is a column over a one-entry dictionary.

Substring works on bytes, as the reference's device path does (equal to
Spark's character semantics on ASCII text). Over a plain column it gathers
each row's window of bytes; over a dictionary column it cuts every entry
once and re-encodes the cut entries (``kernels.dictionary_unique``): equal
cuts of different entries share one code, and the new dictionary is
sorted, so grouping, joining and sorting on codes stay exact.

And, Or and Not follow Spark's three-valued logic; ``x IN (items)`` is the
OR of ``x = item`` under the same logic (null when x is null, or when
nothing matches and some item is null).

If, CaseWhen and Coalesce select per row with ``torch.where`` over their
branches' data and validity (``resolve`` has given every value branch the
conditional's type). A null predicate takes the else branch. String
branches that share one dictionary select codes and keep it; otherwise the
branches are decoded and each row's length and bytes are gathered from the
branch it takes.

Decimals are int64 unscaled values (DECIMAL64) or ``(n, 2)`` int64
``[lo, hi]`` limbs (DECIMAL128, ``exec/int128.py``). Add/Subtract rescale
both operands to the result scale, Multiply multiplies the unscaled values
(the result scale is the sum of the operand scales); a decimal meeting a
double is cast to double first (unscaled / 10**scale in float64; limbs as
hi * 2^64 + lo). A result or operand of DECIMAL128 takes the 128-bit path
(``_eval_arith_wide``): operands rescaled with the overflow check made
before the multiply, a narrow x narrow product through ``mul_64x64``,
wider ones through ``mul_128_exact``, and every decimal Divide through
``decimal_divide_128`` (HALF_UP at the result scale); a result at or past
10**precision, and a zero divisor, give null (Spark's non-ANSI answer).
Comparisons of decimals with decimals or integers are exact at mixed
scales: the finer side is floor-divided down to the coarser scale and its
remainder breaks ties, so nothing is scaled up and nothing can overflow.

Divide of doubles or integers is a double, null where the divisor is zero
(Spark's non-ANSI Divide; the reference's engines give IEEE inf/NaN for a
fractional ``x / 0.0``, a known difference). Abs and UnaryMinus negate in
place (integers wrap, as Java's).

Casts follow the reference's non-ANSI ``cast_val`` (``_eval_cast``; the
pairs of ``E.cast_supported``): a narrowing integer cast wraps, a float
becomes an integer as Java's ``(int)``/``(long)`` (``double_to_integral``,
saturating at the target's range), a decimal keeps its whole part; into
DECIMAL64 an integer or decimal rescales (null past the precision,
checked before the product), anything else goes through a double,
HALF_UP. Casts into and out of DECIMAL128 (``_cast_wide``) rescale up
with the overflow check, round HALF_UP down (by at most 18 digits), and
null what does not fit the target; a float scales in float64 and splits
at 2^64. Dates and timestamps cast as the reference's: midnight, floor
to the day, seconds to and from BIGINT.

Casts to and from strings are ``exprs/cast_strings.py``'s: a dictionary
column is parsed through its dictionary once and the values gathered by
code, a plain column from its bytes; a value becomes a plain column.

IntegralDivide, Remainder and Pmod of numbers follow Java (truncated
division, the dividend's sign; Spark's pmod adds the divisor only to a
negative remainder): a zero divisor (or a NaN one) gives null, the divisor
is replaced before torch divides (its CPU integer division raises on 0),
and ``Long.MIN_VALUE div -1`` (a trap on the card's integer division)
divides by 1 instead, which is its wrapped answer. EqualNullSafe is
equality with null equal to null; NullIf nulls the rows where its sides
are equal; Nvl2 selects by the first value's nullness. The other scalar
functions are ``exprs/math.py``'s.

IsNaN and Nanvl read floats; the date-and-time functions are
``exprs/datetime.py``'s.

The string family and RLIKE (``_eval_string_fn``) run the byte kernels
of ``exprs/strings.py`` and the DFA of ``exprs/regex.py``. A function of
one string column runs over a dictionary column's entries once: a string
result is re-encoded (``kernels.dictionary_unique``), a number or a
boolean gathered by code, and BINARY (Unhex, UnBase64) gathered into a
plain column. Functions of several strings (Concat, ConcatWs, Overlay)
decode their inputs first. Left/Right and Overlay with a FOR length are
Substring and Concat, as the reference rewrites them; StartsWith,
EndsWith and Contains take a literal pattern.

BINARY is a plain string column and goes where strings go (a BINARY
literal is a plain column, never a dictionary); a cast between BINARY and
STRING keeps the bytes. A STRUCT, MAP or ARRAY value is a ``NestedVal``,
the column itself: a struct field is its child (null where the struct
is), map_keys the map's offsets over its key child, size the offsets'
differences, element_at a gather at an entry position (a map's, the first
entry whose key equals the probe, a per-row minimum over the entries),
array_contains a per-row count of the element matches; get_json_object
is ``exprs/json_device.py``'s, its paths over one column sharing one
structure pass.
"""

from __future__ import annotations

import decimal
from typing import List, NamedTuple, Sequence, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import int128 as I128
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exprs import cast_strings as CS
from spark_rapids_tpu_torch.exprs import datetime as DT
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import json_device as JD
from spark_rapids_tpu_torch.exprs import math as MATH
from spark_rapids_tpu_torch.exprs import regex as RX
from spark_rapids_tpu_torch.exprs import strings as S


class ColVal(NamedTuple):
    data: torch.Tensor
    validity: torch.Tensor


class NestedVal(NamedTuple):
    """A STRUCT, MAP or ARRAY value: the device column itself (its
    struct-of-columns or offsets-and-children layout is the value)."""

    col: DeviceColumn

    @property
    def validity(self) -> torch.Tensor:
        return self.col.validity


Val = Union[ColVal, DeviceColumn, NestedVal]

_STRINGY = (T.STRING, T.BINARY)


class EvalContext:
    def __init__(self, batch: ColumnarBatch):
        self.batch = batch
        self.num_rows = batch.num_rows
        self.device = batch.columns[0].device
        # a JSON column's structure, shared by the paths read from it
        self.json: dict = {}


def _broadcast_literal(lit: E.Literal, ctx: EvalContext) -> ColVal:
    n = ctx.num_rows
    dt = lit.dtype
    if dt in _STRINGY:
        return _string_value(lit, ctx)
    if lit.value is None:
        return ColVal(torch.zeros(T.device_shape(dt, n), dtype=dt.torch_dtype,
                                  device=ctx.device),
                      torch.zeros(n, dtype=torch.bool, device=ctx.device))
    value = lit.value
    ones = torch.ones(n, dtype=torch.bool, device=ctx.device)
    if isinstance(dt, T.DecimalType):
        value = decimal_unscaled(value, dt.scale)
        if dt.is_wide:
            limbs = I128.pack(*I128.from_py_ints([value], ctx.device))
            return ColVal(limbs.expand(n, 2), ones)
    return ColVal(torch.full((n,), value, dtype=dt.torch_dtype,
                             device=ctx.device), ones)


def decimal_unscaled(value, scale: int) -> int:
    """The unscaled integer of a decimal literal (value * 10**scale; exact,
    HALF_UP past the scale)."""
    with decimal.localcontext() as c:
        c.prec = 50
        return int(decimal.Decimal(str(value) if isinstance(value, float)
                                   else value).scaleb(scale).quantize(
            decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP))


def _is_wide(v: ColVal) -> bool:
    return v.data.dim() == 2


def _wide_parts(v: ColVal):
    """(hi, lo) of a decimal or integral value (an int64 sign-extended)."""
    if _is_wide(v):
        return I128.split(v.data)
    return I128.from_i64(v.data)


def _as_wide(v: ColVal, dt: T.DataType, to_scale: int):
    """A decimal or integral value as (hi, lo) limbs at ``to_scale``."""
    h, l = _wide_parts(v)
    if to_scale > _scale_of(dt):
        h, l = I128.rescale10(h, l, to_scale - _scale_of(dt))
    return h, l


def _as_wide_checked(v: ColVal, dt: T.DataType, to_scale: int,
                     precision: int):
    """``_as_wide`` with the rescale's overflow flagged (a wrapped rescale
    would dodge the result's overflow check): (hi, lo, overflow)."""
    h, l = _wide_parts(v)
    if to_scale > _scale_of(dt):
        return I128.rescale10_checked(h, l, to_scale - _scale_of(dt),
                                      precision)
    return h, l, torch.zeros_like(h, dtype=torch.bool)


def _wide_result(h, l, ovf, valid, out_t: T.DecimalType) -> ColVal:
    """A DECIMAL128 (or, for a narrow Divide, DECIMAL64) result: null
    where it overflowed."""
    ok = valid & ~ovf
    if out_t.is_wide:
        return ColVal(K.where_valid(ok, I128.pack(h, l)), ok)
    return ColVal(K.where_valid(ok, l), ok)


def _scale_of(dt: T.DataType) -> int:
    """Scale of a decimal operand; an integral one is decimal(d, 0)."""
    return dt.scale if isinstance(dt, T.DecimalType) else 0


def _string_equals_literal(c: DeviceColumn, value: str) -> torch.Tensor:
    """Per-row byte equality of a string column with one literal."""
    if c.is_dict:
        return _string_equals_literal(c.dictionary, value)[c.data.long()]
    raw = value if isinstance(value, bytes) else value.encode("utf-8")
    lens = c.lengths()
    eq = lens == len(raw)
    starts = c.offsets[:-1].long()
    limit = max(c.data.numel() - 1, 0)
    for k, byte in enumerate(raw):
        if c.data.numel() == 0:
            return torch.zeros_like(eq)
        pos = torch.clamp(starts + k, max=limit)
        eq = eq & (c.data[pos] == byte)
    return eq


def _nan_aware_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spark ordering: NaN is greater than everything."""
    if a.is_floating_point():
        an, bn = torch.isnan(a), torch.isnan(b)
        return torch.where(an, torch.zeros_like(an),
                           torch.where(bn, ~an, a < b))
    return a < b


def _compare_result(expr: E.BinaryComparison, lt_m: torch.Tensor,
                    eq_m: torch.Tensor, valid: torch.Tensor) -> ColVal:
    """A comparison from its less-than and equal masks."""
    if isinstance(expr, E.EqualTo):
        return ColVal(eq_m, valid)
    if isinstance(expr, E.LessThan):
        return ColVal(lt_m, valid)
    if isinstance(expr, E.LessThanOrEqual):
        return ColVal(lt_m | eq_m, valid)
    if isinstance(expr, E.GreaterThan):
        return ColVal(~lt_m & ~eq_m, valid)
    if isinstance(expr, E.GreaterThanOrEqual):
        return ColVal(~lt_m, valid)
    raise NotImplementedError(type(expr).__name__)


def _decimal_compare(expr: E.BinaryComparison, l: ColVal, r: ColVal,
                     lt: T.DataType, rt: T.DataType) -> ColVal:
    """Exact comparison of decimal/integral operands at mixed scales."""
    da, sa = l.data.long(), _scale_of(lt)
    db, sb = r.data.long(), _scale_of(rt)
    if sa == sb:
        lt_m, eq_m = da < db, da == db
    elif sa > sb:
        q = torch.div(da, 10 ** (sa - sb), rounding_mode="floor")
        rm = da - q * 10 ** (sa - sb)
        lt_m, eq_m = q < db, (q == db) & (rm == 0)
    else:
        q = torch.div(db, 10 ** (sb - sa), rounding_mode="floor")
        rm = db - q * 10 ** (sb - sa)
        lt_m = (da < q) | ((da == q) & (rm > 0))
        eq_m = (da == q) & (rm == 0)
    return _compare_result(expr, lt_m, eq_m, l.validity & r.validity)


def _wide_floor_div_pow10(h, l, k: int):
    """FLOOR((hi, lo) / 10^k) and a remainder-nonzero flag, for the
    overflow-free comparison at mixed scales."""
    ah, al = I128.abs_(h, l)
    neg = I128.is_neg(h, l)
    rem_any = torch.zeros_like(h, dtype=torch.bool)
    while k > 0:
        step = min(k, 9)
        ah, al, rr = I128._udivmod_small(ah, al, 10 ** step)
        rem_any = rem_any | (rr != 0)
        k -= step
    # floor of a negative: -(q + (remainder ? 1 : 0))
    nh, nl = I128.neg(ah, al)
    nh, nl = I128.sub(nh, nl, torch.zeros_like(nh), rem_any.long())
    return torch.where(neg, nh, ah), torch.where(neg, nl, al), rem_any


def _compare_wide(expr: E.BinaryComparison, l: ColVal, r: ColVal,
                  lt: T.DataType, rt: T.DataType) -> ColVal:
    """Exact comparison where an operand is DECIMAL128, at mixed scales
    without scaling anything up."""
    sa, sb = _scale_of(lt), _scale_of(rt)
    ah, al = _as_wide(l, lt, sa)
    bh, bl = _as_wide(r, rt, sb)
    if sa == sb:
        lt_m, eq_m = I128.cmp_lt(ah, al, bh, bl), I128.cmp_eq(ah, al, bh, bl)
    elif sa > sb:
        qh, ql, rem = _wide_floor_div_pow10(ah, al, sa - sb)
        lt_m = I128.cmp_lt(qh, ql, bh, bl)
        eq_m = I128.cmp_eq(qh, ql, bh, bl) & ~rem
    else:
        qh, ql, rem = _wide_floor_div_pow10(bh, bl, sb - sa)
        eq0 = I128.cmp_eq(ah, al, qh, ql)
        lt_m = I128.cmp_lt(ah, al, qh, ql) | (eq0 & rem)
        eq_m = eq0 & ~rem
    return _compare_result(expr, lt_m, eq_m, l.validity & r.validity)


def _validity_of(expr: E.Expression, ctx: EvalContext) -> torch.Tensor:
    """The validity of one operand (a literal's without building it)."""
    if isinstance(expr, E.Literal):
        return torch.full((ctx.num_rows,), expr.value is not None,
                          dtype=torch.bool, device=ctx.device)
    return eval_expr(expr, ctx).validity


def _eval_compare(expr: E.BinaryComparison, ctx: EvalContext) -> ColVal:
    if isinstance(expr, E.EqualNullSafe):
        eq = _eval_compare(E.EqualTo(expr.left, expr.right), ctx)
        neither = ~_validity_of(expr.left, ctx) & ~_validity_of(expr.right,
                                                               ctx)
        return ColVal((eq.data & eq.validity) | neither,
                      torch.ones_like(neither))
    if expr.left.dtype in _STRINGY or expr.right.dtype in _STRINGY:
        if not isinstance(expr, E.EqualTo):
            raise NotImplementedError("string ordering comparison")
        col_side, lit_side = expr.left, expr.right
        if isinstance(col_side, E.Literal):
            col_side, lit_side = lit_side, col_side
        if not isinstance(lit_side, E.Literal):
            a, b = eval_expr(expr.left, ctx), eval_expr(expr.right, ctx)
            return ColVal(K.strings_equal(a, b), a.validity & b.validity)
        c = eval_expr(col_side, ctx)
        if lit_side.value is None:
            return ColVal(torch.zeros_like(c.validity),
                          torch.zeros_like(c.validity))
        return ColVal(_string_equals_literal(c, lit_side.value), c.validity)
    l = eval_expr(expr.left, ctx)
    r = eval_expr(expr.right, ctx)
    lt, rt = expr.left.dtype, expr.right.dtype
    valid = l.validity & r.validity
    if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
        if E.decimal_operands(lt, rt) is not None:
            if _is_wide(l) or _is_wide(r):
                return _compare_wide(expr, l, r, lt, rt)
            return _decimal_compare(expr, l, r, lt, rt)
        # decimal against a double: both sides as double
        a = (MATH.as_double(l.data, lt) if isinstance(lt, T.DecimalType)
             else l.data.double())
        b = (MATH.as_double(r.data, rt) if isinstance(rt, T.DecimalType)
             else r.data.double())
        return _compare_result(expr, _nan_aware_lt(a, b), a == b, valid)
    a, b = l.data, r.data
    if {lt, rt} == {T.DATE, T.TIMESTAMP}:
        # Spark compares a date as its midnight
        a, b = (x.long() * 86_400_000_000 if t == T.DATE else x
                for x, t in ((a, lt), (b, rt)))
    elif lt != rt:
        ct = E.numeric_widen(lt, rt)
        a, b = a.to(ct.torch_dtype), b.to(ct.torch_dtype)
    eq = a == b
    if a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    # Spark orders NaN above every value and equal to itself
    return _compare_result(expr, _nan_aware_lt(a, b), eq, valid)


def _eval_arith_wide(expr: E.BinaryArithmetic, out_t: T.DecimalType, lt,
                     rt, l: ColVal, r: ColVal, valid) -> ColVal:
    """DECIMAL128 Add/Subtract/Multiply, and every decimal Divide, over
    (hi, lo) limbs; overflow and a zero divisor give null."""
    s1, s2 = _scale_of(lt), _scale_of(rt)
    if isinstance(expr, (E.Add, E.Subtract)):
        s = out_t.scale
        ah, al, ovf_l = _as_wide_checked(l, lt, s, out_t.precision)
        bh, bl, ovf_r = _as_wide_checked(r, rt, s, out_t.precision)
        op = I128.add if isinstance(expr, E.Add) else I128.sub
        h, lo = op(ah, al, bh, bl)
        ovf = I128.overflow_mask(h, lo, out_t.precision) | ovf_l | ovf_r
        return _wide_result(h, lo, ovf, valid, out_t)
    if isinstance(expr, E.Multiply):
        # the result scale is s1 + s2: the product of the unscaled values
        if not _is_wide(l) and not _is_wide(r):
            h, lo = I128.mul_64x64(l.data, r.data)
            ovf = I128.overflow_mask(h, lo, out_t.precision)
        else:
            h, lo, ovf = I128.mul_128_exact(*_as_wide(l, lt, s1),
                                            *_as_wide(r, rt, s2),
                                            out_t.precision)
        return _wide_result(h, lo, ovf, valid, out_t)
    if isinstance(expr, E.Divide):
        # HALF_UP(a * 10^(s_out - s1 + s2) / b), plan/overrides gating the
        # rescale to [0, 76]
        k = out_t.scale - s1 + s2
        h, lo, ovf = I128.decimal_divide_128(*_as_wide(l, lt, s1),
                                             *_as_wide(r, rt, s2), k,
                                             out_t.precision)
        return _wide_result(h, lo, ovf, valid, out_t)
    raise NotImplementedError(f"decimal128 {expr.symbol}")


_INT64_MIN = torch.iinfo(torch.int64).min


def _java_rem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a % b of int64s with the dividend's sign; b is never 0 (x % -1 is
    0, computed as x % 1: the card's MIN % -1 traps)."""
    safe = torch.where(b == -1, torch.ones_like(b), b)
    return a - torch.div(a, safe, rounding_mode="trunc") * safe


def _eval_division(expr: E.BinaryArithmetic, l: ColVal, r: ColVal,
                   valid: torch.Tensor) -> ColVal:
    """IntegralDivide, Remainder and Pmod of numbers (see the module
    docstring)."""
    if isinstance(expr, E.IntegralDivide):  # resolve made both BIGINT
        a, b = l.data.long(), r.data.long()
        zero = b == 0
        safe = torch.where(zero | ((a == _INT64_MIN) & (b == -1)),
                           torch.ones_like(b), b)
        q = torch.div(a, safe, rounding_mode="trunc")
        return ColVal(torch.where(zero, torch.zeros_like(q), q),
                      valid & ~zero)
    dt = expr.dtype.torch_dtype
    a, b = l.data.to(dt), r.data.to(dt)
    if a.is_floating_point():
        zero = (b == 0) | torch.isnan(b)
        safe = torch.where(zero, torch.ones_like(b), b)
        rem = torch.fmod(a, safe)
        if isinstance(expr, E.Pmod):
            rem = torch.where(rem < 0, torch.fmod(rem + safe, safe), rem)
    else:
        zero = b == 0
        a64 = a.long()
        b64 = torch.where(zero, torch.ones_like(b), b).long()
        rem = _java_rem(a64, b64)
        if isinstance(expr, E.Pmod):
            # (r + b) % b where r < 0, the sum wrapping in the type
            shifted = (rem + b64).to(dt).long()
            rem = torch.where(rem < 0, _java_rem(shifted, b64), rem)
        rem = rem.to(dt)
    return ColVal(torch.where(zero, torch.zeros_like(rem), rem),
                  valid & ~zero)


def _eval_arith(expr: E.BinaryArithmetic, ctx: EvalContext) -> ColVal:
    out_t = expr.dtype
    lt, rt = expr.left.dtype, expr.right.dtype
    l = eval_expr(expr.left, ctx)
    r = eval_expr(expr.right, ctx)
    valid = l.validity & r.validity
    if isinstance(expr, (E.IntegralDivide, E.Remainder)):
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            raise NotImplementedError("decimal division is not on device")
        return _eval_division(expr, l, r, valid)
    if isinstance(out_t, T.DecimalType):
        if (out_t.is_wide or _is_wide(l) or _is_wide(r)
                or isinstance(expr, E.Divide)):
            return _eval_arith_wide(expr, out_t, lt, rt, l, r, valid)
        a, b = l.data.long(), r.data.long()
        if isinstance(expr, E.Multiply):
            return ColVal(a * b, valid)  # result scale = sa + sb
        s = out_t.scale
        a = a * 10 ** (s - _scale_of(lt))
        b = b * 10 ** (s - _scale_of(rt))
        if isinstance(expr, E.Add):
            return ColVal(a + b, valid)
        if isinstance(expr, E.Subtract):
            return ColVal(a - b, valid)
        raise NotImplementedError(f"decimal {type(expr).__name__}")
    # decimal with a double: Spark casts the decimal side to double
    a = (MATH.as_double(l.data, lt) if isinstance(lt, T.DecimalType)
         else l.data).to(out_t.torch_dtype)
    b = (MATH.as_double(r.data, rt) if isinstance(rt, T.DecimalType)
         else r.data).to(out_t.torch_dtype)
    if isinstance(expr, E.Add):
        return ColVal(a + b, valid)
    if isinstance(expr, E.Subtract):
        return ColVal(a - b, valid)
    if isinstance(expr, E.Multiply):
        return ColVal(a * b, valid)
    if isinstance(expr, E.Divide):
        # Spark's non-ANSI Divide: null for any zero divisor, doubles too
        zero = b == 0
        q = a.double() / torch.where(zero, torch.ones_like(b), b).double()
        return ColVal(torch.where(zero, torch.zeros_like(q), q),
                      valid & ~zero)
    raise NotImplementedError(type(expr).__name__)


def _cast_wide(v: ColVal, src: T.DataType, dst: T.DataType) -> ColVal:
    """Casts into or out of DECIMAL128: a rescale up checked for overflow
    before it multiplies, a rescale down rounded HALF_UP (decimals) or
    truncated (integers), then null where the value does not fit."""
    if T.is_wide_decimal(dst) and src in T.FRACTIONAL_TYPES:
        return _float_to_wide(v, dst)
    if T.is_wide_decimal(dst):
        diff = dst.scale - _scale_of(src)
        h, l = _wide_parts(v)
        if diff >= 0:
            h, l, ovf = I128.rescale10_checked(h, l, diff, dst.precision)
        else:
            h, l = _wide_div_pow10_half_up(h, l, -diff)
            ovf = torch.zeros_like(v.validity)
        ovf = ovf | I128.overflow_mask(h, l, dst.precision)
        return _wide_result(h, l, ovf, v.validity, dst)
    if dst in T.FRACTIONAL_TYPES:
        return ColVal(MATH.as_double(v.data, src).to(dst.torch_dtype),
                      v.validity)
    s_dst = _scale_of(dst)
    diff = s_dst - src.scale
    h, l = I128.split(v.data)
    valid = v.validity
    if diff > 0:
        h, l, ovf = I128.rescale10_checked(h, l, diff, 38)
        valid = valid & ~ovf
    elif diff < 0:
        if isinstance(dst, T.DecimalType):
            h, l = _wide_div_pow10_half_up(h, l, -diff)
        else:  # an integral cast truncates toward zero
            ah, al = I128.abs_(h, l)
            k = -diff
            while k > 0:
                step = min(k, 9)
                ah, al, _ = I128._udivmod_small(ah, al, 10 ** step)
                k -= step
            nh, nl = I128.neg(ah, al)
            m = I128.is_neg(h, l)
            h, l = torch.where(m, nh, ah), torch.where(m, nl, al)
    # the value must fit one int64
    valid = valid & (h == torch.where(l < 0, -1, 0))
    if isinstance(dst, T.DecimalType):
        valid = valid & (l.abs() < 10 ** min(dst.precision, 18))
        return ColVal(K.where_valid(valid, l), valid)
    return ColVal(K.where_valid(valid, l).to(dst.torch_dtype), valid)


def _float_to_wide(v: ColVal, dst: T.DecimalType) -> ColVal:
    """A float into DECIMAL128, as the reference's: scaled in float64,
    HALF_UP, split at 2^64 (a double's 53 bits are all it has); NaN,
    infinities and magnitudes of 2^127 or more are null."""
    x = v.data.double() * (10.0 ** dst.scale)
    bad = ~torch.isfinite(x) | (x.abs() >= 2.0 ** 127)
    ax = torch.floor(torch.where(bad, torch.zeros_like(x), x).abs() + 0.5)
    hi_f = torch.floor(ax / 2.0 ** 64)
    lo_f = ax - hi_f * 2.0 ** 64
    # lo_f in [0, 2^64) as the int64 with its bits
    lo = torch.where(lo_f >= 2.0 ** 63, lo_f - 2.0 ** 64, lo_f).long()
    h, l = hi_f.long(), lo
    nh, nl = I128.neg(h, l)
    neg = x < 0
    h, l = torch.where(neg, nh, h), torch.where(neg, nl, l)
    ovf = I128.overflow_mask(h, l, dst.precision)
    return _wide_result(h, l, ovf, v.validity & ~bad, dst)


def _wide_div_pow10_half_up(h, l, k: int):
    """(hi, lo) / 10^k rounded HALF_UP once at the full divisor, 0 < k <=
    18: the steps' remainders at their place values add up exactly in
    int64."""
    assert 0 < k <= 18, "a scale reduction past 18 digits is not on device"
    ah, al = I128.abs_(h, l)
    neg = I128.is_neg(h, l)
    rem = torch.zeros_like(h)
    place, kk = 1, k
    while kk > 0:
        step = min(kk, 9)
        ah, al, rr = I128._udivmod_small(ah, al, 10 ** step)
        rem = rem + rr * place
        place *= 10 ** step
        kk -= step
    up = (2 * rem >= 10 ** k).long()
    qh, ql = I128.add(ah, al, torch.zeros_like(up), up)
    nh, nl = I128.neg(qh, ql)
    return torch.where(neg, nh, qh), torch.where(neg, nl, ql)


def _eval_cast(expr: E.Cast, ctx: EvalContext) -> ColVal:
    src, dst = expr.child.dtype, expr.to
    v = eval_expr(expr.child, ctx)
    if src == dst:
        return v
    if not E.cast_supported(src, dst):
        raise NotImplementedError(f"cast {src} -> {dst} is not in the port "
                                  f"yet")
    if T.BINARY in (src, dst):  # the same bytes under the other type
        if v.is_dict:
            v = K.decode_dictionary(v)
        return DeviceColumn(dst, v.data, v.validity, v.offsets)
    if src == T.STRING:
        if expr.ansi or isinstance(dst, T.DecimalType):
            raise NotImplementedError(f"cast string -> {dst} is the CPU "
                                      f"engine's")
        if v.is_dict:  # parse the dictionary once, gather by code
            data, valid = CS.from_string(v.dictionary, dst)
            codes = v.data.long()
            ok = v.validity & valid[codes]
            return ColVal(K.where_valid(ok, data[codes]), ok)
        return ColVal(*CS.from_string(v, dst))
    if dst == T.STRING:
        if src in T.FRACTIONAL_TYPES:
            raise NotImplementedError("cast of a float to string is the CPU "
                                      "engine's")
        return CS.to_string(v.data, v.validity, src)
    # the reference's cast_val (see E.Cast)
    data, valid = v
    if T.is_wide_decimal(src) or T.is_wide_decimal(dst):
        return _cast_wide(v, src, dst)
    if dst == T.BOOLEAN:
        return ColVal(data != 0, valid)
    if src == T.BOOLEAN:
        return ColVal(data.to(dst.torch_dtype), valid)
    if dst == T.TIMESTAMP:
        scale = 86_400_000_000 if src == T.DATE else 1_000_000
        return ColVal(data.long() * scale, valid)
    if src == T.TIMESTAMP and dst in (T.DATE, T.LONG):
        unit = 86_400_000_000 if dst == T.DATE else 1_000_000
        return ColVal((data // unit).to(dst.torch_dtype), valid)
    if isinstance(dst, T.DecimalType):
        return _cast_to_decimal(data, valid, src, dst)
    if isinstance(src, T.DecimalType):
        if dst in T.FRACTIONAL_TYPES:
            return ColVal(MATH.as_double(data, src).to(dst.torch_dtype),
                          valid)
        # the whole part, then wrap
        return ColVal(torch.div(data, 10 ** src.scale, rounding_mode="trunc")
                      .to(dst.torch_dtype), valid)
    if dst in T.INTEGRAL_TYPES and data.is_floating_point():
        return ColVal(MATH.double_to_integral(data, dst), valid)
    # integers (and a date's days, a timestamp's microseconds) wrap into a
    # narrower integer, or convert to a float
    return ColVal(data.to(dst.torch_dtype), valid)


def _cast_to_decimal(data: torch.Tensor, valid: torch.Tensor,
                     src: T.DataType, dst: T.DecimalType) -> ColVal:
    """Into DECIMAL64: a decimal rescaled (HALF_UP when the scale drops),
    an integer times 10**scale (null past the precision, checked before
    the product), anything else (a float, a date's days, a
    timestamp's microseconds) through a double, HALF_UP at the scale
    (NaN, infinities and values past int64 null); null past the
    precision."""
    if isinstance(src, T.DecimalType) or src in T.INTEGRAL_TYPES:
        diff = dst.scale - _scale_of(src)
        d = data.long()
        if diff >= 0:
            # past the precision before the product can wrap: null
            # (Spark's overflow; the reference's int64 product wraps)
            fits = d.abs() <= (10 ** min(dst.precision, 18) - 1) // 10 ** diff
            valid = valid & fits
            scaled = torch.where(fits, d, torch.zeros_like(d)) * 10 ** diff
        else:
            div = 10 ** -diff
            q = torch.div(d, div, rounding_mode="trunc")
            r = d - q * div
            scaled = q + torch.where(2 * r.abs() >= div, torch.sign(r),
                                     torch.zeros_like(r))
    else:
        shifted = data.double() * (10.0 ** dst.scale)
        bad = ~torch.isfinite(shifted) | (shifted.abs() >= 2.0 ** 63)
        half_up = torch.sign(shifted) * torch.floor(shifted.abs() + 0.5)
        scaled = torch.where(bad, torch.zeros_like(half_up), half_up).long()
        valid = valid & ~bad
    over = scaled.abs() >= 10 ** min(dst.precision, 18)
    return ColVal(torch.where(over, torch.zeros_like(scaled), scaled),
                  valid & ~over)


def _eval_in(expr: E.In, ctx: EvalContext) -> ColVal:
    value = expr.value
    if value.dtype in _STRINGY:
        if not all(isinstance(i, E.Literal) for i in expr.items):
            raise NotImplementedError("string IN over non-literal items")
        c = eval_expr(value, ctx)
        target = c.dictionary if c.is_dict else c
        hit = torch.zeros(target.num_rows, dtype=torch.bool,
                          device=c.device)
        for item in expr.items:
            if item.value is not None:
                hit = hit | _string_equals_literal(target, item.value)
        if c.is_dict:
            hit = hit[c.data.long()]
        hit = hit & c.validity
        if any(i.value is None for i in expr.items):
            return ColVal(hit, hit)
        return ColVal(hit, c.validity)
    v = eval_expr(value, ctx)
    hit = torch.zeros_like(v.validity)
    all_valid = v.validity
    for item in expr.items:
        eq = _eval_compare(E.EqualTo(value, item), ctx)
        hit = hit | (eq.data & eq.validity)
        all_valid = all_valid & eq.validity
    return ColVal(hit, hit | all_valid)


def _substring(expr: E.Substring, ctx: EvalContext) -> DeviceColumn:
    c = eval_expr(expr.child, ctx)
    if not c.is_dict:
        return substring_bytes(c, expr.pos, expr.length)
    entries, remap = K.dictionary_unique(
        substring_bytes(c.dictionary, expr.pos, expr.length))
    return DeviceColumn(T.STRING, remap[c.data.long()], c.validity, None,
                        entries)


def substring_bytes(c: DeviceColumn, pos: int, length: int) -> DeviceColumn:
    """Spark's substringSQL over the bytes of a plain string column: the
    window [start, start + length) from pos (1-based; 0 acts as 1; a
    negative pos counts from the end) clamped into [0, len]. One host
    read: the output's byte count."""
    lens = c.lengths().long()
    if pos > 0:
        raw = torch.full_like(lens, pos - 1)
    elif pos == 0:
        raw = torch.zeros_like(lens)
    else:
        raw = lens + pos
    zero = torch.zeros_like(lens)
    start = torch.minimum(torch.maximum(raw, zero), lens)
    # a length past any row (up to Java's int range) clamps to the row
    end = torch.minimum(torch.maximum(raw + min(length, 1 << 40), zero),
                        lens)
    out_len = torch.clamp(end - start, min=0)
    n = c.num_rows
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=c.device)
    if n:
        offsets[1:] = torch.cumsum(out_len, 0)
    total = int(offsets[-1]) if n else 0
    rows = torch.repeat_interleave(torch.arange(n, device=c.device), out_len,
                                   output_size=total)
    rel = torch.arange(total, device=c.device) - offsets[:-1][rows]
    src = c.offsets[:-1].long()[rows] + start[rows] + rel
    return DeviceColumn(T.STRING, c.data[src], c.validity, offsets.int())


def _null_if(expr: E.NullIf, ctx: EvalContext) -> Val:
    """nullif(a, b): a, null where a = b."""
    a = (_string_value(expr.left, ctx) if expr.dtype in _STRINGY
         else eval_expr(expr.left, ctx))
    eq = _eval_compare(E.EqualTo(expr.left, expr.right), ctx)
    keep = ~(eq.data & eq.validity)
    if expr.dtype not in _STRINGY:
        ok = a.validity & keep
        return ColVal(K.where_valid(ok, a.data), ok)
    if a.is_dict:
        ok = a.validity & keep
        return DeviceColumn(T.STRING, torch.where(ok, a.data,
                                                  torch.zeros_like(a.data)),
                            ok, None, a.dictionary)
    return K.gather_string(a, torch.arange(a.num_rows, device=a.device),
                           keep)


def _like(expr: E.Like, ctx: EvalContext) -> ColVal:
    c = eval_expr(expr.child, ctx)
    dfa = RX.like_to_dfa(expr.pattern, expr.escape)
    if c.is_dict:
        hit = RX.match_strings(dfa, c.dictionary)[c.data.long()]
    else:
        hit = RX.match_strings(dfa, c)
    return ColVal(hit & c.validity, c.validity)


def _map_string(c: DeviceColumn, fn) -> DeviceColumn:
    """A function from a plain string column to a string or bytes column,
    over a dictionary column's entries once: a string result re-encoded
    (``kernels.dictionary_unique``), a BINARY one gathered by code."""
    if not c.is_dict:
        out = fn(c)
        return DeviceColumn(out.dtype, out.data, out.validity & c.validity,
                            out.offsets)
    out = fn(c.dictionary)
    if out.dtype == T.BINARY:
        return K.gather_string(out, c.data, c.validity)
    entries, remap = K.dictionary_unique(out)
    return DeviceColumn(T.STRING, remap[c.data.long()], c.validity, None,
                        entries)


def _map_value(c: DeviceColumn, fn) -> ColVal:
    """A function from a plain string column to one value a row, over a
    dictionary column's entries once and gathered by code."""
    if c.is_dict:
        return ColVal(fn(c.dictionary)[c.data.long()], c.validity)
    return ColVal(fn(c), c.validity)


def _plain_string(expr: E.Expression, ctx: EvalContext) -> DeviceColumn:
    c = _string_value(expr, ctx)
    return K.decode_dictionary(c) if c.is_dict else c


def _eval_string_fn(expr: E.Expression, ctx: EvalContext) -> Val:
    """The string family and RLIKE (``exprs/strings.py``,
    ``exprs/regex.py``); the CPU engine's classes never reach here."""
    kid = expr.children[0]
    if isinstance(expr, (E.Chr, E.Hex)) and kid.dtype in T.INTEGRAL_TYPES:
        v = eval_expr(kid, ctx)
        fn = S.chr_of if isinstance(expr, E.Chr) else S.hex_of_long
        return fn(v.data, v.validity)
    if isinstance(expr, E.Concat):
        return S.concat([_plain_string(k, ctx) for k in expr.children])
    if isinstance(expr, E.ConcatWs):
        ones = torch.ones(ctx.num_rows, dtype=torch.bool, device=ctx.device)
        return S.concat_ws(expr.sep.encode("utf-8"), [
            _plain_string(k, ctx) for k in expr.children], ones)
    if isinstance(expr, E.Overlay):  # an explicit FOR length, pos >= 1
        inp, repl = expr.children
        return eval_expr(E.Concat(
            E.Substring(inp, 1, expr.pos - 1), repl,
            E.Substring(inp, expr.pos + expr.length, 1 << 29)), ctx)
    if isinstance(expr, (E.StringLeft, E.StringRight)):
        n = max(expr.n, 0)
        sub = (E.Substring(kid, 1, n) if type(expr) is E.StringLeft
               else E.Substring(kid, -n if n else 1, n))
        return _substring(sub, ctx)
    c = _string_value(kid, ctx)
    if isinstance(expr, (E.StartsWith, E.EndsWith, E.Contains)):
        pat = expr.right
        if not isinstance(pat, E.Literal):
            raise NotImplementedError(
                f"{type(expr).__name__} of a column pattern is not on the "
                f"device")
        if pat.value is None:
            return ColVal(torch.zeros_like(c.validity),
                          torch.zeros_like(c.validity))
        kind = {E.StartsWith: "starts", E.EndsWith: "ends",
                E.Contains: "contains"}[type(expr)]
        return _map_value(c, lambda x: S.search(
            x, pat.value.encode("utf-8"), kind))
    if isinstance(expr, E.Length):
        return _map_value(c, S.char_lengths)
    if isinstance(expr, E.OctetLength):  # BitLength too
        mul = 8 if isinstance(expr, E.BitLength) else 1
        return _map_value(c, lambda x: x.lengths() * mul)
    if isinstance(expr, E.Ascii):
        return _map_value(c, S.ascii_code)
    if isinstance(expr, E.RLike):
        dfa = RX.compile_rlike(expr.pattern)
        return _map_value(c, lambda x: RX.match_strings(dfa, x))
    if isinstance(expr, E.FindInSet):
        def index(x):
            idx = torch.zeros(x.num_rows, dtype=torch.int32, device=x.device)
            items = expr.items.split(",")
            for k in reversed(range(len(items))):
                hit = _string_equals_literal(x, items[k])
                idx = torch.where(hit, k + 1, idx)
            return idx
        return _map_value(c, index)
    if isinstance(expr, E.StringLocate):  # before StringInstr, its base
        if expr.start < 1:
            return _map_value(c, lambda x: torch.zeros(
                x.num_rows, dtype=torch.int32, device=x.device))
        return _map_value(c, lambda x: S.first_match_pos(
            x, expr.substr.encode("utf-8"), expr.start))
    if isinstance(expr, E.StringInstr):
        return _map_value(c, lambda x: S.first_match_pos(
            x, expr.substr.encode("utf-8")))
    return _map_string(c, _string_kernel(expr))


def _string_kernel(expr: E.Expression):
    """The plain-column kernel of a unary string -> string function."""
    if isinstance(expr, (E.Upper, E.Lower)):
        return lambda x: S.change_case(x, isinstance(expr, E.Upper))
    if isinstance(expr, E.StringTrim):  # Left and Right too
        chars = (" " if expr.trim_str is None else expr.trim_str).encode()
        return lambda x: S.trim(x, chars, expr.side in ("both", "left"),
                                expr.side in ("both", "right"))
    if isinstance(expr, E.StringReplace):
        return lambda x: S.replace(x, expr.search.encode("utf-8"),
                                   expr.replacement.encode("utf-8"))
    if isinstance(expr, E.StringLPad):  # StringRPad too
        return lambda x: S.pad(x, expr.length, expr.pad.encode("utf-8"),
                               expr.side_left)
    if isinstance(expr, E.StringRepeat):
        return lambda x: S.repeat(x, expr.times)
    if isinstance(expr, E.StringTranslate):
        return lambda x: S.translate(x, expr.matching.encode("utf-8"),
                                     expr.replace.encode("utf-8"))
    if isinstance(expr, E.SubstringIndex):
        return lambda x: S.substring_index(x, expr.delim.encode("utf-8"),
                                           expr.count)
    kernels = {E.InitCap: S.initcap, E.StringReverse: S.reverse,
               E.Base64: S.base64_encode, E.UnBase64: S.unbase64,
               E.Hex: S.hex_encode, E.Unhex: S.unhex}
    fn = kernels.get(type(expr))
    if fn is None:
        raise NotImplementedError(
            f"expression {type(expr).__name__} is not on the device")
    return fn


def _string_value(expr: E.Expression, ctx: EvalContext,
                  like: DeviceColumn = None) -> DeviceColumn:
    """A string branch as a column; a literal becomes a column of ``n``
    rows (a null one shares ``like``'s dictionary when it has one)."""
    if not isinstance(expr, E.Literal):
        return eval_expr(expr, ctx)
    n, dev = ctx.num_rows, ctx.device
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    if expr.value is None:
        if like is not None and like.is_dict:
            return DeviceColumn(T.STRING, zeros, zeros.bool(), None,
                                like.dictionary)
        return K.null_column(T.STRING, n, dev)
    value = expr.value
    raw = torch.tensor(list(value if isinstance(value, bytes)
                            else value.encode("utf-8")), dtype=torch.uint8,
                       device=dev)
    entry = DeviceColumn(T.STRING, raw,
                         torch.ones(1, dtype=torch.bool, device=dev),
                         torch.tensor([0, raw.numel()], dtype=torch.int32,
                                      device=dev))
    return DeviceColumn(T.STRING, zeros, torch.ones(n, dtype=torch.bool,
                                                    device=dev), None, entry)


def _string_select(take: torch.Tensor, a: DeviceColumn,
                   b: DeviceColumn) -> DeviceColumn:
    """Per row, ``a`` where ``take`` else ``b``."""
    valid = torch.where(take, a.validity, b.validity)
    if a.is_dict and b.is_dict and a.dictionary is b.dictionary:
        return DeviceColumn(T.STRING, torch.where(take, a.data, b.data),
                            valid, None, a.dictionary)
    both = K.concat_device([
        ColumnarBatch([K.decode_dictionary(c) if c.is_dict else c],
                      c.num_rows) for c in (a, b)]).columns[0]
    rows = torch.arange(take.numel(), device=take.device)
    out = K.gather_string(both, torch.where(take, rows, rows + a.num_rows))
    return DeviceColumn(T.STRING, out.data, valid, out.offsets)


def _eval_conditional(expr: E.Expression, ctx: EvalContext) -> Val:
    """If, CaseWhen and Coalesce as a fold of two-way selections from the
    last value back to the first."""
    if isinstance(expr, E.If):
        p, t, f = expr.children
        arms = [(p, t)]
        last = f
    elif isinstance(expr, E.CaseWhen):
        arms = list(expr.branches)
        last = (expr.else_value if expr.else_value is not None
                else E.Literal(None, expr.dtype))
    else:  # Coalesce: each value is its own predicate (non-null)
        arms = [(None, v) for v in expr.children[:-1]]
        last = expr.children[-1]
    if expr.dtype in _STRINGY:
        cols = {id(v): eval_expr(v, ctx) for v in [v for _, v in arms]
                + [last] if not isinstance(v, E.Literal)}
        like = next((c for c in cols.values() if c.is_dict), None)

        def value(e):
            got = cols.get(id(e))
            return got if got is not None else _string_value(e, ctx, like)
        select = _string_select
    else:
        def value(e):
            return eval_expr(e, ctx)

        def select(take, a, b):
            t = take[:, None] if a.data.dim() == 2 else take
            return ColVal(torch.where(t, a.data, b.data),
                          torch.where(take, a.validity, b.validity))
    out = value(last)
    for pred, v in reversed(arms):
        val = value(v)
        if pred is None:
            take = val.validity
        else:
            pv = eval_expr(pred, ctx)
            take = pv.data & pv.validity
        out = select(take, val, out)
    return out


def eval_expr(expr: E.Expression, ctx: EvalContext) -> Val:
    if isinstance(expr, E.Alias):
        return eval_expr(expr.child, ctx)
    if isinstance(expr, E.ColumnRef):
        return _as_val(ctx.batch.columns[expr.index])
    if isinstance(expr, E.Literal):
        return _broadcast_literal(expr, ctx)
    if isinstance(expr, E.BinaryArithmetic):
        return _eval_arith(expr, ctx)
    if isinstance(expr, E.BinaryComparison):
        return _eval_compare(expr, ctx)
    if isinstance(expr, E.Cast):
        return _eval_cast(expr, ctx)
    if isinstance(expr, E.And):
        l = eval_expr(expr.left, ctx)
        r = eval_expr(expr.right, ctx)
        # three-valued logic: valid when both are, or either is a valid False
        valid = ((l.validity & r.validity) | (l.validity & ~l.data)
                 | (r.validity & ~r.data))
        return ColVal(l.data & r.data & l.validity & r.validity, valid)
    if isinstance(expr, E.Or):
        l = eval_expr(expr.left, ctx)
        r = eval_expr(expr.right, ctx)
        # valid when both are, or either is a valid True
        valid = ((l.validity & r.validity) | (l.validity & l.data)
                 | (r.validity & r.data))
        return ColVal((l.data & l.validity) | (r.data & r.validity), valid)
    if isinstance(expr, E.Not):
        c = eval_expr(expr.child, ctx)
        return ColVal(~c.data & c.validity, c.validity)
    if isinstance(expr, (E.UnaryMinus, E.Abs)):
        c = eval_expr(expr.child, ctx)
        if _is_wide(c):
            fn = I128.neg if isinstance(expr, E.UnaryMinus) else I128.abs_
            return ColVal(I128.pack(*fn(*I128.split(c.data))), c.validity)
        return ColVal(-c.data if isinstance(expr, E.UnaryMinus)
                      else c.data.abs(), c.validity)
    if isinstance(expr, (E.IsNull, E.IsNotNull)):
        valid = eval_expr(expr.child, ctx).validity
        return ColVal(~valid if isinstance(expr, E.IsNull) else valid,
                      torch.ones_like(valid))
    if isinstance(expr, E.In):
        return _eval_in(expr, ctx)
    if isinstance(expr, E.IsNaN):
        c = eval_expr(expr.child, ctx)
        return ColVal(torch.isnan(c.data) & c.validity,
                      torch.ones_like(c.validity))
    if isinstance(expr, E.Nanvl):
        l, r = eval_expr(expr.left, ctx), eval_expr(expr.right, ctx)
        a, b = l.data.double(), r.data.double()
        take_b = torch.isnan(a)
        return ColVal(torch.where(take_b, b, a),
                      torch.where(take_b, r.validity, l.validity))
    if isinstance(expr, E.DATETIME_FUNCTIONS):
        return ColVal(*DT.eval_datetime(expr, lambda e: eval_expr(e, ctx)))
    if isinstance(expr, E.NullIf):
        return _null_if(expr, ctx)
    if isinstance(expr, E.Nvl2):
        ref, a, b = expr.children
        take = eval_expr(ref, ctx).validity
        if expr.dtype in _STRINGY:
            return _string_select(take, _string_value(a, ctx),
                                  _string_value(b, ctx))
        x, y = eval_expr(a, ctx), eval_expr(b, ctx)
        t = take[:, None] if x.data.dim() == 2 else take
        return ColVal(torch.where(t, x.data, y.data),
                      torch.where(take, x.validity, y.validity))
    if isinstance(expr, E.SCALAR_FUNCTIONS):
        return ColVal(*MATH.eval_scalar(expr, lambda e: eval_expr(e, ctx),
                                        ctx.num_rows, ctx.device))
    if isinstance(expr, (E.If, E.CaseWhen, E.Coalesce)):
        return _eval_conditional(expr, ctx)
    if isinstance(expr, E.Substring):
        return _substring(expr, ctx)
    if isinstance(expr, E.Like):
        return _like(expr, ctx)
    if isinstance(expr, E._StringFn):
        return _eval_string_fn(expr, ctx)
    if isinstance(expr, E.GetJsonObject):
        c = _plain_string(expr.child, ctx)
        held = ctx.json.get(id(c.data))
        if held is None or held[0] is not c.data:
            held = ctx.json[id(c.data)] = (c.data, JD.structure(c))
        return JD.get_json_object(c, expr.path, held[1])
    if isinstance(expr, E.NESTED_FUNCTIONS):
        return _eval_nested(expr, ctx)
    raise NotImplementedError(
        f"expression {type(expr).__name__} is not in the port yet")


def _as_val(c: DeviceColumn) -> Val:
    """A column read as an expression value."""
    if T.is_nested(c.dtype):
        return NestedVal(c)
    if not c.dtype.fixed_width:
        return c
    return ColVal(c.data, c.validity)


def _eval_nested(expr: E.Expression, ctx: EvalContext) -> Val:
    """The nested expressions on the device layouts: a struct field is its
    child column (null where the struct is), map_keys the map's offsets
    over its key child, element_at of a map the first entry whose key
    equals the probe (a per-row minimum over the entries), and
    array_contains a per-row maximum of the element matches."""
    n, dev = ctx.num_rows, ctx.device
    if isinstance(expr, E.GetStructField):
        st = eval_expr(expr.child, ctx).col
        c = st.children[expr.child.dtype.field_index(expr.field)]
        valid = c.validity & st.validity
        if c.dtype.fixed_width:
            return ColVal(K.where_valid(valid, c.data), valid)
        return _as_val(DeviceColumn(c.dtype, c.data, valid, c.offsets,
                                    c.dictionary, c.children))
    if isinstance(expr, E.CreateNamedStruct):
        kids = tuple(val_to_column(eval_expr(c, ctx), c.dtype)
                     for c in expr.children)
        return NestedVal(DeviceColumn(
            expr.dtype, torch.zeros(0, dtype=torch.int32, device=dev),
            torch.ones(n, dtype=torch.bool, device=dev), children=kids))
    if isinstance(expr, E.MapKeys):
        m = eval_expr(expr.child, ctx).col
        return NestedVal(DeviceColumn(expr.dtype, m.children[0].data,
                                      m.validity, m.offsets))
    if isinstance(expr, E.Size):
        c = eval_expr(expr.child, ctx).col
        lens = (c.offsets[1:] - c.offsets[:-1]).int()
        if expr.legacy_null:
            return ColVal(torch.where(c.validity, lens,
                                      torch.full_like(lens, -1)),
                          torch.ones_like(c.validity))
        return ColVal(K.where_valid(c.validity, lens), c.validity)
    c = eval_expr(expr.left, ctx).col
    probe = eval_expr(expr.right, ctx)
    if isinstance(expr, E.ElementAt) and not isinstance(expr.left.dtype,
                                                        T.MapType):
        # an array, 1-based (a negative index counts from the end)
        lens = (c.offsets[1:] - c.offsets[:-1]).long()
        i = probe.data.long()
        pos = torch.where(i > 0, i - 1, lens + i)
        ok = c.validity & probe.validity & (pos >= 0) & (pos < lens) & (
            i != 0)
        if c.data.numel() == 0:
            return ColVal(torch.zeros(n, dtype=c.data.dtype, device=dev),
                          torch.zeros_like(ok))
        src = torch.clamp(c.offsets[:-1].long() + pos, 0,
                          c.data.shape[0] - 1)
        return ColVal(K.where_valid(ok, c.data[src]), ok)
    keys = c.children[0] if isinstance(expr, E.ElementAt) else c
    total = keys.data.shape[0]
    rows = S.row_ids(c.offsets, total)  # each entry's row
    eq = (keys.data == probe.data[rows]) & probe.validity[rows]
    if isinstance(expr, E.ArrayContains):
        hit = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
            0, rows, eq.int()) > 0
        return ColVal(hit & c.validity & probe.validity,
                      c.validity & probe.validity)
    vals = c.children[1]
    ent = torch.arange(total, device=dev)
    sel = torch.full((n,), total, dtype=torch.long, device=dev)
    sel = sel.scatter_reduce(0, rows, torch.where(
        eq & keys.validity[:total], ent, torch.full_like(ent, total)),
        "amin")
    found = sel < total
    if total == 0:
        return ColVal(torch.zeros(T.device_shape(expr.dtype, n),
                                  dtype=vals.data.dtype, device=dev),
                      torch.zeros_like(found))
    sel_c = torch.clamp(sel, max=total - 1)
    valid = found & c.validity & probe.validity & vals.validity[sel_c]
    return ColVal(K.where_valid(valid, vals.data[sel_c]), valid)


def val_to_column(v: Val, dt: T.DataType) -> DeviceColumn:
    if isinstance(v, NestedVal):
        return v.col
    if isinstance(v, DeviceColumn):
        if dt == T.BINARY and v.is_dict:  # BINARY is never a dictionary
            v = K.decode_dictionary(v)
        if v.dtype != dt and dt in _STRINGY:
            return DeviceColumn(dt, v.data, v.validity, v.offsets,
                                v.dictionary)
        return v
    return DeviceColumn(dt, K.where_valid(v.validity,
                                          v.data.to(dt.torch_dtype)),
                        v.validity)


def bind_projection(exprs: Sequence[E.Expression],
                    schema: T.Schema) -> List[E.Expression]:
    return [E.resolve(e, schema) for e in exprs]


def output_schema(exprs: Sequence[E.Expression]) -> T.Schema:
    fields = []
    for i, e in enumerate(exprs):
        name = e.name if isinstance(e, E.Alias) else f"c{i}"
        if isinstance(e, E.ColumnRef) and e.name:
            name = e.name
        fields.append(T.Field(name, e.dtype, e.nullable))
    return T.Schema(fields)


def project_batch(batch: ColumnarBatch,
                  bound: Sequence[E.Expression]) -> ColumnarBatch:
    """Evaluate a bound projection over a batch."""
    ctx = EvalContext(batch)
    cols = [val_to_column(eval_expr(e, ctx), e.dtype) for e in bound]
    return ColumnarBatch(cols, batch.num_rows)
