"""The CPU fallback engine (counterpart of spark_rapids_tpu/plan/cpu.py).

Operators the planner tags off the device run here, on host Arrow tables,
with numpy: a scan, Project, Filter, Sort (with an optional limit), Limit
and Union in this module, the aggregate and the join in ``cpu_agg.py``.
Substring and LIKE work on Python strings (characters), which equals the
device's bytes on ASCII text; the date-and-time functions are
``plan/cpu_datetime.py``'s (numpy ``datetime64``), the scalar function
families ``plan/cpu_math.py``'s, casts to and from strings
``plan/cpu_cast_strings.py``'s, the string family and regex
``plan/cpu_strings.py``'s, and the nested functions, JSON and BINARY casts
``plan/cpu_nested.py``'s (a nested value is its Arrow array); the other casts follow the reference's
``cast_val`` as the device's do (``E.cast_supported``). IntegralDivide,
Remainder and Pmod follow Java as on the device, decimals exactly in
Python integers (Spark's pmod: the divisor added only to a negative
remainder).
Values are ``(values, valid)`` numpy pairs with the device's null rules:
null slots hold zero (an empty string for strings), and every expression
follows Spark semantics (three-valued And/Or/Not, NaN equal to NaN and
greater than every other double, non-ANSI decimal overflow to null).
Decimals are exact: int64 unscaled values where the precision allows
(p <= 18), Python ints in object arrays for DECIMAL128, and averages and
decimal quotients round HALF_UP with integer arithmetic only. Divide
follows Spark's non-ANSI mode: null for a zero divisor, doubles included
(the reference's CPU engine gives IEEE inf/NaN for a fractional ``x /
0.0``).

Transitions are explicit and one each way: a CPU operator reads a device
child through ``batch_to_arrow`` (device to host), and a device operator
reads a CPU child through its ``do_execute``, which uploads each host table
to the plan's device, named by the planner, with the scan's dictionary
rule (host to device). The engine is a planned placement only: no code
moves work here after a device failure.
"""

from __future__ import annotations

import re
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.compute as pc
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    _arrow_fixed_to_numpy, _decimal_array, batch_from_arrow, batch_to_arrow,
    dictionary_encode_table, fixed_array)
from spark_rapids_tpu_torch.exec.base import DeviceExec
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs.eval import (
    bind_projection, decimal_unscaled, output_schema)
from spark_rapids_tpu_torch.plan import cpu_cast_strings as CCS
from spark_rapids_tpu_torch.plan import cpu_datetime as CDT
from spark_rapids_tpu_torch.plan import cpu_math as CM
from spark_rapids_tpu_torch.plan import cpu_nested as CN
from spark_rapids_tpu_torch.plan import cpu_strings as CST

Pair = Tuple[np.ndarray, np.ndarray]

# expressions the CPU engine evaluates: the port's whole expression set
CPU_EXPRS = E.SUPPORTED + E.CPU_ONLY

_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# host values
# ---------------------------------------------------------------------------


def _wide_decimals(arr: pa.Array) -> np.ndarray:
    """Python-int unscaled values of a decimal128 array (nulls read 0)."""
    limbs = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * len(arr), offset=arr.offset * 16)
    lo = limbs[0::2].view(np.uint64).tolist()
    hi = limbs[1::2].tolist()
    out = np.empty(len(arr), dtype=object)
    out[:] = [(h << 64) | l for h, l in zip(hi, lo)]
    return out


def column_values(arr, dt: T.DataType) -> Pair:
    """(values, valid) of one Arrow column; null slots hold zero or ''."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    if T.is_nested(dt):
        return CN.nested_values(arr)
    valid = (np.ones(len(arr), np.bool_) if arr.null_count == 0
             else np.asarray(arr.is_valid(), dtype=np.bool_))
    if dt == T.STRING:
        vals = np.asarray(arr.fill_null("").to_numpy(zero_copy_only=False),
                          dtype=object)
        return vals, valid
    if dt == T.BINARY:
        vals = np.asarray(arr.fill_null(b"").to_numpy(zero_copy_only=False),
                          dtype=object)
        return vals, valid
    if T.is_wide_decimal(dt):
        vals = _wide_decimals(arr)
        vals[~valid] = 0
        return vals, valid
    vals, _ = _arrow_fixed_to_numpy(arr, dt)
    return vals, valid


def values_to_arrow(vals: np.ndarray, valid: np.ndarray,
                    dt: T.DataType) -> pa.Array:
    """(values, valid) -> an Arrow array of ``dt``."""
    valid = np.asarray(valid, dtype=np.bool_)
    if T.is_nested(dt):
        return CN.nested_to_arrow(vals, valid, dt)
    mask = None if valid.all() else ~valid
    if dt in (T.STRING, T.BINARY):
        return pa.array(vals, dt.arrow_type(), mask=mask)
    if isinstance(dt, T.DecimalType):
        if not dt.is_wide:
            return _decimal_array(np.asarray(vals, np.int64), dt, valid)
        ints = [int(v) if ok else 0 for v, ok in zip(vals, valid)]
        limbs = np.empty((len(ints), 2), np.int64)
        limbs[:, 0] = np.array([v & _MASK64 for v in ints],
                               np.uint64).view(np.int64)
        limbs[:, 1] = np.array([v >> 64 for v in ints], np.int64)
        vbuf = (None if mask is None else pa.py_buffer(
            np.packbits(valid, bitorder="little").tobytes()))
        return pa.Array.from_buffers(dt.arrow_type(), len(ints),
                                     [vbuf, pa.py_buffer(limbs.tobytes())])
    return fixed_array(np.asarray(vals).astype(_np_dtype(dt), copy=False),
                       dt, mask)


def _np_dtype(dt: T.DataType) -> np.dtype:
    """numpy dtype of a fixed-width type's values."""
    return torch.empty(0, dtype=dt.torch_dtype).numpy().dtype


def _is_float(dt: T.DataType) -> bool:
    return dt in T.FRACTIONAL_TYPES


def _scale(dt: T.DataType) -> int:
    return dt.scale if isinstance(dt, T.DecimalType) else 0


def _rescale(vals: np.ndarray, k: int) -> np.ndarray:
    """Unscaled values times 10**k, exact: int64 where every result fits,
    else Python ints."""
    if k == 0:
        return vals
    if vals.dtype != object:
        big = (max(abs(int(vals.max())), abs(int(vals.min())))
               if len(vals) else 0)
        if big * 10 ** k < (1 << 62):
            return vals.astype(np.int64) * np.int64(10 ** k)
    out = np.empty(len(vals), dtype=object)
    out[:] = [int(v) * 10 ** k for v in vals]
    return out


def _half_up_div(num: int, den: int) -> int:
    """Exact ROUND_HALF_UP (away from zero) division; den > 0."""
    q, r = divmod(abs(num), den)
    if 2 * r >= den:
        q += 1
    return q if num >= 0 else -q


def _decimal_overflow(vals: np.ndarray, valid: np.ndarray,
                      dt: T.DecimalType) -> Pair:
    """Spark's non-ANSI decimal overflow: a value of 10**precision or more
    in magnitude is null."""
    if not dt.is_wide:
        return vals.astype(np.int64), valid
    bound = 10 ** dt.precision
    ok = np.array([abs(int(v)) < bound for v in vals], np.bool_)
    out = vals.copy()
    out[~ok] = 0
    return out, valid & ok


def _per_value(vals: np.ndarray, fn) -> np.ndarray:
    """``fn`` over the values; a broadcast literal (stride 0) is mapped
    once and broadcast again, and a long column of Python objects
    (strings) is mapped once per distinct value."""
    if vals.ndim == 1 and len(vals) > 1 and vals.strides[0] == 0:
        return np.broadcast_to(fn(vals[:1]), vals.shape)
    if vals.dtype == object and len(vals) > 4096:
        codes, uniq = pd.factorize(vals, use_na_sentinel=False)
        if 2 * len(uniq) < len(vals):
            return fn(np.asarray(uniq, dtype=object))[codes]
    return fn(vals)


def _as_double(vals: np.ndarray, dt: T.DataType) -> np.ndarray:
    """Values as doubles; a decimal is unscaled / 10**scale, as the
    device's cast."""
    if isinstance(dt, T.DecimalType):
        return _per_value(vals, lambda v: v.astype(np.float64)
                          / (10.0 ** dt.scale))
    return _per_value(vals, lambda v: v.astype(np.float64))


def _canonical_float(vals: np.ndarray) -> np.ndarray:
    """-0.0 as 0.0 (Spark's equality and order of doubles): adding +0.0
    turns -0.0 into +0.0 and leaves every other value, NaN included, as
    it is."""
    return _per_value(vals, lambda v: v + 0.0)


def comparable(a: np.ndarray, lt: T.DataType, b: np.ndarray,
               rt: T.DataType) -> Tuple[np.ndarray, np.ndarray, bool]:
    """Both operands of a comparison in one exact representation, and
    whether it is floating point: doubles win (decimals cast to double),
    decimals and integers meet at the finer scale."""
    if _is_float(lt) or _is_float(rt):
        return (_canonical_float(_as_double(a, lt)),
                _canonical_float(_as_double(b, rt)), True)
    if {lt, rt} == {T.DATE, T.TIMESTAMP}:  # a date as its midnight
        return tuple(np.asarray(x, np.int64) * (86_400_000_000 if t == T.DATE
                                                else 1)
                     for x, t in ((a, lt), (b, rt))) + (False,)
    if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
        s = max(_scale(lt), _scale(rt))
        return _rescale(a, s - _scale(lt)), _rescale(b, s - _scale(rt)), False
    return a, b, False


def _compare(kind: type, a: np.ndarray, b: np.ndarray,
             is_float: bool) -> np.ndarray:
    """One comparison over aligned operands (strings: byte order, which is
    the code-point order of Python strings)."""
    if is_float:
        # Spark's order of doubles: NaN is greater than everything and
        # equal to itself
        an, bn = np.isnan(a), np.isnan(b)
        with np.errstate(invalid="ignore"):
            lt = (a < b) | (bn & ~an)
            eq = (a == b) | (an & bn)
    else:
        lt = np.asarray(a < b, dtype=np.bool_)
        eq = np.asarray(a == b, dtype=np.bool_)
    if kind is E.EqualTo:
        return eq
    if kind is E.LessThan:
        return lt
    if kind is E.LessThanOrEqual:
        return lt | eq
    if kind is E.GreaterThan:
        return ~lt & ~eq
    if kind is E.GreaterThanOrEqual:
        return ~lt
    raise NotImplementedError(kind.__name__)


def _literal(expr: E.Literal, n: int) -> Pair:
    dt = expr.dtype
    if expr.value is None:
        if dt in (T.STRING, T.BINARY):
            return (np.full(n, "" if dt == T.STRING else b"", dtype=object),
                    np.zeros(n, np.bool_))
        if T.is_wide_decimal(dt):
            return np.zeros(n, dtype=object), np.zeros(n, np.bool_)
        return np.zeros(n, _np_dtype(dt)), np.zeros(n, np.bool_)
    ones = np.ones(n, np.bool_)
    if dt in (T.STRING, T.BINARY):
        return np.full(n, expr.value, dtype=object), ones
    if isinstance(dt, T.DecimalType):
        v = decimal_unscaled(expr.value, dt.scale)
        if dt.is_wide:
            return np.full(n, v, dtype=object), ones
        return np.broadcast_to(np.int64(v), (n,)), ones
    # one value for every row: a read-only broadcast, no copy per row
    return np.broadcast_to(np.array(expr.value, _np_dtype(dt)), (n,)), ones


def _java_rem(x: int, y: int) -> int:
    """x % y with x's sign (Java), Python integers, y != 0."""
    r = abs(x) % abs(y)
    return -r if x < 0 else r


def _decimal_division(expr: E.BinaryArithmetic, av, bv, valid,
                      lt: T.DataType, rt: T.DataType) -> Pair:
    """IntegralDivide, Remainder and Pmod with a decimal operand, exact:
    both at the larger scale, Java's truncation; a BIGINT quotient past
    its range, or a remainder past the result's precision, is null."""
    s = max(_scale(lt), _scale(rt))
    fa, fb = 10 ** (s - _scale(lt)), 10 ** (s - _scale(rt))
    divide = isinstance(expr, E.IntegralDivide)
    pmod = isinstance(expr, E.Pmod)
    lo, hi = ((-(1 << 63), 1 << 63) if divide
              else (1 - 10 ** expr.dtype.precision,
                    10 ** expr.dtype.precision))
    out, ok = [], valid.copy()
    for i, (x, y) in enumerate(zip(av.tolist(), bv.tolist())):
        x, y = int(x) * fa, int(y) * fb
        if y == 0 or not ok[i]:
            ok[i] = False
            out.append(0)
            continue
        if divide:
            v = abs(x) // abs(y) * (1 if (x >= 0) == (y >= 0) else -1)
        else:
            v = _java_rem(x, y)
            if pmod and v < 0:
                v = _java_rem(v + y, y)
        ok[i] = lo <= v < hi
        out.append(v if ok[i] else 0)
    if divide:
        return np.array(out, np.int64), ok
    arr = np.empty(len(out), dtype=object)
    arr[:] = out
    return (arr if expr.dtype.is_wide else arr.astype(np.int64)), ok


def _division(expr: E.BinaryArithmetic, av, bv, valid) -> Pair:
    """IntegralDivide, Remainder and Pmod of numbers (Java's semantics, a
    zero or NaN divisor null)."""
    if isinstance(expr, E.IntegralDivide):
        a, b = np.asarray(av).astype(np.int64), np.asarray(bv).astype(
            np.int64)
        zero = b == 0
        # x div -1 is -x, wrapping at Long.MIN_VALUE
        safe = np.where(zero | (b == -1), 1, b)
        with np.errstate(over="ignore"):
            q = np.where(b == -1, -a, _trunc_div(a, safe))
        return np.where(zero, 0, q), valid & ~zero
    nt = _np_dtype(expr.dtype)
    a, b = np.asarray(av).astype(nt), np.asarray(bv).astype(nt)
    if a.dtype.kind == "f":
        zero = (b == 0) | np.isnan(b)
        safe = np.where(zero, 1.0, b).astype(nt)
        with np.errstate(invalid="ignore"):
            r = np.fmod(a, safe)
            if isinstance(expr, E.Pmod):
                r = np.where(r < 0, np.fmod(r + safe, safe), r)
        return np.where(zero, 0.0, r).astype(nt), valid & ~zero
    zero = b == 0
    a64 = a.astype(np.int64)
    b64 = np.where(zero | (b == -1), 1, b).astype(np.int64)
    r = np.where(b == -1, 0, a64 - _trunc_div(a64, b64) * b64)
    if isinstance(expr, E.Pmod):
        with np.errstate(over="ignore"):
            shifted = (r + b.astype(np.int64)).astype(nt).astype(np.int64)
        r2 = shifted - _trunc_div(shifted, b64) * b64
        r = np.where((r < 0) & (b != -1), r2, r)
    return np.where(zero, 0, r).astype(nt), valid & ~zero


def _trunc_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Java's truncated int64 division (b != 0, no b == -1 with MIN)."""
    q = np.floor_divide(a, b)
    fix = (q * b != a) & ((a < 0) != (b < 0))
    return q + fix


def _arith(expr: E.BinaryArithmetic, a: Pair, b: Pair) -> Pair:
    (av, am), (bv, bm) = a, b
    valid = am & bm
    lt, rt, out_t = expr.left.dtype, expr.right.dtype, expr.dtype
    if isinstance(expr, (E.IntegralDivide, E.Remainder)):
        if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
            return _decimal_division(expr, av, bv, valid, lt, rt)
        return _division(expr, av, bv, valid)
    if isinstance(out_t, T.DecimalType):
        if isinstance(expr, E.Divide):
            # exact HALF_UP at the result scale: a * 10^k / b, null on 0
            shift = 10 ** (out_t.scale - _scale(lt) + _scale(rt))
            out = np.zeros(len(av), dtype=object)
            ok = valid.copy()
            for i, (x, y) in enumerate(zip(av.tolist(), bv.tolist())):
                if y == 0:
                    ok[i] = False
                elif ok[i]:
                    num = int(x) * shift
                    q = _half_up_div(num if y > 0 else -num, abs(int(y)))
                    if abs(q) < 10 ** out_t.precision:
                        out[i] = q
                    else:  # past the precision: null (non-ANSI)
                        ok[i] = False
            return (out if out_t.is_wide else out.astype(np.int64)), ok
        if isinstance(expr, E.Multiply):
            if out_t.is_wide:
                out = np.empty(len(av), dtype=object)
                out[:] = [int(x) * int(y) for x, y in zip(av, bv)]
            else:
                out = av.astype(np.int64) * bv.astype(np.int64)
        else:
            x = _rescale(av, out_t.scale - _scale(lt))
            y = _rescale(bv, out_t.scale - _scale(rt))
            if out_t.is_wide or x.dtype == object or y.dtype == object:
                x, y = x.astype(object), y.astype(object)
            out = x + y if isinstance(expr, E.Add) else x - y
        out, valid = _decimal_overflow(out, valid, out_t)
        return out, valid
    np_t = _np_dtype(out_t)
    x = (_as_double(av, lt) if isinstance(lt, T.DecimalType) else av)
    y = (_as_double(bv, rt) if isinstance(rt, T.DecimalType) else bv)
    x, y = np.asarray(x).astype(np_t), np.asarray(y).astype(np_t)
    with np.errstate(over="ignore", invalid="ignore"):
        if isinstance(expr, E.Add):
            out = x + y
        elif isinstance(expr, E.Subtract):
            out = x - y
        elif isinstance(expr, E.Multiply):
            out = x * y
        elif isinstance(expr, E.Divide):
            zero = y == 0
            valid = valid & ~zero
            out = x / np.where(zero, 1.0, y)
        else:
            raise NotImplementedError(type(expr).__name__)
    return np.where(valid, out, np.zeros((), np_t)), valid


def _cast(vals: np.ndarray, valid: np.ndarray, src: T.DataType,
          dst: T.DataType) -> Pair:
    """The reference's ``cast_val`` on the host (see ``E.Cast``)."""
    if src == dst:
        return vals, valid
    if not E.cast_supported(src, dst):
        raise NotImplementedError(f"cast {src} -> {dst} is not in the CPU "
                                  f"engine yet")
    vals = np.asarray(vals)
    if dst == T.BOOLEAN:
        return vals != 0, valid
    if src == T.BOOLEAN and not isinstance(dst, T.DecimalType):
        return vals.astype(_np_dtype(dst)), valid
    if dst == T.TIMESTAMP:
        scale = 86_400_000_000 if src == T.DATE else 1_000_000
        with np.errstate(over="ignore"):
            return vals.astype(np.int64) * np.int64(scale), valid
    if src == T.TIMESTAMP and dst in (T.DATE, T.LONG):
        unit = 86_400_000_000 if dst == T.DATE else 1_000_000
        return np.floor_divide(vals.astype(np.int64), unit).astype(
            _np_dtype(dst)), valid
    if dst in T.FRACTIONAL_TYPES:
        # a decimal through a double, anything else rounded once
        out = (_as_double(vals, src) if isinstance(src, T.DecimalType)
               else vals).astype(_np_dtype(dst))
        return np.where(valid, out, 0.0).astype(_np_dtype(dst)), valid
    if isinstance(dst, T.DecimalType):
        return _cast_to_decimal(vals, valid, src, dst)
    np_t = _np_dtype(dst)
    if src in T.FRACTIONAL_TYPES:
        return _double_to_integral(vals, np_t), valid
    if isinstance(src, T.DecimalType):
        # whole part, truncated toward zero (non-ANSI wraps past the type;
        # a DECIMAL128 whole part past int64 is null, as on the device)
        p = 10 ** src.scale
        whole = [(abs(int(v)) // p) * (1 if v >= 0 else -1) for v in vals]
        if src.is_wide:
            fits = np.array([-(1 << 63) <= w < (1 << 63) for w in whole],
                            np.bool_)
            whole = [w if f else 0 for w, f in zip(whole, fits)]
            valid = valid & fits
        return (np.array([w & _MASK64 for w in whole], np.uint64)
                .view(np.int64).astype(np_t), valid)
    # integers, a date's days or a timestamp's microseconds: wrap
    return vals.astype(np_t), valid


def _cast_to_decimal(vals: np.ndarray, valid: np.ndarray, src: T.DataType,
                     dst: T.DecimalType) -> Pair:
    """Into a decimal: exact rescaling of decimals and integers (HALF_UP
    when the scale drops), everything else through a double HALF_UP at
    the scale (NaN, infinities and magnitudes past the type's bound are
    null; 2^63 for DECIMAL64 and 2^127 for DECIMAL128, as the device's);
    null past the precision. A boolean is its 0 or 1 unscaled, as the
    reference's."""
    if isinstance(src, T.DecimalType) or src in T.INTEGRAL_TYPES \
            or src == T.BOOLEAN:
        if src == T.BOOLEAN:
            k = 0
            vals = vals.astype(np.int64)
        else:
            k = dst.scale - _scale(src)
        if k >= 0:
            out = _rescale(vals.astype(np.int64) if vals.dtype != object
                           else vals, k)
        else:
            out = np.empty(len(vals), dtype=object)
            out[:] = [_half_up_div(int(v), 10 ** -k) for v in vals]
    else:
        with np.errstate(invalid="ignore", over="ignore"):
            shifted = np.asarray(vals, np.float64) * (10.0 ** dst.scale)
            limit = 2.0 ** (127 if dst.is_wide else 63)
            bad = ~np.isfinite(shifted) | (np.abs(shifted) >= limit)
            mag = np.floor(np.abs(np.where(bad, 0.0, shifted)) + 0.5)
        out = np.empty(len(vals), dtype=object)
        out[:] = [int(x) if s >= 0 else -int(x)
                  for x, s in zip(mag.tolist(), shifted.tolist())]
        valid = valid & ~bad
    if not dst.is_wide:
        bound = 10 ** min(dst.precision, 18)
        ok = np.array([abs(int(v)) < bound for v in out], np.bool_)
        return np.where(ok, out, 0).astype(np.int64), valid & ok
    return _decimal_overflow(out.astype(object), valid, dst)


def _double_to_integral(d: np.ndarray, np_t: np.dtype) -> np.ndarray:
    """Java's (int)/(long) of a double (the device's ``double_to_integral``):
    NaN is 0, values at or past the range saturate, the rest truncate."""
    info = np.iinfo(np_t)
    hi = float(2 ** (info.bits - 1))
    over, under = d >= hi, d < -hi
    inside = np.where(np.isnan(d) | over | under, 0.0, d)
    out = np.trunc(inside).astype(np_t)
    return np.where(over, info.max, np.where(under, info.min, out)).astype(
        np_t)


def expr_key(e: E.Expression):
    """A structural key of a bound expression: equal keys evaluate to
    equal values (literals by value and type, columns by ordinal)."""
    if isinstance(e, E.Literal):
        return ("lit", repr(e.value), e.dtype.name)
    if isinstance(e, E.ColumnRef):
        return ("col", e.index)
    if isinstance(e, E.Alias):
        return expr_key(e.child)
    to = (e.to.name, e.ansi) if isinstance(e, E.Cast) else None
    if isinstance(e, E.Round):
        to = e.scale
    elif isinstance(e, E.Rand):
        to = e.seed
    elif isinstance(e, E.Substring):
        to = (e.pos, e.length)
    elif isinstance(e, E.Like):
        to = (e.pattern, e.escape)
    elif isinstance(e, E.TruncDate):
        to = e.unit
    elif isinstance(e, E.NextDay):
        to = e.target
    elif isinstance(e, E.FromUTCTimestamp):
        to = e.tz
    elif isinstance(e, E._StringFn):
        to = e._params
    elif isinstance(e, E.GetStructField):
        to = e.field
    elif isinstance(e, E.GetJsonObject):
        to = e.path
    elif isinstance(e, E.CreateNamedStruct):
        to = e.names
    elif isinstance(e, E.Size):
        to = e.legacy_null
    return (type(e).__name__, to, tuple(expr_key(c) for c in e.children))


def cpu_eval(expr: E.Expression, table: pa.Table,
             cache: Optional[dict] = None) -> Pair:
    """Evaluate a bound expression over a host table: (values, valid).
    With ``cache`` (a dict kept for one table), every sub-expression is
    evaluated once and its arrays are shared, so callers must not write
    into them."""
    if cache is not None:
        k = expr_key(expr)
        got = cache.get(k)
        if got is None:
            got = cache[k] = _cpu_eval(expr, table, cache)
        return got
    return _cpu_eval(expr, table, None)


def _cpu_eval(expr: E.Expression, table: pa.Table,
              cache: Optional[dict]) -> Pair:
    n = table.num_rows

    def ev(e):
        return cpu_eval(e, table, cache)

    if isinstance(expr, E.Alias):
        return ev(expr.child)
    if isinstance(expr, E.ColumnRef):
        return column_values(table.column(expr.index), expr.dtype)
    if isinstance(expr, E.Literal):
        return _literal(expr, n)
    if isinstance(expr, E.Cast):
        v, m = ev(expr.child)
        if T.BINARY in (expr.child.dtype, expr.to):
            return CN.cast_binary(v, m, expr.to)
        if expr.child.dtype == T.STRING and expr.to != T.STRING:
            return CCS.from_string(v, m, expr.to, expr.ansi)
        if expr.to == T.STRING and expr.child.dtype != T.STRING:
            return CCS.to_string(v, m, expr.child.dtype)
        return _cast(v, m, expr.child.dtype, expr.to)
    if isinstance(expr, E.BinaryArithmetic):
        return _arith(expr, ev(expr.left), ev(expr.right))
    if isinstance(expr, E.EqualNullSafe):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        a, b, fl = comparable(a, expr.left.dtype, b, expr.right.dtype)
        eq = _compare(E.EqualTo, a, b, fl) & am & bm
        return eq | (~am & ~bm), np.ones(n, np.bool_)
    if isinstance(expr, E.BinaryComparison):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        a, b, fl = comparable(a, expr.left.dtype, b, expr.right.dtype)
        return _compare(type(expr), a, b, fl) & am & bm, am & bm
    if isinstance(expr, E.And):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        valid = (am & bm) | (am & ~a) | (bm & ~b)
        return a & b & am & bm, valid
    if isinstance(expr, E.Or):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        valid = (am & bm) | (am & a) | (bm & b)
        return (a & am) | (b & bm), valid
    if isinstance(expr, E.Not):
        a, m = ev(expr.child)
        return ~a.astype(np.bool_) & m, m
    if isinstance(expr, (E.UnaryMinus, E.Abs)):
        a, m = ev(expr.child)
        if a.dtype == object:  # DECIMAL128: Python ints
            fn = (lambda v: -v) if isinstance(expr, E.UnaryMinus) else abs
            out = np.empty(len(a), dtype=object)
            out[:] = [fn(int(v)) for v in a]
            return out, m
        with np.errstate(over="ignore"):
            return (np.negative(a) if isinstance(expr, E.UnaryMinus)
                    else np.abs(a)), m
    if isinstance(expr, (E.IsNull, E.IsNotNull)):
        _, m = ev(expr.child)
        return (~m if isinstance(expr, E.IsNull) else m.copy()), \
            np.ones(n, np.bool_)
    if isinstance(expr, E.In):
        v, vm = ev(expr.value)
        hit = np.zeros(n, np.bool_)
        all_valid = vm.copy()
        for item in expr.items:
            iv, im = ev(item)
            a, b, fl = comparable(v, expr.value.dtype, iv, item.dtype)
            hit |= _compare(E.EqualTo, a, b, fl) & vm & im
            all_valid &= im
        return hit, hit | all_valid
    if isinstance(expr, (E.If, E.CaseWhen, E.Coalesce)):
        return _conditional(expr, ev)
    if isinstance(expr, E.IsNaN):
        v, m = ev(expr.child)
        return np.isnan(np.asarray(v, np.float64)) & m, np.ones(n, np.bool_)
    if isinstance(expr, E.Nanvl):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        take_b = np.isnan(a)
        return np.where(take_b, b, a), np.where(take_b, bm, am)
    if isinstance(expr, E.DATETIME_FUNCTIONS):
        return CDT.eval_datetime(expr, ev)
    if isinstance(expr, E.NullIf):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        x, y, fl = comparable(a, expr.left.dtype, b, expr.right.dtype)
        ok = am & ~(_compare(E.EqualTo, x, y, fl) & am & bm)
        empty = {T.STRING: "", T.BINARY: b""}.get(expr.dtype, 0)
        return np.where(ok, a, empty), ok
    if isinstance(expr, E.Nvl2):
        _r, rm = ev(expr.children[0])
        (a, am), (b, bm) = ev(expr.children[1]), ev(expr.children[2])
        return np.where(rm, a, b), np.where(rm, am, bm)
    if isinstance(expr, E.SCALAR_FUNCTIONS):
        return CM.eval_scalar(expr, ev, n)
    if isinstance(expr, E._StringFn):
        return CST.eval_string(expr, ev, n)
    if isinstance(expr, E.Substring):
        v, m = ev(expr.child)
        return _per_value(v, lambda x: np.array(
            [substring_sql(s, expr.pos, expr.length) for s in x],
            dtype=object)), m
    if isinstance(expr, E.Like):
        v, m = ev(expr.child)
        prog = like_regex(expr.pattern, expr.escape)
        return _per_value(v, lambda x: np.array(
            [prog.fullmatch(s) is not None for s in x], np.bool_)) & m, m
    if isinstance(expr, E.NESTED_FUNCTIONS + (E.MapValues,)):
        return CN.eval_nested(expr, ev, n)
    if isinstance(expr, E.GetJsonObject):
        return CN.get_json_object(*ev(expr.child), expr.path)
    if isinstance(expr, E.JsonToStructsText):
        return CN.json_to_text(*ev(expr.child))
    raise NotImplementedError(
        f"expression {type(expr).__name__} is not in the CPU engine yet")


def substring_sql(s: str, pos: int, length: int) -> str:
    """Spark's substringSQL: pos > 0 counts from 1, 0 acts as 1, a
    negative pos counts from the end, and [start, start + length) is
    clamped into the string."""
    start = pos - 1 if pos > 0 else (len(s) + pos if pos < 0 else 0)
    end = start + length
    start = max(start, 0)
    return s[start:end] if end > start else ""


def like_regex(pattern: str, escape: str) -> "re.Pattern":
    """A LIKE pattern as a whole-string regex (``%`` any run, ``_`` any
    one character, ``escape`` quoting the next one). A pattern ending
    with the escape character raises ValueError, as on the device."""
    out, i = [], 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape:
            if i + 1 >= len(pattern):
                raise ValueError(f"the LIKE pattern {pattern!r} ends with "
                                 f"the escape character {escape!r}")
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        out.append(".*" if c == "%" else "." if c == "_" else re.escape(c))
        i += 1
    return re.compile("".join(out), re.DOTALL)


def _conditional(expr: E.Expression, ev) -> Pair:
    """If, CaseWhen and Coalesce: per row, the value of the first arm whose
    predicate is true (a null predicate is not), folded from the last
    value back to the first; Coalesce's arms are its non-null values."""
    if isinstance(expr, E.If):
        p, t, f = expr.children
        arms, last = [(p, t)], f
    elif isinstance(expr, E.CaseWhen):
        arms = list(expr.branches)
        last = (expr.else_value if expr.else_value is not None
                else E.Literal(None, expr.dtype))
    else:
        arms = [(None, v) for v in expr.children[:-1]]
        last = expr.children[-1]
    out, valid = ev(last)
    nested = T.is_nested(expr.dtype)
    for pred, v in reversed(arms):
        vals, vm = ev(v)
        if pred is None:
            take = vm
        else:
            pv, pm = ev(pred)
            take = pv.astype(np.bool_) & pm
        if nested:  # Arrow arrays, selected by Arrow
            out = pc.if_else(pa.array(take), CN.nested_to_arrow(
                vals, vm, expr.dtype), CN.nested_to_arrow(out, valid,
                                                          expr.dtype))
        else:
            out = np.where(take, vals, out)
        valid = np.where(take, vm, valid)
    return out, valid


def cpu_unsupported(expr: E.Expression, schema: T.Schema) -> List[str]:
    """Why the CPU engine cannot evaluate ``expr`` (empty: it can)."""
    out: List[str] = []

    def walk(e: E.Expression):
        if type(e) not in CPU_EXPRS:
            out.append(f"expression {type(e).__name__} is not in the CPU "
                       f"engine yet")
            return
        bound = E.resolve(e, schema)
        if isinstance(bound, E.Cast) and not E.cast_supported(
                bound.child.dtype, bound.to):
            out.append(f"cast {bound.child.dtype} -> {bound.to} is not in "
                       f"the CPU engine yet")
        for c in bound.children:
            walk(c)

    walk(expr)
    return out


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


class CpuExec(DeviceExec):
    """A CPU operator: ``execute_host`` yields host Arrow tables. Read as a
    device operator (``execute``), it uploads each table to ``device``."""

    def __init__(self, *children: DeviceExec, device):
        super().__init__(*children)
        self.device = torch.device(device)

    def plan_device(self) -> torch.device:
        return self.device

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        raise NotImplementedError

    def child_tables(self, child: DeviceExec,
                     partition: int = 0) -> Iterator[pa.Table]:
        """A child's output on the host: a CPU child's tables as they are,
        a device child's batches through the device-to-host transition."""
        if isinstance(child, CpuExec):
            yield from child.execute_host(partition)
            return
        schema = child.output_schema
        for b in child.execute(partition):
            yield batch_to_arrow(b, schema)

    def all_child_rows(self, child: DeviceExec) -> pa.Table:
        """Every row of a child, all its partitions in order, as one host
        table."""
        tables = [t for p in range(child.num_partitions())
                  for t in self.child_tables(child, p)]
        if not tables:
            return child.output_schema.to_arrow().empty_table()
        return pa.concat_tables(tables).combine_chunks()

    def do_execute(self, partition: int):
        """The host-to-device transition: each table uploaded to the plan's
        device, strings dictionary-encoded under the scan's rule."""
        for t in self.execute_host(partition):
            cache: dict = {}
            yield batch_from_arrow(dictionary_encode_table(t), self.device,
                                   dict_cache=cache)

    def node_description(self) -> str:
        return type(self).__name__


class CpuInMemoryScanExec(CpuExec):
    def __init__(self, table: pa.Table, device):
        super().__init__(device=device)
        self.table = table

    @property
    def output_schema(self) -> T.Schema:
        return T.Schema.from_arrow(self.table.schema)

    def node_description(self) -> str:
        return f"CpuInMemoryScan[{self.table.num_rows} rows]"

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        # dictionary-typed strings arrive as the plain strings of the schema
        target = self.output_schema.to_arrow()
        yield (self.table if self.table.schema == target
               else self.table.cast(target))


class CpuParquetScanExec(CpuExec):
    """Parquet files read whole on the host, one partition, every file
    cast to the first file's schema (the reference's; it prunes no row
    group)."""

    def __init__(self, paths: Sequence[str],
                 columns: Optional[Sequence[str]] = None, *, device):
        super().__init__(device=device)
        self.paths = list(paths)
        self.columns = list(columns) if columns is not None else None

    @property
    def output_schema(self) -> T.Schema:
        import pyarrow.parquet as pq

        s = pq.read_schema(self.paths[0])
        if self.columns is not None:
            s = pa.schema([s.field(c) for c in self.columns])
        return T.Schema.from_arrow(s)

    def node_description(self) -> str:
        return f"CpuParquetScan[{len(self.paths)} files]"

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        import pyarrow.parquet as pq

        target = self.output_schema.to_arrow()
        for p in self.paths:
            t = pq.read_table(p, columns=self.columns)
            yield t.select(target.names).cast(target)


class CpuProjectExec(CpuExec):
    def __init__(self, exprs: Sequence[E.Expression], child: DeviceExec,
                 device):
        super().__init__(child, device=device)
        self.exprs = list(exprs)
        self._bound = bind_projection(self.exprs, child.output_schema)
        self._schema = output_schema(self._bound)

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def node_description(self) -> str:
        return f"CpuProject [{', '.join(map(repr, self.exprs))}]"

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        for t in self.child_tables(self.children[0], partition):
            arrays = []
            cache: dict = {}  # sub-expressions shared by the columns
            for e, f in zip(self._bound, self._schema):
                inner = e.child if isinstance(e, E.Alias) else e
                if isinstance(inner, E.ColumnRef):
                    arrays.append(t.column(inner.index))
                else:
                    arrays.append(values_to_arrow(*cpu_eval(e, t, cache),
                                                  f.dtype))
            yield pa.Table.from_arrays(arrays, schema=self._schema.to_arrow())


class CpuFilterExec(CpuExec):
    def __init__(self, condition: E.Expression, child: DeviceExec, device):
        super().__init__(child, device=device)
        self.condition = condition
        self._bound = E.resolve(condition, child.output_schema)

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    def node_description(self) -> str:
        return f"CpuFilter [{self.condition!r}]"

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        for t in self.child_tables(self.children[0], partition):
            vals, valid = cpu_eval(self._bound, t)
            yield t.filter(pa.array(vals.astype(np.bool_) & valid))


def order_ranks(vals: np.ndarray, valid: np.ndarray,
                dt: T.DataType) -> Tuple[np.ndarray, int]:
    """Dense rank of each valid value in Spark order (strings by bytes,
    NaN above every double, -0.0 equal to 0.0) and the number of distinct
    valid values; null rows rank 0."""
    v = vals[valid]
    if _is_float(dt):
        v = _canonical_float(v)
    ranks = np.zeros(len(vals), np.int64)
    if v.dtype == object:
        # strings (or DECIMAL128 ints): hash-factorise, then sort only the
        # distinct values (Python's order of str is code point order, which
        # is UTF-8 byte order)
        codes, uniq = pd.factorize(v, use_na_sentinel=False)
        rank_of = np.empty(len(uniq), np.int64)
        rank_of[np.argsort(uniq, kind="stable")] = np.arange(len(uniq))
        ranks[valid] = rank_of[codes]
        return ranks, len(uniq)
    uniq, inv = np.unique(v, return_inverse=True)
    ranks[valid] = inv.reshape(-1)
    return ranks, len(uniq)


def exact_order_key(vals: np.ndarray, valid: np.ndarray,
                    dt: T.DataType) -> Optional[np.ndarray]:
    """int64 values whose order is the type's, nulls 0, for the types
    whose values are integers (the integers, booleans, dates, timestamps
    and DECIMAL64's unscaled values); None for the others, which rank."""
    if not (dt in T.INTEGRAL_TYPES + (T.BOOLEAN, T.DATE, T.TIMESTAMP)
            or (isinstance(dt, T.DecimalType) and not dt.is_wide)):
        return None
    return np.where(valid, np.asarray(vals).astype(np.int64), 0)


def sort_permutation(table: pa.Table, keys: Sequence[Tuple[E.Expression,
                                                           bool,
                                                           Optional[bool]]]
                     ) -> np.ndarray:
    """Stable ORDER BY permutation over bound (expr, ascending,
    nulls_first) keys, Spark's default null order where None: each key is
    a digit (an integer key its values, then its null flag; any other key
    its dense ranks, nulls at one end), least significant first, and runs
    of digits whose ranges fit 62 bits together are packed into one int64
    and sorted by one stable argsort (equal to a stable sort per digit)."""
    digits: List[np.ndarray] = []  # least significant first
    for expr, ascending, nulls_first in reversed(list(keys)):
        if nulls_first is None:
            nulls_first = ascending
        vals, valid = cpu_eval(expr, table)
        key = exact_order_key(vals, valid, expr.dtype)
        if key is not None:
            if not ascending:
                key = ~key  # order-reversing, and no overflow
            digits.append(key)
            if not valid.all():
                digits.append((valid if nulls_first else ~valid).astype(
                    np.int64))
            continue
        ranks, n_distinct = order_ranks(vals, valid, expr.dtype)
        if not ascending:
            ranks = n_distinct - 1 - ranks
        digits.append(np.where(valid, ranks + 1,
                               0 if nulls_first else n_distinct + 1))
    perm = np.arange(table.num_rows)
    if not table.num_rows:
        return perm
    packed, bits = None, 0
    for d in digits:
        lo = int(d.min())
        width = (int(d.max()) - lo).bit_length()
        if packed is not None and bits + width > 62:
            perm = perm[np.argsort(packed[perm], kind="stable")]
            packed, bits = None, 0
        if width > 62:  # a digit of its own (its values, not offsets)
            perm = perm[np.argsort(d[perm], kind="stable")]
            continue
        digit = d - lo
        packed = digit if packed is None else (digit << bits) | packed
        bits += width
    if packed is not None:
        perm = perm[np.argsort(packed[perm], kind="stable")]
    return perm


class CpuSortExec(CpuExec):
    """Sort of all the child's rows (every partition) on the host, cut to
    ``limit`` rows when given: one partition."""

    def __init__(self, orders: Sequence[SortOrder], child: DeviceExec,
                 device, limit: Optional[int] = None):
        super().__init__(child, device=device)
        self.orders = list(orders)
        self.limit = limit
        schema = child.output_schema
        self._keys = [(E.resolve(o.child, schema), o.ascending,
                       o.nulls_first) for o in self.orders]

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def node_description(self) -> str:
        lim = f" limit={self.limit}" if self.limit is not None else ""
        return f"CpuSort [{', '.join(map(repr, self.orders))}]{lim}"

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        t = self.all_child_rows(self.children[0])
        perm = sort_permutation(t, self._keys)
        if self.limit is not None:
            perm = perm[: self.limit]
        yield t.take(pa.array(perm, pa.int64()))


class CpuLimitExec(CpuExec):
    """First ``n`` rows after ``offset`` rows, across the child's
    partitions in order: one partition."""

    def __init__(self, n: int, child: DeviceExec, device, offset: int = 0):
        super().__init__(child, device=device)
        self.n = n
        self.offset = offset

    @property
    def output_schema(self) -> T.Schema:
        return self.children[0].output_schema

    def num_partitions(self) -> int:
        return 1

    def node_description(self) -> str:
        return f"CpuLimit {self.n} offset={self.offset}"

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        skip, remaining = self.offset, self.n
        child = self.children[0]
        for t in (t for p in range(child.num_partitions())
                  for t in self.child_tables(child, p)):
            if remaining <= 0:
                return
            lo = min(skip, t.num_rows)
            skip -= lo
            take = min(t.num_rows - lo, remaining)
            if take > 0:
                remaining -= take
                yield t.slice(lo, take)


class CpuUnionExec(CpuExec):
    """UNION ALL on the host, under the union's names and nullability (the
    planner has cast each child to the union's types). The partitions of
    each child become partitions of the union, child by child, as the
    reference's ``CpuUnionExec`` numbers them."""

    def __init__(self, schema: T.Schema, *children: DeviceExec, device):
        super().__init__(*children, device=device)
        self._schema = schema

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    def node_description(self) -> str:
        return f"CpuUnion [{len(self.children)} children]"

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        target = self._schema.to_arrow()
        for c in self.children:
            n = c.num_partitions()
            if partition < n:
                for t in self.child_tables(c, partition):
                    yield pa.Table.from_arrays(list(t.columns),
                                               schema=target)
                return
            partition -= n
