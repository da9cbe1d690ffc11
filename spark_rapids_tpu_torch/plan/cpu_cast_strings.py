"""Casts between strings and the scalar types on the CPU engine (counterpart
of the string casts of spark_rapids_tpu/plan/cpu.py).

Over the distinct values of a column (``cpu._per_value``), with the
device's formats and grammar (``exprs/cast_strings.py`` documents them),
written apart from the device's byte-matrix parse so each engine checks
the other: dates, timestamps and floats parse all at once through
pyarrow's regular expressions, the rest one value at a time in Python;
booleans, dates and timestamps format all at once through pyarrow's
casts, the rest one distinct value at a time.
A trimmed literal past ``PARSE_WINDOW`` bytes, or one outside its grammar
or range, is null; string -> FLOAT/DOUBLE is Python's correctly rounded
``float()``.

The CPU engine's own casts, as the reference places them:

- FLOAT/DOUBLE -> string: Java's ``Float.toString`` / ``Double.toString``
  (the shortest text that reads back as the value: a plain decimal for
  10**-3 <= |x| < 10**7 with at least one fraction digit, else
  ``d.dddE[-]n``; ``NaN``, ``Infinity``, ``-0.0``). A FLOAT prints its
  float32 digits (``1.1``), not its double's (the reference's
  ``1.100000023841858`` is fault 18 of ROADMAP queue 3);
- string -> DECIMAL: ``[+-](digits[.digits]|.digits)[(e|E)[+-]digits]``
  (Java's ``BigDecimal``), HALF_UP at the scale, null past the precision;
- ANSI string casts: a non-null string that does not parse raises
  ValueError naming it (Spark's ANSI mode), where the non-ANSI cast gives
  null.
"""

from __future__ import annotations

import decimal
import re
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch import types as T

Pair = Tuple[np.ndarray, np.ndarray]

PARSE_WINDOW = 64
_WS = "".join(chr(c) for c in range(0x21))
_INTEGRAL = re.compile(r"[+-]?\d*(\.\d*)?", re.ASCII)
_FLOAT = re.compile(r"([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)[dDfF]?",
                    re.ASCII)
_DECIMAL = re.compile(r"[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?", re.ASCII)
_TRUE = ("true", "t", "yes", "y", "1")
_FALSE = ("false", "f", "no", "n", "0")
_EPOCH_ORDINAL = 719163  # date(1970, 1, 1).toordinal()
_FIRST_DAY, _LAST_DAY = -719162, 2932896  # 0001-01-01, 9999-12-31


def _parse_integral(t: str, dst: T.DataType) -> Optional[int]:
    if not t or t in "+-" or _INTEGRAL.fullmatch(t) is None:
        return None
    whole = t.split(".")[0]
    digits = whole.lstrip("+-")
    v = int(digits) if digits else 0
    v = -v if whole.startswith("-") else v
    bits = {T.BYTE: 8, T.SHORT: 16, T.INT: 32, T.LONG: 64}[dst]
    return v if -(1 << (bits - 1)) <= v < (1 << (bits - 1)) else None


def _parse_decimal(t: str, dst: T.DecimalType) -> Optional[int]:
    if _DECIMAL.fullmatch(t) is None:
        return None
    with decimal.localcontext() as c:
        c.prec = 200
        c.Emax, c.Emin = 100_000, -100_000
        try:
            q = decimal.Decimal(t).quantize(decimal.Decimal(1).scaleb(
                -dst.scale), rounding=decimal.ROUND_HALF_UP)
        except decimal.InvalidOperation:
            return None
        v = int(q.scaleb(dst.scale))
    return v if abs(v) < 10 ** dst.precision else None


def _parser(dst: T.DataType):
    if dst in T.INTEGRAL_TYPES:
        return lambda t: _parse_integral(t, dst)
    if dst == T.BOOLEAN:
        def parse_bool(t):
            low = t.lower()
            return True if low in _TRUE else False if low in _FALSE else None
        return parse_bool
    if isinstance(dst, T.DecimalType):
        return lambda t: _parse_decimal(t, dst)
    raise NotImplementedError(f"cast string -> {dst} is not in the CPU "
                              f"engine")


def _np_type(dst: T.DataType):
    if isinstance(dst, T.DecimalType):
        return object if dst.is_wide else np.int64
    return {T.BOOLEAN: np.bool_, T.BYTE: np.int8, T.SHORT: np.int16,
            T.INT: np.int32, T.LONG: np.int64, T.FLOAT: np.float32,
            T.DOUBLE: np.float64, T.DATE: np.int32,
            T.TIMESTAMP: np.int64}[dst]


# the grammar of DATE (to the first ``(?:[ T]``) and TIMESTAMP literals as
# one pattern, each field a group (RE2's syntax, for pyarrow)
_DATETIME = (r"^(?P<y>\d{1,5})(?:-(?P<m>\d{1,15})(?:-(?P<d>\d{1,15}))?)?"
             r"(?:[ T](?P<h>\d{1,15}):(?P<mi>\d{1,15}):(?P<s>\d{1,15})"
             r"(?:\.(?P<f>\d{1,6}))?)?$")


def _ints(fields, name: str, default: int) -> np.ndarray:
    """A matched field as int64 (``default`` where it did not take part
    or the row did not match)."""
    f = fields.field(name)
    f = pc.if_else(pc.equal(f, ""), str(default), f)
    return np.asarray(pc.cast(pc.fill_null(f, str(default)), pa.int64()))


def _datetimes(t: pa.Array, with_time: bool):
    """(values, ok) of trimmed literals as DATE days or TIMESTAMP
    microseconds, all at once (pyarrow's regular expressions): each field
    checked, the day against its month's length (numpy's calendar)."""
    if with_time:
        t = pc.replace_substring_regex(t, "(?:UTC|Z)$", "",
                                       max_replacements=1)
        pattern = _DATETIME
    else:  # no time part
        pattern = _DATETIME[:_DATETIME.index("(?:[ T]")] + "$"
    fields = pc.extract_regex(t, pattern)
    ok = np.asarray(fields.is_valid())
    y, m, d = (_ints(fields, k, v) for k, v in (("y", 1970), ("m", 1),
                                                ("d", 1)))
    ok &= (y >= 1) & (y <= 9999) & (m >= 1) & (m <= 12) & (d >= 1)
    y, m = np.where(ok, y, 1970), np.where(ok, m, 1)
    months = (y - 1970) * 12 + (m - 1)
    first = months.astype("datetime64[M]").astype("datetime64[D]").astype(
        np.int64)
    nxt = (months + 1).astype("datetime64[M]").astype(
        "datetime64[D]").astype(np.int64)
    ok &= d <= nxt - first
    days = first + np.where(ok, d, 1) - 1
    if not with_time:
        return days, ok
    timed = np.asarray(pc.not_equal(pc.fill_null(fields.field("h"), ""),
                                    ""))
    h, mi, sec = (_ints(fields, k, 0) for k in ("h", "mi", "s"))
    # the fraction's digits to microseconds: right-padded to six
    micros = np.asarray(pc.cast(pc.utf8_rpad(pc.fill_null(
        fields.field("f"), ""), width=6, padding="0"), pa.int64()))
    ok &= ~timed | ((h <= 23) & (mi <= 59) & (sec <= 59))
    us = (days * 86_400_000_000 + h * 3_600_000_000 + mi * 60_000_000
          + sec * 1_000_000 + micros)
    return np.where(ok, us, 0), ok


def _floats(t: pa.Array):
    """(values, ok) of trimmed literals as doubles, all at once: Java's
    grammar (``_FLOAT``, pyarrow's regular expressions), read by Python's
    correctly rounded ``float``, and the special literals."""
    body = pc.replace_substring_regex(t, "^[+-]", "", max_replacements=1)
    low = pc.utf8_lower(body)
    neg = np.asarray(pc.starts_with(t, "-"))
    inf = np.asarray(pc.is_in(low, pa.array(["inf", "infinity"])))
    nan = np.asarray(pc.or_(pc.and_(pc.equal(low, "nan"), pc.equal(body, t)),
                            pc.equal(body, "NaN")))
    num = np.asarray(pc.match_substring_regex(t, "^" + _FLOAT.pattern
                                              + "$"))
    vals = np.zeros(len(t), np.float64)
    if num.any():
        text = pc.replace_substring_regex(t.filter(pa.array(num)),
                                          "[dDfF]$", "")
        vals[num] = text.to_numpy(zero_copy_only=False).astype(np.float64)
    vals = np.where(inf, np.where(neg, -np.inf, np.inf), vals)
    vals = np.where(nan, np.nan, vals)
    return vals, num | inf | nan


def from_string(vals: np.ndarray, valid: np.ndarray, dst: T.DataType,
                ansi: bool = False) -> Pair:
    """A string column cast to ``dst``; each distinct string parsed once
    (dates, timestamps and floats all at once, the rest one by one)."""
    from spark_rapids_tpu_torch.plan.cpu import _per_value

    def parse_all(x):
        t = pc.utf8_trim(pa.array(x, pa.string()), characters=_WS)
        fits = np.asarray(pc.less_equal(pc.binary_length(t), PARSE_WINDOW))
        if dst in (T.DATE, T.TIMESTAMP):
            v, ok = _datetimes(t, dst == T.TIMESTAMP)
        elif dst in T.FRACTIONAL_TYPES:
            v, ok = _floats(t)
        else:
            parse = _parser(dst)
            got = [parse(s) for s in t.to_pylist()]
            ok = np.array([g is not None for g in got], np.bool_)
            v = np.empty(len(got), dtype=object)
            v[:] = [0 if g is None else g for g in got]
        out = np.empty((len(x), 2), dtype=object)
        out[:, 0] = v
        out[:, 1] = ok & fits
        return out

    got = _per_value(np.asarray(vals, dtype=object), parse_all)
    ok = valid & got[:, 1].astype(np.bool_)
    if ansi and (valid & ~ok).any():
        bad = np.asarray(vals, dtype=object)[valid & ~ok][0]
        raise ValueError(f"invalid input for an ANSI cast of a string to "
                         f"{dst}: {bad!r}")
    data = got[:, 0]
    if _np_type(dst) is object:
        return np.where(ok, data, 0), ok
    with np.errstate(over="ignore"):  # a FLOAT past its range is inf
        data = data.astype(_np_type(dst))
    return np.where(ok, data, np.zeros((), data.dtype)), ok


# ---------------------------------------------------------------------------
# value -> string
# ---------------------------------------------------------------------------


def java_text(x: float, f32: bool) -> str:
    """Java's ``Double.toString`` (``Float.toString`` with ``f32``)."""
    if np.isnan(x):
        return "NaN"
    if np.isinf(x):
        return "Infinity" if x > 0 else "-Infinity"
    if x == 0:
        return "-0.0" if np.signbit(x) else "0.0"
    v = np.float32(x) if f32 else np.float64(x)
    mant, exp = np.format_float_scientific(v, unique=True, trim="-").split(
        "e")
    sign = "-" if mant.startswith("-") else ""
    digits = mant.lstrip("-").replace(".", "")
    e = int(exp)
    if 1e-3 <= abs(float(v)) < 1e7:
        if e >= 0:
            whole = digits[:e + 1].ljust(e + 1, "0")
            frac = digits[e + 1:] or "0"
        else:
            whole, frac = "0", "0" * (-e - 1) + digits
        return f"{sign}{whole}.{frac}"
    return f"{sign}{digits[0]}.{digits[1:] or '0'}E{e}"


def _decimal_text(v: int, scale: int) -> str:
    sign = "-" if v < 0 else ""
    s = str(abs(v)).rjust(scale + 1, "0")
    if not scale:
        return sign + s
    return f"{sign}{s[:-scale]}.{s[-scale:]}"


def _timestamp_text(us: int) -> str:
    days, rem = divmod(us, 86_400_000_000)
    secs, frac = divmod(rem, 1_000_000)
    out = (f"{_date_text(days)} {secs // 3600:02d}:{secs // 60 % 60:02d}:"
           f"{secs % 60:02d}")
    return out + (("." + f"{frac:06d}").rstrip("0") if frac else "")


def _date_text(days: int) -> str:
    """yyyy-MM-dd of a day number, the year clipped to 0..9999 as the
    device's is (numpy's proleptic calendar past year 1..9999)."""
    from spark_rapids_tpu_torch.plan.cpu_datetime import _fields

    y, m, d = (int(f[0]) for f in _fields(np.array([days], np.int64)))
    return f"{min(max(y, 0), 9999):04d}-{m:02d}-{d:02d}"


def _formatter(src: T.DataType):
    if src == T.BOOLEAN:
        return lambda v: "true" if v else "false"
    if src == T.DATE:
        return lambda v: _date_text(int(v))
    if src == T.TIMESTAMP:
        return lambda v: _timestamp_text(int(v))
    if src in T.FRACTIONAL_TYPES:
        return lambda v: java_text(float(v), src == T.FLOAT)
    if isinstance(src, T.DecimalType):
        return lambda v: _decimal_text(int(v), src.scale)
    if src in T.INTEGRAL_TYPES:
        return lambda v: str(int(v))
    raise NotImplementedError(f"cast {src} -> string is not in the CPU "
                              f"engine")


def _vector_text(vals: np.ndarray, src: T.DataType):
    """The text of every value at once (pyarrow's casts) for booleans and
    for dates and timestamps of years 1..9999; None for the rest."""
    if src == T.BOOLEAN:
        return np.where(vals.astype(np.bool_), "true", "false").astype(
            object)
    if src not in (T.DATE, T.TIMESTAMP):
        return None
    v = vals.astype(np.int64)
    days = np.floor_divide(v, 86_400_000_000) if src == T.TIMESTAMP else v
    if len(days) and (days.min() < _FIRST_DAY or days.max() > _LAST_DAY):
        return None  # years past 1..9999: clipped one by one
    if src == T.DATE:
        text = pc.cast(pa.array(v.astype(np.int32)).cast(pa.date32()),
                       pa.string())
    else:
        text = pc.cast(pa.array(v).cast(pa.timestamp("us")), pa.string())
        # six fraction digits: their trailing zeros go, then a bare point
        text = pc.replace_substring_regex(text, r"\.(\d*?)0+$", r".\1")
        text = pc.replace_substring_regex(text, r"\.$", "")
    return text.to_numpy(zero_copy_only=False)


def to_string(vals: np.ndarray, valid: np.ndarray, src: T.DataType) -> Pair:
    """A value column as strings: at once where pyarrow's text is Spark's,
    else each distinct value formatted once."""
    from spark_rapids_tpu_torch.plan.cpu import _per_value

    vals = np.asarray(vals)
    text = _vector_text(vals, src) if vals.dtype != object else None
    if text is not None:
        return np.where(valid, text, ""), valid
    fmt = _formatter(src)
    if vals.dtype == object:
        out = _per_value(vals, lambda x: np.array([fmt(v) for v in x],
                                                  dtype=object))
    elif len(vals) > 4096:
        # distinct bit patterns (-0.0 and each NaN apart from 0.0)
        key = (vals.view(np.int64 if vals.itemsize == 8 else np.int32)
               if vals.dtype.kind == "f" else vals)
        _u, first, inv = np.unique(key, return_index=True,
                                   return_inverse=True)
        text = np.array([fmt(v) for v in vals[first].tolist()],
                        dtype=object)
        out = text[inv.reshape(-1)]
    else:
        out = np.array([fmt(v) for v in vals.tolist()], dtype=object)
    return np.where(valid, out, ""), valid
