"""Spark-exact text-to-typed conversion for CSV/JSON scans.

The port's copy of spark_rapids_tpu/io/text_parse.py.

Reference: GpuTextBasedPartitionReader.scala + GpuCSVScan.scala:439 — the
reference reads text columns raw and applies its OWN Spark-semantics
parsers (cudf + jni CastStrings) instead of trusting the format library's
defaults. Same discipline here: the file is decoded to STRING columns by
Arrow, and this module converts each column with Spark's UnivocityParser /
JacksonParser rules:

- integral types: optional sign + digits only, no whitespace tolerance;
  out-of-range or malformed -> NULL (PERMISSIVE)
- float/double: Java ``Double.parseDouble`` surface incl. ``Infinity``,
  ``NaN``, exponents, trailing ``f/d`` suffixes REJECTED (Spark rejects),
  plus the nanValue/positiveInf/negativeInf option strings
- boolean: ``true``/``false`` case-insensitive only
- date: ``dateFormat`` (default ``yyyy-MM-dd``) parsed strictly
- timestamp: ``timestampFormat`` (default ISO-8601 with optional
  fractional seconds and zone offset)
- decimal: BigDecimal surface; values that need rounding beyond the scale
  are rounded HALF_UP; precision overflow -> NULL
- PERMISSIVE / DROPMALFORMED / FAILFAST modes and
  ``columnNameOfCorruptRecord`` (the raw record lands in the corrupt
  column when any field fails to convert).
"""

from __future__ import annotations

import datetime
import decimal as _dec
import re
from typing import List, Optional

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T

_INT_RE = re.compile(r"^[+-]?\d+$")
_FLOAT_RE = re.compile(
    r"^[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?$")
_DEC_RE = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?$")

_INT_BOUNDS = {
    T.BYTE: (-128, 127),
    T.SHORT: (-(1 << 15), (1 << 15) - 1),
    T.INT: (-(1 << 31), (1 << 31) - 1),
    T.LONG: (-(1 << 63), (1 << 63) - 1),
}


def _java_fmt_to_py(fmt: str) -> str:
    """Subset mapping of java DateTimeFormatter patterns to strptime."""
    out = []
    i = 0
    while i < len(fmt):
        c = fmt[i]
        run = 1
        while i + run < len(fmt) and fmt[i + run] == c:
            run += 1
        if c == "y":
            out.append("%Y")
        elif c == "M":
            out.append("%m")
        elif c == "d":
            out.append("%d")
        elif c == "H":
            out.append("%H")
        elif c == "m":
            out.append("%M")
        elif c == "s":
            out.append("%S")
        elif c == "S":
            out.append("%f")
        elif c == "'":
            j = fmt.index("'", i + 1)
            out.append(fmt[i + 1: j])
            i = j + 1
            continue
        else:
            out.append(c * run)
        i += run
    return "".join(out)


_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)

_ISO_TS_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})[T ](\d{2}):(\d{2}):(\d{2})"
    r"(?:\.(\d{1,9}))?"
    r"(Z|[+-]\d{2}:?\d{2})?$")


class FieldError(Exception):
    pass


def parse_field(s: Optional[str], dt: T.DataType, opts: "CsvOptions"):
    """One field -> python value, raising FieldError on malformed input."""
    if s is None or s == opts.null_value:
        return None
    if dt in _INT_BOUNDS:
        if not _INT_RE.match(s):
            raise FieldError(s)
        v = int(s)
        lo, hi = _INT_BOUNDS[dt]
        if not (lo <= v <= hi):
            raise FieldError(s)
        return v
    if dt in (T.FLOAT, T.DOUBLE):
        if s == opts.nan_value:
            return float("nan")
        if s == opts.positive_inf:
            return float("inf")
        if s == opts.negative_inf:
            return float("-inf")
        # Java Double.parseDouble also accepts Infinity/NaN spellings
        if s in ("Infinity", "+Infinity"):
            return float("inf")
        if s == "-Infinity":
            return float("-inf")
        if s == "NaN":
            return float("nan")
        if not _FLOAT_RE.match(s):
            raise FieldError(s)
        v = float(s)
        return np.float32(v).item() if dt == T.FLOAT else v
    if dt == T.BOOLEAN:
        low = s.lower()
        if low == "true":
            return True
        if low == "false":
            return False
        raise FieldError(s)
    if isinstance(dt, T.DecimalType):
        if not _DEC_RE.match(s):
            raise FieldError(s)
        try:
            v = _dec.Decimal(s)
        except _dec.InvalidOperation:
            raise FieldError(s)
        with _dec.localcontext() as c:
            c.prec = 60
            scaled = v.scaleb(dt.scale).to_integral_value(
                rounding=_dec.ROUND_HALF_UP)
        if abs(int(scaled)) >= 10 ** dt.precision:
            raise FieldError(s)
        return _dec.Decimal(int(scaled)).scaleb(-dt.scale)
    if dt == T.DATE:
        try:
            d = datetime.datetime.strptime(s, opts.date_fmt_py).date()
        except ValueError:
            raise FieldError(s)
        return d
    if dt == T.TIMESTAMP:
        if opts.timestamp_format is None:
            m = _ISO_TS_RE.match(s)
            if not m:
                # Spark also accepts a bare date as midnight
                try:
                    d = datetime.datetime.strptime(s, opts.date_fmt_py)
                    return d.replace(tzinfo=datetime.timezone.utc)
                except ValueError:
                    raise FieldError(s)
            y, mo, dd, hh, mi, ss, frac, tz = m.groups()
            try:
                base = datetime.datetime(int(y), int(mo), int(dd), int(hh),
                                         int(mi), int(ss),
                                         tzinfo=datetime.timezone.utc)
            except ValueError:
                raise FieldError(s)
            micros = int((frac or "0").ljust(6, "0")[:6])
            base = base + datetime.timedelta(microseconds=micros)
            if tz and tz != "Z":
                sign = 1 if tz[0] == "+" else -1
                zz = tz[1:].replace(":", "")
                off = int(zz[:2]) * 60 + int(zz[2:4] or 0)
                base -= sign * datetime.timedelta(minutes=off)
            return base
        try:
            d = datetime.datetime.strptime(s, opts.ts_fmt_py)
        except ValueError:
            raise FieldError(s)
        return d.replace(tzinfo=datetime.timezone.utc)
    if dt in (T.STRING, T.BINARY):
        return s
    raise FieldError(f"unsupported csv type {dt}")


class CsvOptions:
    def __init__(self, null_value: str = "", nan_value: str = "NaN",
                 positive_inf: str = "Inf", negative_inf: str = "-Inf",
                 date_format: str = "yyyy-MM-dd",
                 timestamp_format: Optional[str] = None,
                 mode: str = "PERMISSIVE",
                 corrupt_column: Optional[str] = None):
        assert mode in ("PERMISSIVE", "DROPMALFORMED", "FAILFAST")
        self.null_value = null_value
        self.nan_value = nan_value
        self.positive_inf = positive_inf
        self.negative_inf = negative_inf
        self.date_format = date_format
        self.date_fmt_py = _java_fmt_to_py(date_format)
        self.timestamp_format = timestamp_format
        self.ts_fmt_py = (_java_fmt_to_py(timestamp_format)
                          if timestamp_format else None)
        self.mode = mode
        self.corrupt_column = corrupt_column


def convert_string_table(raw: pa.Table, schema: T.Schema,
                         opts: CsvOptions,
                         raw_lines=None) -> pa.Table:
    """All-string arrow table -> Spark-typed table under the option set.

    PERMISSIVE: malformed fields -> NULL and (if configured) the raw
    record joins the corrupt column; DROPMALFORMED removes the row;
    FAILFAST raises. ``raw_lines`` — a list of record strings OR a
    zero-arg callable returning one (resolved lazily on the FIRST bad row,
    so well-formed files never pay the extra read) — preserves the
    ORIGINAL record text, quoting/escaping included, in the corrupt
    column, matching Spark's columnNameOfCorruptRecord; the fallback
    reconstruction comma-joins the parsed fields."""
    n = raw.num_rows
    str_cols = [raw.column(i).to_pylist() if i < raw.num_columns
                else [None] * n for i in range(len(schema))]
    out_vals: List[List] = [[] for _ in schema]
    corrupt: List[Optional[str]] = []
    keep_rows: List[int] = []
    for r in range(n):
        row_vals = []
        bad = False
        for ci, f in enumerate(schema):
            s = str_cols[ci][r]
            try:
                row_vals.append(parse_field(s, f.dtype, opts))
            except FieldError:
                if opts.mode == "FAILFAST":
                    raise ValueError(
                        f"malformed field {s!r} for {f.name}:{f.dtype} "
                        f"at row {r}")
                row_vals.append(None)
                bad = True
        if bad and opts.mode == "DROPMALFORMED":
            continue
        keep_rows.append(r)
        for ci, v in enumerate(row_vals):
            out_vals[ci].append(v)
        if opts.corrupt_column:
            if not bad:
                corrupt.append(None)
            else:
                if callable(raw_lines):
                    raw_lines = raw_lines()  # lazy: first bad row only
                if raw_lines is not None and r < len(raw_lines):
                    corrupt.append(raw_lines[r])
                else:
                    corrupt.append(
                        ",".join("" if s is None else str(s)
                                 for s in (str_cols[ci][r]
                                           for ci in range(len(schema)))))
    arrays = []
    names = []
    for f, vals in zip(schema, out_vals):
        arrays.append(pa.array(vals, f.dtype.arrow_type()))
        names.append(f.name)
    if opts.corrupt_column:
        arrays.append(pa.array(corrupt, pa.string()))
        names.append(opts.corrupt_column)
    return pa.table(dict(zip(names, arrays)))


# ---------------------------------------------------------------------------
# JSON (JacksonParser analog)
# ---------------------------------------------------------------------------


def _coerce_json(v, dt: T.DataType):
    """JSON value -> Spark type, FieldError on type mismatch (Spark
    JacksonParser conversion rules; lenient number widening, strict
    cross-kind rules)."""
    if v is None:
        return None
    if dt in _INT_BOUNDS:
        if isinstance(v, bool) or not isinstance(v, int):
            raise FieldError(v)
        lo, hi = _INT_BOUNDS[dt]
        if not (lo <= v <= hi):
            raise FieldError(v)
        return v
    if dt in (T.FLOAT, T.DOUBLE):
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            # Spark accepts the string spellings for specials
            if v in ("NaN", "Infinity", "+Infinity", "-Infinity", "+INF",
                     "-INF"):
                return float("nan") if v == "NaN" else (
                    float("-inf") if str(v).startswith("-") else float("inf"))
            raise FieldError(v)
        return float(v)
    if dt == T.BOOLEAN:
        if not isinstance(v, bool):
            raise FieldError(v)
        return v
    if isinstance(dt, T.DecimalType):
        if isinstance(v, bool) or not isinstance(v, (int, float, str)):
            raise FieldError(v)
        try:
            d = _dec.Decimal(str(v))
        except _dec.InvalidOperation:
            raise FieldError(v)
        with _dec.localcontext() as c:
            c.prec = 60
            scaled = d.scaleb(dt.scale).to_integral_value(
                rounding=_dec.ROUND_HALF_UP)
        if abs(int(scaled)) >= 10 ** dt.precision:
            raise FieldError(v)
        return _dec.Decimal(int(scaled)).scaleb(-dt.scale)
    if dt == T.STRING:
        if isinstance(v, str):
            return v
        import json as _json
        return _json.dumps(v, separators=(",", ":"))
    if dt == T.DATE:
        if not isinstance(v, str):
            raise FieldError(v)
        try:
            return datetime.datetime.strptime(v, "%Y-%m-%d").date()
        except ValueError:
            raise FieldError(v)
    if dt == T.TIMESTAMP:
        if not isinstance(v, str):
            raise FieldError(v)
        return parse_field(v, T.TIMESTAMP, _DEFAULT_OPTS)
    if isinstance(dt, T.ArrayType):
        if not isinstance(v, list):
            raise FieldError(v)
        return [_coerce_json(x, dt.element) for x in v]
    raise FieldError(f"unsupported json type {dt}")


_DEFAULT_OPTS = CsvOptions()


def parse_json_lines(lines, schema: T.Schema, mode: str = "PERMISSIVE",
                     corrupt_column: Optional[str] = None) -> pa.Table:
    """Newline-delimited JSON -> Spark-typed table (permissive modes;
    whole-record failure nulls every field, like Spark)."""
    import json as _json

    assert mode in ("PERMISSIVE", "DROPMALFORMED", "FAILFAST")
    out_vals: List[List] = [[] for _ in schema]
    corrupt: List[Optional[str]] = []
    for line in lines:
        if not line.strip():
            continue
        bad = False
        try:
            obj = _json.loads(line)
            if not isinstance(obj, dict):
                raise FieldError(line)
            vals = []
            for f in schema:
                try:
                    vals.append(_coerce_json(obj.get(f.name), f.dtype))
                except FieldError:
                    vals.append(None)
                    bad = True
        except (ValueError, FieldError):
            vals = [None] * len(schema)
            bad = True
        if bad and mode == "FAILFAST":
            raise ValueError(f"malformed JSON record: {line!r}")
        if bad and mode == "DROPMALFORMED":
            continue
        for ci, v in enumerate(vals):
            out_vals[ci].append(v)
        corrupt.append(line.rstrip("\n") if bad else None)
    arrays = []
    names = []
    for f, vals in zip(schema, out_vals):
        arrays.append(pa.array(vals, f.dtype.arrow_type()))
        names.append(f.name)
    if corrupt_column:
        arrays.append(pa.array(corrupt, pa.string()))
        names.append(corrupt_column)
    return pa.table(dict(zip(names, arrays)))
