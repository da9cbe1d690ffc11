"""Casts between strings and the scalar types on the device (counterpart of
spark_rapids_tpu/exprs/cast_strings.py).

To a string (a plain column out; ``strings.emit`` cuts each row from a
per-row byte matrix):

- the integral types and DECIMAL64/DECIMAL128: sign, the integral digits
  (at least one), and exactly ``scale`` fraction digits (``-0.05``,
  ``1.20``; Long.MIN_VALUE included);
- BOOLEAN: ``true`` / ``false``;
- DATE: ``yyyy-MM-dd``; TIMESTAMP: ``yyyy-MM-dd HH:mm:ss[.ffffff]`` in
  UTC with the fraction's trailing zeros trimmed (years clipped to
  0..9999, as the reference's).

From a string, after trimming the bytes <= 0x20 at both ends (a trimmed
literal longer than ``PARSE_WINDOW`` bytes is null on both engines, the
reference's bound), anything outside the grammar or the type's range being
null:

- integral: ``[+-]digits[.digits]``, Spark's ``UTF8String.toLong``: the
  fraction is checked and dropped (``"1.9"`` is 1; the reference's null
  is fault 19 of ROADMAP queue 3), a sign alone is invalid;
- BOOLEAN: t, true, y, yes, 1 / f, false, n, no, 0, in any case;
- DATE: ``yyyy[-M[-d]]`` (years 1..9999, each field 1-15 digits, a
  real day); TIMESTAMP: that date, then optionally ``' '`` or ``'T'`` and
  ``H:m:s[.f]`` (1-6 fraction digits), then optionally ``Z`` or ``UTC``;
- FLOAT and DOUBLE: ``[+-](digits[.digits]|.digits)[(e|E)[+-]digits]``
  with an optional ``d``/``f`` suffix (Java's ``Double.parseDouble``),
  ``Infinity`` and ``NaN`` (optionally signed), and Spark's special
  literals ``inf``, ``infinity`` (signed) and ``nan`` in any case (the
  reference nulls these and a mantissa past 15 digits: fault 20). The
  first 18 significant digits, as an int64, times an exact 106-bit power
  of ten (a double-double table), rounded once: within 1 ulp of
  Python's correctly rounded ``float()``. Hexadecimal literals are null
  (a known difference).

Each parse reads a (rows, w) byte matrix of the trimmed literals, w the
longest of them (at most ``PARSE_WINDOW``): one host read, no padding to
a fixed 64-byte window. A dictionary column is parsed through its
dictionary once and the values gathered by code (``eval._eval_cast``).
Float/double -> string, string -> decimal and ANSI string casts are the
CPU engine's (``plan/cpu_cast_strings.py``), as the reference places them.
"""

from __future__ import annotations

import fractions
from typing import Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import int128 as I128
from spark_rapids_tpu_torch.exprs import datetime as DT
from spark_rapids_tpu_torch.exprs import math as MATH
from spark_rapids_tpu_torch.exprs import strings as S

Pair = Tuple[torch.Tensor, torch.Tensor]

PARSE_WINDOW = 64
_ZERO, _NINE = ord("0"), ord("9")
_POW10 = [10 ** i for i in range(19)]
_INT64_MIN = -(1 << 63)


# ---------------------------------------------------------------------------
# value -> string
# ---------------------------------------------------------------------------


def _digits_i64(x: torch.Tensor, nd: int = 19) -> torch.Tensor:
    """(n, nd) decimal digits (0-9, most significant first) of |x|; Long.
    MIN_VALUE too: the digits come from the non-positive -|x|."""
    v = torch.where(x > 0, -x, x)
    cols = []
    for _ in range(nd):
        q = torch.div(v, 10, rounding_mode="trunc")
        cols.append(q * 10 - v)
        v = q
    return torch.stack(cols[::-1], 1)


def _digits_wide(data: torch.Tensor, nd: int = 45) -> torch.Tensor:
    """(n, nd) digits of a DECIMAL128 magnitude (nine at a time)."""
    ah, al = I128.abs_(*I128.split(data))
    cols = []
    for _ in range(nd // 9):
        ah, al, r = I128._udivmod_small(ah, al, 10 ** 9)
        for _k in range(9):
            cols.append(r % 10)
            r = r // 10
    return torch.stack(cols[::-1], 1)


def decimal_to_string(data: torch.Tensor, scale: int,
                      validity: torch.Tensor) -> DeviceColumn:
    """An integral or decimal value (int64 unscaled, or DECIMAL128 limbs) as
    ``[-]int[.frac]`` with ``scale`` fraction digits."""
    wide = data.dim() == 2
    digs = _digits_wide(data) if wide else _digits_i64(data.long())
    neg = I128.is_neg(*I128.split(data)) if wide else data < 0
    n, nd = digs.shape
    ip = nd - scale  # columns of integral digits
    dot = 1 if scale else 0
    width = 1 + ip + dot + scale
    mat = torch.zeros(n, width, dtype=torch.int64, device=data.device)
    mat[:, 1:1 + ip] = digs[:, :ip] + _ZERO
    if scale:
        mat[:, 1 + ip] = ord(".")
        mat[:, 2 + ip:] = digs[:, ip:] + _ZERO
    # integral digits: from the first non-zero one, at least one
    nz = digs[:, :ip] != 0
    first = torch.where(nz.any(1), nz.int().argmax(1),
                        torch.full((n,), ip - 1, device=data.device))
    start = 1 + first - neg.long()
    rows = torch.arange(n, device=data.device)
    mat[rows, start] = torch.where(neg, torch.full_like(start, ord("-")),
                                   mat[rows, start])
    lens = width - start
    return S.emit(mat, lens, start, validity)


def bool_to_string(data: torch.Tensor, validity: torch.Tensor
                   ) -> DeviceColumn:
    n = data.numel()
    mat = torch.tensor(list(b"falsetrue"), dtype=torch.uint8,
                       device=data.device).expand(n, 9)
    t = data.bool()
    return S.emit(mat, torch.where(t, 4, 5), torch.where(t, 5, 0), validity)


def _put2(mat, col: int, v: torch.Tensor) -> None:
    mat[:, col] = v // 10 + _ZERO
    mat[:, col + 1] = v % 10 + _ZERO


def _date_cols(mat, days: torch.Tensor) -> None:
    y, m, d = DT.civil_from_days(days)
    y = y.long().clamp(0, 9999)
    _put2(mat, 0, y // 100)
    _put2(mat, 2, y % 100)
    mat[:, 4] = ord("-")
    _put2(mat, 5, m.long())
    mat[:, 7] = ord("-")
    _put2(mat, 8, d.long())


def date_to_string(days: torch.Tensor, validity: torch.Tensor
                   ) -> DeviceColumn:
    n = days.numel()
    mat = torch.zeros(n, 10, dtype=torch.int64, device=days.device)
    _date_cols(mat, days.long())
    return S.emit(mat, torch.full((n,), 10, device=days.device),
                  torch.zeros(n, dtype=torch.int64, device=days.device),
                  validity)


def timestamp_to_string(us: torch.Tensor, validity: torch.Tensor
                        ) -> DeviceColumn:
    us = us.long()
    n = us.numel()
    days = torch.div(us, 86_400_000_000, rounding_mode="floor")
    rem = us - days * 86_400_000_000
    secs, frac = rem // 1_000_000, rem % 1_000_000
    mat = torch.zeros(n, 26, dtype=torch.int64, device=us.device)
    _date_cols(mat, days)
    mat[:, 10] = ord(" ")
    _put2(mat, 11, secs // 3600)
    mat[:, 13] = ord(":")
    _put2(mat, 14, (secs // 60) % 60)
    mat[:, 16] = ord(":")
    _put2(mat, 17, secs % 60)
    mat[:, 19] = ord(".")
    fd = _digits_i64(frac, 6)
    mat[:, 20:] = fd + _ZERO
    # the fraction without its trailing zeros (none at all when it is 0)
    nz = fd != 0
    last = torch.where(nz.any(1), 5 - nz.flip(1).int().argmax(1),
                       torch.full((n,), -1, device=us.device))
    lens = torch.where(frac > 0, 21 + last, torch.full_like(last, 19))
    return S.emit(mat, lens, torch.zeros_like(lens), validity)


def to_string(data: torch.Tensor, validity: torch.Tensor,
              src: T.DataType) -> DeviceColumn:
    """A device value of ``src`` as a plain string column."""
    if src == T.BOOLEAN:
        return bool_to_string(data, validity)
    if src == T.DATE:
        return date_to_string(data, validity)
    if src == T.TIMESTAMP:
        return timestamp_to_string(data, validity)
    if src in T.INTEGRAL_TYPES or isinstance(src, T.DecimalType):
        return decimal_to_string(data, getattr(src, "scale", 0), validity)
    raise NotImplementedError(f"cast {src} -> string is not on device")


# ---------------------------------------------------------------------------
# string -> value
# ---------------------------------------------------------------------------


class Literals:
    """The trimmed literals of a plain string column as a (rows, w) byte
    matrix (int64, 0 past each literal), with each literal's length and
    whether it was longer than ``PARSE_WINDOW``."""

    def __init__(self, col: DeviceColumn):
        n, dev = col.num_rows, col.device
        nbytes = col.data.numel()
        rows = S.row_ids(col.offsets, nbytes)
        pos = torch.arange(nbytes, device=dev)
        content = col.data > 0x20
        first = torch.full((n,), nbytes, dtype=torch.int64, device=dev)
        last = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if nbytes:
            first.scatter_reduce_(0, rows[content], pos[content], "amin")
            last.scatter_reduce_(0, rows[content], pos[content], "amax")
        tlen = torch.where(last >= 0, last - first + 1,
                           torch.zeros_like(last))
        self.too_long = tlen > PARSE_WINDOW
        self.tlen = tlen.clamp(max=PARSE_WINDOW)
        w = int(self.tlen.max()) if n else 0
        self.w = max(w, 1)
        self.idx = torch.arange(self.w, device=dev)
        at = first[:, None].clamp(max=max(nbytes - 1, 0)) + self.idx
        inside = self.idx < self.tlen[:, None]
        if nbytes:
            self.mat = torch.where(inside, col.data[at.clamp(
                max=nbytes - 1)].long(), torch.zeros_like(at))
        else:
            self.mat = torch.zeros(n, self.w, dtype=torch.int64, device=dev)
        self.is_dig = (self.mat >= _ZERO) & (self.mat <= _NINE)
        self.dig = torch.where(self.is_dig, self.mat - _ZERO,
                               torch.zeros_like(self.mat))
        self.validity = col.validity & ~self.too_long
        self.n = n

    def byte(self, at: torch.Tensor) -> torch.Tensor:
        """Each row's byte at ``at`` (0 outside its literal)."""
        ok = (at >= 0) & (at < self.tlen)
        got = self.mat.gather(1, at.clamp(0, self.w - 1)[:, None])[:, 0]
        return torch.where(ok, got, torch.zeros_like(got))

    def find(self, ch: int, start: torch.Tensor,
             end: torch.Tensor) -> torch.Tensor:
        """Each row's first position of byte ``ch`` in [start, end), else
        end."""
        hit = ((self.mat == ch) & (self.idx >= start[:, None])
               & (self.idx < end[:, None]))
        pos = torch.where(hit, self.idx, torch.full_like(self.idx, self.w))
        return torch.minimum(pos.min(1).values, end)

    def field(self, start: torch.Tensor, end: torch.Tensor,
              most: int = 15) -> Pair:
        """(value, ok) of the digits in [start, end): 1..``most`` digits
        (at most 18), nothing else."""
        sel = (self.idx >= start[:, None]) & (self.idx < end[:, None])
        ok = ((~sel | self.is_dig).all(1) & (end > start)
              & (end - start <= most))
        place = (end[:, None] - 1 - self.idx).clamp(0, 18)
        pw = torch.tensor(_POW10, dtype=torch.int64,
                          device=self.mat.device)[place]
        return (torch.where(sel, self.dig * pw,
                            torch.zeros_like(pw)).sum(1), ok)

    def lower(self) -> torch.Tensor:
        m = self.mat
        return torch.where((m >= ord("A")) & (m <= ord("Z")), m + 32, m)

    def equals(self, mat: torch.Tensor, start: torch.Tensor,
               word: bytes) -> torch.Tensor:
        """Whether the literal from ``start`` to its end is ``word``."""
        ok = self.tlen - start == len(word)
        for k, ch in enumerate(word):
            at = (start + k).clamp(0, self.w - 1)[:, None]
            ok = ok & (mat.gather(1, at)[:, 0] == ch)
        return ok


def _sign(lit: Literals):
    c0 = lit.mat[:, 0]
    neg = c0 == ord("-")
    return neg, (neg | (c0 == ord("+"))).long()


def string_to_integral(lit: Literals, dst: T.DataType) -> Pair:
    """Spark's ``UTF8String.toLong``: an optional sign, digits, and an
    optional ``.`` whose fraction digits are checked and dropped."""
    neg, p0 = _sign(lit)
    end = lit.tlen
    dot = lit.find(ord("."), p0, end)
    in_num = ((lit.idx >= p0[:, None]) & (lit.idx < end[:, None])
              & (lit.idx != dot[:, None]))
    ok = (~in_num | lit.is_dig).all(1) & (end > p0)
    # the integral digits' magnitude: at most 19 significant digits, whose
    # int64 sum wraps to the uint64 bits of the magnitude (< 10**19)
    sel = (lit.idx >= p0[:, None]) & (lit.idx < dot[:, None])
    nonzero = sel & (lit.dig != 0)
    first = torch.where(nonzero, lit.idx, torch.full_like(lit.idx, lit.w)
                        ).min(1).values
    ok = ok & (dot - first <= 19)
    place = (dot[:, None] - 1 - lit.idx).clamp(0, 18)
    pw = torch.tensor(_POW10, dtype=torch.int64, device=lit.mat.device)[place]
    mag = torch.where(sel, lit.dig * pw, torch.zeros_like(pw)).sum(1)
    # past int64: a positive needs mag <= MAX (non-negative bits), a
    # negative mag <= 2**63 (non-negative bits or exactly MIN's)
    ok = ok & ((mag >= 0) | (neg & (mag == _INT64_MIN)))
    val = torch.where(neg, -mag, mag)
    if dst != T.LONG:
        info = torch.iinfo(dst.torch_dtype)
        ok = ok & (val >= info.min) & (val <= info.max)
    val = torch.where(ok, val, torch.zeros_like(val))
    return val.to(dst.torch_dtype), lit.validity & ok


_TRUE = (b"true", b"t", b"yes", b"y", b"1")
_FALSE = (b"false", b"f", b"no", b"n", b"0")


def string_to_boolean(lit: Literals) -> Pair:
    low = lit.lower()
    zero = torch.zeros_like(lit.tlen)
    t = torch.zeros(lit.n, dtype=torch.bool, device=low.device)
    f = torch.zeros_like(t)
    for w in _TRUE:
        t = t | lit.equals(low, zero, w)
    for w in _FALSE:
        f = f | lit.equals(low, zero, w)
    return t, lit.validity & (t | f)


def _date_part(lit: Literals, end: torch.Tensor) -> Pair:
    """(days, ok) of ``yyyy[-M[-d]]`` in [0, end)."""
    zero = torch.zeros_like(end)
    d1 = lit.find(ord("-"), torch.ones_like(end), end)
    y, oky = lit.field(zero, d1)
    has_m = d1 < end
    d2 = lit.find(ord("-"), d1 + 1, end)
    m, okm = lit.field(d1 + 1, d2)
    has_d = d2 < end
    d, okd = lit.field(d2 + 1, end)
    m = torch.where(has_m, m, torch.ones_like(m))
    d = torch.where(has_d, d, torch.ones_like(d))
    ok = (oky & (okm | ~has_m) & (okd | ~has_d) & (y >= 1) & (y <= 9999)
          & (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31) & (d1 <= 5))
    y, m, d = (torch.where(ok, v, torch.ones_like(v)) for v in (y, m, d))
    days = DT.days_from_civil(y, m, d)
    ry, rm, rd = DT.civil_from_days(days)
    ok = ok & (ry == y) & (rm == m) & (rd == d)
    return days.long(), ok


def string_to_date(lit: Literals) -> Pair:
    days, ok = _date_part(lit, lit.tlen)
    days = torch.where(ok, days, torch.zeros_like(days))
    return days.int(), lit.validity & ok


def string_to_timestamp(lit: Literals) -> Pair:
    end = lit.tlen
    last = lit.byte(end - 1)
    is_utc = ((end >= 3) & (lit.byte(end - 3) == ord("U"))
              & (lit.byte(end - 2) == ord("T")) & (last == ord("C")))
    endz = torch.where(is_utc, end - 3,
                       torch.where((end >= 1) & (last == ord("Z")), end - 1,
                                   end))
    zero = torch.zeros_like(end)
    sep = torch.minimum(lit.find(ord(" "), zero, endz),
                        lit.find(ord("T"), zero, endz))
    has_time = sep < endz
    days, okd = _date_part(lit, sep)
    c1 = lit.find(ord(":"), sep + 1, endz)
    c2 = lit.find(ord(":"), c1 + 1, endz)
    dot = lit.find(ord("."), c2 + 1, endz)
    h, okh = lit.field(sep + 1, c1)
    mi, okm = lit.field(c1 + 1, c2)
    s, oks = lit.field(c2 + 1, dot)
    has_frac = dot < endz
    f, okf = lit.field(dot + 1, endz, most=6)
    flen = (endz - dot - 1).clamp(0, 6)
    micros = f * torch.tensor([10 ** (6 - k) for k in range(7)],
                              dtype=torch.int64, device=f.device)[flen]
    okt = (okh & okm & oks & (okf | ~has_frac) & (h <= 23) & (mi <= 59)
           & (s <= 59) & (c1 < endz) & (c2 < endz))
    ok = okd & (okt | ~has_time)
    t = torch.where(has_time, h * 3_600_000_000 + mi * 60_000_000
                    + s * 1_000_000 + torch.where(has_frac, micros,
                                                  torch.zeros_like(micros)),
                    torch.zeros_like(h))
    us = days * 86_400_000_000 + t
    return torch.where(ok, us, torch.zeros_like(us)), lit.validity & ok


# 10**e for e in [_E_MIN, _E_MAX] as (m_hi, m_lo, x): 10**e = (m_hi + m_lo)
# * 2**x, m_hi in [0.5, 1), m_hi + m_lo within 2**-106 of exact
_E_MIN, _E_MAX = -400, 400
_POW_TABLES: dict = {}


def _pow10_table(device) -> torch.Tensor:
    key = torch.device(device)
    tbl = _POW_TABLES.get(key)
    if tbl is None:
        rows = []
        for e in range(_E_MIN, _E_MAX + 1):
            p = fractions.Fraction(10) ** e
            x = p.numerator.bit_length() - p.denominator.bit_length()
            while p / fractions.Fraction(2) ** x >= 1:
                x += 1
            while p / fractions.Fraction(2) ** x < fractions.Fraction(1, 2):
                x -= 1
            m = p / fractions.Fraction(2) ** x
            hi = float(m)
            lo = float(m - fractions.Fraction(hi))
            rows.append((hi, lo, float(x)))
        tbl = _POW_TABLES[key] = torch.tensor(rows, dtype=torch.float64,
                                              device=key)
    return tbl


def _scale10(m: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """m * 10**e (m an int64 below 10**18) rounded once from a double-double
    product: within 1 ulp of the exact value."""
    tbl = _pow10_table(m.device)[(e.clamp(_E_MIN, _E_MAX) - _E_MIN)]
    ph, pl, x = tbl[:, 0], tbl[:, 1], tbl[:, 2].long()
    mh = m.double()
    ml = (m - mh.long()).double()  # exact: |m - mh| < 2**10
    p = mh * ph
    ah, al = MATH.split(mh)
    bh, bl = MATH.split(ph)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    t = p + (err + mh * pl + ml * ph)
    half = torch.div(x, 2, rounding_mode="floor")
    return t * _pow2(half) * _pow2(x - half)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2.0**k for int64 k in [-1022, 1023], exactly (its bits)."""
    return ((k + 1023) << 52).view(torch.float64)


def string_to_fractional(lit: Literals, dst: T.DataType) -> Pair:
    neg, p0 = _sign(lit)
    end = lit.tlen
    low = lit.lower()
    # Java's Infinity/NaN and Spark's inf/infinity/nan in any case
    is_inf = (lit.equals(low, p0, b"inf") | lit.equals(low, p0, b"infinity"))
    is_nan = ((lit.equals(low, p0, b"nan") & (p0 == 0))
              | lit.equals(lit.mat, p0, b"NaN"))
    # an optional d/f suffix
    sfx = lit.byte(end - 1)
    mend = torch.where((end > p0 + 1) & ((sfx == ord("d")) | (sfx == ord("D"))
                                         | (sfx == ord("f"))
                                         | (sfx == ord("F"))), end - 1, end)
    epos = torch.minimum(lit.find(ord("e"), p0, mend),
                         lit.find(ord("E"), p0, mend))
    dot = lit.find(ord("."), p0, epos)
    has_exp = epos < mend
    in_mant = ((lit.idx >= p0[:, None]) & (lit.idx < epos[:, None])
               & (lit.idx != dot[:, None]))
    n_digits = in_mant.sum(1)
    ok = (~in_mant | lit.is_dig).all(1) & (n_digits > 0)
    # the exponent: a sign, then 1+ digits (saturated far past any finite
    # result)
    es = lit.byte(epos + 1)
    eneg = es == ord("-")
    e0 = epos + 1 + (eneg | (es == ord("+"))).long()
    esel = (lit.idx >= e0[:, None]) & (lit.idx < mend[:, None])
    e_ok = (~esel | lit.is_dig).all(1) & (mend > e0)
    # leading zeros of the exponent do not count
    e_first = torch.where(esel & (lit.dig != 0), lit.idx,
                          torch.full_like(lit.idx, lit.w)).min(1).values
    big = mend - e_first > 6
    ev, _ok = lit.field(torch.maximum(e0, e_first), mend, most=18)
    ev = torch.where(big, torch.full_like(ev, 10 ** 6), ev)
    ev = torch.where(has_exp, torch.where(eneg, -ev, ev),
                     torch.zeros_like(ev))
    ok = ok & (e_ok | ~has_exp)
    # the first 18 significant digits as an int64, and the power of ten
    # that places them
    c = torch.cumsum(in_mant.long(), 1) - in_mant.long()  # digit index
    sig = in_mant & (lit.dig != 0)
    n = lit.n
    big_c = torch.full((n,), 1 << 30, dtype=torch.int64, device=c.device)
    fsd = torch.where(sig, c, big_c[:, None]).min(1).values
    n_int = (in_mant & (lit.idx < dot[:, None])).sum(1)
    take = in_mant & (c >= fsd[:, None]) & (c < fsd[:, None] + 18)
    place = (fsd[:, None] + 17 - c).clamp(0, 18)
    pw = torch.tensor(_POW10, dtype=torch.int64, device=c.device)[place]
    m = torch.where(take, lit.dig * pw, torch.zeros_like(pw)).sum(1)
    e10 = (n_int - fsd - 18 + ev).clamp(-100_000, 100_000)
    val = torch.where(fsd >= big_c, torch.zeros_like(m, dtype=torch.float64),
                      _scale10(m, e10))
    val = torch.where(e10 > _E_MAX, torch.full_like(val, float("inf")), val)
    val = torch.where((e10 < _E_MIN) | (m == 0), torch.zeros_like(val), val)
    val = torch.where(is_inf, torch.full_like(val, float("inf")), val)
    val = torch.where(is_nan, torch.full_like(val, float("nan")), val)
    val = torch.where(neg, -val, val)
    ok = (ok | is_inf | is_nan) & (end > 0)
    val = torch.where(ok, val, torch.zeros_like(val))
    return val.to(dst.torch_dtype), lit.validity & ok


def from_string(col: DeviceColumn, dst: T.DataType) -> Pair:
    """(data, validity) of a plain string column cast to ``dst``."""
    lit = Literals(col)
    if dst in T.INTEGRAL_TYPES:
        return string_to_integral(lit, dst)
    if dst == T.BOOLEAN:
        return string_to_boolean(lit)
    if dst == T.DATE:
        return string_to_date(lit)
    if dst == T.TIMESTAMP:
        return string_to_timestamp(lit)
    if dst in T.FRACTIONAL_TYPES:
        return string_to_fractional(lit, dst)
    raise NotImplementedError(f"cast string -> {dst} is not on device")
