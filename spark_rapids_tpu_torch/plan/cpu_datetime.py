"""The date-and-time functions on the CPU engine (counterpart of the
datetime parts of spark_rapids_tpu/plan/cpu.py).

numpy over ``(values, valid)`` pairs, by a route of its own: calendar
fields come from numpy's ``datetime64`` units (``[D]``, ``[M]``, ``[Y]``)
where the device uses integer civil-date arithmetic (``exprs/datetime.py``),
so each engine checks the other. ``months_between`` follows the
reference's order of operations and constants (``exprs/datetime.py``), so
the double is bit-equal to the device's; the zone conversions read the
same ``utils/tzdb.py`` tables.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs.datetime import MB_RECIP_1E8, MB_RECIP_MONTH
from spark_rapids_tpu_torch.utils import tzdb

Pair = Tuple[np.ndarray, np.ndarray]
DAY_US = 86_400_000_000


def _months(days: np.ndarray) -> np.ndarray:
    """Months since 1970-01 of int days (numpy's calendar)."""
    return np.asarray(days, np.int64).astype("datetime64[D]").astype(
        "datetime64[M]").astype(np.int64)


def _first_day(months: np.ndarray) -> np.ndarray:
    """The days of the first day of each month since 1970-01."""
    return months.astype("datetime64[M]").astype("datetime64[D]").astype(
        np.int64)


def _fields(days: np.ndarray):
    """(year, month, day of month) of int days."""
    mi = _months(days)
    return (mi // 12 + 1970, mi % 12 + 1,
            np.asarray(days, np.int64) - _first_day(mi) + 1)


def _month_start(y: np.ndarray, m: np.ndarray) -> np.ndarray:
    """datetime64[M] of (year, month)."""
    return ((np.asarray(y, np.int64) - 1970) * 12
            + np.asarray(m, np.int64) - 1).astype("datetime64[M]")


def _month_len(M: np.ndarray) -> np.ndarray:
    return ((M + 1).astype("datetime64[D]")
            - M.astype("datetime64[D]")).astype(np.int64)


def _days(d: np.ndarray) -> np.ndarray:
    return np.asarray(d).astype("datetime64[D]").astype(np.int64)


def _iso_week(days: np.ndarray) -> np.ndarray:
    """ISO-8601 week: the week of the Thursday of the date's Monday-first
    week, counted from that Thursday's year's first Thursday."""
    days = np.asarray(days, np.int64)
    thursday = days - (days + 3) % 7 + 3
    jan1 = _days(thursday.astype("datetime64[D]").astype("datetime64[Y]"))
    return ((thursday - jan1) // 7 + 1).astype(np.int32)


def _civil(y, m, d):
    """(days, ok) of civil fields, ok false for a date that does not exist
    or a year outside 1..9999."""
    y, m, d = (np.asarray(a, np.int64) for a in (y, m, d))
    ok = (y >= 1) & (y <= 9999) & (m >= 1) & (m <= 12) & (d >= 1)
    M = _month_start(np.where(ok, y, 1970), np.where(ok, m, 1))
    ok &= d <= _month_len(M)
    days = _days(M.astype("datetime64[D]")) + np.where(ok, d, 1) - 1
    return np.where(ok, days, 0), ok


def _months_between(a, lt, b, rt) -> np.ndarray:
    def ymds(v, dt):
        v = np.asarray(v, np.int64)
        if dt == T.TIMESTAMP:
            days = np.floor_divide(v, DAY_US)
            # Spark truncates the time of day to whole seconds
            secs = np.floor_divide(v - days * DAY_US,
                                   1_000_000).astype(np.float64)
        else:
            days, secs = v, np.zeros(v.shape, np.float64)
        y, m, d = _fields(days)
        return y, m, d, secs

    y1, m1, d1, s1 = ymds(a, lt)
    y2, m2, d2, s2 = ymds(b, rt)
    months = (y1 - y2) * 12 + (m1 - m2)
    both_ends = ((d1 == _month_len(_month_start(y1, m1)))
                 & (d2 == _month_len(_month_start(y2, m2))))
    frac = ((d1 - d2).astype(np.float64) * 86400.0 + s1 - s2) \
        * MB_RECIP_MONTH
    out = months.astype(np.float64) + np.where((d1 == d2) | both_ends, 0.0,
                                               frac)
    return np.sign(out) * np.floor(np.abs(out) * 1e8 + 0.5) * MB_RECIP_1E8


def eval_datetime(expr: E.Expression,
                  ev: Callable[[E.Expression], Pair]) -> Pair:
    """(values, valid) of one of ``E.DATETIME_FUNCTIONS`` on the host."""
    if isinstance(expr, (E.MakeDate, E.MakeTimestamp)):
        vals = [ev(c) for c in expr.children]
        valid = np.logical_and.reduce([m for _, m in vals])
        days, ok = _civil(*(vals[i][0] for i in range(3)))
        if isinstance(expr, E.MakeDate):
            return days.astype(np.int32), valid & ok
        hh, mi = (np.asarray(vals[i][0], np.int64) for i in (3, 4))
        sec = np.asarray(vals[5][0], np.float64)
        with np.errstate(invalid="ignore"):
            ok &= ((hh >= 0) & (hh <= 23) & (mi >= 0) & (mi <= 59)
                   & (sec >= 0) & (sec < 60))
        sec = np.where(ok, sec, 0.0)
        micros = (days * DAY_US + hh * 3_600_000_000 + mi * 60_000_000
                  + np.round(sec * 1e6).astype(np.int64))
        valid = valid & ok
        return np.where(valid, micros, 0), valid
    if isinstance(expr, E.MonthsBetween):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        return (_months_between(a, expr.left.dtype, b, expr.right.dtype),
                am & bm)
    if isinstance(expr, (E.AddMonths, E.DateAdd, E.DateSub, E.DateDiff)):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        if isinstance(expr, E.AddMonths):
            d = a.astype("datetime64[D]")
            M = d.astype("datetime64[M]")
            dom = (d - M.astype("datetime64[D]")).astype(np.int64)
            target = M + b
            out = _days(target.astype("datetime64[D]")) + np.minimum(
                dom, _month_len(target) - 1)
        elif isinstance(expr, E.DateAdd):
            out = a + b
        else:
            out = a - b
        return out.astype(np.int32), am & bm
    x, m = ev(expr.children[0])
    x = np.asarray(x)
    if isinstance(expr, (E.Hour, E.Minute, E.Second)):
        tod = np.mod(x.astype(np.int64), DAY_US)
        div, mod = {E.Hour: (3_600_000_000, 24), E.Minute: (60_000_000, 60),
                    E.Second: (1_000_000, 60)}[type(expr)]
        return (tod // div % mod).astype(np.int32), m
    if isinstance(expr, E.FromUTCTimestamp):
        dd = x.astype(np.int64)
        if isinstance(expr, E.ToUTCTimestamp):
            lstarts, offs, prev = tzdb.local_transitions(expr.tz)
            ustarts, _ = tzdb.utc_transitions(expr.tz)
            j = np.clip(np.searchsorted(lstarts, dd, side="right") - 1, 0,
                        len(lstarts) - 1)
            cand = dd - prev[j]
            return np.where(cand < ustarts[j], cand, dd - offs[j]), m
        starts, offs = tzdb.utc_transitions(expr.tz)
        j = np.clip(np.searchsorted(starts, dd, side="right") - 1, 0,
                    len(starts) - 1)
        return dd + offs[j], m
    if isinstance(expr, E.UnixTimestampOf):
        us = x.astype(np.int64) * (DAY_US if expr.child.dtype == T.DATE
                                   else 1)
        return np.floor_divide(us, 1_000_000), m
    if isinstance(expr, E.FromUnixTime):
        return x.astype(np.int64) * 1_000_000, m
    if isinstance(expr, E.TimestampSeconds):
        with np.errstate(over="ignore"):
            return x.astype(np.int64) * expr.SCALE, m
    if isinstance(expr, E.UnixSeconds):
        return np.floor_divide(x.astype(np.int64), expr.DIV), m
    if isinstance(expr, (E.UnixDate, E.DateFromUnixDate)):
        return x.astype(np.int32), m
    days = x.astype(np.int64)
    if isinstance(expr, E.DayOfWeek):
        return ((days + 4) % 7 + 1).astype(np.int32), m
    if isinstance(expr, E.WeekOfYear):
        return _iso_week(days), m
    if isinstance(expr, E.NextDay):
        dow = (days + 4) % 7 + 1
        delta = (expr.target - dow) % 7
        return (days + np.where(delta == 0, 7, delta)).astype(np.int32), m
    d = days.astype("datetime64[D]")
    if isinstance(expr, E.LastDay):
        M = d.astype("datetime64[M]")
        return (_days((M + 1).astype("datetime64[D]")) - 1).astype(
            np.int32), m
    if isinstance(expr, E.TruncDate):
        unit = expr.unit
        if unit == "week":
            return (days - (days + 3) % 7).astype(np.int32), m
        if unit == "quarter":
            M = d.astype("datetime64[M]").astype(np.int64)
            out = (M - M % 3).astype("datetime64[M]")
        else:
            out = d.astype("datetime64[Y]" if unit == "year"
                           else "datetime64[M]")
        return _days(out.astype("datetime64[D]")).astype(np.int32), m
    mi = _months(days)
    if isinstance(expr, E.DayOfMonth):
        out = days - _first_day(mi) + 1
    elif isinstance(expr, E.DayOfYear):
        out = days - _first_day(mi - mi % 12) + 1
    else:
        out = {E.Year: mi // 12 + 1970, E.Month: mi % 12 + 1,
               E.Quarter: mi % 12 // 3 + 1}[type(expr)]
    return out.astype(np.int32), m
