"""The date-and-time functions on the device (counterpart of the datetime
section of spark_rapids_tpu/exprs/eval.py).

A DATE is int32 days and a TIMESTAMP int64 microseconds since 1970-01-01
UTC (``resolve`` has cast each input to the unit its function reads).
Calendar fields come from Howard Hinnant's civil-from-days algorithm in
integer arithmetic, whose floor divisions (torch's ``//`` and ``%`` floor
on every device) keep the days and the time of day of instants before the
epoch right, and Hinnant's era, a truncating division, keeps dates
before year 1 right too. ``months_between`` computes its double in the
reference's order of operations, with its two divisions by constants
done as the reference's compiled path does them (XLA multiplies by the
reciprocal), so the result is bit-equal to it. The zone conversions
look each row up in ``utils/tzdb.py``'s transition table, copied once to
each device.
"""

from __future__ import annotations

import threading
from typing import Callable, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.utils import tzdb

DAY_US = 86_400_000_000
# months_between's divisions by constants, as the reference's compiled path
# performs them: XLA turns ``x / c`` into ``x * (1 / c)``
MB_RECIP_MONTH = 1.0 / (31.0 * 86400.0)
MB_RECIP_1E8 = 1.0 / 1e8
Pair = Tuple[torch.Tensor, torch.Tensor]


def civil_from_days(days: torch.Tensor):
    """(year, month, day) int32 of int32 days since the epoch."""
    z = days.int() + 719468
    # Hinnant's era is a truncating division of the adjusted day: exact
    # before year 1 too
    era = torch.div(torch.where(z >= 0, z, z - 146096), 146097,
                    rounding_mode="trunc")
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + torch.where(mp < 10, 3, -9).int()
    y = y + (m <= 2).int()
    return y.int(), m.int(), d.int()


def days_from_civil(y: torch.Tensor, m: torch.Tensor,
                    d: torch.Tensor) -> torch.Tensor:
    """int32 days since the epoch of a (year, month, day)."""
    y = y.int() - (m <= 2).int()
    era = torch.div(torch.where(y >= 0, y, y - 399), 400,
                    rounding_mode="trunc")
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9).int()
    doy = (153 * mp + 2) // 5 + d.int() - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).int()


def _first_of_next_month(y, m):
    return (torch.where(m == 12, y + 1, y), torch.where(m == 12, 1, m + 1))


def month_length(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    ny, nm = _first_of_next_month(y, m)
    one = torch.ones_like(y)
    return days_from_civil(ny, nm, one) - days_from_civil(y, m, one)


def day_of_week(days: torch.Tensor) -> torch.Tensor:
    """1 = Sunday ... 7 = Saturday; 1970-01-01 was a Thursday."""
    return (days.int() + 4) % 7 + 1


def day_of_year(days: torch.Tensor) -> torch.Tensor:
    y, _, _ = civil_from_days(days)
    one = torch.ones_like(y)
    return days.int() - days_from_civil(y, one, one) + 1


def iso_week(days: torch.Tensor) -> torch.Tensor:
    """ISO-8601 week of the year: week 1 holds the first Thursday, and a
    week that starts in December or ends in January belongs to the year of
    its Thursday."""
    days = days.int()
    doy = day_of_year(days)
    wd = (days + 3) % 7 + 1  # Monday 1 ... Sunday 7
    w = (doy - wd + 10) // 7
    y, _, _ = civil_from_days(days)

    def weeks_in(yy):
        one = torch.ones_like(yy)
        jan1_wd = (days_from_civil(yy, one, one) + 3) % 7 + 1
        leap = ((yy % 4 == 0) & (yy % 100 != 0)) | (yy % 400 == 0)
        return torch.where((jan1_wd == 4) | (leap & (jan1_wd == 3)), 53,
                           52).int()

    return torch.where(w < 1, weeks_in(y - 1),
                       torch.where(w > weeks_in(y), 1, w)).int()


_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def _zone_table(kind: str, tz: str, device) -> Tuple[torch.Tensor, ...]:
    """A zone's transition arrays (``tzdb``) on ``device``, copied once."""
    key = (kind, tz, torch.device(device))
    with _TABLES_LOCK:
        got = _TABLES.get(key)
        if got is None:
            arrays = (tzdb.utc_transitions(tz) if kind == "utc"
                      else tzdb.local_transitions(tz) + (
                          tzdb.utc_transitions(tz)[0],))
            got = tuple(torch.from_numpy(a).to(device) for a in arrays)
            _TABLES[key] = got
    return got


def _lookup(starts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Index of the table entry that applies to each ``x``."""
    j = torch.searchsorted(starts, x.contiguous(), right=True) - 1
    return j.clamp(0, starts.numel() - 1)


def _months_between(l, lt, r, rt) -> torch.Tensor:
    def ymds(v, dt):
        if dt == T.TIMESTAMP:
            days = v // DAY_US
            # Spark truncates the time of day to whole seconds
            secs = ((v - days * DAY_US) // 1_000_000).double()
        else:
            days = v
            secs = torch.zeros(v.shape, dtype=torch.float64,
                               device=v.device)
        y, m, d = civil_from_days(days.int())
        return y, m, d, secs

    y1, m1, d1, s1 = ymds(l, lt)
    y2, m2, d2, s2 = ymds(r, rt)
    months = (y1 - y2) * 12 + (m1 - m2)
    both_ends = (d1 == month_length(y1, m1)) & (d2 == month_length(y2, m2))
    sec_diff = (d1 - d2).double() * 86400.0 + s1 - s2
    frac = sec_diff * MB_RECIP_MONTH
    out = months.double() + torch.where((d1 == d2) | both_ends,
                                        torch.zeros_like(frac), frac)
    return torch.sign(out) * torch.floor(out.abs() * 1e8 + 0.5) * MB_RECIP_1E8


def _add_months(days: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    y, m, d = civil_from_days(days)
    tot = y * 12 + (m - 1) + n.int()
    ny = tot // 12
    nm = tot % 12 + 1
    return days_from_civil(ny, nm, torch.minimum(d, month_length(ny, nm)))


def _trunc(days: torch.Tensor, unit: str) -> torch.Tensor:
    y, m, _ = civil_from_days(days)
    one = torch.ones_like(y)
    if unit == "year":
        return days_from_civil(y, one, one)
    if unit == "quarter":
        return days_from_civil(y, ((m - 1) // 3) * 3 + 1, one)
    if unit == "month":
        return days_from_civil(y, m, one)
    return days.int() - (days.int() + 3) % 7  # the week's Monday


def _make_date_parts(yy, mm, dd):
    """(days, ok) of civil fields; ok false where the date does not exist
    or the year is outside 1..9999."""
    mc = mm.clamp(1, 12)
    ok = ((mm >= 1) & (mm <= 12) & (dd >= 1) & (dd <= month_length(yy, mc))
          & (yy >= 1) & (yy <= 9999))
    return days_from_civil(yy, mc, dd.clamp(1, 31)), ok


def eval_datetime(expr: E.Expression,
                  ev: Callable[[E.Expression], Pair]) -> Pair:
    """(data, validity) of one of ``E.DATETIME_FUNCTIONS``; ``ev``
    evaluates a child to its (data, validity)."""
    if isinstance(expr, (E.MakeDate, E.MakeTimestamp)):
        vals = [ev(c) for c in expr.children]
        valid = vals[0][1]
        for _, v in vals[1:]:
            valid = valid & v
        yy, mm, dd = (vals[i][0].int() for i in range(3))
        days, ok = _make_date_parts(yy, mm, dd)
        if isinstance(expr, E.MakeDate):
            return torch.where(ok, days, torch.zeros_like(days)), valid & ok
        hh, mi = vals[3][0].int(), vals[4][0].int()
        sec = vals[5][0].double()
        ok = (ok & (hh >= 0) & (hh <= 23) & (mi >= 0) & (mi <= 59)
              & (sec >= 0) & (sec < 60))
        micros = (days.long() * DAY_US + hh.long() * 3_600_000_000
                  + mi.long() * 60_000_000
                  + torch.round(torch.where(ok, sec, torch.zeros_like(sec))
                                * 1e6).long())
        valid = valid & ok
        return torch.where(valid, micros, torch.zeros_like(micros)), valid
    if isinstance(expr, E.MonthsBetween):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        return (_months_between(a, expr.left.dtype, b, expr.right.dtype),
                am & bm)
    if isinstance(expr, (E.AddMonths, E.DateAdd, E.DateSub, E.DateDiff)):
        (a, am), (b, bm) = ev(expr.left), ev(expr.right)
        if isinstance(expr, E.AddMonths):
            out = _add_months(a, b)
        elif isinstance(expr, E.DateAdd):
            out = a.int() + b.int()
        else:
            out = a.int() - b.int()
        return out, am & bm
    x, valid = ev(expr.children[0])
    if isinstance(expr, (E.Hour, E.Minute, E.Second)):
        tod = x % DAY_US  # floors: instants before the epoch too
        if isinstance(expr, E.Minute):
            out = (tod // 60_000_000) % 60
        elif isinstance(expr, E.Second):
            out = (tod // 1_000_000) % 60
        else:
            out = tod // 3_600_000_000
        return out.int(), valid
    if isinstance(expr, E.FromUTCTimestamp):
        if isinstance(expr, E.ToUTCTimestamp):
            lstarts, offs, prev, ustarts = _zone_table("local", expr.tz,
                                                       x.device)
            j = _lookup(lstarts, x)
            # a DST overlap: keep the earlier offset while it still lands
            # before the transition instant, as java.time does
            cand = x - prev[j]
            return torch.where(cand < ustarts[j], cand, x - offs[j]), valid
        starts, offs = _zone_table("utc", expr.tz, x.device)
        return x + offs[_lookup(starts, x)], valid
    if isinstance(expr, E.UnixTimestampOf):
        us = x.long() * DAY_US if expr.child.dtype == T.DATE else x.long()
        return us // 1_000_000, valid
    if isinstance(expr, E.FromUnixTime):
        return x.long() * 1_000_000, valid
    if isinstance(expr, E.TimestampSeconds):
        return x.long() * expr.SCALE, valid
    if isinstance(expr, E.UnixSeconds):
        return x.long() // expr.DIV, valid
    if isinstance(expr, (E.UnixDate, E.DateFromUnixDate)):
        return x.int(), valid
    days = x.int()
    if isinstance(expr, E.DayOfWeek):
        return day_of_week(days), valid
    if isinstance(expr, E.DayOfYear):
        return day_of_year(days), valid
    if isinstance(expr, E.WeekOfYear):
        return iso_week(days), valid
    if isinstance(expr, E.LastDay):
        y, m, _ = civil_from_days(days)
        ny, nm = _first_of_next_month(y, m)
        return days_from_civil(ny, nm, torch.ones_like(ny)) - 1, valid
    if isinstance(expr, E.TruncDate):
        return _trunc(days, expr.unit), valid
    if isinstance(expr, E.NextDay):
        delta = (expr.target - day_of_week(days)) % 7
        return days + torch.where(delta == 0, 7, delta).int(), valid
    y, m, d = civil_from_days(days)
    if isinstance(expr, E.Year):
        return y, valid
    if isinstance(expr, E.Month):
        return m, valid
    if isinstance(expr, E.Quarter):
        return (m + 2) // 3, valid
    if isinstance(expr, E.DayOfMonth):
        return d, valid
    raise NotImplementedError(
        f"expression {type(expr).__name__} is not in the port yet")
