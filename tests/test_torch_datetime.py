"""The date-and-time family and IsNaN/Nanvl in the port, held against the
JAX package's device path on the CPU (interpret mode of its jnp path) and
against the port's own CPU engine.

Inputs are made from a seed with numpy and reach every edge the family
has: dates from 0001 to 9999 and before 1970, leap days and month ends,
the ISO week edges around every New Year of 1990-2030, instants before
the epoch, and the DST gaps and overlaps of America/Los_Angeles and
Europe/Berlin. Each group of classes is one projection per input, so the
JAX device path compiles once a group.

Tolerance: integers, dates and timestamps are bit-equal, and so are the
doubles (MonthsBetween computes in the reference's order of operations;
Nanvl selects); no tolerance is used.

Where the reference reads a function of days over a TIMESTAMP as int32
days (LastDay, AddMonths, TruncDate, NextDay, DateAdd, DateSub, DateDiff,
UnixDate) the port casts the timestamp to its DATE first (Spark's
implicit cast); those are held against the reference given the DATE.
The reference's NextDay takes three-letter day names only; the port also
takes Spark's two-letter and full names.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

ENGINES = {"device": None, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                          "false"}}
US = 1_000_000
DAY_US = 86_400 * US
_E = datetime.date(1970, 1, 1)
MIN_DAY = (datetime.date(1, 1, 1) - _E).days
MAX_DAY = (datetime.date(9999, 12, 31) - _E).days


def _edge_days():
    out = []
    for y in (1, 4, 100, 400, 1582, 1900, 1969, 1970, 2000, 2024, 2100,
              9999):
        for m, d in ((1, 1), (2, 28), (3, 1), (12, 31)):
            out.append((datetime.date(y, m, d) - _E).days)
        if y % 4 == 0 and (y % 100 or y % 400 == 0):
            out.append((datetime.date(y, 2, 29) - _E).days)
    for y in range(1990, 2031):  # ISO week edges
        for d in (datetime.date(y, 12, 27) + datetime.timedelta(k)
                  for k in range(9)):
            if d.year <= 9999:
                out.append((d - _E).days)
    return out


def _edge_instants():
    out = []
    for zone_local in ("2021-03-14T02:30", "2021-11-07T01:30",
                       "2021-03-28T02:30", "2021-10-31T02:30",
                       "1969-12-31T23:59:59", "1900-01-01T00:00",
                       "2099-12-31T23:59:59"):
        base = int(np.datetime64(zone_local, "us").astype(np.int64))
        for shift_h in (-9, -8, -7, -2, -1, 0, 1):
            for k in (-1, 0, 1):
                out.append(base - shift_h * 3600 * US + k * US)
    return out


def _dates_table(seed=11, n=600):
    rng = np.random.default_rng(seed)
    days = np.concatenate([
        np.array(_edge_days(), np.int64),
        rng.integers(MIN_DAY, MAX_DAY + 1, n),
        rng.integers(-40000, 1000, n // 2)])  # before 1970
    m = len(days)
    valid = rng.random(m) > 0.05
    other = rng.integers(MIN_DAY // 2, MAX_DAY // 2, m)
    months = rng.integers(-3000, 3000, m)
    return pa.table({
        "d": pa.array(days.astype(np.int32), pa.int32(),
                      mask=~valid).cast(pa.date32()),
        "d2": pa.array(other.astype(np.int32), pa.int32()).cast(pa.date32()),
        "n": pa.array(months.astype(np.int32), pa.int32()),
        "b": pa.array(rng.integers(-128, 128, m).astype(np.int8)),
    })


def _times_table(seed=12, n=600):
    rng = np.random.default_rng(seed)
    lo, hi = MIN_DAY * DAY_US, (MAX_DAY + 1) * DAY_US - 1
    ts = np.concatenate([
        np.array(_edge_instants(), np.int64),
        rng.integers(lo, hi, n),
        rng.integers(-3 * 10**15, 10**14, n // 2),  # before 1970
        rng.integers(1_500_000_000 * US, 1_700_000_000 * US, n // 2)])
    m = len(ts)
    valid = rng.random(m) > 0.05
    days = rng.integers(MIN_DAY, MAX_DAY + 1, m)
    return pa.table({
        "ts": pa.array(ts, pa.int64(), mask=~valid).cast(
            pa.timestamp("us", tz="UTC")),
        "ts2": pa.array(rng.integers(-2 * 10**15, 4 * 10**15, m),
                        pa.int64()).cast(pa.timestamp("us", tz="UTC")),
        "d": pa.array(days.astype(np.int32), pa.int32()).cast(pa.date32()),
        "s": pa.array(rng.integers(-2**40, 2**40, m), pa.int64()),
    })


def _make_table(seed=13, n=500):
    rng = np.random.default_rng(seed)
    m = n
    year = rng.integers(-5, 10010, m)
    year[: m // 2] = rng.integers(1, 10000, m // 2)
    month = rng.integers(0, 14, m)
    day = rng.integers(0, 33, m)
    sec = np.array([round(x, k) for x, k in zip(
        rng.uniform(-1, 61, m), rng.integers(0, 7, m))])
    sec[::7] = np.nan
    return pa.table({
        "y": pa.array(year.astype(np.int32)),
        "mo": pa.array(month.astype(np.int32)),
        "dd": pa.array(day.astype(np.int32), mask=rng.random(m) < 0.05),
        "h": pa.array(rng.integers(-1, 25, m).astype(np.int32)),
        "mi": pa.array(rng.integers(-1, 61, m).astype(np.int32)),
        "sec": pa.array(sec),
        "f": pa.array(np.where(rng.random(m) < 0.3, np.nan,
                               rng.normal(size=m)).astype(np.float32),
                      mask=rng.random(m) < 0.05),
        "g": pa.array(np.where(rng.random(m) < 0.3, np.nan,
                               rng.normal(size=m)), mask=rng.random(m) < 0.1),
    })


# group -> (table builder, {name: builder(M, T, port) -> expression})
GROUPS = {
    "date_fields": (_dates_table, {
        "year": lambda M, T, p: M.Year(M.col("d")),
        "month": lambda M, T, p: M.Month(M.col("d")),
        "dayofmonth": lambda M, T, p: M.DayOfMonth(M.col("d")),
        "dayofweek": lambda M, T, p: M.DayOfWeek(M.col("d")),
        "dayofyear": lambda M, T, p: M.DayOfYear(M.col("d")),
        "quarter": lambda M, T, p: M.Quarter(M.col("d")),
        "weekofyear": lambda M, T, p: M.WeekOfYear(M.col("d")),
        "lastday": lambda M, T, p: M.LastDay(M.col("d")),
        "unixdate": lambda M, T, p: M.UnixDate(M.col("d")),
        "datefromunixdate": lambda M, T, p: M.DateFromUnixDate(M.col("n")),
    }),
    "date_arith": (_dates_table, {
        "addmonths": lambda M, T, p: M.AddMonths(M.col("d2"), M.col("n")),
        "addmonths_byte": lambda M, T, p: M.AddMonths(M.col("d2"),
                                                      M.col("b")),
        "dateadd": lambda M, T, p: M.DateAdd(M.col("d2"), M.col("n")),
        "datesub": lambda M, T, p: M.DateSub(M.col("d2"), M.col("b")),
        "datediff": lambda M, T, p: M.DateDiff(M.col("d"), M.col("d2")),
        "monthsbetween_dates": lambda M, T, p: M.MonthsBetween(
            M.col("d"), M.col("d2")),
        "trunc_year": lambda M, T, p: M.TruncDate(M.col("d"), "year"),
        "trunc_yy": lambda M, T, p: M.TruncDate(M.col("d"), "yy"),
        "trunc_quarter": lambda M, T, p: M.TruncDate(M.col("d"),
                                                     "quarter"),
        "trunc_month": lambda M, T, p: M.TruncDate(M.col("d"), "MONTH"),
        "trunc_week": lambda M, T, p: M.TruncDate(M.col("d"), "week"),
        "nextday_mo": lambda M, T, p: M.NextDay(M.col("d"),
                                                "MO" if p else "mon"),
        "nextday_sunday": lambda M, T, p: M.NextDay(
            M.col("d"), "Sunday" if p else "sun"),
        "nextday_fri": lambda M, T, p: M.NextDay(M.col("d"), "fri"),
        "unix_ts_of_date": lambda M, T, p: M.UnixTimestampOf(M.col("d")),
    }),
    "time_fields": (_times_table, {
        "hour": lambda M, T, p: M.Hour(M.col("ts")),
        "minute": lambda M, T, p: M.Minute(M.col("ts")),
        "second": lambda M, T, p: M.Second(M.col("ts")),
        "year_ts": lambda M, T, p: M.Year(M.col("ts")),
        "month_ts": lambda M, T, p: M.Month(M.col("ts")),
        "dayofweek_ts": lambda M, T, p: M.DayOfWeek(M.col("ts")),
        "dayofyear_ts": lambda M, T, p: M.DayOfYear(M.col("ts")),
        "weekofyear_ts": lambda M, T, p: M.WeekOfYear(M.col("ts")),
        "monthsbetween_ts": lambda M, T, p: M.MonthsBetween(
            M.col("ts"), M.col("ts2")),
        "monthsbetween_mixed": lambda M, T, p: M.MonthsBetween(
            M.col("ts"), M.col("d")),
        "unix_ts_of": lambda M, T, p: M.UnixTimestampOf(M.col("ts")),
        "unixseconds": lambda M, T, p: M.UnixSeconds(M.col("ts")),
        "unixmillis": lambda M, T, p: M.UnixMillis(M.col("ts")),
        "unixmicros": lambda M, T, p: M.UnixMicros(M.col("ts")),
        "fromunixtime": lambda M, T, p: M.FromUnixTime(
            M.Cast(M.UnixSeconds(M.col("ts")), T.LONG)),
        "tsseconds": lambda M, T, p: M.TimestampSeconds(M.col("s")),
        "tsmillis": lambda M, T, p: M.TimestampMillis(M.col("s")),
        "tsmicros": lambda M, T, p: M.TimestampMicros(M.col("s")),
        # the port casts a timestamp to its date for functions of days
        "lastday_ts": lambda M, T, p: M.LastDay(
            M.col("ts") if p else M.Cast(M.col("ts"), T.DATE)),
        "trunc_month_ts": lambda M, T, p: M.TruncDate(
            M.col("ts") if p else M.Cast(M.col("ts"), T.DATE), "month"),
        "datediff_ts": lambda M, T, p: M.DateDiff(
            M.col("ts") if p else M.Cast(M.col("ts"), T.DATE), M.col("d")),
    }),
    "zones": (_times_table, {
        "from_utc_la": lambda M, T, p: M.FromUTCTimestamp(
            M.col("ts"), "America/Los_Angeles"),
        "to_utc_la": lambda M, T, p: M.ToUTCTimestamp(
            M.col("ts"), "America/Los_Angeles"),
        "from_utc_berlin": lambda M, T, p: M.FromUTCTimestamp(
            M.col("ts"), "Europe/Berlin"),
        "to_utc_berlin": lambda M, T, p: M.ToUTCTimestamp(
            M.col("ts"), "Europe/Berlin"),
        "to_utc_kolkata": lambda M, T, p: M.ToUTCTimestamp(
            M.col("ts2"), "Asia/Kolkata"),
        "round_trip_la": lambda M, T, p: M.ToUTCTimestamp(
            M.FromUTCTimestamp(M.col("ts"), "America/Los_Angeles"),
            "America/Los_Angeles"),
    }),
    "make_and_nan": (_make_table, {
        "makedate": lambda M, T, p: M.MakeDate(M.col("y"), M.col("mo"),
                                               M.col("dd")),
        "maketimestamp": lambda M, T, p: M.MakeTimestamp(
            M.col("y"), M.col("mo"), M.col("dd"), M.col("h"), M.col("mi"),
            M.col("sec")),
        "isnan_float": lambda M, T, p: M.IsNaN(M.col("f")),
        "isnan_double": lambda M, T, p: M.IsNaN(M.col("g")),
        "nanvl_float": lambda M, T, p: M.Nanvl(M.col("f"), M.col("g")),
        "nanvl_double": lambda M, T, p: M.Nanvl(M.col("g"), M.lit(-1.5)),
    }),
}
# results outside 0001-9999, where the reference's civil arithmetic floors
# a negative era (it is outside Spark's range): the port's two engines
# only
PORT_GROUPS = dict(GROUPS, far_years=(_dates_table, {
    "addmonths_far": lambda M, T, p: M.AddMonths(M.col("d"), M.col("n")),
    "dateadd_far": lambda M, T, p: M.LastDay(M.DateAdd(M.col("d"),
                                                       M.col("n"))),
}))
# every class of the family appears in some group (checked below)
CLASSES = sorted(set().union(*(g[1] for g in GROUPS.values())))


def _select(df, M, cases, port):
    T = PT if port else JT
    return df.select(*[M.Alias(f(M, T, port), name)
                       for name, f in cases.items()])


def _jax_rows(group):
    build, cases = GROUPS[group]
    df = jax_from_arrow(build())
    df.shuffle_partitions = 1
    return _select(df, JE, cases, False).to_arrow()


def _port_rows(group, engine):
    build, cases = PORT_GROUPS[group]
    conf = ENGINES[engine]
    df = port_from_arrow(build(), None if conf is None else RapidsConf(conf),
                         device="cpu")
    out = _select(df, PE, cases, True)
    plan = out.explain()
    if engine == "device":
        assert "!" not in plan, plan  # every node on the device path
    return out.to_arrow()


def _storage(a: pa.Array) -> np.ndarray:
    """int64 of each value's storage (a double's bits, a date's days, a
    timestamp's microseconds; a decimal's two 64-bit limbs, shape (n,
    2)); null slots 0."""
    valid = np.asarray(a.is_valid())
    if pa.types.is_decimal(a.type):
        limbs = np.frombuffer(a.buffers()[1], np.int64, count=2 * len(a),
                              offset=a.offset * 16).reshape(len(a), 2)
        return np.where(valid[:, None], limbs, 0)
    if pa.types.is_floating(a.type):
        x = np.asarray(a.cast(pa.float64()).fill_null(0)).view(np.int64)
    elif pa.types.is_boolean(a.type):
        x = np.asarray(a.fill_null(False)).astype(np.int64)
    elif pa.types.is_date32(a.type):
        x = np.asarray(a.cast(pa.int32()).fill_null(0)).astype(np.int64)
    else:
        x = np.asarray(a.cast(pa.int64()).fill_null(0))
    return np.where(valid, x, 0)


def assert_bit_equal(got: pa.Table, exp: pa.Table, rel: float = 0.0,
                     skip=None):
    """Column by column: equal Arrow types, validity and values, doubles
    bit for bit, or within relative ``rel`` where it is given (NaN where
    NaN). ``skip``: {column: rows} left out of the value comparison."""
    assert got.column_names == exp.column_names
    for name in got.column_names:
        a, b = got[name].combine_chunks(), exp[name].combine_chunks()
        assert a.type == b.type, (name, a.type, b.type)
        keep = np.ones(len(a), np.bool_)
        if skip and name in skip:
            keep[skip[name]] = False
        va, vb = np.asarray(a.is_valid()), np.asarray(b.is_valid())
        assert np.array_equal(va[keep], vb[keep]), (
            name, np.flatnonzero(keep & (va != vb))[:5])
        if rel and pa.types.is_floating(a.type):
            x = np.asarray(a.cast(pa.float64()).fill_null(0.0))
            y = np.asarray(b.cast(pa.float64()).fill_null(0.0))
            with np.errstate(invalid="ignore"):
                same = (x == y) | (np.isnan(x) & np.isnan(y)) | (
                    np.abs(x - y) <= rel * np.maximum(np.abs(x),
                                                      np.abs(y)))
            bad = np.flatnonzero(keep & ~same)
        else:
            diff = _storage(a) != _storage(b)
            bad = np.flatnonzero(keep & (diff.any(1) if diff.ndim == 2
                                         else diff))
        assert not len(bad), (name, bad[:5], _storage(a)[bad[:3]],
                              _storage(b)[bad[:3]])


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("group", list(GROUPS))
def test_datetime_group_matches_jax(group, engine):
    """Every class of the group on the port's engine against the JAX
    device path, bit-equal (nulls included)."""
    assert_bit_equal(_port_rows(group, engine), _jax_rows(group))


@pytest.mark.parametrize("group", list(PORT_GROUPS))
def test_datetime_group_device_matches_cpu_engine(group):
    """The port's two engines on the same inputs, bit-equal."""
    assert_bit_equal(_port_rows(group, "device"),
                     _port_rows(group, "cpu_engine"))


def test_every_class_of_the_family_is_held():
    """Each of the 32 classes (and IsNaN, Nanvl) is in some group."""
    built = set()
    for build, cases in GROUPS.values():
        for f in cases.values():
            e = f(PE, PT, True)
            stack = [e]
            while stack:
                x = stack.pop()
                built.add(type(x))
                stack.extend(x.children)
    missing = [c.__name__ for c in PE.DATETIME_FUNCTIONS + (PE.IsNaN,
                                                            PE.Nanvl)
               if c not in built]
    assert not missing, missing


def test_timestamp_before_the_epoch_floors():
    """A pre-1970 instant reads its own day's time of day and date."""
    t = pa.table({"ts": pa.array([-1, -DAY_US, -DAY_US - 1], pa.int64())
                  .cast(pa.timestamp("us", tz="UTC"))})
    for conf in ENGINES.values():
        df = port_from_arrow(t, None if conf is None else RapidsConf(conf),
                             device="cpu")
        rows = df.select(PE.Hour(PE.col("ts")).alias("h"),
                         PE.Second(PE.col("ts")).alias("s"),
                         PE.DayOfMonth(PE.col("ts")).alias("d")).collect()
        assert [tuple(r.values()) for r in rows] == [
            (23, 59, 31), (0, 0, 31), (23, 59, 30)]


def test_missing_zone_raises_naming_it():
    t = pa.table({"ts": pa.array([0], pa.int64()).cast(
        pa.timestamp("us", tz="UTC"))})
    for conf in ENGINES.values():
        df = port_from_arrow(t, None if conf is None else RapidsConf(conf),
                             device="cpu")
        with pytest.raises(Exception, match="No/Such_Zone"):
            df.select(PE.FromUTCTimestamp(PE.col("ts"), "No/Such_Zone")
                      .alias("x")).collect()
