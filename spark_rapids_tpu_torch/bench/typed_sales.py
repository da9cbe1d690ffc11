"""A typed store_sales pass: TPC-DS store_sales retyped to the narrow
types a Spark user's Parquet holds (TINYINT quantity, SMALLINT store key,
FLOAT money, a TIMESTAMP of sale), and five queries over it that carry the
scalar types and the date-and-time family through every operator.

``typed_store_sales(tables)`` builds the table with pyarrow alone from
``tpcds_schema``'s store_sales, date_dim and time_dim:

- ``ss_quantity`` int8 (1-100), ``ss_store_sk`` int16;
- ``ss_sales_price``, ``ss_ext_discount_amt`` and ``ss_net_profit``
  float32 (from decimal(7,2));
- ``sold_ts`` a ``timestamp[us, UTC]``: ``d_date`` of ``ss_sold_date_sk``
  plus ``t_time`` (seconds) of ``ss_sold_time_sk``;
- ``ss_ticket_number`` and ``ss_item_sk`` as they are; the generator's
  nulls are kept (null keys give a null quantity, store or time).

The queries take the DataFrames of ``df_tables`` and a ``Lib`` (the
expression, window, type and sort-order modules to build with, the port's
by default; the tests pass the JAX package's to run the same plans there):

- T1, hourly profile (the shape of q88/q96): sales between two TIMESTAMP
  literals grouped by hour and day of week: Sum of a FLOAT, Average of a
  TINYINT, Min/Max of a SMALLINT, Count, ORDER BY;
- T2, calendar pass: one projection of every date-time class over all
  rows (TruncDate at MONTH, QUARTER and YEAR, NextDay 'MO', the Unix and
  Timestamp conversions, the zone conversions with America/Los_Angeles),
  then a Sum and a Count of each column (dates as days, timestamps as
  microseconds);
- T3, hour-bucket join: an aggregate per (store, hour bucket as a
  TIMESTAMP) joined back to the sales on both keys, each sale's share of
  its hour summed per store;
- T4, rolling windows: per store, ordered by ``sold_ts``, a RANGE frame of
  one hour (3,600,000,000 microseconds) before each row with a FLOAT Sum
  and a Count, and ROWS 10 PRECEDING..CURRENT ROW Min/Max of the TINYINT
  quantity, summed per store;
- T5 (partitioned) is T1 and T3 on several splits and shuffle partitions
  (``df_tables(..., partitions=4, shuffle_partitions=4)``) and the global
  sorts ``GLOBAL_SORT`` (ORDER BY sold_ts DESC, through a range exchange)
  and ``GLOBAL_SORT2`` (ORDER BY sold_ts DESC, ss_sales_price: two keys,
  which the planner, as the reference's, sorts in one partition).

``pandas_t1`` is an independent pandas computation of T1.
"""

from __future__ import annotations

import datetime
from typing import Dict, NamedTuple

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch.exprs.expr import timestamp_micros

HOUR_US = 3_600_000_000
ZONE = "America/Los_Angeles"
T1_FROM = datetime.datetime(1999, 3, 1, tzinfo=datetime.timezone.utc)
T1_TO = datetime.datetime(2002, 10, 31, 23, 59, 59,
                          tzinfo=datetime.timezone.utc)
TABLES = ("store_sales", "date_dim", "time_dim")


class Lib(NamedTuple):
    """The modules a query is built with."""

    E: object
    T: object
    W: object
    SortOrder: type
    port: bool = True


def port_lib() -> Lib:
    from spark_rapids_tpu_torch import types
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.exprs import expr, window

    return Lib(expr, types, window, SortOrder, True)


def _lookup(keys: pa.ChunkedArray, dim_keys: np.ndarray,
            dim_vals: np.ndarray):
    """(dimension value of each key, valid): a null or unmatched key is
    null."""
    k = keys.combine_chunks()
    valid = np.asarray(k.is_valid(), np.bool_)
    kv = np.asarray(k.fill_null(0), np.int64)
    order = np.argsort(dim_keys, kind="stable")
    sk = dim_keys[order]
    pos = np.clip(np.searchsorted(sk, kv), 0, len(sk) - 1)
    hit = valid & (sk[pos] == kv)
    return np.where(hit, dim_vals[order][pos], 0), hit


def _as_float32(col: pa.ChunkedArray) -> pa.Array:
    return col.combine_chunks().cast(pa.float64()).cast(pa.float32())


def typed_store_sales(tables: Dict[str, pa.Table]) -> pa.Table:
    """The typed table (see the module docstring) from the three TPC-DS
    tables."""
    ss, dd, td = (tables[n] for n in TABLES)
    days, dok = _lookup(ss.column("ss_sold_date_sk"),
                        np.asarray(dd.column("d_date_sk"), np.int64),
                        np.asarray(dd.column("d_date").cast(pa.int32()),
                                   np.int64))
    secs, tok = _lookup(ss.column("ss_sold_time_sk"),
                        np.asarray(td.column("t_time_sk"), np.int64),
                        np.asarray(td.column("t_time"), np.int64))
    ts = days * 86_400_000_000 + secs * 1_000_000
    qty = ss.column("ss_quantity").combine_chunks()
    store = ss.column("ss_store_sk").combine_chunks()
    return pa.table({
        "ss_ticket_number": ss.column("ss_ticket_number"),
        "ss_item_sk": ss.column("ss_item_sk"),
        "ss_store_sk": store.cast(pa.int16()),
        "ss_quantity": qty.cast(pa.int8()),
        "ss_sales_price": _as_float32(ss.column("ss_sales_price")),
        "ss_ext_discount_amt": _as_float32(ss.column("ss_ext_discount_amt")),
        "ss_net_profit": _as_float32(ss.column("ss_net_profit")),
        "sold_ts": pa.array(ts, pa.int64(), mask=~(dok & tok)).cast(
            pa.timestamp("us", tz="UTC")),
    })


def tables_for(sf: float, seed: int = 0) -> Dict[str, pa.Table]:
    """``{"typed_store_sales": ...}`` at scale factor ``sf``."""
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    return {"typed_store_sales": typed_store_sales(
        S.tables_for(sf, seed, names=TABLES))}


def df_tables(tables, conf=None, batch_rows: int = 1 << 22, device=None,
              partitions: int = 1, shuffle_partitions: int = 4):
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    return Q.df_tables(tables, conf, batch_rows=batch_rows, device=device,
                       partitions=partitions,
                       shuffle_partitions=shuffle_partitions)


def _ts(L: Lib):
    return L.E.col("sold_ts")


def _date(L: Lib):
    return L.E.Cast(_ts(L), L.T.DATE)


def _day_of_week(L: Lib):
    """DayOfWeek of the sale: of the timestamp itself in the port; of its
    date in the reference, whose CPU engine reads a timestamp's
    microseconds as days there (its device path does not)."""
    return L.E.DayOfWeek(_ts(L) if L.port else _date(L))


def t1(d, L: Lib = None):
    L = L or port_lib()
    E, T = L.E, L.T
    s = d["typed_store_sales"]
    # the port reads a datetime literal as a TIMESTAMP; the reference
    # takes its microseconds
    lo, hi = ((T1_FROM, T1_TO) if L.port else
              (timestamp_micros(T1_FROM), timestamp_micros(T1_TO)))
    s = s.filter(E.And(E.GreaterThanOrEqual(_ts(L), E.lit(lo, T.TIMESTAMP)),
                       E.LessThanOrEqual(_ts(L), E.lit(hi, T.TIMESTAMP))))
    s = s.select(E.Alias(E.Hour(_ts(L)), "hr"),
                 E.Alias(_day_of_week(L), "dow"), E.col("ss_quantity"),
                 E.col("ss_store_sk"), E.col("ss_sales_price"))
    g = s.group_by("hr", "dow").agg(
        E.Alias(E.Sum(E.col("ss_sales_price")), "sum_price"),
        E.Alias(E.Average(E.col("ss_quantity")), "avg_qty"),
        E.Alias(E.Min(E.col("ss_store_sk")), "min_store"),
        E.Alias(E.Max(E.col("ss_store_sk")), "max_store"),
        E.Alias(E.Count(), "n"))
    return g.sort(L.SortOrder(E.col("hr")), L.SortOrder(E.col("dow")))


def t2_columns(L: Lib):
    """(name, expression) of the calendar pass: every class of the
    family over ``sold_ts`` and the narrow columns; dates as their days
    (UnixDate), timestamps as their microseconds (UnixMicros)."""
    E, T = L.E, L.T
    ts, dt = _ts(L), _date(L)

    def days(e):
        return E.UnixDate(e)

    def micros(e):
        return E.UnixMicros(e)

    secs = E.UnixTimestampOf(ts)
    return [
        ("year", E.Year(ts)), ("month", E.Month(ts)),
        ("dom", E.DayOfMonth(ts)), ("dow", _day_of_week(L)),
        ("doy", E.DayOfYear(ts)), ("quarter", E.Quarter(ts)),
        ("week", E.WeekOfYear(ts)), ("hour", E.Hour(ts)),
        ("minute", E.Minute(ts)), ("second", E.Second(ts)),
        ("last_day", days(E.LastDay(dt))),
        ("add_months", days(E.AddMonths(dt, E.col("ss_quantity")))),
        ("months_between", E.MonthsBetween(ts, E.TruncDate(dt, "year"))),
        ("trunc_month", days(E.TruncDate(dt, "MONTH"))),
        ("trunc_quarter", days(E.TruncDate(dt, "QUARTER"))),
        ("trunc_year", days(E.TruncDate(dt, "YEAR"))),
        ("next_day", days(E.NextDay(dt, "MO" if L.port else "mon"))),
        ("date_add", days(E.DateAdd(dt, E.col("ss_quantity")))),
        ("date_sub", days(E.DateSub(dt, E.col("ss_store_sk")))),
        ("date_diff", E.DateDiff(dt, E.lit(datetime.date(1998, 1, 1)))),
        ("unix_ts", secs),
        ("from_unixtime", micros(E.FromUnixTime(secs))),
        ("make_date", days(E.MakeDate(E.Year(ts), E.Month(ts),
                                      E.DayOfMonth(ts)))),
        ("make_ts", micros(E.MakeTimestamp(
            E.Year(ts), E.Month(ts), E.DayOfMonth(ts), E.Hour(ts),
            E.Minute(ts), E.Cast(E.Second(ts), T.DOUBLE)))),
        ("ts_seconds", micros(E.TimestampSeconds(secs))),
        ("ts_millis", micros(E.TimestampMillis(E.UnixMillis(ts)))),
        ("ts_micros", micros(E.TimestampMicros(E.UnixMicros(ts)))),
        ("unix_seconds", E.UnixSeconds(ts)),
        ("unix_date", days(dt)),
        ("from_unix_date", days(E.DateFromUnixDate(days(dt)))),
        ("from_utc", micros(E.FromUTCTimestamp(ts, ZONE))),
        ("to_utc", micros(E.ToUTCTimestamp(ts, ZONE))),
    ]


def t2(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    cols = t2_columns(L)
    p = d["typed_store_sales"].select(*[E.Alias(e, n) for n, e in cols])
    aggs = []
    for n, _ in cols:
        aggs += [E.Alias(E.Sum(E.col(n)), f"sum_{n}"),
                 E.Alias(E.Count(E.col(n)), f"n_{n}")]
    return p.agg(*aggs)


def hour_bucket(L: Lib):
    """A sale's hour as a TIMESTAMP (its date, its hour, minute 0)."""
    E, T = L.E, L.T
    ts = _ts(L)
    return E.MakeTimestamp(E.Year(ts), E.Month(ts), E.DayOfMonth(ts),
                           E.Hour(ts), E.lit(0), E.lit(0.0, T.DOUBLE))


def t3(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    s = d["typed_store_sales"].select(
        E.col("ss_store_sk"), E.Alias(hour_bucket(L), "hb"),
        E.col("ss_net_profit"))
    hours = s.group_by("ss_store_sk", "hb").agg(
        E.Alias(E.Sum(E.col("ss_net_profit")), "hour_profit"),
        E.Alias(E.Count(), "hour_n"))
    j = s.join(hours, on=["ss_store_sk", "hb"], how="inner")
    j = j.select(E.col("ss_store_sk"), E.col("hb"), E.col("hour_n"),
                 E.Alias(E.Divide(E.col("ss_net_profit"),
                                  E.col("hour_profit")), "share"))
    return j.group_by("ss_store_sk").agg(
        E.Alias(E.Sum(E.col("share")), "shares"),
        E.Alias(E.Count(E.col("share")), "n_share"),
        E.Alias(E.Sum(E.col("hour_n")), "sum_hour_n"),
        E.Alias(E.Min(E.col("hb")), "first_hour"),
        E.Alias(E.Max(E.col("hb")), "last_hour"),
        E.Alias(E.Count(), "n")).sort(L.SortOrder(E.col("ss_store_sk")))


def t4_windows(d, L: Lib = None):
    """The sales with the four rolling-window columns."""
    L = L or port_lib()
    E, W = L.E, L.W
    s = d["typed_store_sales"].select(
        E.col("ss_store_sk"), E.col("sold_ts"), E.col("ss_ticket_number"),
        E.col("ss_item_sk"), E.col("ss_quantity"), E.col("ss_sales_price"))
    part = (E.col("ss_store_sk"),)
    hour = W.WindowSpec(part, (L.SortOrder(_ts(L)),),
                        W.WindowFrame("range", -HOUR_US, 0))
    # ROWS over a total order: rows that tie on every key are equal in
    # quantity, so the frame's Min/Max cannot depend on their order
    rows = W.WindowSpec(part, tuple(L.SortOrder(E.col(c)) for c in (
        "sold_ts", "ss_ticket_number", "ss_item_sk", "ss_quantity")),
        W.WindowFrame("rows", -10, 0))
    s = s.with_window(
        E.Alias(W.WindowExpression(E.Sum(E.col("ss_sales_price")), hour),
                "hour_sum"),
        E.Alias(W.WindowExpression(E.Count(E.col("ss_sales_price")), hour),
                "hour_n"))
    return s.with_window(
        E.Alias(W.WindowExpression(E.Min(E.col("ss_quantity")), rows),
                "min_q10"),
        E.Alias(W.WindowExpression(E.Max(E.col("ss_quantity")), rows),
                "max_q10"))


def t4(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    return t4_windows(d, L).group_by("ss_store_sk").agg(
        E.Alias(E.Sum(E.col("hour_sum")), "sum_hour_sum"),
        E.Alias(E.Sum(E.col("hour_n")), "sum_hour_n"),
        E.Alias(E.Sum(E.col("min_q10")), "sum_min_q10"),
        E.Alias(E.Sum(E.col("max_q10")), "sum_max_q10"),
        E.Alias(E.Min(E.col("min_q10")), "min_min_q10"),
        E.Alias(E.Max(E.col("max_q10")), "max_max_q10"),
        E.Alias(E.Count(), "n")).sort(L.SortOrder(E.col("ss_store_sk")))


def global_sort(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    return d["typed_store_sales"].select(
        E.col("sold_ts"), E.col("ss_sales_price")).sort(
        L.SortOrder(_ts(L), False))


def global_sort2(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    return d["typed_store_sales"].select(
        E.col("sold_ts"), E.col("ss_sales_price")).sort(
        L.SortOrder(_ts(L), False), L.SortOrder(E.col("ss_sales_price")))


QUERIES = {"T1": t1, "T2": t2, "T3": t3, "T4": t4}
GLOBAL_SORTS = {"GLOBAL_SORT": global_sort, "GLOBAL_SORT2": global_sort2}


def pandas_t1(table: pa.Table):
    """T1 by pandas over the typed table: rows as dicts in T1's order."""
    import pandas as pd

    ts = np.asarray(table.column("sold_ts").cast(pa.int64()).fill_null(0))
    ok = np.asarray(table.column("sold_ts").is_valid())
    lo, hi = timestamp_micros(T1_FROM), timestamp_micros(T1_TO)
    keep = ok & (ts >= lo) & (ts <= hi)
    days = np.floor_divide(ts, 86_400_000_000)
    df = pd.DataFrame({
        "hr": (np.mod(ts, 86_400_000_000) // HOUR_US).astype(np.int32),
        "dow": ((days + 4) % 7 + 1).astype(np.int32),
        "price": table.column("ss_sales_price").to_pandas().astype(
            "float64"),
        "qty": table.column("ss_quantity").to_pandas().astype("Int64"),
        "store": table.column("ss_store_sk").to_pandas().astype("Int64"),
    })[keep]
    g = df.groupby(["hr", "dow"], sort=True)
    out = []
    for (hr, dow), grp in g:
        price = grp["price"].dropna()
        qty = grp["qty"].dropna()
        store = grp["store"].dropna()
        out.append({
            "hr": int(hr), "dow": int(dow),
            "sum_price": float(price.sum()) if len(price) else None,
            "avg_qty": float(qty.astype(float).mean()) if len(qty)
            else None,
            "min_store": int(store.min()) if len(store) else None,
            "max_store": int(store.max()) if len(store) else None,
            "n": int(len(grp))})
    return out


# each query's ORDER BY columns (their values are unique per row)
ORDER_KEYS = {"T1": ("hr", "dow"), "T2": (), "T3": ("ss_store_sk",),
              "T4": ("ss_store_sk",)}


def check_rows(name: str, got, exp):
    """(ok, reason): the rows equal under the equivalence bar (doubles
    within relative 1e-6, ``tpch.rows_match``) and in the same ORDER BY
    order."""
    from spark_rapids_tpu_torch.bench.tpch import rows_match

    if [list(r) for r in got[:1]] != [list(r) for r in exp[:1]]:
        return False, "column names differ"
    if not rows_match(got, exp):
        return False, "rows differ"
    keys = ORDER_KEYS[name]
    if [tuple(r[k] for k in keys) for r in got] != [
            tuple(r[k] for k in keys) for r in exp]:
        return False, f"ORDER BY order of {keys} differs"
    return True, ""


def check_sorted(name: str, got: pa.Table, exp: pa.Table):
    """(ok, reason) of a global sort: ``sold_ts`` equal in order (nulls
    last, as DESC puts them); the (sold_ts, price) rows equal as a
    multiset for ``GLOBAL_SORT`` (rows that tie on its one key may come in
    any order) and in order for ``GLOBAL_SORT2``."""
    if got.num_rows != exp.num_rows:
        return False, f"{got.num_rows} rows, expected {exp.num_rows}"

    def cols(t):
        ts = t.column("sold_ts").combine_chunks()
        pr = t.column("ss_sales_price").combine_chunks()
        return (np.asarray(ts.cast(pa.int64()).fill_null(0)),
                np.asarray(ts.is_valid()),
                np.asarray(pr.cast(pa.float64()).fill_null(0.0)).view(
                    np.int64), np.asarray(pr.is_valid()))

    g, e = cols(got), cols(exp)
    if not (np.array_equal(g[0], e[0]) and np.array_equal(g[1], e[1])):
        return False, "sold_ts order differs"
    if name == "GLOBAL_SORT":
        g = [a[np.lexsort(g[::-1])] for a in g]
        e = [a[np.lexsort(e[::-1])] for a in e]
    if not all(np.array_equal(a, b) for a, b in zip(g, e)):
        return False, "rows differ"
    return True, ""
