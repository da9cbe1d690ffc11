"""The scalar sales pass: the scalar function families and the string casts
over the TPC-DS tables (the generators of ``tpcds_schema``, none cut), on
the card and on the CPU engine.

``tables_for(sf)`` gives item, customer and date_dim as they are, and two
store_sales built from the generator's rows with pyarrow alone
(``scalar_tables``):

- ``store_sales``, typed as a Parquet file holds it: the keys, an INT
  quantity, the decimal(7,2) money, the sale's DATE (``d_date`` of
  ``ss_sold_date_sk``) and a TIMESTAMP (that date, ``ss_sold_time_sk``
  seconds and the ticket's milliseconds); ``ss_customer_sk`` and
  ``ss_promo_sk`` null in 4% of rows each, as dsdgen leaves a fact row's
  foreign keys null;
- ``untyped_store_sales``: the same rows' keys, quantity, money and sale
  date cast to strings by pyarrow, as a CSV read without a schema gives
  them (nulls stay null).

The queries take the DataFrames of ``df_tables`` and a ``Lib`` (the
expression, window, type and sort-order modules to build with; the tests
pass the JAX package's to run the same plans there):

- N1, ingest: the untyped table's strings cast to BIGINT, INT, DOUBLE and
  DATE, joined with item on the parsed item key, summed per category and
  month; ``n1_typed`` is the same query over the typed table;
- N2, every class: one projection over store_sales of every device class
  of the slice (the division, null, rounding, math, bitwise and hash
  families), each column summed and counted per store;
- N3, hash buckets: store_sales left-joined with customer, grouped by
  ``pmod(hash(customer, item), 64)`` and the ``xxhash64`` bucket, with
  round/bround/floor/ceil of the (exact, decimal) money sums as doubles,
  greatest/least of the three
  prices and nullif/nvl2/<=> over the nullable keys;
- N4, formatting: the keys, DATE, TIMESTAMP, DECIMAL64 and DECIMAL128
  cast to strings, grouped by the formatted date (a plain string key),
  with the rows whose string does not cast back to the original counted
  (all 0);
- N5, window: a running and a ROWS 30 PRECEDING sum of
  ``round(ss_net_paid * 1.07, 2)`` (the exact product as a double) over
  ``pmod(ss_customer_sk, 1000)`` partitions in a total order, summed per
  partition;
- N6, the CPU engine's nodes: one store's double price cast to string, a
  decimal round and floor and a decimal pmod, in one projection that the
  planner places on the CPU engine (``explain`` names it with the
  reference's reasons), aggregated on the device.

N7 (partitioned) is N1 and N3 with 4 splits and 4 shuffle partitions.
``pandas_n1`` computes N1 and ``arrow_n4`` N4 independently of the port
(pyarrow's casts and formatting, pandas' grouping).
"""

from __future__ import annotations

import decimal
from typing import Dict, NamedTuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

TABLES = ("store_sales", "item", "customer", "date_dim")
NULL_SHARE = 0.04
UNTYPED = ("ss_item_sk", "ss_customer_sk", "ss_store_sk", "ss_quantity",
           "ss_sales_price", "ss_net_paid", "ss_sold_date")
ORDER_KEYS = {"N1": ("i_category", "moy"), "N2": ("ss_store_sk",),
              "N3": ("hb", "xb"), "N4": ("date_s",), "N5": ("part",),
              "N6": ("ss_store_sk",)}


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


def _with_nulls(col: pa.ChunkedArray, rng, share: float) -> pa.Array:
    a = col.combine_chunks()
    mask = rng.random(len(a)) < share
    return pa.array(np.asarray(a), a.type, mask=mask)


def scalar_tables(tables: Dict[str, pa.Table], seed: int = 0
                  ) -> Dict[str, pa.Table]:
    """The typed and untyped store_sales (see the module docstring) from the
    generator's store_sales and date_dim."""
    from spark_rapids_tpu_torch.bench.typed_sales import _lookup

    ss, dd = tables["store_sales"], tables["date_dim"]
    rng = np.random.default_rng(seed + 15)
    days, ok = _lookup(ss.column("ss_sold_date_sk"),
                       np.asarray(dd.column("d_date_sk"), np.int64),
                       np.asarray(dd.column("d_date").cast(pa.int32()),
                                  np.int64))
    ticket = np.asarray(ss.column("ss_ticket_number"), np.int64)
    secs = np.asarray(ss.column("ss_sold_time_sk"), np.int64)
    us = days * 86_400_000_000 + secs * 1_000_000 + (ticket % 1000) * 1000
    typed = pa.table({
        "ss_item_sk": ss.column("ss_item_sk"),
        "ss_customer_sk": _with_nulls(ss.column("ss_customer_sk"), rng,
                                      NULL_SHARE),
        "ss_store_sk": ss.column("ss_store_sk"),
        "ss_promo_sk": _with_nulls(ss.column("ss_promo_sk"), rng,
                                   NULL_SHARE),
        "ss_ticket_number": ss.column("ss_ticket_number"),
        "ss_quantity": ss.column("ss_quantity").cast(pa.int32()),
        "ss_wholesale_cost": ss.column("ss_wholesale_cost"),
        "ss_list_price": ss.column("ss_list_price"),
        "ss_sales_price": ss.column("ss_sales_price"),
        "ss_net_paid": ss.column("ss_net_paid"),
        "ss_net_profit": ss.column("ss_net_profit"),
        "ss_sold_date": pa.array(days.astype(np.int32), pa.int32(),
                                 mask=~ok).cast(pa.date32()),
        "ss_sold_ts": pa.array(us, pa.int64(), mask=~ok).cast(
            pa.timestamp("us", tz="UTC")),
    })
    untyped = pa.table({c: pc.cast(typed.column(c), pa.string())
                        for c in UNTYPED})
    return {"store_sales": typed, "untyped_store_sales": untyped}


def tables_for(sf: float, seed: int = 0) -> Dict[str, pa.Table]:
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    base = S.tables_for(sf, seed, names=TABLES)
    out = {k: base[k] for k in ("item", "customer", "date_dim")}
    out.update(scalar_tables(base, seed))
    return out


def df_tables(tables, conf=None, batch_rows: int = 1 << 22, device=None,
              partitions: int = 1, shuffle_partitions: int = 4):
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    return Q.df_tables(tables, conf, batch_rows=batch_rows, device=device,
                       partitions=partitions,
                       shuffle_partitions=shuffle_partitions)


def _items(d, L: Lib):
    E = L.E
    return d["item"].select(E.col("i_item_sk"), E.col("i_category"))


def n1(d, L: Lib = None, typed: bool = False):
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    if typed:
        s = d["store_sales"].select(
            E.Alias(col("ss_item_sk"), "item_sk"),
            E.Alias(col("ss_quantity"), "qty"),
            E.Alias(E.Cast(col("ss_net_paid"), T.DOUBLE), "paid"),
            E.Alias(col("ss_sold_date"), "sold"))
    else:
        s = d["untyped_store_sales"].select(
            E.Alias(E.Cast(col("ss_item_sk"), T.LONG), "item_sk"),
            E.Alias(E.Cast(col("ss_quantity"), T.INT), "qty"),
            E.Alias(E.Cast(col("ss_net_paid"), T.DOUBLE), "paid"),
            E.Alias(E.Cast(col("ss_sold_date"), T.DATE), "sold"))
    j = s.join(_items(d, L), left_on="item_sk", right_on="i_item_sk")
    g = j.select(col("i_category"), E.Alias(E.Month(col("sold")), "moy"),
                 col("qty"), col("paid")).group_by("i_category", "moy").agg(
        E.Alias(E.Sum(col("qty")), "qty"), E.Alias(E.Sum(col("paid")),
                                                   "paid"),
        E.Alias(E.Count(), "n"))
    return g.sort(L.SortOrder(col("i_category")), L.SortOrder(col("moy")))


def n2_columns(L: Lib):
    """(name, expression) of N2's projection: every device class of the
    slice over store_sales (doubles inside their functions' domains)."""
    E, T = L.E, L.T
    col, lit = E.col, E.lit
    x = E.Cast(col("ss_net_paid"), T.DOUBLE)
    y = E.Cast(col("ss_list_price"), T.DOUBLE)
    u = E.Divide(E.Abs(x), E.Add(E.Abs(x), lit(1.0)))   # in [0, 1)
    v = E.Add(u, lit(0.25))               # in [0.25, 1.25)
    w = E.Multiply(u, lit(0.9))           # in [0, 0.9)
    q, item, ticket = col("ss_quantity"), col("ss_item_sk"), col(
        "ss_ticket_number")
    cust, promo = col("ss_customer_sk"), col("ss_promo_sk")

    def i(e):  # a boolean as 0/1
        return E.Cast(e, T.INT)

    cols = [
        ("div", E.IntegralDivide(item, q)),
        ("rem", E.Remainder(ticket, q)),
        ("rem_d", E.Remainder(x, lit(7.5))),
        ("pmod", E.Pmod(cust, lit(97))),
        ("eqns", i(E.EqualNullSafe(cust, promo))),
        ("nullif", E.NullIf(q, lit(50))),
        ("nvl2", E.Nvl2(cust, q, lit(0))),
        ("greatest", E.Greatest(x, y)),
        ("least", E.Least(col("ss_sales_price"), col("ss_list_price"))),
        ("round", E.Round(x, 0)),
        ("bround", E.BRound(x, 0)),
        ("round_item", E.Round(item, -1)),
        ("bround_item", E.BRound(item, -2)),
        ("floor", E.Floor(x)),
        ("ceil", E.Ceil(y)),
        ("rint", E.Rint(x)),
    ]
    for name in ("Sqrt", "Cbrt", "Exp", "Expm1", "Log", "Log10", "Log2",
                 "Log1p", "Sin", "Cos", "Tan", "Cot", "Sec", "Csc",
                 "Atan", "Sinh", "Cosh", "Tanh", "Asinh", "ToDegrees",
                 "ToRadians"):
        cols.append((name.lower(), getattr(E, name)(v)))
    cols += [
        ("asin", E.Asin(w)), ("acos", E.Acos(w)), ("atanh", E.Atanh(w)),
        ("acosh", E.Acosh(E.Add(v, lit(1.0)))),
        ("signum", E.Signum(E.Cast(col("ss_net_profit"), T.DOUBLE))),
        ("atan2", E.Atan2(x, y)), ("hypot", E.Hypot(x, y)),
        ("pow", E.Pow(u, lit(2.5))),
        ("factorial", E.Factorial(E.Pmod(q, lit(21)))),
        ("positive", E.Positive(col("ss_net_paid"))),
        ("band", E.BitwiseAnd(item, ticket)),
        ("bor", E.BitwiseOr(item, ticket)),
        ("bxor", E.BitwiseXor(item, ticket)),
        ("bnot", E.BitwiseNot(item)),
        ("shl", E.ShiftLeft(item, q)),
        ("shr", E.ShiftRight(ticket, lit(3))),
        ("shru", E.ShiftRightUnsigned(E.BitwiseNot(item), q)),
        ("bitcount", E.BitCount(ticket)),
        ("bitget", E.BitGet(item, E.Pmod(q, lit(16)))),
        ("hash", E.Pmod(E.Murmur3Hash(cust, item), lit(1000003))),
        ("xxhash", E.Pmod(E.XxHash64(ticket, col("ss_sold_date")),
                          lit(1000003))),
    ]
    return cols


def n2(d, L: Lib = None, part: int = None):
    """N2; ``part`` 0 or 1 keeps the first or the second half of its
    columns (the same rows: a check can run the halves apart)."""
    L = L or port_lib()
    E = L.E
    cols = n2_columns(L)
    if part is not None:
        half = len(cols) // 2
        cols = cols[:half] if part == 0 else cols[half:]
    p = d["store_sales"].select(E.col("ss_store_sk"),
                                *[E.Alias(e, n) for n, e in cols])
    aggs = []
    for n, _ in cols:
        aggs += [E.Alias(E.Sum(E.col(n)), f"sum_{n}"),
                 E.Alias(E.Count(E.col(n)), f"n_{n}")]
    return p.group_by("ss_store_sk").agg(*aggs).sort(
        L.SortOrder(E.col("ss_store_sk")))


def n3(d, L: Lib = None):
    L = L or port_lib()
    E, T = L.E, L.T
    col, lit = E.col, E.lit
    cust = d["customer"].select(col("c_customer_sk"), col("c_birth_year"))
    s = d["store_sales"].join(cust, left_on=col("ss_customer_sk"),
                              right_on=col("c_customer_sk"), how="left")
    prices = [col("ss_sales_price"), col("ss_list_price"),
              col("ss_wholesale_cost")]
    p = s.select(
        E.Alias(E.Pmod(E.Murmur3Hash(col("ss_customer_sk"),
                                     col("ss_item_sk")), lit(64)), "hb"),
        E.Alias(E.Pmod(E.XxHash64(col("ss_customer_sk"), col("ss_item_sk")),
                       lit(64)), "xb"),
        col("ss_net_paid"),
        E.Alias(E.Greatest(*prices), "hi"), E.Alias(E.Least(*prices), "lo"),
        E.Alias(E.Nvl2(col("ss_customer_sk"), lit(1), lit(0)), "known"),
        E.Alias(E.NullIf(col("ss_promo_sk"), col("ss_store_sk")), "promo"),
        E.Alias(E.Cast(E.EqualNullSafe(col("ss_customer_sk"),
                                       col("c_customer_sk")), T.INT),
                "same"),
        col("c_birth_year"))
    g = p.group_by("hb", "xb").agg(
        E.Alias(E.Sum(col("ss_net_paid")), "paid"),
        E.Alias(E.Sum(col("hi")), "hi"),
        E.Alias(E.Sum(col("lo")), "lo"), E.Alias(E.Sum(col("known")),
                                                 "known"),
        E.Alias(E.Count(col("promo")), "promos"),
        E.Alias(E.Sum(col("same")), "same"),
        E.Alias(E.Max(col("c_birth_year")), "max_birth"),
        E.Alias(E.Count(), "n"))
    # the money sum is exact (a decimal), so its double, and each rounding
    # of it, is the same in any summation order
    paid = E.Cast(col("paid"), T.DOUBLE)
    return g.select(
        col("hb"), col("xb"), E.Alias(E.Round(paid, 2), "paid"),
        E.Alias(E.BRound(paid, 0), "paid_even"),
        E.Alias(E.Floor(paid), "paid_floor"),
        E.Alias(E.Ceil(paid), "paid_ceil"), col("hi"), col("lo"),
        col("known"), col("promos"), col("same"), col("max_birth"),
        col("n")).sort(L.SortOrder(col("hb")), L.SortOrder(col("xb")))


N4_WIDE = (24, 3)
N4_BAD = ("bad_item", "bad_cust", "bad_date", "bad_ts", "bad_paid",
          "bad_wide")


def n4(d, L: Lib = None):
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    S = T.STRING

    def bad(e):  # 1 where the cast back is not the original
        return E.Cast(E.Not(e), T.INT)

    s = d["store_sales"].select(
        E.Alias(E.Cast(col("ss_sold_date"), S), "date_s"),
        E.Alias(E.Cast(col("ss_item_sk"), S), "item_s"),
        E.Alias(E.Cast(col("ss_customer_sk"), S), "cust_s"),
        E.Alias(E.Cast(col("ss_sold_ts"), S), "ts_s"),
        E.Alias(E.Cast(col("ss_net_paid"), S), "paid_s"),
        E.Alias(E.Cast(E.Cast(col("ss_net_paid"), T.DecimalType(*N4_WIDE)),
                       S), "wide_s"),
        col("ss_item_sk"), col("ss_customer_sk"), col("ss_sold_date"),
        col("ss_sold_ts"), col("ss_net_paid"))
    checks = s.select(
        col("date_s"),
        E.Alias(E.Cast(col("item_s"), T.LONG), "item_back"),
        E.Alias(bad(E.EqualNullSafe(E.Cast(col("item_s"), T.LONG),
                                    col("ss_item_sk"))), "bad_item"),
        E.Alias(bad(E.EqualNullSafe(E.Cast(col("cust_s"), T.LONG),
                                    col("ss_customer_sk"))), "bad_cust"),
        E.Alias(bad(E.EqualNullSafe(E.Cast(col("date_s"), T.DATE),
                                    col("ss_sold_date"))), "bad_date"),
        E.Alias(bad(E.EqualNullSafe(E.Cast(col("ts_s"), T.TIMESTAMP),
                                    col("ss_sold_ts"))), "bad_ts"),
        E.Alias(bad(E.EqualNullSafe(E.Cast(col("paid_s"), T.DOUBLE),
                                    E.Cast(col("ss_net_paid"), T.DOUBLE))),
                "bad_paid"),
        E.Alias(bad(E.EqualNullSafe(E.Cast(col("wide_s"), T.DOUBLE),
                                    E.Cast(col("paid_s"), T.DOUBLE))),
                "bad_wide"))
    g = checks.group_by("date_s").agg(
        E.Alias(E.Count(), "n"), E.Alias(E.Sum(col("item_back")),
                                         "item_sum"),
        *[E.Alias(E.Sum(col(b)), b) for b in N4_BAD])
    return g.sort(L.SortOrder(col("date_s")))


def n5_amount(L: Lib):
    """round(ss_net_paid * 1.07, 2) of the exact product's double (its
    shortest text is the product's, so Spark's round is HALF_UP of the
    product). The reference's Round of a double scales its binary value
    (ROADMAP queue 3, fault 14), so it is given the same answer as a
    decimal rescale."""
    E, T = L.E, L.T
    prod = E.Multiply(E.col("ss_net_paid"), E.lit(decimal.Decimal("1.07")))
    if L.port:
        return E.Round(E.Cast(prod, T.DOUBLE), 2)
    return E.Cast(E.Cast(prod, T.DecimalType(11, 2)), T.DOUBLE)


N5_ORDER = ("ss_ticket_number", "ss_item_sk", "amt")


def n5(d, L: Lib = None):
    L = L or port_lib()
    E, W = L.E, L.W
    col = E.col
    s = d["store_sales"].select(
        E.Alias(E.Pmod(col("ss_customer_sk"), E.lit(1000)), "part"),
        col("ss_ticket_number"), col("ss_item_sk"),
        E.Alias(n5_amount(L), "amt"))
    order = tuple(L.SortOrder(col(c)) for c in N5_ORDER)
    running = W.WindowSpec((col("part"),), order,
                           W.WindowFrame("rows", None, 0))
    last30 = W.WindowSpec((col("part"),), order,
                          W.WindowFrame("rows", -30, 0))
    w = s.with_window(
        E.Alias(W.WindowExpression(E.Sum(col("amt")), running), "run"),
        E.Alias(W.WindowExpression(E.Sum(col("amt")), last30), "last30"))
    return w.group_by("part").agg(
        E.Alias(E.Sum(col("run")), "sum_run"),
        E.Alias(E.Sum(col("last30")), "sum_last30"),
        E.Alias(E.Sum(col("amt")), "amt"),
        E.Alias(E.Count(), "n")).sort(L.SortOrder(col("part")))


N6_PMOD = decimal.Decimal("0.07")


def n6(d, L: Lib = None, store: int = 1):
    """One store's rows through the CPU engine's casts and decimal
    functions (the reference's Round of a decimal leaves it unrounded,
    fault 17: it is given the same HALF_UP as a rescale)."""
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    paid = col("ss_net_paid")
    rounded = (E.Round(paid, 1) if L.port
               else E.Cast(paid, T.DecimalType(7, 1)))
    s = d["store_sales"].filter(E.EqualTo(col("ss_store_sk"),
                                          E.lit(store))).select(
        col("ss_store_sk"),
        E.Alias(E.Cast(E.Cast(col("ss_sales_price"), T.DOUBLE), T.STRING),
                "price_s"),
        E.Alias(rounded, "paid_r"), E.Alias(E.Floor(paid), "paid_f"),
        E.Alias(E.Pmod(paid, E.lit(N6_PMOD)), "paid_m"))
    return s.group_by("ss_store_sk").agg(
        E.Alias(E.Max(col("price_s")), "max_price_s"),
        E.Alias(E.Min(col("price_s")), "min_price_s"),
        E.Alias(E.Sum(col("paid_r")), "paid_r"),
        E.Alias(E.Sum(col("paid_f")), "paid_f"),
        E.Alias(E.Sum(col("paid_m")), "paid_m"),
        E.Alias(E.Count(), "n"))


QUERIES = {"N1": n1, "N2": n2, "N3": n3, "N4": n4, "N5": n5, "N6": n6}
PARTITIONED = ("N1", "N3")


def first_store(tables) -> int:
    return int(pc.min(tables["store_sales"].column("ss_store_sk")).as_py())


def check_rows(name: str, got, exp, order_keys=None):
    """(ok, reason): the rows equal under the equivalence bar (doubles
    within relative 1e-6, ``tpch.rows_match``) and in ORDER BY order
    (the keys of ``name`` in ``order_keys``, this pass's by default)."""
    from spark_rapids_tpu_torch.bench.tpch import rows_match

    if [list(r) for r in got[:1]] != [list(r) for r in exp[:1]]:
        return False, "column names differ"
    if not rows_match(got, exp):
        return False, "rows differ"
    keys = (order_keys or ORDER_KEYS)[name]
    if [tuple(r[k] for k in keys) for r in got] != [
            tuple(r[k] for k in keys) for r in exp]:
        return False, f"ORDER BY order of {keys} differs"
    return True, ""


def informative(rows) -> bool:
    """Whether a result shows values: a row with no null."""
    return any(all(v is not None for v in r.values()) for r in rows)


def pandas_n1(tables):
    """N1 from the untyped strings by pyarrow's own casts and pandas'
    join and grouping: rows as dicts in N1's order."""
    import pandas as pd

    u = tables["untyped_store_sales"]
    df = pd.DataFrame({
        "item_sk": pc.cast(u.column("ss_item_sk"), pa.int64()).to_pandas(),
        "qty": pc.cast(u.column("ss_quantity"), pa.int64()).to_pandas(),
        "paid": pc.cast(u.column("ss_net_paid"), pa.float64()).to_pandas(),
        "moy": pc.month(pc.cast(u.column("ss_sold_date"),
                                pa.date32())).to_pandas(),
    })
    item = tables["item"].select(["i_item_sk", "i_category"]).to_pandas()
    j = df.merge(item, left_on="item_sk", right_on="i_item_sk")
    g = j.groupby(["i_category", "moy"], dropna=False, sort=False).agg(
        qty=("qty", "sum"), paid=("paid", "sum"), n=("qty", "size"),
        paid_n=("paid", "count"), qty_n=("qty", "count")).reset_index()
    out = []
    for r in g.itertuples():
        out.append({"i_category": None if pd.isna(r.i_category)
                    else r.i_category,
                    "moy": None if pd.isna(r.moy) else int(r.moy),
                    "qty": int(r.qty) if r.qty_n else None,
                    "paid": float(r.paid) if r.paid_n else None,
                    "n": int(r.n)})
    out.sort(key=lambda r: (r["i_category"] is not None, r["i_category"]
                            or "", r["moy"] is not None, r["moy"] or 0))
    return out


def arrow_n4(tables):
    """N4 by pyarrow's own date formatting and pandas' grouping: per date
    string its rows and item sum, and no string that fails to cast back."""
    import pandas as pd

    ss = tables["store_sales"]
    df = pd.DataFrame({
        "date_s": pc.cast(ss.column("ss_sold_date"), pa.string()).to_pandas(),
        "item": ss.column("ss_item_sk").to_pandas()})
    g = df.groupby("date_s", dropna=False, sort=False).agg(
        n=("item", "size"), item_sum=("item", "sum")).reset_index()
    out = [dict({"date_s": None if pd.isna(r.date_s) else r.date_s,
                 "n": int(r.n), "item_sum": int(r.item_sum)},
                **{b: 0 for b in N4_BAD}) for r in g.itertuples()]
    out.sort(key=lambda r: (r["date_s"] is not None, r["date_s"] or ""))
    return out
