"""The statistics pass: the aggregate family over the TPC-DS tables (the
generators of ``tpcds_schema``, none cut), on the card and on the CPU
engine.

The queries take the DataFrames of ``df_tables`` and a ``Lib`` (the
expression, window, type and sort-order modules to build with, the port's
by default; the tests pass the JAX package's to run the same plans there):

- S1, q17 as the TPC-DS specification writes it: store_sales joined with
  the store_returns of the same ticket and item and the catalog_sales of
  the returning customer and item, three date_dim filters (the first
  quarter of 2001, the first three quarters of 2001), store and item; per
  (i_item_id, i_item_desc, s_state) the count, average, ``stddev_samp``
  and ``stddev_samp / avg`` of ss_quantity, sr_return_quantity and
  cs_quantity; ORDER BY the three keys, LIMIT 100;
- S2, q39a and q39b as the specification writes them: per (warehouse,
  item, month) of 2001 the ``stddev_samp`` and mean of
  inv_quantity_on_hand, kept where ``stddev / mean > 1``, month 1 joined
  with month 2 (q39b: and month 1's cov above 1.5), ordered by every
  column;
- S3, store_sales joined with item, per (ss_store_sk, i_category): every
  device aggregate of the family (the variance family of ss_quantity and
  of the decimal ss_net_paid, corr and both covariances of the two,
  min_by/max_by of the item by the sale date, bool_and/bool_or of
  ``ss_net_paid > 0``, count_if of ``ss_quantity > 50``, any_value of the
  category, first/last of the brand, min/max of the item id (dictionary
  strings) and max of a 20-byte prefix of its description (plain
  strings));
- S4, variance windows over store_sales partitioned by ss_store_sk:
  var_samp(ss_quantity) and stddev_pop(ss_net_paid) over UNBOUNDED, the
  running RANGE frame and a RANGE 7 PRECEDING frame on ss_sold_date_sk,
  and over ROWS 30 PRECEDING in a total order (date, ticket, item,
  quantity, net paid: rows that tie on it are equal in both values), each
  summed per store; ``S4_SKEW`` is a skewness and a kurtosis window (ROWS
  30 PRECEDING in the same order) over the first store's rows, which the
  planner places on the CPU engine, as the reference's does, their
  non-NaN values summed and counted;
- S5, the CPU engine's aggregates per store: bit_and, bit_or and bit_xor
  of ss_item_sk, percentile(ss_quantity, 0.9) and median(ss_net_paid) (a
  mixed plan: the aggregate on the CPU engine, its scan on the card).

``pandas_s1`` and ``pandas_s2`` compute S1 and S2 independently from the
specification's text (pandas' sample standard deviation). Each query
reads only the columns it uses, as Spark's column pruning leaves it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import pyarrow as pa

TABLES = ("date_dim", "store_sales", "store_returns", "catalog_sales",
          "store", "item", "inventory", "warehouse")
S1_YEAR = 2001
S2_YEAR = 2001


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

    return Lib(expr, types, window, SortOrder)


def tables_for(sf: float, seed: int = 0) -> Dict[str, pa.Table]:
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    return S.tables_for(sf, seed, names=TABLES)


def df_tables(tables, conf=None, batch_rows: int = 1 << 22, device=None,
              partitions: int = 1, shuffle_partitions: int = 4):
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    return Q.df_tables(tables, conf, batch_rows=batch_rows, device=device,
                       partitions=partitions,
                       shuffle_partitions=shuffle_partitions)


def _cols(df, L: Lib, *names):
    """``df`` cut to the columns a query reads (Spark's column pruning)."""
    return df.select(*[L.E.col(c) for c in names])


def _dates(d, L: Lib, alias: str, last_qoy: int):
    E = L.E
    return d["date_dim"].filter(E.And(
        E.EqualTo(E.col("d_year"), E.lit(S1_YEAR)),
        E.LessThanOrEqual(E.col("d_qoy"), E.lit(last_qoy)))).select(
        E.Alias(E.col("d_date_sk"), alias))


S1_MEASURES = (("store_sales_quantity", "ss_quantity"),
               ("store_returns_quantity", "sr_return_quantity"),
               ("catalog_sales_quantity", "cs_quantity"))


def s1(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    col = E.col
    ss = d["store_sales"].join(_dates(d, L, "d1_sk", 1),
                               left_on=col("ss_sold_date_sk"),
                               right_on=col("d1_sk"))
    sr = d["store_returns"].join(_dates(d, L, "d2_sk", 3),
                                 left_on=col("sr_returned_date_sk"),
                                 right_on=col("d2_sk"))
    cs = d["catalog_sales"].join(_dates(d, L, "d3_sk", 3),
                                 left_on=col("cs_sold_date_sk"),
                                 right_on=col("d3_sk"))
    j = (ss.join(sr, left_on=[col("ss_customer_sk"), col("ss_item_sk"),
                              col("ss_ticket_number")],
                 right_on=[col("sr_customer_sk"), col("sr_item_sk"),
                           col("sr_ticket_number")])
         .join(cs, left_on=[col("sr_customer_sk"), col("sr_item_sk")],
               right_on=[col("cs_bill_customer_sk"), col("cs_item_sk")])
         .join(_cols(d["store"], L, "s_store_sk", "s_state"),
               left_on="ss_store_sk", right_on="s_store_sk")
         .join(_cols(d["item"], L, "i_item_sk", "i_item_id", "i_item_desc"),
               left_on="ss_item_sk", right_on="i_item_sk"))
    aggs = []
    for name, c in S1_MEASURES:
        aggs += [E.Alias(E.Count(col(c)), f"{name}count"),
                 E.Alias(E.Average(col(c)), f"{name}ave"),
                 E.Alias(E.StddevSamp(col(c)), f"{name}stdev")]
    g = j.group_by("i_item_id", "i_item_desc", "s_state").agg(*aggs)
    out = [col("i_item_id"), col("i_item_desc"), col("s_state")]
    for name, _c in S1_MEASURES:
        out += [col(f"{name}count"), col(f"{name}ave"), col(f"{name}stdev"),
                E.Alias(E.Divide(col(f"{name}stdev"), col(f"{name}ave")),
                        f"{name}cov")]
    return g.select(*out).sort(*[L.SortOrder(col(k)) for k in (
        "i_item_id", "i_item_desc", "s_state")], limit=100)


def _inv(d, L: Lib):
    """q39's ``inv``: per (warehouse, item, month) of the year the sample
    standard deviation, mean and cov of the quantity on hand, where cov >
    1."""
    E, T = L.E, L.T
    col = E.col
    j = (d["inventory"]
         .join(_cols(d["item"], L, "i_item_sk"), left_on="inv_item_sk",
               right_on="i_item_sk")
         .join(_cols(d["warehouse"], L, "w_warehouse_sk", "w_warehouse_name"),
               left_on="inv_warehouse_sk", right_on="w_warehouse_sk")
         .join(_cols(d["date_dim"].filter(E.EqualTo(col("d_year"),
                                                    E.lit(S2_YEAR))),
                     L, "d_date_sk", "d_moy"),
               left_on="inv_date_sk", right_on="d_date_sk"))
    g = j.group_by("w_warehouse_name", "w_warehouse_sk", "i_item_sk",
                   "d_moy").agg(
        E.Alias(E.StddevSamp(col("inv_quantity_on_hand")), "stdev"),
        E.Alias(E.Average(col("inv_quantity_on_hand")), "mean"))
    zero = E.EqualTo(col("mean"), E.lit(0.0))
    ratio = E.Divide(col("stdev"), col("mean"))
    g = g.filter(E.GreaterThan(E.If(zero, E.lit(0.0), ratio), E.lit(1.0)))
    return g.select(col("w_warehouse_name"), col("w_warehouse_sk"),
                    col("i_item_sk"), col("d_moy"), col("stdev"),
                    col("mean"), E.Alias(E.If(zero, E.lit(None, T.DOUBLE),
                                              ratio), "cov"))


def _s2(d, L: Lib, month1_cov=None):
    E = L.E
    col = E.col

    def month(m, tag):
        side = _inv(d, L).filter(E.EqualTo(col("d_moy"), E.lit(m)))
        return side.select(*[E.Alias(col(c), f"{c}{tag}") for c in (
            "w_warehouse_sk", "i_item_sk", "d_moy", "mean", "cov")])

    inv1 = month(1, "1")
    if month1_cov is not None:
        inv1 = inv1.filter(E.GreaterThan(col("cov1"), E.lit(month1_cov)))
    j = inv1.join(month(2, "2"), left_on=[col("i_item_sk1"),
                                          col("w_warehouse_sk1")],
                  right_on=[col("i_item_sk2"), col("w_warehouse_sk2")])
    return j.sort(*[L.SortOrder(col(k)) for k in S2_ORDER])


S2_ORDER = ("w_warehouse_sk1", "i_item_sk1", "d_moy1", "mean1", "cov1",
            "d_moy2", "mean2", "cov2")


def s2a(d, L: Lib = None):
    return _s2(d, L or port_lib())


def s2b(d, L: Lib = None):
    return _s2(d, L or port_lib(), month1_cov=1.5)


def s3(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    col = E.col
    q, paid = col("ss_quantity"), col("ss_net_paid")
    aggs = []
    for tag, x in (("q", q), ("paid", paid)):
        aggs += [E.Alias(E.VarianceSamp(x), f"var_samp_{tag}"),
                 E.Alias(E.VariancePop(x), f"var_pop_{tag}"),
                 E.Alias(E.StddevSamp(x), f"stddev_samp_{tag}"),
                 E.Alias(E.StddevPop(x), f"stddev_pop_{tag}"),
                 E.Alias(E.Skewness(x), f"skewness_{tag}"),
                 E.Alias(E.Kurtosis(x), f"kurtosis_{tag}")]
    aggs += [
        E.Alias(E.Corr(q, paid), "corr"),
        E.Alias(E.CovarSamp(q, paid), "covar_samp"),
        E.Alias(E.CovarPop(q, paid), "covar_pop"),
        E.Alias(E.MinBy(col("ss_item_sk"), col("ss_sold_date_sk")),
                "min_by_item"),
        E.Alias(E.MaxBy(col("ss_item_sk"), col("ss_sold_date_sk")),
                "max_by_item"),
        E.Alias(E.BoolAnd(E.GreaterThan(paid, E.lit(0))), "all_paid"),
        E.Alias(E.BoolOr(E.GreaterThan(paid, E.lit(0))), "any_paid"),
        E.Alias(E.CountIf(E.GreaterThan(q, E.lit(50.0))), "n_over_50"),
        E.Alias(E.AnyValue(col("i_category")), "category"),
        E.Alias(E.First(col("i_brand")), "first_brand"),
        E.Alias(E.Last(col("i_brand")), "last_brand"),
        E.Alias(E.Min(col("i_item_id")), "min_item_id"),
        E.Alias(E.Max(col("i_item_id")), "max_item_id"),
        E.Alias(E.Max(E.Substring(col("i_item_desc"), 1, 20)),
                "max_desc20"),
        E.Alias(E.Count(), "n")]
    j = _cols(d["store_sales"], L, "ss_item_sk", "ss_store_sk",
              "ss_sold_date_sk", "ss_quantity", "ss_net_paid").join(
        _cols(d["item"], L, "i_item_sk", "i_category", "i_brand",
              "i_item_id", "i_item_desc"),
        left_on="ss_item_sk", right_on="i_item_sk")
    return j.group_by("ss_store_sk", "i_category").agg(
        *aggs).sort(L.SortOrder(col("ss_store_sk")),
                    L.SortOrder(col("i_category")))


S4_FRAMES = (("unbounded", "range", None, None), ("running", "range", None, 0),
             ("range7", "range", -7, 0), ("rows30", "rows", -30, 0))
# ROWS frames read a total order: rows that tie on it are equal in both
# measured values, so a frame cannot depend on their order
TOTAL_ORDER = ("ss_sold_date_sk", "ss_ticket_number", "ss_item_sk",
               "ss_quantity", "ss_net_paid")


def s4_windows(d, L: Lib = None):
    """The sales (store, date and the two measures) with the eight window
    columns."""
    L = L or port_lib()
    E, W = L.E, L.W
    col = E.col
    s = d["store_sales"].select(*[col(c) for c in (
        "ss_store_sk",) + TOTAL_ORDER])
    # the reference's window variance reads a decimal's unscaled value
    # (its CPU engine refuses a decimal), so it is given the double
    paid = (col("ss_net_paid") if L.port
            else E.Cast(col("ss_net_paid"), L.T.DOUBLE))
    part = (col("ss_store_sk"),)
    by_date = (L.SortOrder(col("ss_sold_date_sk")),)
    total = tuple(L.SortOrder(col(c)) for c in TOTAL_ORDER)
    for order in (by_date, total):
        ws = []
        for tag, kind, a, b in S4_FRAMES:
            if (order is total) != (kind == "rows"):
                continue
            spec = W.WindowSpec(part, order, W.WindowFrame(kind, a, b))
            ws += [E.Alias(W.WindowExpression(E.VarianceSamp(
                col("ss_quantity")), spec), f"var_samp_q_{tag}"),
                E.Alias(W.WindowExpression(E.StddevPop(paid), spec),
                        f"stddev_pop_paid_{tag}")]
        s = s.with_window(*ws)
    return s


def s4(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    aggs = []
    for tag, *_ in S4_FRAMES:
        for c in (f"var_samp_q_{tag}", f"stddev_pop_paid_{tag}"):
            aggs += [E.Alias(E.Sum(E.col(c)), f"sum_{c}"),
                     E.Alias(E.Count(E.col(c)), f"n_{c}")]
    return s4_windows(d, L).group_by("ss_store_sk").agg(
        *aggs, E.Alias(E.Count(), "n")).sort(L.SortOrder(E.col("ss_store_sk")))


def first_store(tables) -> int:
    import pyarrow.compute as pc

    return int(pc.min(tables["store_sales"].column("ss_store_sk")).as_py())


def s4_skew(d, L: Lib = None, store: int = 1):
    """Skewness and kurtosis windows over one store's rows: the CPU
    engine runs them."""
    L = L or port_lib()
    E, W = L.E, L.W
    col = E.col
    s = d["store_sales"].filter(E.EqualTo(col("ss_store_sk"),
                                          E.lit(store))).select(
        *[col(c) for c in ("ss_store_sk",) + TOTAL_ORDER])
    spec = W.WindowSpec((col("ss_store_sk"),),
                        tuple(L.SortOrder(col(c)) for c in TOTAL_ORDER),
                        W.WindowFrame("rows", -30, 0))
    s = s.with_window(
        E.Alias(W.WindowExpression(E.Skewness(col("ss_quantity")), spec),
                "skew"),
        E.Alias(W.WindowExpression(E.Kurtosis(col("ss_quantity")), spec),
                "kurt"))
    # NaN where a frame's values are all equal: left out of the sums
    s = s.select(col("ss_store_sk"), *[E.Alias(E.If(
        E.IsNaN(col(c)), E.lit(None, L.T.DOUBLE), col(c)), c)
        for c in ("skew", "kurt")])
    aggs = []
    for c in ("skew", "kurt"):
        aggs += [E.Alias(E.Sum(col(c)), f"sum_{c}"),
                 E.Alias(E.Count(col(c)), f"n_{c}")]
    return s.group_by("ss_store_sk").agg(*aggs, E.Alias(E.Count(), "n"))


def s5(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    col = E.col
    return _cols(d["store_sales"], L, "ss_store_sk", "ss_item_sk",
                 "ss_quantity", "ss_net_paid").group_by("ss_store_sk").agg(
        E.Alias(E.BitAndAgg(col("ss_item_sk")), "bit_and_item"),
        E.Alias(E.BitOrAgg(col("ss_item_sk")), "bit_or_item"),
        E.Alias(E.BitXorAgg(col("ss_item_sk")), "bit_xor_item"),
        E.Alias(E.Percentile(col("ss_quantity"), 0.9), "p90_quantity"),
        E.Alias(E.Median(col("ss_net_paid")), "median_paid")).sort(
        L.SortOrder(col("ss_store_sk")))


QUERIES = {"S1": s1, "S2a": s2a, "S2b": s2b, "S3": s3, "S4": s4, "S5": s5}
# each query's ORDER BY columns (unique per row)
ORDER_KEYS = {"S1": ("i_item_id", "i_item_desc", "s_state"),
              "S2a": S2_ORDER, "S2b": S2_ORDER,
              "S3": ("ss_store_sk", "i_category"), "S4": ("ss_store_sk",),
              "S4_SKEW": (), "S5": ("ss_store_sk",)}
# the queries wholly on the device (S4_SKEW's windows and S5's aggregate
# are the CPU engine's)
DEVICE_ONLY = ("S1", "S2a", "S2b", "S3", "S4")


def check_rows(name: str, got, exp):
    """(ok, reason): the rows equal under the equivalence bar (doubles
    within relative 1e-6 with an absolute floor of 1e-6,
    ``tpch.rows_match``) and in the same ORDER BY order."""
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


def _pd(t: pa.Table, cols):
    """A pandas frame of ``cols`` of ``t``, decimals as floats."""
    import pandas as pd

    out = {}
    for c in cols:
        a = t.column(c)
        if pa.types.is_decimal(a.type):
            a = a.cast(pa.float64())
        out[c] = a.to_pandas()
    return pd.DataFrame(out)


def pandas_s1(tables):
    """S1 by pandas from the specification's text: rows as dicts in S1's
    order."""
    dd = _pd(tables["date_dim"], ["d_date_sk", "d_year", "d_qoy"])
    y = dd[dd.d_year == S1_YEAR]
    d1 = set(y[y.d_qoy == 1].d_date_sk)
    d23 = set(y[y.d_qoy <= 3].d_date_sk)
    ss = _pd(tables["store_sales"], [
        "ss_sold_date_sk", "ss_customer_sk", "ss_item_sk",
        "ss_ticket_number", "ss_store_sk", "ss_quantity"])
    sr = _pd(tables["store_returns"], [
        "sr_returned_date_sk", "sr_customer_sk", "sr_item_sk",
        "sr_ticket_number", "sr_return_quantity"])
    cs = _pd(tables["catalog_sales"], [
        "cs_sold_date_sk", "cs_bill_customer_sk", "cs_item_sk",
        "cs_quantity"])
    ss = ss[ss.ss_sold_date_sk.isin(d1)]
    sr = sr[sr.sr_returned_date_sk.isin(d23)]
    cs = cs[cs.cs_sold_date_sk.isin(d23)]
    j = ss.merge(sr, left_on=["ss_customer_sk", "ss_item_sk",
                              "ss_ticket_number"],
                 right_on=["sr_customer_sk", "sr_item_sk",
                           "sr_ticket_number"])
    j = j.merge(cs, left_on=["sr_customer_sk", "sr_item_sk"],
                right_on=["cs_bill_customer_sk", "cs_item_sk"])
    j = j.merge(_pd(tables["store"], ["s_store_sk", "s_state"]),
                left_on="ss_store_sk", right_on="s_store_sk")
    j = j.merge(_pd(tables["item"], ["i_item_sk", "i_item_id",
                                     "i_item_desc"]),
                left_on="ss_item_sk", right_on="i_item_sk")
    keys = ["i_item_id", "i_item_desc", "s_state"]
    g = j.groupby(keys, sort=True)
    stats = {c: g[c].agg(["count", "mean", "std"]) for _n, c in S1_MEASURES}
    out = []
    for i, key in enumerate(stats[S1_MEASURES[0][1]].index[:100]):
        r = dict(zip(keys, key))
        for name, c in S1_MEASURES:
            cnt, ave, sd = stats[c].iloc[i]
            sd = None if cnt < 2 else float(sd)
            r[f"{name}count"] = int(cnt)
            r[f"{name}ave"] = float(ave) if cnt else None
            r[f"{name}stdev"] = sd
            r[f"{name}cov"] = None if sd is None or not ave else sd / ave
        out.append(r)
    return out


def pandas_s2(tables, month1_cov=None):
    """S2a (``month1_cov`` None) or S2b (1.5) by pandas from the
    specification's text."""
    inv = _pd(tables["inventory"], ["inv_date_sk", "inv_item_sk",
                                    "inv_warehouse_sk",
                                    "inv_quantity_on_hand"])
    dd = _pd(tables["date_dim"], ["d_date_sk", "d_year", "d_moy"])
    j = inv.merge(dd[dd.d_year == S2_YEAR], left_on="inv_date_sk",
                  right_on="d_date_sk")
    j = j[j.inv_item_sk.isin(set(_pd(tables["item"],
                                     ["i_item_sk"]).i_item_sk))]
    j = j[j.inv_warehouse_sk.isin(set(_pd(tables["warehouse"], [
        "w_warehouse_sk"]).w_warehouse_sk))]
    g = j.groupby(["inv_warehouse_sk", "inv_item_sk", "d_moy"], sort=True)[
        "inv_quantity_on_hand"].agg(["std", "mean", "count"]).reset_index()
    # a one-row group's sample deviation is null: no cov, and the filter
    # drops it
    g = g[(g["count"] > 1) & (g["mean"] != 0)]
    g = g.assign(cov=g["std"] / g["mean"])
    g = g[g["cov"] > 1]
    m1 = g[g.d_moy == 1]
    m2 = g[g.d_moy == 2]
    if month1_cov is not None:
        m1 = m1[m1["cov"] > month1_cov]
    jj = m1.merge(m2, on=["inv_warehouse_sk", "inv_item_sk"],
                  suffixes=("1", "2"))
    out = [{"w_warehouse_sk1": int(r.inv_warehouse_sk),
            "i_item_sk1": int(r.inv_item_sk), "d_moy1": 1,
            "mean1": float(r.mean1), "cov1": float(r.cov1),
            "w_warehouse_sk2": int(r.inv_warehouse_sk),
            "i_item_sk2": int(r.inv_item_sk), "d_moy2": 2,
            "mean2": float(r.mean2), "cov2": float(r.cov2)}
           for r in jj.itertuples()]
    out.sort(key=lambda r: tuple(r[k] for k in S2_ORDER))
    return out


PANDAS = {"S1": pandas_s1, "S2a": pandas_s2,
          "S2b": lambda t: pandas_s2(t, month1_cov=1.5)}


def informative(rows) -> bool:
    """Whether a result shows values: a row with no null."""
    return any(all(v is not None for v in r.values()) for r in rows)


def exact_skew_rows(tables, store: int):
    """S4_SKEW by numpy, frame by frame (each ROWS 30 PRECEDING frame's
    moments about its own mean): the row of S4_SKEW's aggregate."""
    ss = tables["store_sales"]
    cols = {c: ss.column(c) for c in ("ss_store_sk",) + TOTAL_ORDER}
    keep = np.asarray(cols["ss_store_sk"].to_numpy(zero_copy_only=False)
                      == store)
    arrs = []
    for c in TOTAL_ORDER:
        a = cols[c]
        if pa.types.is_decimal(a.type):
            a = a.cast(pa.float64())
        arrs.append(np.asarray(a.to_numpy(zero_copy_only=False),
                               np.float64)[keep])
    order = np.lexsort(arrs[::-1])
    x = arrs[3][order]
    sums = {"skew": 0.0, "kurt": 0.0}
    counts = {"skew": 0, "kurt": 0}
    for i in range(len(x)):
        w = x[max(0, i - 30): i + 1]
        d = w - w.mean()
        m2 = float((d * d).sum())
        if m2 == 0:
            continue
        k = len(w)
        sums["skew"] += np.sqrt(k) * float((d ** 3).sum()) / m2 ** 1.5
        sums["kurt"] += k * float((d ** 4).sum()) / (m2 * m2) - 3.0
        counts["skew"] += 1
        counts["kurt"] += 1
    return {"ss_store_sk": store, "sum_skew": sums["skew"],
            "n_skew": counts["skew"], "sum_kurt": sums["kurt"],
            "n_kurt": counts["kurt"], "n": int(len(x))}
