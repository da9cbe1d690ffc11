"""TPC-DS queries on the port's DataFrame front end (counterpart of
spark_rapids_tpu/bench/tpcds_queries.py), written as the reference writes
them, plus a pandas reference answer for each.

q3, q7, q42, q52 and q96 are the TPC-DS half of ``bench.py``'s headline
suite: each an inner-join star over store_sales with filtered dimensions,
then a group-by and a sort with a limit (q96 a global count instead). q7
filters promotions with an Or, groups by the plain-string item id and
averages a double and three decimal(7,2) columns (HALF_UP into
decimal(11,6)); q3/q42/q52 sum decimal(7,2) sales into decimal(17,2).

q44 and q67 rank rows with a window over decimal money columns: q44 ranks
items by their average net profit (decimal(7,2) averaged into
decimal(11,6)) in both directions, q67 ranks aggregated sales
(decimal(7,2) times a double quantity, summed as double) within each
category.

q9, q28, q40, q43, q87, q88, q93 and q97 carry the outer, semi and anti
joins, the conditionals and COUNT(DISTINCT): q9 and q28 are global
averages and counts over ``If`` panels of store_sales (q28 also six
distinct counts, which the planner rewrites into joins), q43 and q88 sum
``If`` panels after inner joins, q93 left-joins store_sales with
store_returns on (ticket, item) and semi-joins the reason, q40
left-joins catalog_sales with catalog_returns on (order, item) and
sums ``If``/``Coalesce`` of decimals, q97 full-joins two distinct
(customer, item) sets and q87 anti-joins three distinct (last, first)
name sets. ``TABLES`` names the tables each query reads.

``BREADTH`` holds 33 more queries, each written as the reference writes
it (its join graph, predicates and ORDER BY): q1, q14, q17, q25, q26,
q27, q29, q32, q34, q38, q41, q50, q55, q64, q65, q73, q79 and q92 over
the tables above, and q13, q16, q30, q37, q39, q48, q62, q69, q78, q81,
q82, q84, q85, q94 and q99, which also read customer_address, inventory,
web_returns, web_site, web_page, call_center, ship_mode and income_band.
They have no pandas reference: they are held against the JAX package
(tests) and against the port's CPU engine (``chip_smoke.py``). Where a
query's ORDER BY keys do not order every row and its LIMIT cuts a tie
group (``TIED_AT_LIMIT``), ``check_rows`` holds that group by its count.

``UNION_SLICE`` (Union, Substring, Like), ``DECIMAL_SLICE`` (Divide and
DECIMAL128 on the device) and ``WINDOW_SLICE`` (q47/q57/q89: decimal(21,6)
window averages partitioned by plain-string columns; q70/q86: ranks over
sums) complete the reference's 99 queries, held the same way.

The pandas references compute the same answers independently: decimal
sums and HALF_UP averages exactly in integers, double sums and averages in
float64. Results are compared with ``tpch.rows_match`` (rel 1e-6 on
doubles, exact keys, decimals and counts) and the ORDER BY columns in
order.
"""

from __future__ import annotations

import decimal
from typing import Callable, Dict, List, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs.expr import (
    Abs, Add, And, Average, Cast, Coalesce, Count, CountDistinct, Divide,
    EqualTo, GreaterThan, GreaterThanOrEqual, If, In, IsNotNull, IsNull,
    LessThan, LessThanOrEqual, Like, Max, Min, Multiply, Not, Or, Substring,
    Subtract, Sum, col, lit,
)
from spark_rapids_tpu_torch.exprs.window import (
    Rank, WindowFrame, over, window_spec)

D = Dict[str, "object"]


def asc(c, nf=None):
    return SortOrder(col(c) if isinstance(c, str) else c, nulls_first=nf)


def desc(c, nf=None):
    return SortOrder(col(c) if isinstance(c, str) else c, ascending=False,
                     nulls_first=nf)


def _between(c, lo, hi):
    c = col(c) if isinstance(c, str) else c
    return And(GreaterThanOrEqual(c, lit(lo)), LessThanOrEqual(c, lit(hi)))


def _distinct(df, *cols_):
    return df.select(*cols_).group_by(*cols_).agg()


QUERIES: Dict[str, Callable[[D], "object"]] = {}


def q(name):
    def reg(fn):
        QUERIES[name] = fn
        return fn
    return reg


@q("q3")
def q3(d: D):
    ss = d["store_sales"]
    dt = d["date_dim"].filter(EqualTo(col("d_moy"), lit(11)))
    it = d["item"].filter(_between(col("i_manufact_id"), 100, 150))
    j = (ss.join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(it, left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("d_year", "i_brand", "i_brand_id")
            .agg(Sum(col("ss_ext_sales_price")).alias("sum_agg"))
            .sort(asc("d_year"), desc("sum_agg"), asc("i_brand_id"),
                  limit=100))


@q("q7")
def q7(d: D):
    ss = d["store_sales"]
    cd = d["customer_demographics"].filter(
        And(And(EqualTo(col("cd_gender"), lit("M")),
                EqualTo(col("cd_marital_status"), lit("S"))),
            EqualTo(col("cd_education_status"), lit("College"))))
    dt = d["date_dim"].filter(EqualTo(col("d_year"), lit(2000)))
    pr = d["promotion"].filter(
        Or(EqualTo(col("p_channel_email"), lit("N")),
           EqualTo(col("p_channel_event"), lit("N"))))
    j = (ss.join(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
         .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(pr, left_on="ss_promo_sk", right_on="p_promo_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_item_id")
            .agg(Average(col("ss_quantity")).alias("agg1"),
                 Average(col("ss_list_price")).alias("agg2"),
                 Average(col("ss_coupon_amt")).alias("agg3"),
                 Average(col("ss_sales_price")).alias("agg4"))
            .sort("i_item_id", limit=100))


@q("q42")
def q42(d: D):
    j = (d["store_sales"]
         .join(d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(11)),
                                        EqualTo(col("d_year"), lit(2000)))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("d_year", "i_category_id", "i_category")
            .agg(Sum(col("ss_ext_sales_price")).alias("sum_agg"))
            .sort(desc("sum_agg"), asc("d_year"), asc("i_category_id"),
                  asc("i_category"), limit=100))


@q("q44")
def q44(d: D):
    """Best and worst performing items by avg net profit (two ranked
    subqueries joined)."""
    base = (d["store_sales"]
            .group_by("ss_item_sk")
            .agg(Average(col("ss_net_profit")).alias("rank_col")))
    asc_rank = base.with_window(
        over(Rank(), window_spec(order_by=[asc("rank_col"),
                                           asc("ss_item_sk")])).alias("rnk"))
    desc_rank = base.with_window(
        over(Rank(), window_spec(order_by=[desc("rank_col"),
                                           asc("ss_item_sk")])).alias("rnk"))
    best = (asc_rank.filter(LessThanOrEqual(col("rnk"), lit(10)))
            .select(col("ss_item_sk").alias("best_sk"),
                    col("rnk").alias("rnk")))
    worst = (desc_rank.filter(LessThanOrEqual(col("rnk"), lit(10)))
             .select(col("ss_item_sk").alias("worst_sk"),
                     col("rnk").alias("rnk2")))
    j = (best.join(worst, left_on=col("rnk"), right_on=col("rnk2"))
         .join(d["item"].select(col("i_item_sk").alias("i1"),
                                col("i_product_name").alias("best_performing")),
               left_on=col("best_sk"), right_on=col("i1"))
         .join(d["item"].select(col("i_item_sk").alias("i2"),
                                col("i_product_name").alias("worst_performing")),
               left_on=col("worst_sk"), right_on=col("i2")))
    return (j.select("rnk", "best_performing", "worst_performing")
            .sort("rnk", limit=100))


@q("q67")
def q67(d: D):
    """Top items per category by rank over sales (ROLLUP base grouping)."""
    j = (d["store_sales"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    g = (j.group_by("i_category", "i_class", "i_brand", "i_product_name",
                    "d_year", "d_qoy", "d_moy", "s_store_id")
         .agg(Sum(Multiply(col("ss_sales_price"),
                           col("ss_quantity"))).alias("sumsales")))
    w = g.with_window(
        over(Rank(), window_spec(partition_by=["i_category"],
                                 order_by=[desc("sumsales")])).alias("rk"))
    return (w.filter(LessThanOrEqual(col("rk"), lit(10)))
            .select("i_category", "i_class", "i_brand", "i_product_name",
                    "d_year", "sumsales", "rk")
            .sort(asc("i_category", nf=True), desc("sumsales"), asc("rk"),
                  limit=100))


@q("q52")
def q52(d: D):
    j = (d["store_sales"]
         .join(d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(11)),
                                        EqualTo(col("d_year"), lit(2000)))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("d_year", "i_brand", "i_brand_id")
            .agg(Sum(col("ss_ext_sales_price")).alias("ext_price"))
            .sort(asc("d_year"), desc("ext_price"), asc("i_brand_id"),
                  limit=100))


@q("q96")
def q96(d: D):
    td = d["time_dim"].filter(And(EqualTo(col("t_hour"), lit(20)),
                                  GreaterThanOrEqual(col("t_minute"),
                                                     lit(30))))
    hd = d["household_demographics"].filter(EqualTo(col("hd_dep_count"),
                                                    lit(7)))
    st = d["store"].filter(EqualTo(col("s_store_name"), lit("ese")))
    j = (d["store_sales"]
         .join(td, left_on="ss_sold_time_sk", right_on="t_time_sk")
         .join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
         .join(st, left_on="ss_store_sk", right_on="s_store_sk"))
    return j.agg(Count().alias("cnt"))


@q("q9")
def q9(d: D):
    """Bucketed averages via CASE over quantity ranges (scalar subqueries
    evaluated as conditional aggregates in one pass)."""
    ss = d["store_sales"]

    def bucket(lo, hi, name):
        cond = _between(col("ss_quantity"), float(lo), float(hi))
        return (Average(If(cond, col("ss_ext_discount_amt"),
                           lit(None, T.DOUBLE))).alias(f"avg_disc_{name}"),
                Average(If(cond, col("ss_net_paid"),
                           lit(None, T.DOUBLE))).alias(f"avg_paid_{name}"),
                Count(If(cond, col("ss_quantity"),
                         lit(None, T.DOUBLE))).alias(f"cnt_{name}"))
    aggs = []
    for i, (lo, hi) in enumerate(Q9_BUCKETS):
        aggs.extend(bucket(lo, hi, f"b{i}"))
    return ss.agg(*aggs)


Q9_BUCKETS = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
Q28_BUCKETS = [(0, 5, 8.0, 18.0), (6, 10, 9.0, 19.0), (11, 15, 10.0, 20.0),
               (16, 20, 11.0, 21.0), (21, 25, 12.0, 22.0),
               (26, 30, 13.0, 23.0)]


@q("q28")
def q28(d: D):
    """Six price-bucket aggregate panels over store_sales (conditional
    aggregates in one pass, like q9)."""
    ss = d["store_sales"]
    aggs = []
    for i, (qlo, qhi, plo, phi) in enumerate(Q28_BUCKETS):
        cond = And(_between(col("ss_quantity"), float(qlo), float(qhi)),
                   Or(_between(col("ss_list_price"), plo, phi),
                      _between(col("ss_coupon_amt"), plo * 10, phi * 10)))
        v = If(cond, col("ss_list_price"), lit(None, T.DOUBLE))
        aggs.extend([
            Average(v).alias(f"b{i}_avg"),
            Count(v).alias(f"b{i}_cnt"),
            CountDistinct(v).alias(f"b{i}_cntd"),
        ])
    return ss.agg(*aggs)


@q("q40")
def q40(d: D):
    """Catalog sales +/- returns by warehouse/item around a pivot date."""
    pivot = 900
    j = (d["catalog_sales"]
         .join(d["catalog_returns"],
               left_on=[col("cs_order_number"), col("cs_item_sk")],
               right_on=[col("cr_order_number"), col("cr_item_sk")],
               how="left")
         .join(d["warehouse"], left_on="cs_warehouse_sk",
               right_on="w_warehouse_sk")
         .join(d["item"].filter(_between(col("i_current_price"), 0.99, 50.0)),
               left_on="cs_item_sk", right_on="i_item_sk")
         .join(d["date_dim"].filter(_between(col("d_date_sk"),
                                             pivot - 30, pivot + 30)),
               left_on="cs_sold_date_sk", right_on="d_date_sk"))
    net = Subtract(col("cs_sales_price"),
                   Coalesce(col("cr_refunded_cash"), lit(0.0)))
    g = (j.group_by("w_state", "i_item_id")
         .agg(Sum(If(LessThan(col("d_date_sk"), lit(pivot)), net,
                     lit(0.0))).alias("sales_before"),
              Sum(If(GreaterThanOrEqual(col("d_date_sk"), lit(pivot)), net,
                     lit(0.0))).alias("sales_after")))
    return g.sort("w_state", "i_item_id", limit=100)


Q43_DAYS = ("Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
            "Friday", "Saturday")


@q("q43")
def q43(d: D):
    """Store sales by weekday per store."""
    j = (d["store_sales"]
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2000))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk"))

    def day(nm):
        return Sum(If(EqualTo(col("d_day_name"), lit(nm)),
                      col("ss_sales_price"),
                      lit(None, T.DOUBLE))).alias(f"{nm[:3].lower()}_sales")
    return (j.group_by("s_store_name", "s_store_id")
            .agg(*[day(nm) for nm in Q43_DAYS])
            .sort("s_store_name", "s_store_id", limit=100))


@q("q87")
def q87(d: D):
    """Customers in store but not in both other channels (EXCEPT chain)."""
    dt = d["date_dim"].filter(_between(col("d_month_seq"), 12, 23))

    def chan(fact, datecol, custcol):
        return _distinct(
            d[fact].join(dt, left_on=datecol, right_on="d_date_sk")
            .join(d["customer"], left_on=custcol, right_on="c_customer_sk"),
            "c_last_name", "c_first_name")
    ss = chan("store_sales", "ss_sold_date_sk", "ss_customer_sk")
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")
    ws = chan("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")
    out = (ss.join(cs, on=["c_last_name", "c_first_name"], how="left_anti")
           .join(ws, on=["c_last_name", "c_first_name"], how="left_anti"))
    return out.agg(Count().alias("num_customers"))


Q88_SLOTS = ((8, 30, 59, "h8_30"), (9, 0, 29, "h9_00"), (9, 30, 59, "h9_30"),
             (10, 0, 29, "h10_00"), (10, 30, 59, "h10_30"),
             (11, 0, 29, "h11_00"), (11, 30, 59, "h11_30"),
             (12, 0, 29, "h12_00"))


@q("q88")
def q88(d: D):
    """Store traffic by half-hour time slots (8 conditional counts)."""
    hd = d["household_demographics"].filter(
        Or(Or(And(EqualTo(col("hd_dep_count"), lit(4)),
                  LessThanOrEqual(col("hd_vehicle_count"), lit(6))),
              And(EqualTo(col("hd_dep_count"), lit(2)),
                  LessThanOrEqual(col("hd_vehicle_count"), lit(4)))),
           And(EqualTo(col("hd_dep_count"), lit(0)),
               LessThanOrEqual(col("hd_vehicle_count"), lit(2)))))
    st = d["store"].filter(EqualTo(col("s_store_name"), lit("ese")))
    j = (d["store_sales"]
         .join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
         .join(st, left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["time_dim"], left_on="ss_sold_time_sk",
               right_on="t_time_sk"))

    def slot(h, mlo, mhi, name):
        return Sum(If(And(EqualTo(col("t_hour"), lit(h)),
                          _between(col("t_minute"), mlo, mhi)),
                      lit(1), lit(0))).alias(name)
    return j.agg(*[slot(*s_) for s_ in Q88_SLOTS])


@q("q93")
def q93(d: D):
    """Actual store sales after returns per customer for one reason."""
    j = (d["store_sales"]
         .join(d["store_returns"],
               left_on=[col("ss_ticket_number"), col("ss_item_sk")],
               right_on=[col("sr_ticket_number"), col("sr_item_sk")],
               how="left")
         .join(d["reason"].filter(EqualTo(col("r_reason_desc"),
                                          lit("Did not fit"))),
               left_on=col("sr_reason_sk"), right_on=col("r_reason_sk"),
               how="left_semi"))
    val = If(IsNull(col("sr_return_quantity")),
             Multiply(col("ss_quantity"), col("ss_sales_price")),
             Multiply(Subtract(col("ss_quantity"),
                               col("sr_return_quantity")),
                      col("ss_sales_price")))
    g = (j.group_by("ss_customer_sk")
         .agg(Sum(val).alias("sumsales")))
    return g.sort(asc("sumsales"), asc("ss_customer_sk"), limit=100)


@q("q97")
def q97(d: D):
    """Store/catalog customer-item overlap counts."""
    ss = _distinct(
        d["store_sales"].join(
            d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
            left_on="ss_sold_date_sk", right_on="d_date_sk"),
        "ss_customer_sk", "ss_item_sk").select(
        col("ss_customer_sk").alias("sc"), col("ss_item_sk").alias("si"),
        lit(1).alias("s_flag"))
    cs = _distinct(
        d["catalog_sales"].join(
            d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
            left_on="cs_sold_date_sk", right_on="d_date_sk"),
        "cs_bill_customer_sk", "cs_item_sk").select(
        col("cs_bill_customer_sk").alias("cc"),
        col("cs_item_sk").alias("ci"), lit(1).alias("c_flag"))
    j = ss.join(cs, left_on=[col("sc"), col("si")],
                right_on=[col("cc"), col("ci")], how="full")
    return j.agg(
        Sum(If(And(IsNotNull(col("s_flag")), IsNull(col("c_flag"))),
               lit(1), lit(0))).alias("store_only"),
        Sum(If(And(IsNull(col("s_flag")), IsNotNull(col("c_flag"))),
               lit(1), lit(0))).alias("catalog_only"),
        Sum(If(And(IsNotNull(col("s_flag")), IsNotNull(col("c_flag"))),
               lit(1), lit(0))).alias("store_and_catalog"))


# the breadth slice, as the reference writes each query


@q("q1")
def q1(d: D):
    """Customers returning more than 1.2x their store's average return."""
    sr = d["store_returns"].join(
        d["date_dim"].filter(EqualTo(col("d_year"), lit(1999))),
        left_on="sr_returned_date_sk", right_on="d_date_sk")
    ctr = (sr.group_by("sr_customer_sk", "sr_store_sk")
           .agg(Sum(col("sr_return_amt")).alias("ctr_total_return")))
    avg_by_store = (ctr.group_by("sr_store_sk")
                    .agg(Average(col("ctr_total_return")).alias("avg_ret"))
                    .select(col("sr_store_sk").alias("avg_store_sk"),
                            col("avg_ret")))
    j = (ctr.join(avg_by_store, left_on="sr_store_sk",
                  right_on="avg_store_sk")
         .filter(GreaterThan(col("ctr_total_return"),
                             Multiply(col("avg_ret"), lit(1.2))))
         .join(d["store"].filter(In(col("s_state"),
                                    [lit(s) for s in ("TN", "GA", "OH")])),
               left_on=col("sr_store_sk"), right_on=col("s_store_sk"))
         .join(d["customer"], left_on="sr_customer_sk",
               right_on="c_customer_sk"))
    return j.select("c_customer_id").sort("c_customer_id", limit=100)


@q("q13")
def q13(d: D):
    """Store sales averages under OR'd demographic/address conditions."""
    j = (d["store_sales"]
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2001))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["customer_demographics"], left_on="ss_cdemo_sk",
               right_on="cd_demo_sk")
         .join(d["household_demographics"], left_on="ss_hdemo_sk",
               right_on="hd_demo_sk")
         .join(d["customer_address"].filter(
             EqualTo(col("ca_country"), lit("United States"))),
             left_on="ss_addr_sk", right_on="ca_address_sk"))
    j = j.filter(Or(
        And(And(EqualTo(col("cd_marital_status"), lit("M")),
                EqualTo(col("cd_education_status"), lit("College"))),
            _between(col("ss_sales_price"), 100.0, 150.0)),
        And(And(EqualTo(col("cd_marital_status"), lit("S")),
                EqualTo(col("cd_education_status"), lit("Primary"))),
            _between(col("ss_sales_price"), 50.0, 100.0))))
    return j.agg(Average(col("ss_quantity")).alias("avg_qty"),
                 Average(col("ss_ext_sales_price")).alias("avg_esp"),
                 Average(col("ss_ext_wholesale_cost")).alias("avg_ewc"),
                 Sum(col("ss_ext_wholesale_cost")).alias("sum_ewc"))


@q("q14")
def q14(d: D):
    """Cross-channel items (brand/class/category INTERSECTion across the
    three channels) and their store sales (base grouping)."""
    def chan_items(fact, item_col):
        return _distinct(
            d[fact].join(d["item"], left_on=item_col, right_on="i_item_sk"),
            "i_brand_id", "i_class_id", "i_category_id")
    ss_i = chan_items("store_sales", "ss_item_sk")
    cs_i = chan_items("catalog_sales", "cs_item_sk")
    ws_i = chan_items("web_sales", "ws_item_sk")
    common = (ss_i.join(cs_i, on=["i_brand_id", "i_class_id",
                                  "i_category_id"], how="left_semi")
              .join(ws_i, on=["i_brand_id", "i_class_id", "i_category_id"],
                    how="left_semi"))
    it = d["item"].join(common, on=["i_brand_id", "i_class_id",
                                    "i_category_id"], how="left_semi")
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(2000)),
                                  EqualTo(col("d_moy"), lit(11))))
    j = (d["store_sales"]
         .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(it, left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_brand_id", "i_class_id", "i_category_id")
            .agg(Sum(col("ss_ext_sales_price")).alias("sales"),
                 Count().alias("number_sales"))
            .sort("i_brand_id", "i_class_id", "i_category_id", limit=100))


@q("q16")
def q16(d: D):
    """Catalog orders shipped from one warehouse with another order from a
    different warehouse and no returns (EXISTS/NOT EXISTS)."""
    cs = (d["catalog_sales"]
          .join(d["date_dim"].filter(_between(col("d_date_sk"), 730, 790)),
                left_on="cs_ship_date_sk", right_on="d_date_sk")
          .join(d["customer_address"].filter(EqualTo(col("ca_state"),
                                                     lit("GA"))),
                left_on="cs_ship_addr_sk", right_on="ca_address_sk")
          .join(d["call_center"], left_on="cs_call_center_sk",
                right_on="cc_call_center_sk"))
    # another sale on the same order from a different warehouse: order
    # numbers with >1 distinct warehouse
    multi_wh = (d["catalog_sales"]
                .group_by("cs_order_number")
                .agg(CountDistinct(col("cs_warehouse_sk")).alias("nwh"))
                .filter(GreaterThan(col("nwh"), lit(1)))
                .select(col("cs_order_number").alias("mw_order")))
    returned = _distinct(d["catalog_returns"], "cr_order_number")
    cs = (cs.join(multi_wh, left_on=col("cs_order_number"),
                  right_on=col("mw_order"), how="left_semi")
          .join(returned, left_on=col("cs_order_number"),
                right_on=col("cr_order_number"), how="left_anti"))
    return cs.agg(CountDistinct(col("cs_order_number")).alias("order_count"),
                  Sum(col("cs_ext_ship_cost")).alias("total_shipping_cost"),
                  Sum(col("cs_net_profit")).alias("total_net_profit"))


@q("q17")
def q17(d: D):
    """Items bought then returned then re-bought via catalog (3-way fact
    join with quantity statistics)."""
    ss = (d["store_sales"]
          .join(d["date_dim"].filter(EqualTo(col("d_qoy"), lit(1)))
                .select(col("d_date_sk").alias("d1_sk"),
                        col("d_year").alias("d1_year")),
                left_on=col("ss_sold_date_sk"), right_on=col("d1_sk")))
    sr = (d["store_returns"]
          .join(d["date_dim"].filter(_between(col("d_qoy"), 1, 3))
                .select(col("d_date_sk").alias("d2_sk")),
                left_on=col("sr_returned_date_sk"), right_on=col("d2_sk")))
    cs = (d["catalog_sales"]
          .join(d["date_dim"].filter(_between(col("d_qoy"), 1, 3))
                .select(col("d_date_sk").alias("d3_sk")),
                left_on=col("cs_sold_date_sk"), right_on=col("d3_sk")))
    j = (ss.join(sr, left_on=[col("ss_customer_sk"), col("ss_item_sk"),
                              col("ss_ticket_number")],
                 right_on=[col("sr_customer_sk"), col("sr_item_sk"),
                           col("sr_ticket_number")])
         .join(cs, left_on=[col("sr_customer_sk"), col("sr_item_sk")],
               right_on=[col("cs_bill_customer_sk"), col("cs_item_sk")])
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_item_id", "i_item_desc", "s_state")
            .agg(Count(col("ss_quantity")).alias("store_sales_cnt"),
                 Average(col("ss_quantity")).alias("store_sales_avg"),
                 Count(col("sr_return_quantity")).alias("store_ret_cnt"),
                 Average(col("sr_return_quantity")).alias("store_ret_avg"),
                 Count(col("cs_quantity")).alias("catalog_cnt"),
                 Average(col("cs_quantity")).alias("catalog_avg"))
            .sort("i_item_id", "i_item_desc", "s_state", limit=100))


@q("q25")
def q25(d: D):
    """Store items sold then returned then catalog-rebought: profit sums."""
    ss = (d["store_sales"]
          .join(d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(4)),
                                         EqualTo(col("d_year"), lit(2000))))
                .select(col("d_date_sk").alias("d1_sk")),
                left_on=col("ss_sold_date_sk"), right_on=col("d1_sk")))
    sr = (d["store_returns"]
          .join(d["date_dim"].filter(And(_between(col("d_moy"), 4, 10),
                                         EqualTo(col("d_year"), lit(2000))))
                .select(col("d_date_sk").alias("d2_sk")),
                left_on=col("sr_returned_date_sk"), right_on=col("d2_sk")))
    cs = (d["catalog_sales"]
          .join(d["date_dim"].filter(And(_between(col("d_moy"), 4, 10),
                                         EqualTo(col("d_year"), lit(2000))))
                .select(col("d_date_sk").alias("d3_sk")),
                left_on=col("cs_sold_date_sk"), right_on=col("d3_sk")))
    j = (ss.join(sr, left_on=[col("ss_customer_sk"), col("ss_item_sk"),
                              col("ss_ticket_number")],
                 right_on=[col("sr_customer_sk"), col("sr_item_sk"),
                           col("sr_ticket_number")])
         .join(cs, left_on=[col("sr_customer_sk"), col("sr_item_sk")],
               right_on=[col("cs_bill_customer_sk"), col("cs_item_sk")])
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_item_id", "i_item_desc", "s_store_id",
                       "s_store_name")
            .agg(Sum(col("ss_net_profit")).alias("store_sales_profit"),
                 Sum(col("sr_net_loss")).alias("store_returns_loss"),
                 Sum(col("cs_net_profit")).alias("catalog_sales_profit"))
            .sort("i_item_id", "i_item_desc", "s_store_id", "s_store_name",
                  limit=100))


@q("q26")
def q26(d: D):
    """q7 on catalog sales."""
    cd = d["customer_demographics"].filter(
        And(And(EqualTo(col("cd_gender"), lit("M")),
                EqualTo(col("cd_marital_status"), lit("S"))),
            EqualTo(col("cd_education_status"), lit("College"))))
    pr = d["promotion"].filter(
        Or(EqualTo(col("p_channel_email"), lit("N")),
           EqualTo(col("p_channel_event"), lit("N"))))
    j = (d["catalog_sales"]
         .join(cd, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2000))),
               left_on="cs_sold_date_sk", right_on="d_date_sk")
         .join(pr, left_on="cs_promo_sk", right_on="p_promo_sk")
         .join(d["item"], left_on="cs_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_item_id")
            .agg(Average(col("cs_quantity")).alias("agg1"),
                 Average(col("cs_list_price")).alias("agg2"),
                 Average(col("cs_coupon_amt")).alias("agg3"),
                 Average(col("cs_sales_price")).alias("agg4"))
            .sort("i_item_id", limit=100))


@q("q27")
def q27(d: D):
    """Store sales averages by item/state (base grouping; ROLLUP in the
    official)."""
    cd = d["customer_demographics"].filter(
        And(And(EqualTo(col("cd_gender"), lit("M")),
                EqualTo(col("cd_marital_status"), lit("S"))),
            EqualTo(col("cd_education_status"), lit("College"))))
    j = (d["store_sales"]
         .join(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk")
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2000))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["store"].filter(In(col("s_state"),
                                    [lit(s) for s in ("TN", "GA", "TX")])),
               left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_item_id", "s_state")
            .agg(Average(col("ss_quantity")).alias("agg1"),
                 Average(col("ss_list_price")).alias("agg2"),
                 Average(col("ss_coupon_amt")).alias("agg3"),
                 Average(col("ss_sales_price")).alias("agg4"))
            .sort("i_item_id", "s_state", limit=100))


@q("q29")
def q29(d: D):
    """q25 shape with quantity sums."""
    ss = (d["store_sales"]
          .join(d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(4)),
                                         EqualTo(col("d_year"), lit(1999))))
                .select(col("d_date_sk").alias("d1_sk")),
                left_on=col("ss_sold_date_sk"), right_on=col("d1_sk")))
    sr = (d["store_returns"]
          .join(d["date_dim"].filter(And(_between(col("d_moy"), 4, 7),
                                         EqualTo(col("d_year"), lit(1999))))
                .select(col("d_date_sk").alias("d2_sk")),
                left_on=col("sr_returned_date_sk"), right_on=col("d2_sk")))
    cs = (d["catalog_sales"]
          .join(d["date_dim"].filter(In(col("d_year"),
                                        [lit(y) for y in (1999, 2000, 2001)]))
                .select(col("d_date_sk").alias("d3_sk")),
                left_on=col("cs_sold_date_sk"), right_on=col("d3_sk")))
    j = (ss.join(sr, left_on=[col("ss_customer_sk"), col("ss_item_sk"),
                              col("ss_ticket_number")],
                 right_on=[col("sr_customer_sk"), col("sr_item_sk"),
                           col("sr_ticket_number")])
         .join(cs, left_on=[col("sr_customer_sk"), col("sr_item_sk")],
               right_on=[col("cs_bill_customer_sk"), col("cs_item_sk")])
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_item_id", "i_item_desc", "s_store_id",
                       "s_store_name")
            .agg(Sum(col("ss_quantity")).alias("store_sales_quantity"),
                 Sum(col("sr_return_quantity")).alias("store_ret_quantity"),
                 Sum(col("cs_quantity")).alias("catalog_sales_quantity"))
            .sort("i_item_id", "i_item_desc", "s_store_id", "s_store_name",
                  limit=100))


@q("q30")
def q30(d: D):
    """Web returners returning >1.2x their state's average (q1 on web)."""
    wr = d["web_returns"].join(
        d["date_dim"].filter(EqualTo(col("d_year"), lit(1999))),
        left_on="wr_returned_date_sk", right_on="d_date_sk")
    wr = wr.join(d["customer_address"], left_on="wr_returning_addr_sk",
                 right_on="ca_address_sk")
    ctr = (wr.group_by("wr_returning_customer_sk", "ca_state")
           .agg(Sum(col("wr_return_amt")).alias("ctr_total_return")))
    avg_by_state = (ctr.group_by("ca_state")
                    .agg(Average(col("ctr_total_return")).alias("avg_ret"))
                    .select(col("ca_state").alias("st2"), col("avg_ret")))
    j = (ctr.join(avg_by_state, left_on=col("ca_state"), right_on=col("st2"))
         .filter(GreaterThan(col("ctr_total_return"),
                             Multiply(col("avg_ret"), lit(1.2))))
         .join(d["customer"], left_on="wr_returning_customer_sk",
               right_on="c_customer_sk"))
    return (j.select("c_customer_id", "c_first_name", "c_last_name",
                     "ctr_total_return")
            .sort("c_customer_id", "ctr_total_return", limit=100))


@q("q32")
def q32(d: D):
    """Excess catalog discounts: discount > 1.3x item-period average."""
    dt = d["date_dim"].filter(_between(col("d_date_sk"), 730, 820))
    base = (d["catalog_sales"]
            .join(dt, left_on="cs_sold_date_sk", right_on="d_date_sk")
            .join(d["item"].filter(EqualTo(col("i_manufact_id"), lit(77))),
                  left_on="cs_item_sk", right_on="i_item_sk"))
    avg_disc = (base.group_by("i_item_sk")
                .agg(Average(col("cs_ext_discount_amt")).alias("avg_d"))
                .select(col("i_item_sk").alias("ad_item"), col("avg_d")))
    j = (base.join(avg_disc, left_on=col("i_item_sk"),
                   right_on=col("ad_item"))
         .filter(GreaterThan(col("cs_ext_discount_amt"),
                             Multiply(lit(1.3), col("avg_d")))))
    return j.agg(Sum(col("cs_ext_discount_amt")).alias("excess_discount"))


@q("q34")
def q34(d: D):
    """Customers with 15-20 items per ticket in selected months."""
    dt = d["date_dim"].filter(And(
        Or(EqualTo(col("d_dom"), lit(1)), _between(col("d_dom"), 25, 28)),
        In(col("d_year"), [lit(y) for y in (1999, 2000, 2001)])))
    hd = d["household_demographics"].filter(
        Or(EqualTo(col("hd_buy_potential"), lit(">10000")),
           EqualTo(col("hd_buy_potential"), lit("Unknown"))))
    st = d["store"].filter(In(col("s_county"),
                              [lit(c) for c in ("Williamson County",
                                                "Ziebach County")]))
    j = (d["store_sales"]
         .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(st, left_on="ss_store_sk", right_on="s_store_sk")
         .join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk"))
    g = (j.group_by("ss_ticket_number", "ss_customer_sk")
         .agg(Count().alias("cnt"))
         .filter(_between(col("cnt"), 3, 20)))
    out = g.join(d["customer"], left_on="ss_customer_sk",
                 right_on="c_customer_sk")
    return (out.select("c_last_name", "c_first_name", "c_salutation",
                       "c_preferred_cust_flag", "ss_ticket_number", "cnt")
            .sort(asc("c_last_name"), asc("c_first_name"),
                  asc("c_salutation"), desc("c_preferred_cust_flag"),
                  asc("ss_ticket_number"), limit=200))


@q("q37")
def q37(d: D):
    """Catalog items with inventory 100-500 in a window."""
    it = d["item"].filter(And(_between(col("i_current_price"), 20.0, 50.0),
                              In(col("i_manufact_id"),
                                 [lit(m) for m in
                                  range(600, 700)])))
    inv = (d["inventory"].filter(_between(col("inv_quantity_on_hand"),
                                          100, 500))
           .join(d["date_dim"].filter(_between(col("d_date_sk"), 700, 760)),
                 left_on="inv_date_sk", right_on="d_date_sk"))
    j = (d["catalog_sales"]
         .join(it, left_on="cs_item_sk", right_on="i_item_sk")
         .join(inv, left_on=col("cs_item_sk"), right_on=col("inv_item_sk"),
               how="left_semi"))
    return (_distinct(j, "i_item_id", "i_item_desc", "i_current_price")
            .sort("i_item_id", limit=100))


@q("q38")
def q38(d: D):
    """Customers appearing in all three channels (INTERSECT via semi)."""
    dt = d["date_dim"].filter(_between(col("d_month_seq"), 12, 23))
    def chan(fact, datecol, custcol):
        return _distinct(
            d[fact].join(dt, left_on=datecol, right_on="d_date_sk")
            .join(d["customer"], left_on=custcol, right_on="c_customer_sk"),
            "c_last_name", "c_first_name")
    ss = chan("store_sales", "ss_sold_date_sk", "ss_customer_sk")
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")
    ws = chan("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")
    both = (ss.join(cs, on=["c_last_name", "c_first_name"], how="left_semi")
            .join(ws, on=["c_last_name", "c_first_name"], how="left_semi"))
    return both.agg(Count().alias("cnt"))


@q("q39")
def q39(d: D):
    """Warehouse/item monthly inventory mean and variability, month pair
    join (stddev expressed via sum of squares)."""
    j = (d["inventory"]
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(1998))),
               left_on="inv_date_sk", right_on="d_date_sk")
         .join(d["item"], left_on="inv_item_sk", right_on="i_item_sk")
         .join(d["warehouse"], left_on="inv_warehouse_sk",
               right_on="w_warehouse_sk"))
    g = (j.group_by("w_warehouse_sk", "i_item_sk", "d_moy")
         .agg(Average(col("inv_quantity_on_hand")).alias("mean_q"),
              Average(Multiply(col("inv_quantity_on_hand"),
                               col("inv_quantity_on_hand"))).alias("mean_q2"),
              Count().alias("n")))
    g = g.select("w_warehouse_sk", "i_item_sk", "d_moy", "mean_q",
                 Subtract(col("mean_q2"),
                          Multiply(col("mean_q"), col("mean_q"))).alias("var"))
    g = g.filter(GreaterThan(col("mean_q"), lit(0.0)))
    m1 = g.filter(EqualTo(col("d_moy"), lit(1))).select(
        col("w_warehouse_sk").alias("w1"), col("i_item_sk").alias("i1"),
        col("mean_q").alias("mean1"), col("var").alias("var1"))
    m2 = g.filter(EqualTo(col("d_moy"), lit(2))).select(
        col("w_warehouse_sk").alias("w2"), col("i_item_sk").alias("i2"),
        col("mean_q").alias("mean2"), col("var").alias("var2"))
    jj = m1.join(m2, left_on=[col("w1"), col("i1")],
                 right_on=[col("w2"), col("i2")])
    return jj.sort("w1", "i1", "mean1", limit=100)


@q("q41")
def q41(d: D):
    """Distinct product names for one manufacturer range with attribute
    combinations (the EXISTS count subquery becomes a semi join)."""
    attrs = d["item"].filter(Or(
        And(EqualTo(col("i_color"), lit("red")),
            EqualTo(col("i_units"), lit("Each"))),
        And(EqualTo(col("i_color"), lit("blue")),
            EqualTo(col("i_units"), lit("Dozen")))))
    combos = _distinct(attrs, "i_manufact")
    j = (d["item"].filter(_between(col("i_manufact_id"), 700, 800))
         .join(combos, left_on="i_manufact", right_on="i_manufact",
               how="left_semi"))
    return (_distinct(j, "i_product_name")
            .sort("i_product_name", limit=100))


@q("q48")
def q48(d: D):
    """Quantity sum under OR'd demographic/address/price conditions."""
    j = (d["store_sales"]
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2000))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["customer_demographics"], left_on="ss_cdemo_sk",
               right_on="cd_demo_sk")
         .join(d["customer_address"].filter(
             EqualTo(col("ca_country"), lit("United States"))),
             left_on="ss_addr_sk", right_on="ca_address_sk"))
    j = j.filter(Or(
        And(And(EqualTo(col("cd_marital_status"), lit("M")),
                EqualTo(col("cd_education_status"), lit("4 yr Degree"))),
            _between(col("ss_sales_price"), 100.0, 150.0)),
        And(And(EqualTo(col("cd_marital_status"), lit("D")),
                EqualTo(col("cd_education_status"), lit("2 yr Degree"))),
            _between(col("ss_sales_price"), 50.0, 100.0))))
    return j.agg(Sum(col("ss_quantity")).alias("total_qty"))


@q("q50")
def q50(d: D):
    """Return latency buckets per store."""
    j = (d["store_sales"]
         .join(d["store_returns"],
               left_on=[col("ss_ticket_number"), col("ss_item_sk"),
                        col("ss_customer_sk")],
               right_on=[col("sr_ticket_number"), col("sr_item_sk"),
                         col("sr_customer_sk")])
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["date_dim"].filter(And(EqualTo(col("d_year"), lit(2000)),
                                        EqualTo(col("d_moy"), lit(8))))
               .select(col("d_date_sk").alias("ret_date")),
               left_on=col("sr_returned_date_sk"), right_on=col("ret_date")))
    lag = Subtract(col("sr_returned_date_sk"), col("ss_sold_date_sk"))
    def bucket(cond, name):
        return Sum(If(cond, lit(1), lit(0))).alias(name)
    return (j.group_by("s_store_name", "s_store_id")
            .agg(bucket(LessThanOrEqual(lag, lit(30)), "d30"),
                 bucket(And(GreaterThan(lag, lit(30)),
                            LessThanOrEqual(lag, lit(60))), "d60"),
                 bucket(And(GreaterThan(lag, lit(60)),
                            LessThanOrEqual(lag, lit(90))), "d90"),
                 bucket(And(GreaterThan(lag, lit(90)),
                            LessThanOrEqual(lag, lit(120))), "d120"),
                 bucket(GreaterThan(lag, lit(120)), "dmore"))
            .sort("s_store_name", "s_store_id", limit=100))


@q("q55")
def q55(d: D):
    j = (d["store_sales"]
         .join(d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(11)),
                                        EqualTo(col("d_year"), lit(1999)))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["item"].filter(EqualTo(col("i_manager_id"), lit(28))),
               left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_brand_id", "i_brand")
            .agg(Sum(col("ss_ext_sales_price")).alias("ext_price"))
            .sort(desc("ext_price"), asc("i_brand_id"), limit=100))


@q("q62")
def q62(d: D):
    """Web shipping latency buckets by warehouse/ship-mode/site."""
    j = (d["web_sales"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="ws_ship_date_sk", right_on="d_date_sk")
         .join(d["warehouse"], left_on="ws_warehouse_sk",
               right_on="w_warehouse_sk")
         .join(d["ship_mode"], left_on="ws_ship_mode_sk",
               right_on="sm_ship_mode_sk")
         .join(d["web_site"], left_on="ws_web_site_sk",
               right_on="web_site_sk"))
    lag = Subtract(col("ws_ship_date_sk"), col("ws_sold_date_sk"))
    def b(cond, name):
        return Sum(If(cond, lit(1), lit(0))).alias(name)
    return (j.group_by("w_warehouse_name", "sm_type", "web_name")
            .agg(b(LessThanOrEqual(lag, lit(30)), "d30"),
                 b(And(GreaterThan(lag, lit(30)),
                       LessThanOrEqual(lag, lit(60))), "d60"),
                 b(And(GreaterThan(lag, lit(60)),
                       LessThanOrEqual(lag, lit(90))), "d90"),
                 b(And(GreaterThan(lag, lit(90)),
                       LessThanOrEqual(lag, lit(120))), "d120"),
                 b(GreaterThan(lag, lit(120)), "dmore"))
            .sort("w_warehouse_name", "sm_type", "web_name", limit=100))


@q("q64")
def q64(d: D):
    """Cross-year store purchases of returned items with demographics
    (heavily simplified join chain keeping the returns+two-year shape)."""
    def year_sales(year, alias_prefix):
        j = (d["store_sales"]
             .join(d["store_returns"],
                   left_on=[col("ss_item_sk"), col("ss_ticket_number")],
                   right_on=[col("sr_item_sk"), col("sr_ticket_number")])
             .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(year))),
                   left_on="ss_sold_date_sk", right_on="d_date_sk")
             .join(d["item"].filter(In(col("i_color"),
                                       [lit(c) for c in
                                        ("purple", "burlywood", "indian",
                                         "spring", "floral", "medium",
                                         "red", "blue")])),
                   left_on="ss_item_sk", right_on="i_item_sk")
             .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk"))
        return (j.group_by("i_product_name", "i_item_sk", "s_store_name")
                .agg(Count().alias(f"{alias_prefix}_cnt"),
                     Sum(col("ss_wholesale_cost")).alias(f"{alias_prefix}_s1"),
                     Sum(col("ss_list_price")).alias(f"{alias_prefix}_s2"),
                     Sum(col("ss_coupon_amt")).alias(f"{alias_prefix}_s3")))
    y1 = year_sales(1999, "y1")
    y2 = year_sales(2000, "y2").select(
        col("i_item_sk").alias("i2"), col("s_store_name").alias("st2"),
        col("y2_cnt"), col("y2_s1"), col("y2_s2"), col("y2_s3"))
    j = y1.join(y2, left_on=[col("i_item_sk"), col("s_store_name")],
                right_on=[col("i2"), col("st2")])
    j = j.filter(GreaterThanOrEqual(col("y2_cnt"), col("y1_cnt")))
    return (j.select("i_product_name", "s_store_name", "y1_cnt", "y2_cnt",
                     "y1_s1", "y2_s1")
            .sort("i_product_name", "s_store_name", limit=100))


@q("q65")
def q65(d: D):
    """Items selling at <=10% of their store's average revenue."""
    dt = d["date_dim"].filter(_between(col("d_month_seq"), 12, 23))
    sa = (d["store_sales"]
          .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
          .group_by("ss_store_sk", "ss_item_sk")
          .agg(Sum(col("ss_sales_price")).alias("revenue")))
    sb = (sa.group_by("ss_store_sk")
          .agg(Average(col("revenue")).alias("ave"))
          .select(col("ss_store_sk").alias("st2"), col("ave")))
    j = (sa.join(sb, left_on=col("ss_store_sk"), right_on=col("st2"))
         .filter(LessThanOrEqual(col("revenue"),
                                 Multiply(lit(0.1), col("ave"))))
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk"))
    return (j.select("s_store_name", "i_item_desc", "revenue",
                     "i_current_price", "i_wholesale_cost", "i_brand")
            .sort("s_store_name", "i_item_desc", limit=100))


@q("q69")
def q69(d: D):
    """Demographics of store-active, web/catalog-inactive customers in
    selected states (EXISTS + NOT EXISTS)."""
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(2001)),
                                  _between(col("d_moy"), 4, 6)))
    ss_c = _distinct(d["store_sales"].join(
        dt, left_on="ss_sold_date_sk", right_on="d_date_sk"),
        "ss_customer_sk")
    ws_c = _distinct(d["web_sales"].join(
        dt, left_on="ws_sold_date_sk", right_on="d_date_sk"),
        "ws_bill_customer_sk")
    cs_c = _distinct(d["catalog_sales"].join(
        dt, left_on="cs_sold_date_sk", right_on="d_date_sk"),
        "cs_bill_customer_sk")
    c = (d["customer"]
         .join(d["customer_address"].filter(
             In(col("ca_state"), [lit(s) for s in ("KY", "GA", "NM")])),
             left_on="c_current_addr_sk", right_on="ca_address_sk")
         .join(ss_c, left_on=col("c_customer_sk"),
               right_on=col("ss_customer_sk"), how="left_semi")
         .join(ws_c, left_on=col("c_customer_sk"),
               right_on=col("ws_bill_customer_sk"), how="left_anti")
         .join(cs_c, left_on=col("c_customer_sk"),
               right_on=col("cs_bill_customer_sk"), how="left_anti")
         .join(d["customer_demographics"], left_on="c_current_cdemo_sk",
               right_on="cd_demo_sk"))
    return (c.group_by("cd_gender", "cd_marital_status",
                       "cd_education_status")
            .agg(Count().alias("cnt1"))
            .sort("cd_gender", "cd_marital_status", "cd_education_status",
                  limit=100))


@q("q73")
def q73(d: D):
    """q34 with 1-5 items per ticket."""
    dt = d["date_dim"].filter(And(
        Or(EqualTo(col("d_dom"), lit(1)), _between(col("d_dom"), 25, 28)),
        In(col("d_year"), [lit(y) for y in (1999, 2000, 2001)])))
    hd = d["household_demographics"].filter(
        In(col("hd_buy_potential"), [lit(">10000"), lit("Unknown")]))
    st = d["store"].filter(In(col("s_county"),
                              [lit(c) for c in ("Williamson County",
                                                "Ziebach County")]))
    j = (d["store_sales"]
         .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(st, left_on="ss_store_sk", right_on="s_store_sk")
         .join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk"))
    g = (j.group_by("ss_ticket_number", "ss_customer_sk")
         .agg(Count().alias("cnt"))
         .filter(_between(col("cnt"), 1, 5)))
    out = g.join(d["customer"], left_on="ss_customer_sk",
                 right_on="c_customer_sk")
    return (out.select("c_last_name", "c_first_name", "c_salutation",
                       "c_preferred_cust_flag", "ss_ticket_number", "cnt")
            .sort(desc("cnt"), asc("c_last_name"), limit=100))


@q("q78")
def q78(d: D):
    """Customer/item/year sales with NO returns, all channels compared."""
    def chan(sales, ret, item, date, cust, qty, price, s_ord, r_ord, r_item,
             pre):
        j = (d[sales]
             .join(d[ret], left_on=[col(s_ord), col(item)],
                   right_on=[col(r_ord), col(r_item)], how="left_anti")
             .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2000))),
                   left_on=date, right_on="d_date_sk"))
        return (j.group_by(cust, item)
                .agg(Sum(col(qty)).alias(f"{pre}_qty"),
                     Sum(col(price)).alias(f"{pre}_amt")))
    ss = chan("store_sales", "store_returns", "ss_item_sk",
              "ss_sold_date_sk", "ss_customer_sk", "ss_quantity",
              "ss_ext_sales_price", "ss_ticket_number", "sr_ticket_number",
              "sr_item_sk", "ss")
    ws = chan("web_sales", "web_returns", "ws_item_sk", "ws_sold_date_sk",
              "ws_bill_customer_sk", "ws_quantity", "ws_ext_sales_price",
              "ws_order_number", "wr_order_number", "wr_item_sk", "ws")
    cs = chan("catalog_sales", "catalog_returns", "cs_item_sk",
              "cs_sold_date_sk", "cs_bill_customer_sk", "cs_quantity",
              "cs_ext_sales_price", "cs_order_number", "cr_order_number",
              "cr_item_sk", "cs")
    j = (ss.join(ws.select(col("ws_bill_customer_sk").alias("wc"),
                           col("ws_item_sk").alias("wi"),
                           col("ws_qty"), col("ws_amt")),
                 left_on=[col("ss_customer_sk"), col("ss_item_sk")],
                 right_on=[col("wc"), col("wi")])
         .join(cs.select(col("cs_bill_customer_sk").alias("cc"),
                         col("cs_item_sk").alias("ci"),
                         col("cs_qty"), col("cs_amt")),
               left_on=[col("ss_customer_sk"), col("ss_item_sk")],
               right_on=[col("cc"), col("ci")]))
    j = j.filter(GreaterThan(col("ws_qty"), lit(0.0)))
    return (j.select("ss_customer_sk", "ss_item_sk", "ss_qty", "ss_amt",
                     "ws_qty", "cs_qty")
            .sort(asc("ss_customer_sk"), asc("ss_item_sk"), limit=100))


@q("q79")
def q79(d: D):
    """Per-trip amounts for big stores on weekdays."""
    hd = d["household_demographics"].filter(
        Or(EqualTo(col("hd_dep_count"), lit(6)),
           GreaterThan(col("hd_vehicle_count"), lit(2))))
    dt = d["date_dim"].filter(And(
        EqualTo(col("d_day_name"), lit("Monday")),
        In(col("d_year"), [lit(y) for y in (1999, 2000, 2001)])))
    st = d["store"].filter(GreaterThanOrEqual(col("s_number_employees"),
                                              lit(200)))
    j = (d["store_sales"]
         .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(st, left_on="ss_store_sk", right_on="s_store_sk")
         .join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk"))
    g = (j.group_by("ss_ticket_number", "ss_customer_sk", "s_city")
         .agg(Sum(col("ss_coupon_amt")).alias("amt"),
              Sum(col("ss_net_profit")).alias("profit")))
    out = g.join(d["customer"], left_on="ss_customer_sk",
                 right_on="c_customer_sk")
    return (out.select("c_last_name", "c_first_name", "s_city", "amt",
                       "profit", "ss_ticket_number")
            .sort("c_last_name", "c_first_name", "s_city", "profit",
                  "ss_ticket_number", limit=100))


@q("q81")
def q81(d: D):
    """q30 on catalog returns with state average."""
    cr = (d["catalog_returns"]
          .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2000))),
                left_on="cr_returned_date_sk", right_on="d_date_sk")
          .join(d["customer_address"], left_on="cr_returning_addr_sk",
                right_on="ca_address_sk"))
    ctr = (cr.group_by("cr_returning_customer_sk", "ca_state")
           .agg(Sum(col("cr_return_amt_inc_tax")).alias("ctr_total_return")))
    avg_by_state = (ctr.group_by("ca_state")
                    .agg(Average(col("ctr_total_return")).alias("avg_ret"))
                    .select(col("ca_state").alias("st2"), col("avg_ret")))
    j = (ctr.join(avg_by_state, left_on=col("ca_state"), right_on=col("st2"))
         .filter(GreaterThan(col("ctr_total_return"),
                             Multiply(col("avg_ret"), lit(1.2))))
         .join(d["customer"], left_on="cr_returning_customer_sk",
               right_on="c_customer_sk")
         .join(d["customer_address"].filter(EqualTo(col("ca_state"),
                                                    lit("GA")))
               .select(col("ca_address_sk").alias("home_addr")),
               left_on=col("c_current_addr_sk"), right_on=col("home_addr")))
    return (j.select("c_customer_id", "c_first_name", "c_last_name",
                     "ctr_total_return")
            .sort("c_customer_id", "ctr_total_return", limit=100))


@q("q82")
def q82(d: D):
    """q37 on store sales."""
    it = d["item"].filter(And(_between(col("i_current_price"), 30.0, 60.0),
                              In(col("i_manufact_id"),
                                 [lit(m) for m in range(400, 500)])))
    inv = (d["inventory"].filter(_between(col("inv_quantity_on_hand"),
                                          100, 500))
           .join(d["date_dim"].filter(_between(col("d_date_sk"), 700, 760)),
                 left_on="inv_date_sk", right_on="d_date_sk"))
    j = (d["store_sales"]
         .join(it, left_on="ss_item_sk", right_on="i_item_sk")
         .join(inv, left_on=col("ss_item_sk"), right_on=col("inv_item_sk"),
               how="left_semi"))
    return (_distinct(j, "i_item_id", "i_item_desc", "i_current_price")
            .sort("i_item_id", limit=100))


@q("q84")
def q84(d: D):
    """Customers in one city within an income band (denormalized lookup)."""
    ib = d["income_band"].filter(And(
        GreaterThanOrEqual(col("ib_lower_bound"), lit(30_000)),
        LessThanOrEqual(col("ib_upper_bound"), lit(80_000))))
    j = (d["customer"]
         .join(d["customer_address"].filter(EqualTo(col("ca_city"),
                                                    lit("Midway"))),
               left_on="c_current_addr_sk", right_on="ca_address_sk")
         .join(d["household_demographics"], left_on="c_current_hdemo_sk",
               right_on="hd_demo_sk")
         .join(ib, left_on=col("hd_income_band_sk"),
               right_on=col("ib_income_band_sk"))
         .join(d["store_returns"], left_on=col("c_current_cdemo_sk"),
               right_on=col("sr_cdemo_sk"), how="left_semi"))
    return (j.select("c_customer_id", "c_last_name", "c_first_name")
            .sort("c_customer_id", limit=100))


@q("q85")
def q85(d: D):
    """Web returns with reason stats under demographic/address conditions."""
    j = (d["web_returns"]
         .join(d["web_sales"],
               left_on=[col("wr_order_number"), col("wr_item_sk")],
               right_on=[col("ws_order_number"), col("ws_item_sk")])
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2000))),
               left_on="ws_sold_date_sk", right_on="d_date_sk")
         .join(d["reason"], left_on="wr_reason_sk", right_on="r_reason_sk")
         .join(d["web_page"], left_on="ws_web_page_sk",
               right_on="wp_web_page_sk"))
    return (j.group_by("r_reason_desc")
            .agg(Average(col("ws_quantity")).alias("avg_qty"),
                 Average(col("wr_refunded_cash")).alias("avg_cash"),
                 Average(col("wr_fee")).alias("avg_fee"))
            .sort("r_reason_desc", "avg_qty", limit=100))


@q("q92")
def q92(d: D):
    """Excess web discounts (q32 on web)."""
    dt = d["date_dim"].filter(_between(col("d_date_sk"), 730, 820))
    base = (d["web_sales"]
            .join(dt, left_on="ws_sold_date_sk", right_on="d_date_sk")
            .join(d["item"].filter(EqualTo(col("i_manufact_id"), lit(350))),
                  left_on="ws_item_sk", right_on="i_item_sk"))
    avg_disc = (base.group_by("i_item_sk")
                .agg(Average(col("ws_ext_discount_amt")).alias("avg_d"))
                .select(col("i_item_sk").alias("ad_item"), col("avg_d")))
    j = (base.join(avg_disc, left_on=col("i_item_sk"),
                   right_on=col("ad_item"))
         .filter(GreaterThan(col("ws_ext_discount_amt"),
                             Multiply(lit(1.3), col("avg_d")))))
    return j.agg(Sum(col("ws_ext_discount_amt")).alias("excess_discount"))


@q("q94")
def q94(d: D):
    """Web orders shipped from one state via multiple warehouses, no
    returns (q16 on web)."""
    ws = (d["web_sales"]
          .join(d["date_dim"].filter(_between(col("d_date_sk"), 730, 790)),
                left_on="ws_ship_date_sk", right_on="d_date_sk")
          .join(d["customer_address"].filter(EqualTo(col("ca_state"),
                                                     lit("GA"))),
                left_on="ws_ship_addr_sk", right_on="ca_address_sk")
          .join(d["web_site"].filter(EqualTo(col("web_company_name"),
                                             lit("pri"))),
                left_on="ws_web_site_sk", right_on="web_site_sk"))
    multi_wh = (d["web_sales"]
                .group_by("ws_order_number")
                .agg(CountDistinct(col("ws_warehouse_sk")).alias("nwh"))
                .filter(GreaterThan(col("nwh"), lit(1)))
                .select(col("ws_order_number").alias("mw_order")))
    returned = _distinct(d["web_returns"], "wr_order_number")
    ws = (ws.join(multi_wh, left_on=col("ws_order_number"),
                  right_on=col("mw_order"), how="left_semi")
          .join(returned, left_on=col("ws_order_number"),
                right_on=col("wr_order_number"), how="left_anti"))
    return ws.agg(CountDistinct(col("ws_order_number")).alias("order_count"),
                  Sum(col("ws_ext_ship_cost")).alias("total_shipping_cost"),
                  Sum(col("ws_net_profit")).alias("total_net_profit"))


@q("q99")
def q99(d: D):
    """Catalog shipping latency buckets (q62 on catalog)."""
    j = (d["catalog_sales"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="cs_ship_date_sk", right_on="d_date_sk")
         .join(d["warehouse"], left_on="cs_warehouse_sk",
               right_on="w_warehouse_sk")
         .join(d["ship_mode"], left_on="cs_ship_mode_sk",
               right_on="sm_ship_mode_sk")
         .join(d["call_center"], left_on="cs_call_center_sk",
               right_on="cc_call_center_sk"))
    lag = Subtract(col("cs_ship_date_sk"), col("cs_sold_date_sk"))
    def b(cond, name):
        return Sum(If(cond, lit(1), lit(0))).alias(name)
    return (j.group_by("w_warehouse_name", "sm_type", "cc_name")
            .agg(b(LessThanOrEqual(lag, lit(30)), "d30"),
                 b(And(GreaterThan(lag, lit(30)),
                       LessThanOrEqual(lag, lit(60))), "d60"),
                 b(And(GreaterThan(lag, lit(60)),
                       LessThanOrEqual(lag, lit(90))), "d90"),
                 b(And(GreaterThan(lag, lit(90)),
                       LessThanOrEqual(lag, lit(120))), "d120"),
                 b(GreaterThan(lag, lit(120)), "dmore"))
            .sort("w_warehouse_name", "sm_type", "cc_name", limit=100))


# the union slice, as the reference writes each query (q23 and q24 compute
# their threshold as Spark does: see ``spend_threshold``)


def spend_threshold(one_row, factor: str):
    """``factor * m`` for the one value ``m`` of a global aggregate, typed
    as Spark types it: the literal ``factor`` is a decimal, a decimal
    times a decimal is a decimal and a decimal times a double a double.
    0 when the aggregate gives no row or a null."""
    rows = one_row.collect()
    m = next(iter(rows[0].values())) if rows else None
    if m is None:
        return decimal.Decimal(0)
    if isinstance(m, float):
        return float(decimal.Decimal(factor)) * m
    return decimal.Decimal(factor) * m


@q("q5")
def q5(d: D):
    """Channel profit summary (base grouping; official uses ROLLUP)."""
    ss = (d["store_sales"].join(d["date_dim"], left_on="ss_sold_date_sk",
                                right_on="d_date_sk")
          .filter(EqualTo(col("d_year"), lit(2000)))
          .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
          .select(lit("store channel").alias("channel"),
                  col("s_store_id").alias("id"),
                  col("ss_ext_sales_price").alias("sales"),
                  col("ss_net_profit").alias("profit")))
    cs = (d["catalog_sales"].join(d["date_dim"], left_on="cs_sold_date_sk",
                                  right_on="d_date_sk")
          .filter(EqualTo(col("d_year"), lit(2000)))
          .join(d["catalog_page"], left_on="cs_catalog_page_sk",
                right_on="cp_catalog_page_sk")
          .select(lit("catalog channel").alias("channel"),
                  col("cp_catalog_page_id").alias("id"),
                  col("cs_ext_sales_price").alias("sales"),
                  col("cs_net_profit").alias("profit")))
    ws = (d["web_sales"].join(d["date_dim"], left_on="ws_sold_date_sk",
                              right_on="d_date_sk")
          .filter(EqualTo(col("d_year"), lit(2000)))
          .join(d["web_site"], left_on="ws_web_site_sk",
                right_on="web_site_sk")
          .select(lit("web channel").alias("channel"),
                  col("web_site_id").alias("id"),
                  col("ws_ext_sales_price").alias("sales"),
                  col("ws_net_profit").alias("profit")))
    u = ss.union(cs).union(ws)
    return (u.group_by("channel", "id")
            .agg(Sum(col("sales")).alias("sales"),
                 Sum(col("profit")).alias("profit"))
            .sort("channel", "id", limit=100))


@q("q6")
def q6(d: D):
    """States where >=10 customers bought items priced 1.2x their category
    average (scalar per-category average computed as a subplan join)."""
    cat_avg = (d["item"].group_by("i_category")
               .agg(Average(col("i_current_price")).alias("cat_avg")))
    it = d["item"].join(cat_avg, left_on="i_category",
                        right_on="i_category").filter(
        GreaterThan(col("i_current_price"),
                    Multiply(lit(1.2), col("cat_avg"))))
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(1999)),
                                  EqualTo(col("d_moy"), lit(1))))
    j = (d["store_sales"]
         .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(it, left_on="ss_item_sk", right_on="i_item_sk")
         .join(d["customer"], left_on="ss_customer_sk",
               right_on="c_customer_sk")
         .join(d["customer_address"], left_on="c_current_addr_sk",
               right_on="ca_address_sk"))
    g = (j.group_by("ca_state").agg(Count().alias("cnt"))
         .filter(GreaterThanOrEqual(col("cnt"), lit(10))))
    return g.sort(asc("cnt"), asc("ca_state"), limit=100)


@q("q8")
def q8(d: D):
    """Store sales for customers in selected zips (zip-list INTERSECT
    preferred-customer zips, as a semi join)."""
    zips = _distinct(d["customer_address"].filter(
        In(Substring(col("ca_zip"), 1, 2),
           [lit(z) for z in ("13", "24", "27", "35", "40", "45", "51",
                             "54", "60", "66", "72", "77", "81", "89",
                             "90")]))
        .select(Substring(col("ca_zip"), 1, 2).alias("zip_pref")),
        "zip_pref")
    pref = _distinct(
        d["customer"].filter(EqualTo(col("c_preferred_cust_flag"), lit("Y")))
        .join(d["customer_address"], left_on="c_current_addr_sk",
              right_on="ca_address_sk")
        .select(Substring(col("ca_zip"), 1, 2).alias("pref_zip")),
        "pref_zip")
    both = zips.join(pref, left_on="zip_pref", right_on="pref_zip",
                     how="left_semi")
    dt = d["date_dim"].filter(And(EqualTo(col("d_qoy"), lit(2)),
                                  EqualTo(col("d_year"), lit(1999))))
    st = d["store"].with_column("s_zip_pref", Substring(col("s_zip"), 1, 2))
    j = (d["store_sales"]
         .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(st, left_on="ss_store_sk", right_on="s_store_sk")
         # official q8: stores match on the 2-char zip prefix
         .join(both, left_on=col("s_zip_pref"),
               right_on=col("zip_pref"), how="left_semi"))
    return (j.group_by("s_store_name")
            .agg(Sum(col("ss_net_profit")).alias("net_profit"))
            .sort("s_store_name", limit=100))


@q("q10")
def q10(d: D):
    """Demographics of customers active in any channel in a county set
    (EXISTS -> semi joins)."""
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(2000)),
                                  _between(col("d_moy"), 1, 4)))
    ss_c = _distinct(d["store_sales"].join(
        dt, left_on="ss_sold_date_sk", right_on="d_date_sk"),
        "ss_customer_sk")
    ws_c = _distinct(d["web_sales"].join(
        dt, left_on="ws_sold_date_sk", right_on="d_date_sk"),
        "ws_bill_customer_sk")
    cs_c = _distinct(d["catalog_sales"].join(
        dt, left_on="cs_sold_date_sk", right_on="d_date_sk"),
        "cs_bill_customer_sk")
    c = (d["customer"]
         .join(d["customer_address"].filter(
             In(col("ca_county"), [lit(x) for x in
                                   ("Williamson County", "Ziebach County",
                                    "Walker County")])),
               left_on="c_current_addr_sk", right_on="ca_address_sk")
         .join(ss_c, left_on=col("c_customer_sk"),
               right_on=col("ss_customer_sk"), how="left_semi"))
    web_or_cat = ws_c.select(
        col("ws_bill_customer_sk").alias("cust")).union(
        cs_c.select(col("cs_bill_customer_sk").alias("cust")))
    c = c.join(web_or_cat, left_on=col("c_customer_sk"), right_on=col("cust"),
               how="left_semi")
    j = c.join(d["customer_demographics"], left_on="c_current_cdemo_sk",
               right_on="cd_demo_sk")
    return (j.group_by("cd_gender", "cd_marital_status",
                       "cd_education_status")
            .agg(Count().alias("cnt1"))
            .sort("cd_gender", "cd_marital_status", "cd_education_status",
                  limit=100))


@q("q15")
def q15(d: D):
    """Catalog sales by customer zip for selected zips/states/big sales."""
    j = (d["catalog_sales"]
         .join(d["date_dim"].filter(And(EqualTo(col("d_qoy"), lit(1)),
                                        EqualTo(col("d_year"), lit(2000)))),
               left_on="cs_sold_date_sk", right_on="d_date_sk")
         .join(d["customer"], left_on="cs_bill_customer_sk",
               right_on="c_customer_sk")
         .join(d["customer_address"], left_on="c_current_addr_sk",
               right_on="ca_address_sk"))
    j = j.filter(Or(Or(
        In(Substring(col("ca_zip"), 1, 5),
           [lit(z) for z in ("85669", "86197", "88274", "83405", "86475")]),
        In(col("ca_state"), [lit(s) for s in ("CA", "WA", "GA")])),
        GreaterThan(col("cs_sales_price"), lit(500.0))))
    return (j.group_by("ca_zip")
            .agg(Sum(col("cs_sales_price")).alias("total"))
            .sort("ca_zip", limit=100))


@q("q18")
def q18(d: D):
    """Catalog averages by customer geography (base grouping; official
    uses ROLLUP)."""
    cd1 = d["customer_demographics"].filter(
        And(EqualTo(col("cd_gender"), lit("F")),
            EqualTo(col("cd_education_status"), lit("Unknown"))))
    j = (d["catalog_sales"]
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(1998))),
               left_on="cs_sold_date_sk", right_on="d_date_sk")
         .join(cd1, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
         .join(d["customer"].filter(In(col("c_birth_month"),
                                       [lit(m) for m in (1, 6, 8, 9)])),
               left_on="cs_bill_customer_sk", right_on="c_customer_sk")
         .join(d["customer_address"], left_on="c_current_addr_sk",
               right_on="ca_address_sk")
         .join(d["item"], left_on="cs_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_item_id", "ca_country", "ca_state", "ca_county")
            .agg(Average(col("cs_quantity")).alias("agg1"),
                 Average(col("cs_list_price")).alias("agg2"),
                 Average(col("cs_coupon_amt")).alias("agg3"),
                 Average(col("cs_sales_price")).alias("agg4"),
                 Average(col("cs_net_profit")).alias("agg5"),
                 Average(col("c_birth_year")).alias("agg6"),
                 Average(col("c_birth_month")).alias("agg7"))
            .sort("ca_country", "ca_state", "ca_county", "i_item_id",
                  limit=100))


@q("q19")
def q19(d: D):
    """Brand revenue where customer and store are in different zips."""
    j = (d["store_sales"]
         .join(d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(11)),
                                        EqualTo(col("d_year"), lit(1998)))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["item"].filter(EqualTo(col("i_manager_id"), lit(8))),
               left_on="ss_item_sk", right_on="i_item_sk")
         .join(d["customer"], left_on="ss_customer_sk",
               right_on="c_customer_sk")
         .join(d["customer_address"], left_on="c_current_addr_sk",
               right_on="ca_address_sk")
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk",
               condition=Not(EqualTo(Substring(col("ca_zip"), 1, 5),
                                     Substring(col("s_zip"), 1, 5)))))
    return (j.group_by("i_brand_id", "i_brand", "i_manufact_id", "i_manufact")
            .agg(Sum(col("ss_ext_sales_price")).alias("ext_price"))
            .sort(desc("ext_price"), asc("i_brand"), asc("i_brand_id"),
                  asc("i_manufact_id"), asc("i_manufact"), limit=100))


@q("q22")
def q22(d: D):
    """Average inventory by product hierarchy (base grouping; ROLLUP in
    the official)."""
    j = (d["inventory"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="inv_date_sk", right_on="d_date_sk")
         .join(d["item"], left_on="inv_item_sk", right_on="i_item_sk"))
    return (j.group_by("i_product_name", "i_brand", "i_class", "i_category")
            .agg(Average(col("inv_quantity_on_hand")).alias("qoh"))
            .sort(asc("qoh"), asc("i_product_name"), asc("i_brand"),
                  asc("i_class"), asc("i_category"), limit=100))


def _q23_spend(d: D):
    return (d["store_sales"]
            .group_by("ss_customer_sk")
            .agg(Sum(Multiply(col("ss_quantity"), col("ss_sales_price")))
                 .alias("csales")))


def q23_threshold(d: D):
    """Half of q23's largest customer spend (``spend_threshold``)."""
    return spend_threshold(
        _q23_spend(d).agg(Max(col("csales")).alias("m")), "0.5")


@q("q23")
def q23(d: D, thresh=None):
    """Catalog/web sales of frequently-bought store items by best
    customers (two-level semi-join funnel). A best customer spent more
    than ``thresh``: by default half the largest customer spend, typed as
    Spark types ``0.5 * max`` (``spend_threshold``; the spend is a double
    here, since ss_quantity is)."""
    dt4 = d["date_dim"].filter(In(col("d_year"),
                                  [lit(y) for y in (1999, 2000)]))
    freq = (d["store_sales"]
            .join(dt4, left_on="ss_sold_date_sk", right_on="d_date_sk")
            .group_by("ss_item_sk")
            .agg(Count().alias("cnt"))
            .filter(GreaterThan(col("cnt"), lit(4)))
            .select(col("ss_item_sk").alias("freq_item")))
    spend = _q23_spend(d)
    if thresh is None:
        thresh = q23_threshold(d)
    best = (spend.filter(GreaterThan(col("csales"), lit(thresh)))
            .select(col("ss_customer_sk").alias("best_cust")))
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(2000)),
                                  EqualTo(col("d_moy"), lit(2))))
    cs = (d["catalog_sales"]
          .join(dt, left_on="cs_sold_date_sk", right_on="d_date_sk")
          .join(freq, left_on=col("cs_item_sk"), right_on=col("freq_item"),
                how="left_semi")
          .join(best, left_on=col("cs_bill_customer_sk"),
                right_on=col("best_cust"), how="left_semi")
          .select(Multiply(col("cs_quantity"),
                           col("cs_list_price")).alias("sales")))
    ws = (d["web_sales"]
          .join(dt, left_on="ws_sold_date_sk", right_on="d_date_sk")
          .join(freq, left_on=col("ws_item_sk"), right_on=col("freq_item"),
                how="left_semi")
          .join(best, left_on=col("ws_bill_customer_sk"),
                right_on=col("best_cust"), how="left_semi")
          .select(Multiply(col("ws_quantity"),
                           col("ws_list_price")).alias("sales")))
    return cs.union(ws).agg(Sum(col("sales")).alias("sum_sales"))


def _q24_paid(d: D):
    base = (d["store_sales"]
            .join(d["store_returns"],
                  left_on=[col("ss_ticket_number"), col("ss_item_sk")],
                  right_on=[col("sr_ticket_number"), col("sr_item_sk")])
            .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
            .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk")
            .join(d["customer"], left_on="ss_customer_sk",
                  right_on="c_customer_sk")
            .join(d["customer_address"],
                  left_on=[col("c_current_addr_sk")],
                  right_on=[col("ca_address_sk")],
                  condition=Not(EqualTo(col("c_birth_country"),
                                        col("ca_country")))))
    return (base.group_by("c_last_name", "c_first_name", "s_store_name",
                          "i_color")
            .agg(Sum(col("ss_net_paid")).alias("netpaid")))


def q24_threshold(d: D):
    """0.05 times q24's average paid (``spend_threshold``)."""
    return spend_threshold(
        _q24_paid(d).agg(Average(col("netpaid")).alias("m")), "0.05")


@q("q24")
def q24(d: D, thresh=None):
    """Customers whose color-item store purchases (matched to returns)
    exceed the average (paid > ``thresh``, by default 0.05 * avg paid,
    a decimal, as Spark types it: ``spend_threshold``)."""
    paid = _q24_paid(d)
    if thresh is None:
        thresh = q24_threshold(d)
    out = (paid.filter(EqualTo(col("i_color"), lit("red")))
           .filter(GreaterThan(col("netpaid"), lit(thresh))))
    return out.sort("c_last_name", "c_first_name", "s_store_name", limit=100)


@q("q33")
def q33(d: D):
    """Manufacturer revenue for Books items across the three channels in
    one month/timezone."""
    books = _distinct(d["item"].filter(EqualTo(col("i_category"),
                                               lit("Books"))),
                      "i_manufact_id")
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(1998)),
                                  EqualTo(col("d_moy"), lit(3))))
    ca = d["customer_address"].filter(EqualTo(col("ca_gmt_offset"),
                                              lit(-5.0)))
    def chan(fact, datecol, addrcol, itemcol, price):
        return (d[fact]
                .join(dt, left_on=datecol, right_on="d_date_sk")
                .join(ca, left_on=addrcol, right_on="ca_address_sk")
                .join(d["item"], left_on=itemcol, right_on="i_item_sk")
                .join(books, left_on="i_manufact_id",
                      right_on="i_manufact_id", how="left_semi")
                .select(col("i_manufact_id").alias("mid"),
                        col(price).alias("price")))
    u = (chan("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_item_sk",
              "ss_ext_sales_price")
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_bill_addr_sk",
                     "cs_item_sk", "cs_ext_sales_price"))
         .union(chan("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
                     "ws_item_sk", "ws_ext_sales_price")))
    return (u.group_by("mid").agg(Sum(col("price")).alias("total_sales"))
            .sort(desc("total_sales"), asc("mid"), limit=100))


@q("q35")
def q35(d: D):
    """q10 shape with more demographics output."""
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(2000)),
                                  LessThan(col("d_qoy"), lit(4))))
    ss_c = _distinct(d["store_sales"].join(
        dt, left_on="ss_sold_date_sk", right_on="d_date_sk"),
        "ss_customer_sk")
    ws_c = _distinct(d["web_sales"].join(
        dt, left_on="ws_sold_date_sk", right_on="d_date_sk"),
        "ws_bill_customer_sk")
    cs_c = _distinct(d["catalog_sales"].join(
        dt, left_on="cs_sold_date_sk", right_on="d_date_sk"),
        "cs_bill_customer_sk")
    c = (d["customer"]
         .join(d["customer_address"], left_on="c_current_addr_sk",
               right_on="ca_address_sk")
         .join(ss_c, left_on=col("c_customer_sk"),
               right_on=col("ss_customer_sk"), how="left_semi"))
    web_or_cat = ws_c.select(
        col("ws_bill_customer_sk").alias("cust")).union(
        cs_c.select(col("cs_bill_customer_sk").alias("cust")))
    c = c.join(web_or_cat, left_on=col("c_customer_sk"), right_on=col("cust"),
               how="left_semi")
    j = c.join(d["customer_demographics"], left_on="c_current_cdemo_sk",
               right_on="cd_demo_sk")
    return (j.group_by("ca_state", "cd_gender", "cd_marital_status")
            .agg(Count().alias("cnt1"),
                 Min(col("cd_dep_count")).alias("mn"),
                 Max(col("cd_dep_count")).alias("mx"),
                 Average(col("cd_dep_count")).alias("av"))
            .sort("ca_state", "cd_gender", "cd_marital_status", limit=100))


@q("q45")
def q45(d: D):
    """Web sales by customer zip/city for selected zips or items."""
    items = _distinct(d["item"].filter(In(col("i_item_sk"),
                                          [lit(i) for i in
                                           (2, 3, 5, 7, 11, 13, 17, 19, 23,
                                            29)])),
                      "i_item_id")
    j = (d["web_sales"]
         .join(d["date_dim"].filter(And(EqualTo(col("d_qoy"), lit(2)),
                                        EqualTo(col("d_year"), lit(2001)))),
               left_on="ws_sold_date_sk", right_on="d_date_sk")
         .join(d["customer"], left_on="ws_bill_customer_sk",
               right_on="c_customer_sk")
         .join(d["customer_address"], left_on="c_current_addr_sk",
               right_on="ca_address_sk")
         .join(d["item"], left_on="ws_item_sk", right_on="i_item_sk"))
    zips = [lit(z) for z in ("85669", "86197", "88274", "83405", "86475",
                             "85392", "85460", "80348", "81792")]
    j = j.filter(Or(In(Substring(col("ca_zip"), 1, 5), zips),
                    In(col("i_item_id"), [lit(x) for x in
                                          [f"ITEM{i:08d}" for i in
                                           (2, 3, 5, 7, 11, 13, 17, 19, 23,
                                            29)]])))
    return (j.group_by("ca_zip", "ca_city")
            .agg(Sum(col("ws_sales_price")).alias("total"))
            .sort("ca_zip", "ca_city", limit=100))


@q("q46")
def q46(d: D):
    """Per-trip customer amounts where bought city != home city."""
    hd = d["household_demographics"].filter(
        Or(EqualTo(col("hd_dep_count"), lit(4)),
           EqualTo(col("hd_vehicle_count"), lit(3))))
    dt = d["date_dim"].filter(And(
        In(col("d_dom"), [lit(x) for x in (1, 2, 25, 26, 27, 28)]),
        In(col("d_year"), [lit(y) for y in (1999, 2000, 2001)])))
    st = d["store"].filter(In(col("s_city"),
                              [lit(c) for c in ("Midway", "Fairview")]))
    trips = (d["store_sales"]
             .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
             .join(st, left_on="ss_store_sk", right_on="s_store_sk")
             .join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
             .join(d["customer_address"].select(
                 col("ca_address_sk").alias("bought_addr"),
                 col("ca_city").alias("bought_city")),
                 left_on=col("ss_addr_sk"), right_on=col("bought_addr")))
    g = (trips.group_by("ss_ticket_number", "ss_customer_sk", "bought_city")
         .agg(Sum(col("ss_coupon_amt")).alias("amt"),
              Sum(col("ss_net_profit")).alias("profit")))
    j = (g.join(d["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
         .join(d["customer_address"].select(
             col("ca_address_sk").alias("home_addr"),
             col("ca_city").alias("home_city")),
             left_on=col("c_current_addr_sk"), right_on=col("home_addr"),
             condition=Not(EqualTo(col("bought_city"), col("home_city")))))
    return (j.select("c_last_name", "c_first_name", "home_city",
                     "bought_city", "ss_ticket_number", "amt", "profit")
            .sort("c_last_name", "c_first_name", "home_city", "bought_city",
                  "ss_ticket_number", limit=100))


@q("q56")
def q56(d: D):
    """Item revenue for selected colors across channels (q33 by color)."""
    colors = _distinct(d["item"].filter(
        In(col("i_color"), [lit(c) for c in ("slate", "blanched", "burnished",
                                             "red", "blue", "green")])),
        "i_item_id")
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(2001)),
                                  EqualTo(col("d_moy"), lit(2))))
    ca = d["customer_address"].filter(EqualTo(col("ca_gmt_offset"),
                                              lit(-5.0)))
    def chan(fact, datecol, addrcol, itemcol, price):
        return (d[fact]
                .join(dt, left_on=datecol, right_on="d_date_sk")
                .join(ca, left_on=addrcol, right_on="ca_address_sk")
                .join(d["item"], left_on=itemcol, right_on="i_item_sk")
                .join(colors, left_on="i_item_id", right_on="i_item_id",
                      how="left_semi")
                .select(col("i_item_id").alias("iid"),
                        col(price).alias("price")))
    u = (chan("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_item_sk",
              "ss_ext_sales_price")
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_bill_addr_sk",
                     "cs_item_sk", "cs_ext_sales_price"))
         .union(chan("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
                     "ws_item_sk", "ws_ext_sales_price")))
    return (u.group_by("iid").agg(Sum(col("price")).alias("total_sales"))
            .sort("total_sales", "iid", limit=100))


@q("q60")
def q60(d: D):
    """q56 for one category (Music) in another month."""
    music = _distinct(d["item"].filter(EqualTo(col("i_category"),
                                               lit("Music"))),
                      "i_item_id")
    dt = d["date_dim"].filter(And(EqualTo(col("d_year"), lit(1998)),
                                  EqualTo(col("d_moy"), lit(9))))
    ca = d["customer_address"].filter(EqualTo(col("ca_gmt_offset"),
                                              lit(-5.0)))
    def chan(fact, datecol, addrcol, itemcol, price):
        return (d[fact]
                .join(dt, left_on=datecol, right_on="d_date_sk")
                .join(ca, left_on=addrcol, right_on="ca_address_sk")
                .join(d["item"], left_on=itemcol, right_on="i_item_sk")
                .join(music, left_on="i_item_id", right_on="i_item_id",
                      how="left_semi")
                .select(col("i_item_id").alias("iid"),
                        col(price).alias("price")))
    u = (chan("store_sales", "ss_sold_date_sk", "ss_addr_sk", "ss_item_sk",
              "ss_ext_sales_price")
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_bill_addr_sk",
                     "cs_item_sk", "cs_ext_sales_price"))
         .union(chan("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
                     "ws_item_sk", "ws_ext_sales_price")))
    return (u.group_by("iid").agg(Sum(col("price")).alias("total_sales"))
            .sort("iid", "total_sales", limit=100))


@q("q66")
def q66(d: D):
    """Warehouse monthly shipping by web+catalog (time-of-day split)."""
    td = d["time_dim"].filter(_between(col("t_time"), 30000, 60000))
    sm = d["ship_mode"].filter(In(col("sm_carrier"),
                                  [lit(c) for c in ("UPS", "FEDEX")]))
    def chan(fact, datecol, timecol, shipcol, whcol, price, qty, name):
        j = (d[fact]
             .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(1999))),
                   left_on=datecol, right_on="d_date_sk")
             .join(td, left_on=timecol, right_on="t_time_sk")
             .join(sm, left_on=shipcol, right_on="sm_ship_mode_sk")
             .join(d["warehouse"], left_on=whcol,
                   right_on="w_warehouse_sk"))
        return j.select(
            "w_warehouse_name", "w_warehouse_sq_ft", "w_city", "w_county",
            "w_state", col("d_moy"),
            Multiply(col(price), col(qty)).alias("sales"))
    u = chan("web_sales", "ws_sold_date_sk", "ws_sold_time_sk",
             "ws_ship_mode_sk", "ws_warehouse_sk", "ws_ext_sales_price",
             "ws_quantity", "web").union(
        chan("catalog_sales", "cs_sold_date_sk", "cs_sold_time_sk",
             "cs_ship_mode_sk", "cs_warehouse_sk", "cs_ext_sales_price",
             "cs_quantity", "catalog"))
    def m(i):
        return Sum(If(EqualTo(col("d_moy"), lit(i)), col("sales"),
                      lit(0.0))).alias(f"m{i}")
    return (u.group_by("w_warehouse_name", "w_warehouse_sq_ft", "w_city",
                       "w_county", "w_state")
            .agg(*[m(i) for i in range(1, 13)])
            .sort("w_warehouse_name", limit=100))


@q("q68")
def q68(d: D):
    """q46 shape with extended amounts."""
    hd = d["household_demographics"].filter(
        Or(EqualTo(col("hd_dep_count"), lit(4)),
           EqualTo(col("hd_vehicle_count"), lit(3))))
    dt = d["date_dim"].filter(And(
        In(col("d_dom"), [lit(x) for x in (1, 2)]),
        In(col("d_year"), [lit(y) for y in (1999, 2000, 2001)])))
    st = d["store"].filter(In(col("s_city"),
                              [lit(c) for c in ("Midway", "Fairview")]))
    trips = (d["store_sales"]
             .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
             .join(st, left_on="ss_store_sk", right_on="s_store_sk")
             .join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
             .join(d["customer_address"].select(
                 col("ca_address_sk").alias("bought_addr"),
                 col("ca_city").alias("bought_city")),
                 left_on=col("ss_addr_sk"), right_on=col("bought_addr")))
    g = (trips.group_by("ss_ticket_number", "ss_customer_sk", "bought_city")
         .agg(Sum(col("ss_ext_sales_price")).alias("extended_price"),
              Sum(col("ss_ext_list_price")).alias("list_price"),
              Sum(col("ss_ext_tax")).alias("extended_tax")))
    j = (g.join(d["customer"], left_on="ss_customer_sk",
                right_on="c_customer_sk")
         .join(d["customer_address"].select(
             col("ca_address_sk").alias("home_addr"),
             col("ca_city").alias("home_city")),
             left_on=col("c_current_addr_sk"), right_on=col("home_addr"),
             condition=Not(EqualTo(col("bought_city"), col("home_city")))))
    return (j.select("c_last_name", "c_first_name", "home_city",
                     "bought_city", "ss_ticket_number", "extended_price",
                     "extended_tax", "list_price")
            .sort("c_last_name", "ss_ticket_number", limit=100))


@q("q71")
def q71(d: D):
    """Brand revenue by hour (meal times) across channels."""
    it = d["item"].filter(EqualTo(col("i_manager_id"), lit(1)))
    dt = d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(11)),
                                  EqualTo(col("d_year"), lit(1999))))
    td = d["time_dim"].filter(In(col("t_meal_time"),
                                 [lit(m) for m in ("breakfast", "dinner")]))
    def chan(fact, datecol, timecol, itemcol, price):
        return (d[fact]
                .join(dt, left_on=datecol, right_on="d_date_sk")
                .join(it, left_on=itemcol, right_on="i_item_sk")
                .join(td, left_on=timecol, right_on="t_time_sk")
                .select("i_brand_id", "i_brand", "t_hour", "t_minute",
                        col(price).alias("ext_price")))
    u = (chan("web_sales", "ws_sold_date_sk", "ws_sold_time_sk",
              "ws_item_sk", "ws_ext_sales_price")
         .union(chan("catalog_sales", "cs_sold_date_sk", "cs_sold_time_sk",
                     "cs_item_sk", "cs_ext_sales_price"))
         .union(chan("store_sales", "ss_sold_date_sk", "ss_sold_time_sk",
                     "ss_item_sk", "ss_ext_sales_price")))
    return (u.group_by("i_brand_id", "i_brand", "t_hour", "t_minute")
            .agg(Sum(col("ext_price")).alias("ext_price"))
            .sort(desc("ext_price"), asc("i_brand_id"), asc("t_hour"),
                  limit=200))


@q("q72")
def q72(d: D):
    """Catalog orders where inventory was short in the sold week.

    Official q72 linkage: the inventory snapshot date is tied to the sold
    date through d_week_seq equality (d1.d_week_seq = d2.d_week_seq), so
    each sale only sees that week's snapshots; without it the inventory
    join is a semi-cartesian."""
    d1 = (d["date_dim"].filter(EqualTo(col("d_year"), lit(1999)))
          .select(col("d_date_sk").alias("sold_d"),
                  col("d_week_seq").alias("sold_week")))
    d2 = (d["date_dim"]
          .select(col("d_date_sk").alias("inv_d"),
                  col("d_week_seq").alias("inv_week")))
    inv = d["inventory"].join(d2, left_on="inv_date_sk", right_on="inv_d")
    j = (d["catalog_sales"]
         .join(d1, left_on="cs_sold_date_sk", right_on="sold_d")
         .join(inv,
               left_on=[col("cs_item_sk"), col("sold_week")],
               right_on=[col("inv_item_sk"), col("inv_week")],
               condition=LessThan(col("inv_quantity_on_hand"),
                                  col("cs_quantity")))
         .join(d["warehouse"], left_on=col("inv_warehouse_sk"),
               right_on=col("w_warehouse_sk"))
         .join(d["item"], left_on="cs_item_sk", right_on="i_item_sk")
         .join(d["household_demographics"].filter(
             EqualTo(col("hd_buy_potential"), lit(">10000"))),
             left_on="cs_bill_hdemo_sk", right_on="hd_demo_sk"))
    g = (j.group_by("i_item_desc", "w_warehouse_name", "sold_week")
         .agg(Count().alias("no_promo")))
    return g.sort(desc("no_promo"), asc("i_item_desc"),
                  asc("w_warehouse_name"), asc("sold_week"), limit=100)


@q("q76")
def q76(d: D):
    """Sales with null keys by channel (union of null-column slices)."""
    ss = (d["store_sales"].filter(IsNull(col("ss_promo_sk")))
          .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk")
          .join(d["date_dim"], left_on="ss_sold_date_sk",
                right_on="d_date_sk")
          .select(lit("store").alias("channel"),
                  lit("promo").alias("col_name"), col("d_year"),
                  col("d_qoy"), col("i_category"),
                  col("ss_ext_sales_price").alias("ext_sales_price")))
    ws = (d["web_sales"].filter(IsNull(col("ws_promo_sk")))
          .join(d["item"], left_on="ws_item_sk", right_on="i_item_sk")
          .join(d["date_dim"], left_on="ws_sold_date_sk",
                right_on="d_date_sk")
          .select(lit("web").alias("channel"),
                  lit("promo").alias("col_name"), col("d_year"),
                  col("d_qoy"), col("i_category"),
                  col("ws_ext_sales_price").alias("ext_sales_price")))
    cs = (d["catalog_sales"].filter(IsNull(col("cs_promo_sk")))
          .join(d["item"], left_on="cs_item_sk", right_on="i_item_sk")
          .join(d["date_dim"], left_on="cs_sold_date_sk",
                right_on="d_date_sk")
          .select(lit("catalog").alias("channel"),
                  lit("promo").alias("col_name"), col("d_year"),
                  col("d_qoy"), col("i_category"),
                  col("cs_ext_sales_price").alias("ext_sales_price")))
    u = ss.union(ws).union(cs)
    return (u.group_by("channel", "col_name", "d_year", "d_qoy",
                       "i_category")
            .agg(Count().alias("sales_cnt"),
                 Sum(col("ext_sales_price")).alias("sales_amt"))
            .sort("channel", "col_name", "d_year", "d_qoy", "i_category",
                  limit=100))


@q("q77")
def q77(d: D):
    """Channel profit and returns summary (base grouping)."""
    dt = d["date_dim"].filter(_between(col("d_date_sk"), 730, 790))
    ss = (d["store_sales"].join(dt, left_on="ss_sold_date_sk",
                                right_on="d_date_sk")
          .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
          .group_by("s_store_sk")
          .agg(Sum(col("ss_ext_sales_price")).alias("sales"),
               Sum(col("ss_net_profit")).alias("profit"))
          .select(lit("store").alias("channel"),
                  col("s_store_sk").alias("id"), col("sales"),
                  col("profit")))
    sr = (d["store_returns"].join(dt, left_on="sr_returned_date_sk",
                                  right_on="d_date_sk")
          .join(d["store"], left_on="sr_store_sk", right_on="s_store_sk")
          .group_by("s_store_sk")
          .agg(Sum(col("sr_return_amt")).alias("ret"),
               Sum(col("sr_net_loss")).alias("loss"))
          .select(lit("store").alias("channel"),
                  col("s_store_sk").alias("id"),
                  Multiply(col("ret"), lit(-1.0)).alias("sales"),
                  Multiply(col("loss"), lit(-1.0)).alias("profit")))
    cs = (d["catalog_sales"].join(dt, left_on="cs_sold_date_sk",
                                  right_on="d_date_sk")
          .group_by("cs_call_center_sk")
          .agg(Sum(col("cs_ext_sales_price")).alias("sales"),
               Sum(col("cs_net_profit")).alias("profit"))
          .select(lit("catalog").alias("channel"),
                  col("cs_call_center_sk").alias("id"), col("sales"),
                  col("profit")))
    ws = (d["web_sales"].join(dt, left_on="ws_sold_date_sk",
                              right_on="d_date_sk")
          .join(d["web_page"], left_on="ws_web_page_sk",
                right_on="wp_web_page_sk")
          .group_by("wp_web_page_sk")
          .agg(Sum(col("ws_ext_sales_price")).alias("sales"),
               Sum(col("ws_net_profit")).alias("profit"))
          .select(lit("web").alias("channel"),
                  col("wp_web_page_sk").alias("id"), col("sales"),
                  col("profit")))
    u = ss.union(sr).union(cs).union(ws)
    return (u.group_by("channel", "id")
            .agg(Sum(col("sales")).alias("sales"),
                 Sum(col("profit")).alias("profit"))
            .sort("channel", "id", limit=100))


@q("q80")
def q80(d: D):
    """Channel sales/returns/profit net summary (base grouping)."""
    dt = d["date_dim"].filter(_between(col("d_date_sk"), 730, 760))
    pr = d["promotion"].filter(EqualTo(col("p_channel_tv"), lit("N")))
    ss = (d["store_sales"]
          .join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
          .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
          .join(d["item"].filter(GreaterThan(col("i_current_price"),
                                             lit(50.0))),
                left_on="ss_item_sk", right_on="i_item_sk")
          .join(pr, left_on="ss_promo_sk", right_on="p_promo_sk")
          .join(d["store_returns"],
                left_on=[col("ss_ticket_number"), col("ss_item_sk")],
                right_on=[col("sr_ticket_number"), col("sr_item_sk")],
                how="left")
          .select(lit("store").alias("channel"),
                  col("s_store_id").alias("id"),
                  col("ss_ext_sales_price").alias("sales"),
                  Coalesce(col("sr_return_amt"), lit(0.0)).alias("returns_"),
                  Subtract(col("ss_net_profit"),
                           Coalesce(col("sr_net_loss"),
                                    lit(0.0))).alias("profit")))
    cs = (d["catalog_sales"]
          .join(dt, left_on="cs_sold_date_sk", right_on="d_date_sk")
          .join(d["catalog_page"], left_on="cs_catalog_page_sk",
                right_on="cp_catalog_page_sk")
          .join(d["item"].filter(GreaterThan(col("i_current_price"),
                                             lit(50.0))),
                left_on="cs_item_sk", right_on="i_item_sk")
          .join(pr, left_on="cs_promo_sk", right_on="p_promo_sk")
          .join(d["catalog_returns"],
                left_on=[col("cs_order_number"), col("cs_item_sk")],
                right_on=[col("cr_order_number"), col("cr_item_sk")],
                how="left")
          .select(lit("catalog").alias("channel"),
                  col("cp_catalog_page_id").alias("id"),
                  col("cs_ext_sales_price").alias("sales"),
                  Coalesce(col("cr_return_amount"),
                           lit(0.0)).alias("returns_"),
                  Subtract(col("cs_net_profit"),
                           Coalesce(col("cr_net_loss"),
                                    lit(0.0))).alias("profit")))
    ws = (d["web_sales"]
          .join(dt, left_on="ws_sold_date_sk", right_on="d_date_sk")
          .join(d["web_site"], left_on="ws_web_site_sk",
                right_on="web_site_sk")
          .join(d["item"].filter(GreaterThan(col("i_current_price"),
                                             lit(50.0))),
                left_on="ws_item_sk", right_on="i_item_sk")
          .join(pr, left_on="ws_promo_sk", right_on="p_promo_sk")
          .join(d["web_returns"],
                left_on=[col("ws_order_number"), col("ws_item_sk")],
                right_on=[col("wr_order_number"), col("wr_item_sk")],
                how="left")
          .select(lit("web").alias("channel"),
                  col("web_site_id").alias("id"),
                  col("ws_ext_sales_price").alias("sales"),
                  Coalesce(col("wr_return_amt"), lit(0.0)).alias("returns_"),
                  Subtract(col("ws_net_profit"),
                           Coalesce(col("wr_net_loss"),
                                    lit(0.0))).alias("profit")))
    u = ss.union(cs).union(ws)
    return (u.group_by("channel", "id")
            .agg(Sum(col("sales")).alias("sales"),
                 Sum(col("returns_")).alias("returns_"),
                 Sum(col("profit")).alias("profit"))
            .sort("channel", "id", limit=100))


@q("q91")
def q91(d: D):
    """Call-center returns by manager for one month/demographics."""
    cd = d["customer_demographics"].filter(Or(
        Or(And(EqualTo(col("cd_marital_status"), lit("M")),
               EqualTo(col("cd_education_status"), lit("Unknown"))),
           And(EqualTo(col("cd_marital_status"), lit("W")),
               EqualTo(col("cd_education_status"), lit("Advanced Degree")))),
        And(EqualTo(col("cd_marital_status"), lit("S")),
            EqualTo(col("cd_education_status"), lit("College")))))
    j = (d["catalog_returns"]
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(1998))),
               left_on="cr_returned_date_sk", right_on="d_date_sk")
         .join(d["call_center"], left_on="cr_call_center_sk",
               right_on="cc_call_center_sk")
         .join(d["customer"], left_on="cr_returning_customer_sk",
               right_on="c_customer_sk")
         .join(cd, left_on="c_current_cdemo_sk", right_on="cd_demo_sk")
         .join(d["household_demographics"].filter(
             Or(Like(col("hd_buy_potential"), "0-500%"),
                Like(col("hd_buy_potential"), "Unknown%"))),
             left_on="c_current_hdemo_sk", right_on="hd_demo_sk")
         .join(d["customer_address"].filter(In(col("ca_gmt_offset"),
                                               [lit(-7.0), lit(-6.0)])),
               left_on="c_current_addr_sk", right_on="ca_address_sk"))
    return (j.group_by("cc_name", "cc_manager", "cd_marital_status",
                       "cd_education_status")
            .agg(Sum(col("cr_net_loss")).alias("returns_loss"))
            .sort(desc("returns_loss"), limit=100))


@q("q95")
def q95(d: D):
    """q94 but orders must share another order's warehouse chain AND be
    returned (ws_wh self-join shape)."""
    ws_wh = (d["web_sales"].select(
        col("ws_order_number").alias("o1"),
        col("ws_warehouse_sk").alias("wh1"))
        .join(d["web_sales"].select(
            col("ws_order_number").alias("o2"),
            col("ws_warehouse_sk").alias("wh2")),
            left_on=col("o1"), right_on=col("o2"),
            condition=Not(EqualTo(col("wh1"), col("wh2")))))
    multi = _distinct(ws_wh, "o1")
    returned = _distinct(
        d["web_returns"].join(multi, left_on=col("wr_order_number"),
                              right_on=col("o1"), how="left_semi"),
        "wr_order_number")
    ws = (d["web_sales"]
          .join(d["date_dim"].filter(_between(col("d_date_sk"), 730, 790)),
                left_on="ws_ship_date_sk", right_on="d_date_sk")
          .join(d["customer_address"].filter(EqualTo(col("ca_state"),
                                                     lit("GA"))),
                left_on="ws_ship_addr_sk", right_on="ca_address_sk")
          .join(d["web_site"].filter(EqualTo(col("web_company_name"),
                                             lit("pri"))),
                left_on="ws_web_site_sk", right_on="web_site_sk")
          .join(multi, left_on=col("ws_order_number"), right_on=col("o1"),
                how="left_semi")
          .join(returned, left_on=col("ws_order_number"),
                right_on=col("wr_order_number"), how="left_semi"))
    return ws.agg(CountDistinct(col("ws_order_number")).alias("order_count"),
                  Sum(col("ws_ext_ship_cost")).alias("total_shipping_cost"),
                  Sum(col("ws_net_profit")).alias("total_net_profit"))


# ---------------------------------------------------------------------------
# the decimal slice: the queries that divide (Divide, Abs, DECIMAL128)
# ---------------------------------------------------------------------------


def _year_total(d: D, channel: str, year: int):
    """Per-customer yearly total of one channel (q4/q11/q74)."""
    if channel == "s":
        f, date_col, cust_col = (d["store_sales"], "ss_sold_date_sk",
                                 "ss_customer_sk")
        price = Subtract(col("ss_ext_list_price"),
                         col("ss_ext_discount_amt"))
    elif channel == "c":
        f, date_col, cust_col = (d["catalog_sales"], "cs_sold_date_sk",
                                 "cs_bill_customer_sk")
        price = Subtract(col("cs_ext_list_price"),
                         col("cs_ext_discount_amt"))
    else:
        f, date_col, cust_col = (d["web_sales"], "ws_sold_date_sk",
                                 "ws_bill_customer_sk")
        price = Subtract(col("ws_ext_list_price"),
                         col("ws_ext_discount_amt"))
    j = (f.join(d["date_dim"].filter(EqualTo(col("d_year"), lit(year))),
                left_on=date_col, right_on="d_date_sk")
         .join(d["customer"], left_on=cust_col, right_on="c_customer_sk"))
    return (j.group_by("c_customer_id", "c_first_name", "c_last_name")
            .agg(Sum(price).alias("year_total")))


def _totals(d: D, channel: str, year: int, key: str, total: str):
    return _year_total(d, channel, year).select(
        col("c_customer_id").alias(key), col("year_total").alias(total))


@q("q2")
def q2(d: D):
    """Web and catalog weekly sales by weekday, year over year (a channel
    union, a weekly pivot, a self-join on week_seq + 53)."""
    ws = d["web_sales"].select(
        col("ws_sold_date_sk").alias("sold_date_sk"),
        col("ws_ext_sales_price").alias("sales_price"))
    cs = d["catalog_sales"].select(
        col("cs_sold_date_sk").alias("sold_date_sk"),
        col("cs_ext_sales_price").alias("sales_price"))
    wscs = ws.union(cs).join(d["date_dim"], left_on="sold_date_sk",
                             right_on="d_date_sk")

    def day(name, alias):
        return Sum(If(EqualTo(col("d_day_name"), lit(name)),
                      col("sales_price"), lit(None, T.DOUBLE))).alias(alias)
    wk = (wscs.group_by("d_week_seq")
          .agg(day("Sunday", "sun"), day("Monday", "mon"),
               day("Friday", "fri")))

    def year(y, n):
        weeks = _distinct(d["date_dim"].filter(
            EqualTo(col("d_year"), lit(y))), "d_week_seq")
        return (wk.join(weeks, left_on="d_week_seq", right_on="d_week_seq")
                .select(col("d_week_seq").alias(f"wk{n}"),
                        col("sun").alias(f"sun{n}"),
                        col("mon").alias(f"mon{n}"),
                        col("fri").alias(f"fri{n}")))
    y1 = year(1999, 1)
    y2 = year(2000, 2).select(Subtract(col("wk2"), lit(53)).alias("wk2s"),
                              "sun2", "mon2", "fri2")
    j = y1.join(y2, left_on=col("wk1"), right_on=col("wk2s"))
    return (j.select("wk1", Divide(col("sun1"), col("sun2")).alias("r_sun"),
                     Divide(col("mon1"), col("mon2")).alias("r_mon"),
                     Divide(col("fri1"), col("fri2")).alias("r_fri"))
            .sort("wk1"))


@q("q4")
def q4(d: D):
    """Customers whose catalog and web spending grew faster than their
    store spending (three channels, two years, self-joins)."""
    j = (_totals(d, "s", 1999, "sid", "s_y1")
         .join(_totals(d, "s", 2000, "sid2", "s_y2"), left_on=col("sid"),
               right_on=col("sid2"))
         .join(_totals(d, "c", 1999, "cid", "c_y1"), left_on=col("sid"),
               right_on=col("cid"))
         .join(_totals(d, "c", 2000, "cid2", "c_y2"), left_on=col("sid"),
               right_on=col("cid2"))
         .join(_totals(d, "w", 1999, "wid", "w_y1"), left_on=col("sid"),
               right_on=col("wid"))
         .join(_totals(d, "w", 2000, "wid2", "w_y2"), left_on=col("sid"),
               right_on=col("wid2")))
    j = j.filter(And(
        And(GreaterThan(col("c_y1"), lit(0.0)),
            GreaterThan(col("s_y1"), lit(0.0))),
        And(GreaterThan(Divide(col("c_y2"), col("c_y1")),
                        Divide(col("s_y2"), col("s_y1"))),
            GreaterThan(Divide(col("w_y2"), Coalesce(col("w_y1"), lit(1.0))),
                        Divide(col("s_y2"), col("s_y1"))))))
    return j.select("sid").sort("sid", limit=100)


def _web_beats_store(d: D):
    """q11 and q74: customers whose web growth beat their store growth."""
    j = (_totals(d, "s", 1999, "sid", "s_y1")
         .join(_totals(d, "s", 2000, "sid2", "s_y2"), left_on=col("sid"),
               right_on=col("sid2"))
         .join(_totals(d, "w", 1999, "wid", "w_y1"), left_on=col("sid"),
               right_on=col("wid"))
         .join(_totals(d, "w", 2000, "wid2", "w_y2"), left_on=col("sid"),
               right_on=col("wid2")))
    j = j.filter(And(
        And(GreaterThan(col("w_y1"), lit(0.0)),
            GreaterThan(col("s_y1"), lit(0.0))),
        GreaterThan(Divide(col("w_y2"), col("w_y1")),
                    Divide(col("s_y2"), col("s_y1")))))
    return j.select("sid").sort("sid", limit=100)


@q("q11")
def q11(d: D):
    """Customers whose web growth beat their store growth (q4 with two
    channels)."""
    return _web_beats_store(d)


@q("q74")
def q74(d: D):
    """q11 again (the reference's q74 body is q11's)."""
    return _web_beats_store(d)


def _revenue_share(d: D, fact: str, date_col: str, item_col: str,
                   price: str, times_one: bool):
    """q12/q20/q98: each item's revenue and its share of its class's
    revenue (a window Sum over a decimal(17,2) sum: decimal(27,2))."""
    dt = d["date_dim"].filter(_between(col("d_date_sk"), 760, 790))
    it = d["item"].filter(In(col("i_category"),
                             [lit(x) for x in ("Sports", "Books", "Home")]))
    j = (d[fact].join(dt, left_on=date_col, right_on="d_date_sk")
         .join(it, left_on=item_col, right_on="i_item_sk"))
    g = (j.group_by("i_item_id", "i_item_desc", "i_category", "i_class",
                    "i_current_price")
         .agg(Sum(col(price)).alias("itemrevenue")))
    w = g.with_window(
        over(Sum(col("itemrevenue")),
             window_spec(partition_by=["i_class"],
                         frame=WindowFrame("rows", None, None)))
        .alias("class_rev"))
    ratio = Divide(Multiply(col("itemrevenue"), lit(100.0)),
                   col("class_rev"))
    if times_one:
        ratio = Multiply(ratio, lit(1.0))
    return (w.select("i_item_id", "i_item_desc", "i_category", "i_class",
                     "i_current_price", "itemrevenue",
                     ratio.alias("revenueratio"))
            .sort("i_category", "i_class", "i_item_id", "i_item_desc",
                  "revenueratio", limit=100))


@q("q12")
def q12(d: D):
    """Web revenue share within its class over a 30-day window."""
    return _revenue_share(d, "web_sales", "ws_sold_date_sk", "ws_item_sk",
                          "ws_ext_sales_price", True)


@q("q20")
def q20(d: D):
    """Catalog revenue share within its class (q12 on catalog)."""
    return _revenue_share(d, "catalog_sales", "cs_sold_date_sk",
                          "cs_item_sk", "cs_ext_sales_price", False)


@q("q98")
def q98(d: D):
    """Store revenue share within its class (q12 on store sales)."""
    return _revenue_share(d, "store_sales", "ss_sold_date_sk", "ss_item_sk",
                          "ss_ext_sales_price", False)


@q("q21")
def q21(d: D):
    """Inventory before and after a date by warehouse and item."""
    pivot = 900
    j = (d["inventory"]
         .join(d["date_dim"].filter(_between(col("d_date_sk"),
                                             pivot - 30, pivot + 30)),
               left_on="inv_date_sk", right_on="d_date_sk")
         .join(d["item"], left_on="inv_item_sk", right_on="i_item_sk")
         .join(d["warehouse"], left_on="inv_warehouse_sk",
               right_on="w_warehouse_sk"))
    g = (j.group_by("w_warehouse_name", "i_item_id")
         .agg(Sum(If(LessThan(col("d_date_sk"), lit(pivot)),
                     col("inv_quantity_on_hand"), lit(0)))
              .alias("inv_before"),
              Sum(If(GreaterThanOrEqual(col("d_date_sk"), lit(pivot)),
                     col("inv_quantity_on_hand"), lit(0)))
              .alias("inv_after")))
    g = g.filter(And(GreaterThan(col("inv_before"), lit(0)),
                     _between(Divide(Cast(col("inv_after"), T.DOUBLE),
                                     Cast(col("inv_before"), T.DOUBLE)),
                              2.0 / 3.0, 3.0 / 2.0)))
    return g.sort("w_warehouse_name", "i_item_id", limit=100)


@q("q31")
def q31(d: D):
    """County store-versus-web quarterly growth."""
    def chan(fact, datecol, addrcol, price, qoy, name):
        j = (d[fact]
             .join(d["date_dim"].filter(
                 And(EqualTo(col("d_year"), lit(2000)),
                     EqualTo(col("d_qoy"), lit(qoy)))),
                 left_on=datecol, right_on="d_date_sk")
             .join(d["customer_address"], left_on=addrcol,
                   right_on="ca_address_sk"))
        return (j.group_by("ca_county")
                .agg(Sum(col(price)).alias(name))
                .select(col("ca_county").alias(f"{name}_cty"), col(name)))
    ss1 = chan("store_sales", "ss_sold_date_sk", "ss_addr_sk",
               "ss_ext_sales_price", 1, "ss1")
    ss2 = chan("store_sales", "ss_sold_date_sk", "ss_addr_sk",
               "ss_ext_sales_price", 2, "ss2")
    ws1 = chan("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
               "ws_ext_sales_price", 1, "ws1")
    ws2 = chan("web_sales", "ws_sold_date_sk", "ws_bill_addr_sk",
               "ws_ext_sales_price", 2, "ws2")
    j = (ss1.join(ss2, left_on=col("ss1_cty"), right_on=col("ss2_cty"))
         .join(ws1, left_on=col("ss1_cty"), right_on=col("ws1_cty"))
         .join(ws2, left_on=col("ss1_cty"), right_on=col("ws2_cty")))
    j = j.filter(And(GreaterThan(col("ss1"), lit(0.0)),
                     GreaterThan(col("ws1"), lit(0.0))))
    j = j.filter(GreaterThan(Divide(col("ws2"), col("ws1")),
                             Divide(col("ss2"), col("ss1"))))
    return (j.select(col("ss1_cty").alias("county"),
                     Divide(col("ws2"), col("ws1")).alias("web_growth"),
                     Divide(col("ss2"), col("ss1")).alias("store_growth"))
            .sort("county", limit=100))


@q("q36")
def q36(d: D):
    """Gross margin ranked within its category (a window over an
    aggregate; the base grouping of the official ROLLUP)."""
    j = (d["store_sales"]
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(2001))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["item"], left_on="ss_item_sk", right_on="i_item_sk")
         .join(d["store"].filter(EqualTo(col("s_state"), lit("TN"))),
               left_on="ss_store_sk", right_on="s_store_sk"))
    g = (j.group_by("i_category", "i_class")
         .agg(Sum(col("ss_net_profit")).alias("profit"),
              Sum(col("ss_ext_sales_price")).alias("sales")))
    g = g.select("i_category", "i_class",
                 Divide(col("profit"), col("sales")).alias("gross_margin"))
    w = g.with_window(
        over(Rank(), window_spec(partition_by=["i_category"],
                                 order_by=[asc("gross_margin")]))
        .alias("rank_within_parent"))
    return w.sort("i_category", "rank_within_parent", limit=100)


def _vs_window_average(g, part, value: str, avg: str):
    """q53/q63: rows whose sales differ from their partition's average (a
    window Average over a decimal(17,2) sum: decimal(21,6)) by more than
    10% of it."""
    w = g.with_window(
        over(Average(col(value)),
             window_spec(partition_by=part,
                         frame=WindowFrame("rows", None, None)))
        .alias(avg))
    gap = Abs(Subtract(col(value), col(avg)))
    return w.filter(And(GreaterThan(col(avg), lit(0.0)),
                        GreaterThan(Divide(gap, col(avg)), lit(0.1))))


@q("q49")
def q49(d: D):
    """The worst return ratios of each channel (a ranked union)."""
    def chan(sales, returns, s_item, s_ord, s_qty, s_price, r_item, r_ord,
             r_qty, r_amt, name):
        j = (d[sales]
             .join(d[returns], left_on=[col(s_ord), col(s_item)],
                   right_on=[col(r_ord), col(r_item)])
             .filter(GreaterThan(col(s_price), lit(1.0))))
        g = (j.group_by(s_item)
             .agg(Sum(col(r_qty)).alias("ret_qty"),
                  Sum(col(s_qty)).alias("sold_qty"),
                  Sum(col(r_amt)).alias("ret_amt"),
                  Sum(Multiply(col(s_price), col(s_qty))).alias("sold_amt")))
        g = g.select(col(s_item).alias("item"),
                     Divide(col("ret_qty"), col("sold_qty")
                            ).alias("currency_ratio"))
        w = g.with_window(over(Rank(), window_spec(
            order_by=[asc("currency_ratio")])).alias("return_rank"))
        return (w.filter(LessThanOrEqual(col("return_rank"), lit(10)))
                .select(lit(name).alias("channel"), "item", "return_rank"))
    u = (chan("web_sales", "web_returns", "ws_item_sk", "ws_order_number",
              "ws_quantity", "ws_net_paid", "wr_item_sk", "wr_order_number",
              "wr_return_quantity", "wr_return_amt", "web")
         .union(chan("catalog_sales", "catalog_returns", "cs_item_sk",
                     "cs_order_number", "cs_quantity", "cs_net_paid",
                     "cr_item_sk", "cr_order_number", "cr_return_quantity",
                     "cr_return_amount", "catalog"))
         .union(chan("store_sales", "store_returns", "ss_item_sk",
                     "ss_ticket_number", "ss_quantity", "ss_net_paid",
                     "sr_item_sk", "sr_ticket_number", "sr_return_quantity",
                     "sr_return_amt", "store")))
    return u.sort("channel", "return_rank", "item", limit=100)


@q("q51")
def q51(d: D):
    """Web against store cumulative daily sales per item (running window
    sums over a decimal(17,2) daily sum: decimal(27,2); the reference's
    simplification to matched items)."""
    def daily(fact, item, date, price, i_alias, d_alias, name):
        return (d[fact]
                .join(d["date_dim"].filter(_between(col("d_month_seq"),
                                                    12, 23)),
                      left_on=date, right_on="d_date_sk")
                .group_by(item, "d_date_sk")
                .agg(Sum(col(price)).alias(name))
                .select(col(item).alias(i_alias),
                        col("d_date_sk").alias(d_alias), col(name)))
    ws = daily("web_sales", "ws_item_sk", "ws_sold_date_sk",
               "ws_sales_price", "w_item", "w_date", "web_day")
    ss = daily("store_sales", "ss_item_sk", "ss_sold_date_sk",
               "ss_sales_price", "s_item", "s_date", "store_day")
    j = ws.join(ss, left_on=[col("w_item"), col("w_date")],
                right_on=[col("s_item"), col("s_date")])
    spec = window_spec(partition_by=["w_item"], order_by=["w_date"],
                       frame=WindowFrame("rows", None, 0))
    w = j.with_window(
        over(Sum(col("web_day")), spec).alias("web_cumulative"),
        over(Sum(col("store_day")), spec).alias("store_cumulative"))
    out = w.filter(GreaterThan(col("web_cumulative"),
                               col("store_cumulative")))
    return (out.select("w_item", "w_date", "web_cumulative",
                       "store_cumulative")
            .sort("w_item", "w_date", limit=100))


@q("q53")
def q53(d: D):
    """Quarterly manufacturer sales against their average (a window)."""
    it = d["item"].filter(In(col("i_class"),
                             [lit(c) for c in ("accessories", "classical",
                                               "fiction", "history")]))
    j = (d["store_sales"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(it, left_on="ss_item_sk", right_on="i_item_sk")
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk"))
    g = (j.group_by("i_manufact_id", "d_qoy")
         .agg(Sum(col("ss_sales_price")).alias("sum_sales")))
    out = _vs_window_average(g, ["i_manufact_id"], "sum_sales",
                             "avg_quarterly_sales")
    return (out.select("i_manufact_id", "sum_sales", "avg_quarterly_sales")
            .sort(asc("avg_quarterly_sales"), asc("sum_sales"),
                  asc("i_manufact_id"), limit=100))


@q("q54")
def q54(d: D):
    """Customers who bought a category through catalog or web, bucketed by
    their later store revenue (the reference's simplification: a count
    by spend segment)."""
    cw = (d["catalog_sales"].select(
        col("cs_sold_date_sk").alias("sold_date"),
        col("cs_bill_customer_sk").alias("cust"),
        col("cs_item_sk").alias("item"))
        .union(d["web_sales"].select(
            col("ws_sold_date_sk").alias("sold_date"),
            col("ws_bill_customer_sk").alias("cust"),
            col("ws_item_sk").alias("item"))))
    my = (cw.join(d["item"].filter(And(EqualTo(col("i_category"),
                                               lit("Women")),
                                       EqualTo(col("i_class"),
                                               lit("dresses")))),
                  left_on=col("item"), right_on=col("i_item_sk"))
          .join(d["date_dim"].filter(And(EqualTo(col("d_moy"), lit(12)),
                                         EqualTo(col("d_year"), lit(1998)))),
                left_on=col("sold_date"), right_on=col("d_date_sk")))
    custs = _distinct(my, "cust")
    rev = (d["store_sales"]
           .join(custs, left_on=col("ss_customer_sk"), right_on=col("cust"),
                 how="left_semi")
           .group_by("ss_customer_sk")
           .agg(Sum(col("ss_ext_sales_price")).alias("revenue")))
    seg = rev.select(
        Cast(Divide(col("revenue"), lit(50.0)), T.LONG).alias("segment"))
    return (seg.group_by("segment").agg(Count().alias("num_customers"))
            .sort("segment", limit=100))


@q("q58")
def q58(d: D):
    """Items selling equally well in all three channels in one week."""
    wk = _distinct(d["date_dim"].filter(EqualTo(col("d_week_seq"), lit(60))),
                   "d_date_sk")

    def chan(fact, datecol, itemcol, price, name):
        return (d[fact]
                .join(wk, left_on=datecol, right_on="d_date_sk",
                      how="left_semi")
                .join(d["item"], left_on=itemcol, right_on="i_item_sk")
                .group_by("i_item_id")
                .agg(Sum(col(price)).alias(name))
                .select(col("i_item_id").alias(f"{name}_id"), col(name)))
    ss = chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
              "ss_ext_sales_price", "ss_rev")
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
              "cs_ext_sales_price", "cs_rev")
    ws = chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
              "ws_ext_sales_price", "ws_rev")
    j = (ss.join(cs, left_on=col("ss_rev_id"), right_on=col("cs_rev_id"))
         .join(ws, left_on=col("ss_rev_id"), right_on=col("ws_rev_id")))
    avg3 = Divide(Add(Add(col("ss_rev"), col("cs_rev")), col("ws_rev")),
                  lit(3.0))
    j = j.filter(And(
        And(_between(Divide(col("ss_rev"), avg3), 0.9, 1.1),
            _between(Divide(col("cs_rev"), avg3), 0.9, 1.1)),
        _between(Divide(col("ws_rev"), avg3), 0.9, 1.1)))
    return (j.select(col("ss_rev_id").alias("item_id"), "ss_rev", "cs_rev",
                     "ws_rev")
            .sort("item_id", "ss_rev", limit=100))


@q("q59")
def q59(d: D):
    """Week-over-week store sales ratios by weekday."""
    def day(name, alias):
        return Sum(If(EqualTo(col("d_day_name"), lit(name)),
                      col("ss_sales_price"), lit(None, T.DOUBLE))
                   ).alias(alias)
    wss = (d["store_sales"]
           .join(d["date_dim"], left_on="ss_sold_date_sk",
                 right_on="d_date_sk")
           .group_by("d_week_seq", "ss_store_sk")
           .agg(day("Sunday", "sun"), day("Wednesday", "wed"),
                day("Friday", "fri")))
    y1 = (wss.filter(_between(col("d_week_seq"), 10, 62))
          .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
          .select(col("s_store_name").alias("name1"),
                  col("s_store_id").alias("id1"),
                  col("d_week_seq").alias("wk1"),
                  col("sun").alias("sun1"), col("wed").alias("wed1"),
                  col("fri").alias("fri1")))
    y2 = (wss.filter(_between(col("d_week_seq"), 62, 114))
          .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk")
          .select(col("s_store_id").alias("id2"),
                  Subtract(col("d_week_seq"), lit(52)).alias("wk2"),
                  col("sun").alias("sun2"), col("wed").alias("wed2"),
                  col("fri").alias("fri2")))
    j = y1.join(y2, left_on=[col("id1"), col("wk1")],
                right_on=[col("id2"), col("wk2")])
    return (j.select("name1", "id1", "wk1",
                     Divide(col("sun1"), col("sun2")).alias("r_sun"),
                     Divide(col("wed1"), col("wed2")).alias("r_wed"),
                     Divide(col("fri1"), col("fri2")).alias("r_fri"))
            .sort("name1", "id1", "wk1", limit=100))


@q("q61")
def q61(d: D):
    """Promotional against total sales for one category, time zone and
    month (two global sums joined on a constant key)."""
    base = (d["store_sales"]
            .join(d["date_dim"].filter(And(EqualTo(col("d_year"), lit(1998)),
                                           EqualTo(col("d_moy"), lit(11)))),
                  left_on="ss_sold_date_sk", right_on="d_date_sk")
            .join(d["store"].filter(EqualTo(col("s_gmt_offset"), lit(-5.0))),
                  left_on="ss_store_sk", right_on="s_store_sk")
            .join(d["item"].filter(EqualTo(col("i_category"),
                                           lit("Jewelry"))),
                  left_on="ss_item_sk", right_on="i_item_sk")
            .join(d["customer"], left_on="ss_customer_sk",
                  right_on="c_customer_sk")
            .join(d["customer_address"].filter(
                EqualTo(col("ca_gmt_offset"), lit(-5.0))),
                left_on="c_current_addr_sk", right_on="ca_address_sk"))
    promo = (base.join(d["promotion"].filter(
        Or(Or(EqualTo(col("p_channel_dmail"), lit("Y")),
              EqualTo(col("p_channel_email"), lit("Y"))),
           EqualTo(col("p_channel_tv"), lit("Y")))),
        left_on="ss_promo_sk", right_on="p_promo_sk")
        .agg(Sum(col("ss_ext_sales_price")).alias("promotions")))
    total = base.agg(Sum(col("ss_ext_sales_price")).alias("total"))
    pj = promo.select("promotions", lit(1).alias("#k1"))
    tj = total.select("total", lit(1).alias("#k2"))
    j = pj.join(tj, left_on=col("#k1"), right_on=col("#k2"))
    return j.select("promotions", "total",
                    Multiply(Divide(col("promotions"), col("total")),
                             lit(100.0)).alias("ratio"))


@q("q63")
def q63(d: D):
    """q53 by manager."""
    it = d["item"].filter(In(col("i_class"),
                             [lit(c) for c in ("accessories", "dresses",
                                               "shirts", "pants")]))
    j = (d["store_sales"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(it, left_on="ss_item_sk", right_on="i_item_sk")
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk"))
    g = (j.group_by("i_manager_id", "d_moy")
         .agg(Sum(col("ss_sales_price")).alias("sum_sales")))
    out = _vs_window_average(g, ["i_manager_id"], "sum_sales",
                             "avg_monthly_sales")
    return (out.select("i_manager_id", "sum_sales", "avg_monthly_sales")
            .sort(asc("i_manager_id"), asc("avg_monthly_sales"),
                  asc("sum_sales"), limit=100))


@q("q75")
def q75(d: D):
    """Year-over-year channel sales net of returns by item attributes."""
    def chan(sales, ret, s_item, s_date, s_qty, s_price, r_item, r_ord_or_t,
             s_ord_or_t, r_qty, r_amt):
        j = (d[sales]
             .join(d[ret], left_on=[col(s_ord_or_t), col(s_item)],
                   right_on=[col(r_ord_or_t), col(r_item)], how="left")
             .join(d["date_dim"], left_on=s_date, right_on="d_date_sk")
             .join(d["item"].filter(EqualTo(col("i_category"),
                                            lit("Books"))),
                   left_on=s_item, right_on="i_item_sk"))
        return j.select(
            col("d_year"), col("i_brand_id"), col("i_class_id"),
            col("i_category_id"), col("i_manufact_id"),
            Subtract(col(s_qty), Coalesce(col(r_qty), lit(0.0)))
            .alias("qty"),
            Subtract(Multiply(col(s_price), lit(1.0)),
                     Coalesce(col(r_amt), lit(0.0))).alias("amt"))
    u = (chan("store_sales", "store_returns", "ss_item_sk",
              "ss_sold_date_sk", "ss_quantity", "ss_ext_sales_price",
              "sr_item_sk", "sr_ticket_number", "ss_ticket_number",
              "sr_return_quantity", "sr_return_amt")
         .union(chan("catalog_sales", "catalog_returns", "cs_item_sk",
                     "cs_sold_date_sk", "cs_quantity", "cs_ext_sales_price",
                     "cr_item_sk", "cr_order_number", "cs_order_number",
                     "cr_return_quantity", "cr_return_amount"))
         .union(chan("web_sales", "web_returns", "ws_item_sk",
                     "ws_sold_date_sk", "ws_quantity", "ws_ext_sales_price",
                     "wr_item_sk", "wr_order_number", "ws_order_number",
                     "wr_return_quantity", "wr_return_amt")))
    g = (u.group_by("d_year", "i_brand_id", "i_class_id", "i_category_id",
                    "i_manufact_id")
         .agg(Sum(col("qty")).alias("qty"), Sum(col("amt")).alias("amt")))

    def year(y, n):
        return g.filter(EqualTo(col("d_year"), lit(y))).select(
            col("i_brand_id").alias(f"b{n}"), col("i_class_id").alias(f"c{n}"),
            col("i_category_id").alias(f"g{n}"),
            col("i_manufact_id").alias(f"m{n}"),
            col("qty").alias(f"qty{n}"), col("amt").alias(f"amt{n}"))
    j = year(1999, 1).join(
        year(2000, 2), left_on=[col("b1"), col("c1"), col("g1"), col("m1")],
        right_on=[col("b2"), col("c2"), col("g2"), col("m2")])
    j = j.filter(LessThan(Divide(col("qty2"),
                                 Coalesce(col("qty1"), lit(1.0))), lit(0.9)))
    return (j.select("b1", "c1", "g1", "m1", "qty1", "qty2", "amt1", "amt2")
            .sort(asc("qty2"), asc("b1"), limit=100))


@q("q83")
def q83(d: D):
    """Return quantities across the three channels for shared items."""
    def chan(ret, item, date, qty, name):
        return (d[ret]
                .join(d["date_dim"].filter(_between(col("d_date_sk"),
                                                    730, 790)),
                      left_on=date, right_on="d_date_sk")
                .join(d["item"], left_on=item, right_on="i_item_sk")
                .group_by("i_item_id")
                .agg(Sum(col(qty)).alias(name))
                .select(col("i_item_id").alias(f"{name}_id"), col(name)))
    sr = chan("store_returns", "sr_item_sk", "sr_returned_date_sk",
              "sr_return_quantity", "sr_qty")
    cr = chan("catalog_returns", "cr_item_sk", "cr_returned_date_sk",
              "cr_return_quantity", "cr_qty")
    wr = chan("web_returns", "wr_item_sk", "wr_returned_date_sk",
              "wr_return_quantity", "wr_qty")
    j = (sr.join(cr, left_on=col("sr_qty_id"), right_on=col("cr_qty_id"))
         .join(wr, left_on=col("sr_qty_id"), right_on=col("wr_qty_id")))
    total = Add(Add(col("sr_qty"), col("cr_qty")), col("wr_qty"))
    return (j.select(col("sr_qty_id").alias("item_id"), "sr_qty", "cr_qty",
                     "wr_qty",
                     Divide(Multiply(col("sr_qty"), lit(100.0)), total)
                     .alias("sr_share"))
            .sort("item_id", "sr_qty", limit=100))


@q("q90")
def q90(d: D):
    """The ratio of morning to evening web sales."""
    wp = d["web_page"].filter(_between(col("wp_char_count"), 2500, 5200))
    hd = d["household_demographics"].filter(EqualTo(col("hd_dep_count"),
                                                    lit(6)))

    def half(hlo, hhi, name):
        td = d["time_dim"].filter(_between(col("t_hour"), hlo, hhi))
        j = (d["web_sales"]
             .join(td, left_on="ws_sold_time_sk", right_on="t_time_sk")
             .join(hd, left_on="ws_bill_hdemo_sk", right_on="hd_demo_sk")
             .join(wp, left_on="ws_web_page_sk", right_on="wp_web_page_sk"))
        return j.agg(Count().alias(name))
    am = half(8, 9, "amc").select("amc", lit(1).alias("#k1"))
    pm = half(19, 20, "pmc").select("pmc", lit(1).alias("#k2"))
    j = am.join(pm, left_on=col("#k1"), right_on=col("#k2"))
    return j.select(Divide(Cast(col("amc"), T.DOUBLE),
                           Cast(col("pmc"), T.DOUBLE)).alias("am_pm_ratio"))



# ---------------------------------------------------------------------------
# the window slice: the rest of the window surface (plain-string partition
# keys) and the last two rank queries
# ---------------------------------------------------------------------------


def _monthly_vs_average(d: D, fact: str, date_col: str, item_col: str,
                        price: str, dim: str, dim_key: str, fact_dim: str,
                        dim_name: str):
    """q47/q57: the 1999 monthly sales of each (category, brand, store or
    call center) against their yearly average (a window Average of
    decimal(17,2) sums into decimal(21,6), partitioned by plain strings),
    kept where they differ from it by more than 10%."""
    j = (d[fact]
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(1999))),
               left_on=date_col, right_on="d_date_sk")
         .join(d["item"], left_on=item_col, right_on="i_item_sk")
         .join(d[dim], left_on=fact_dim, right_on=dim_key))
    g = (j.group_by("i_category", "i_brand", dim_name, "d_year", "d_moy")
         .agg(Sum(col(price)).alias("sum_sales")))
    out = _vs_window_average(g, ["i_category", "i_brand", dim_name,
                                 "d_year"], "sum_sales", "avg_monthly_sales")
    return out.select("i_category", "i_brand", dim_name, "d_year", "d_moy",
                      "sum_sales", "avg_monthly_sales")


@q("q47")
def q47(d: D):
    """Monthly brand sales in each store against their yearly average
    (the reference's simplification of the lead/lag months to the average
    comparison)."""
    out = _monthly_vs_average(d, "store_sales", "ss_sold_date_sk",
                              "ss_item_sk", "ss_sales_price", "store",
                              "s_store_sk", "ss_store_sk", "s_store_name")
    return out.sort(asc("i_category"), asc("i_brand"), asc("s_store_name"),
                    asc("d_moy"), limit=100)


@q("q57")
def q57(d: D):
    """q47 on catalog sales and call centers."""
    out = _monthly_vs_average(d, "catalog_sales", "cs_sold_date_sk",
                              "cs_item_sk", "cs_sales_price", "call_center",
                              "cc_call_center_sk", "cs_call_center_sk",
                              "cc_name")
    return out.sort(desc("sum_sales"), asc("cc_name"), limit=100)


def _ranked_sums(d: D, j, parent: str, child: str, value: str):
    """q70/q86: the sum of ``value`` per (parent, child), ranked within
    the parent by the sum, descending (the base grouping of the official
    ROLLUP)."""
    g = (j.group_by(parent, child)
         .agg(Sum(col(value)).alias("total_sum")))
    w = g.with_window(
        over(Rank(), window_spec(partition_by=[parent],
                                 order_by=[desc("total_sum")]))
        .alias("rank_within_parent"))
    return w.sort(asc(parent), asc("rank_within_parent"), limit=100)


@q("q70")
def q70(d: D):
    """Store profit by state and county, ranked within the state."""
    j = (d["store_sales"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk"))
    return _ranked_sums(d, j, "s_state", "s_county", "ss_net_profit")


@q("q86")
def q86(d: D):
    """Web revenue by category and class, ranked within the category."""
    j = (d["web_sales"]
         .join(d["date_dim"].filter(_between(col("d_month_seq"), 12, 23)),
               left_on="ws_sold_date_sk", right_on="d_date_sk")
         .join(d["item"], left_on="ws_item_sk", right_on="i_item_sk"))
    return _ranked_sums(d, j, "i_category", "i_class", "ws_net_paid")


@q("q89")
def q89(d: D):
    """Monthly class sales in each store against their yearly average,
    kept where they differ from it by more than 10% of it."""
    it = d["item"].filter(Or(
        And(In(col("i_category"), [lit(c) for c in ("Books", "Electronics",
                                                    "Sports")]),
            In(col("i_class"), [lit(c) for c in ("fiction", "history",
                                                 "fishing")])),
        And(In(col("i_category"), [lit(c) for c in ("Men", "Jewelry",
                                                    "Women")]),
            In(col("i_class"), [lit(c) for c in ("shirts", "birdal",
                                                 "dresses")]))))
    j = (d["store_sales"]
         .join(d["date_dim"].filter(EqualTo(col("d_year"), lit(1999))),
               left_on="ss_sold_date_sk", right_on="d_date_sk")
         .join(it, left_on="ss_item_sk", right_on="i_item_sk")
         .join(d["store"], left_on="ss_store_sk", right_on="s_store_sk"))
    g = (j.group_by("i_category", "i_class", "i_brand", "s_store_name",
                    "s_company_name", "d_moy")
         .agg(Sum(col("ss_sales_price")).alias("sum_sales")))
    w = g.with_window(
        over(Average(col("sum_sales")),
             window_spec(partition_by=["i_category", "i_brand",
                                       "s_store_name", "s_company_name"],
                         frame=WindowFrame("rows", None, None)))
        .alias("avg_monthly_sales"))
    out = w.filter(GreaterThan(Abs(Subtract(col("sum_sales"),
                                            col("avg_monthly_sales"))),
                               Multiply(lit(0.1),
                                        col("avg_monthly_sales"))))
    return (out.select("i_category", "i_class", "i_brand", "s_store_name",
                       "d_moy", "sum_sales", "avg_monthly_sales")
            .sort(asc("s_store_name"), asc("i_category"), asc("i_class"),
                  asc("i_brand"), asc("d_moy"), limit=100))

# the threshold each of q23 and q24 computes by default
THRESHOLDS = {"q23": q23_threshold, "q24": q24_threshold}

# the TPC-DS half of bench.py's headline suite, in its order
HEADLINE = ("q3", "q7", "q42", "q52", "q96")
# the joins slice: outer/semi/anti joins, conditionals, COUNT(DISTINCT)
JOINS = ("q9", "q28", "q40", "q43", "q87", "q88", "q93", "q97")
# the breadth slice: the queries that need no feature beyond the joins
# slice's, over all 24 tables
BREADTH = ("q1", "q13", "q14", "q16", "q17", "q25", "q26", "q27", "q29",
           "q30", "q32", "q34", "q37", "q38", "q39", "q41", "q48", "q50",
           "q55", "q62", "q64", "q65", "q69", "q73", "q78", "q79", "q81",
           "q82", "q84", "q85", "q92", "q94", "q99")
# the union slice: Union, Substring, Like, string-column equality and
# residual join conditions (and q6, q18 and q22, which need nothing new)
UNION_SLICE = ("q5", "q6", "q8", "q10", "q15", "q18", "q19", "q22", "q23",
               "q24", "q33", "q35", "q45", "q46", "q56", "q60", "q66", "q68",
               "q71", "q72", "q76", "q77", "q80", "q91", "q95")
# the union slice's queries that join with a residual condition (q19's
# compares two Substrings)
CONDITION_JOINS = ("q19", "q24", "q46", "q68", "q72", "q95")
# the decimal slice: the queries that divide (Divide, Abs, DECIMAL128 on
# the device): q2, q4, q11, q21, q31, q54, q58, q59, q61, q74, q75, q83
# and q90 divide; q12, q20 and q98 divide by a window Sum over a
# decimal(17,2) sum (decimal(27,2)); q36, q49, q51, q53 and q63 add ranks
# over quotients, running window sums into DECIMAL128 and window averages
# (decimal(21,6)) under Abs. (q47, q57 and q89, which partition their
# windows by plain-string columns, came with the window slice.)
DECIMAL_SLICE = ("q2", "q4", "q11", "q12", "q20", "q21", "q31", "q54",
                 "q58", "q59", "q61", "q74", "q75", "q83", "q90", "q98",
                 "q36", "q49", "q51", "q53", "q63")
# the window slice: q47, q57 and q89 average decimal(17,2) sums over
# windows partitioned by plain strings (i_brand, s_store_name, cc_name,
# s_company_name); q70 and q86 rank sums. With it all 99 TPC-DS queries run
WINDOW_SLICE = ("q47", "q57", "q70", "q86", "q89")
# the breadth queries whose decimal(21,6) averages (DECIMAL128) ran on the
# CPU engine before the decimal slice, wholly on the device since
WIDE_AVERAGES = ("q1", "q30", "q65", "q81")

# the tables each query reads (tpcds_schema.tables_for(sf, names=...))
TABLES = {
    "q9": ("store_sales",),
    "q28": ("store_sales",),
    "q40": ("catalog_sales", "catalog_returns", "warehouse", "item",
            "date_dim"),
    "q43": ("store_sales", "date_dim", "store"),
    "q87": ("store_sales", "catalog_sales", "web_sales", "date_dim",
            "customer"),
    "q88": ("store_sales", "household_demographics", "store", "time_dim"),
    "q93": ("store_sales", "store_returns", "reason"),
    "q97": ("store_sales", "catalog_sales", "date_dim"),
    "q1": ("store_returns", "date_dim", "store", "customer"),
    "q13": ("store_sales", "store", "date_dim", "customer_demographics",
            "household_demographics", "customer_address"),
    "q14": ("store_sales", "catalog_sales", "web_sales", "item",
            "date_dim"),
    "q16": ("catalog_sales", "catalog_returns", "date_dim",
            "customer_address", "call_center"),
    "q17": ("store_sales", "store_returns", "catalog_sales", "date_dim",
            "store", "item"),
    "q25": ("store_sales", "store_returns", "catalog_sales", "date_dim",
            "store", "item"),
    "q26": ("catalog_sales", "customer_demographics", "date_dim",
            "promotion", "item"),
    "q27": ("store_sales", "customer_demographics", "date_dim", "store",
            "item"),
    "q29": ("store_sales", "store_returns", "catalog_sales", "date_dim",
            "store", "item"),
    "q30": ("web_returns", "date_dim", "customer_address", "customer"),
    "q32": ("catalog_sales", "date_dim", "item"),
    "q34": ("store_sales", "date_dim", "store", "household_demographics",
            "customer"),
    "q37": ("catalog_sales", "item", "inventory", "date_dim"),
    "q38": ("store_sales", "catalog_sales", "web_sales", "date_dim",
            "customer"),
    "q39": ("inventory", "date_dim", "item", "warehouse"),
    "q41": ("item",),
    "q48": ("store_sales", "store", "date_dim", "customer_demographics",
            "customer_address"),
    "q50": ("store_sales", "store_returns", "store", "date_dim"),
    "q55": ("store_sales", "date_dim", "item"),
    "q62": ("web_sales", "date_dim", "warehouse", "ship_mode", "web_site"),
    "q64": ("store_sales", "store_returns", "date_dim", "item", "store"),
    "q65": ("store_sales", "date_dim", "store", "item"),
    "q69": ("customer", "customer_address", "customer_demographics",
            "store_sales", "web_sales", "catalog_sales", "date_dim"),
    "q73": ("store_sales", "date_dim", "store", "household_demographics",
            "customer"),
    "q78": ("store_sales", "store_returns", "web_sales", "web_returns",
            "catalog_sales", "catalog_returns", "date_dim"),
    "q79": ("store_sales", "date_dim", "store", "household_demographics",
            "customer"),
    "q81": ("catalog_returns", "date_dim", "customer_address", "customer"),
    "q82": ("store_sales", "item", "inventory", "date_dim"),
    "q84": ("customer", "customer_address", "household_demographics",
            "income_band", "store_returns"),
    "q85": ("web_returns", "web_sales", "date_dim", "reason", "web_page"),
    "q92": ("web_sales", "date_dim", "item"),
    "q94": ("web_sales", "date_dim", "customer_address", "web_site",
            "web_returns"),
    "q99": ("catalog_sales", "date_dim", "warehouse", "ship_mode",
            "call_center"),
    # the union slice
    "q5": ("date_dim", "store", "store_sales", "catalog_sales", "web_sales",
           "catalog_page", "web_site"),
    "q6": ("date_dim", "item", "store_sales", "customer",
           "customer_address"),
    "q8": ("date_dim", "store", "store_sales", "customer",
           "customer_address"),
    "q10": ("date_dim", "customer_demographics", "store_sales",
            "catalog_sales", "web_sales", "customer", "customer_address"),
    "q15": ("date_dim", "catalog_sales", "customer", "customer_address"),
    "q18": ("date_dim", "item", "customer_demographics", "catalog_sales",
            "customer", "customer_address"),
    "q19": ("date_dim", "item", "store", "store_sales", "customer",
            "customer_address"),
    "q22": ("date_dim", "item", "inventory"),
    "q23": ("date_dim", "store_sales", "catalog_sales", "web_sales"),
    "q24": ("item", "store", "store_sales", "store_returns", "customer",
            "customer_address"),
    "q33": ("date_dim", "item", "store_sales", "catalog_sales", "web_sales",
            "customer_address"),
    "q35": ("date_dim", "customer_demographics", "store_sales",
            "catalog_sales", "web_sales", "customer", "customer_address"),
    "q45": ("date_dim", "item", "web_sales", "customer",
            "customer_address"),
    "q46": ("date_dim", "store", "household_demographics", "store_sales",
            "customer", "customer_address"),
    "q56": ("date_dim", "item", "store_sales", "catalog_sales", "web_sales",
            "customer_address"),
    "q60": ("date_dim", "item", "store_sales", "catalog_sales", "web_sales",
            "customer_address"),
    "q66": ("date_dim", "time_dim", "catalog_sales", "web_sales",
            "warehouse", "ship_mode"),
    "q68": ("date_dim", "store", "household_demographics", "store_sales",
            "customer", "customer_address"),
    "q71": ("date_dim", "time_dim", "item", "store_sales", "catalog_sales",
            "web_sales"),
    "q72": ("date_dim", "item", "household_demographics", "catalog_sales",
            "warehouse", "inventory"),
    "q76": ("date_dim", "item", "store_sales", "catalog_sales",
            "web_sales"),
    "q77": ("date_dim", "store", "store_sales", "store_returns",
            "catalog_sales", "web_sales", "web_page"),
    "q80": ("date_dim", "item", "store", "promotion", "store_sales",
            "store_returns", "catalog_sales", "catalog_returns", "web_sales",
            "web_returns", "catalog_page", "web_site"),
    "q91": ("date_dim", "customer_demographics", "household_demographics",
            "catalog_returns", "customer", "customer_address",
            "call_center"),
    "q95": ("date_dim", "web_sales", "customer_address", "web_returns",
            "web_site"),
    # the decimal slice
    "q2": ("web_sales", "catalog_sales", "date_dim"),
    "q4": ("store_sales", "catalog_sales", "web_sales", "date_dim",
           "customer"),
    "q11": ("store_sales", "web_sales", "date_dim", "customer"),
    "q12": ("web_sales", "date_dim", "item"),
    "q20": ("catalog_sales", "date_dim", "item"),
    "q21": ("inventory", "date_dim", "item", "warehouse"),
    "q31": ("store_sales", "web_sales", "date_dim", "customer_address"),
    "q36": ("store_sales", "date_dim", "item", "store"),
    "q49": ("web_sales", "web_returns", "catalog_sales", "catalog_returns",
            "store_sales", "store_returns"),
    "q51": ("web_sales", "store_sales", "date_dim"),
    "q53": ("store_sales", "date_dim", "item", "store"),
    "q54": ("catalog_sales", "web_sales", "item", "date_dim",
            "store_sales"),
    "q58": ("store_sales", "catalog_sales", "web_sales", "date_dim",
            "item"),
    "q59": ("store_sales", "date_dim", "store"),
    "q61": ("store_sales", "date_dim", "store", "item", "customer",
            "customer_address", "promotion"),
    "q63": ("store_sales", "date_dim", "item", "store"),
    "q74": ("store_sales", "web_sales", "date_dim", "customer"),
    "q75": ("store_sales", "store_returns", "catalog_sales",
            "catalog_returns", "web_sales", "web_returns", "date_dim",
            "item"),
    "q83": ("store_returns", "catalog_returns", "web_returns", "date_dim",
            "item"),
    "q90": ("web_sales", "time_dim", "household_demographics", "web_page"),
    "q98": ("store_sales", "date_dim", "item"),
    # the window slice
    "q47": ("store_sales", "date_dim", "item", "store"),
    "q57": ("catalog_sales", "date_dim", "item", "call_center"),
    "q70": ("store_sales", "date_dim", "store"),
    "q86": ("web_sales", "date_dim", "item"),
    "q89": ("store_sales", "date_dim", "item", "store"),
}


def streaming_windows() -> Dict[str, list]:
    """Three window groups over store_sales that stream (``exec/window.py``
    ``plan_stream_mode``), each [(alias, window expression)], ordered by
    the sale date and ticket: ``running`` (partitioned by store:
    row_number, rank, dense_rank and ROWS UNBOUNDED PRECEDING..CURRENT ROW
    Sum/Count/Min/Max of the quantity cast to INT; a running float Min/Max
    does not stream), ``bounded`` (partitioned by store: lead, lag and a
    ROWS 3 PRECEDING..3 FOLLOWING Sum) and ``running_global`` (no
    partition, so its one partition spans every batch and the running
    carry continues across each batch edge: row_number, rank, dense_rank,
    a running Sum and Max). A name's first word is its stream mode.
    ``chip_smoke.py`` phase 15 and ``profile_tpch --suite
    streaming_windows`` run them."""
    from spark_rapids_tpu_torch.exprs import window as W

    parts, order = ["ss_store_sk"], ["ss_sold_date_sk", "ss_ticket_number"]
    spec = W.window_spec(parts, order)
    run = W.window_spec(parts, order, W.WindowFrame("rows", None, 0))
    near = W.window_spec(parts, order, W.WindowFrame("rows", -3, 3))
    whole = W.window_spec([], order)
    whole_run = W.window_spec([], order, W.WindowFrame("rows", None, 0))
    qty = Cast(col("ss_quantity"), T.INT)
    running = (("row_number", W.RowNumber(), spec),
               ("rank", W.Rank(), spec), ("dense_rank", W.DenseRank(), spec),
               ("run_sum", Sum(qty), run), ("run_count", Count(qty), run),
               ("run_min", Min(qty), run), ("run_max", Max(qty), run))
    bounded = (("lead_qty", W.Lead(qty, 1), spec),
               ("lag_qty", W.Lag(qty, 2), spec),
               ("near_sum", Sum(qty), near))
    running_global = (("row_number", W.RowNumber(), whole),
                      ("rank", W.Rank(), whole),
                      ("dense_rank", W.DenseRank(), whole),
                      ("run_sum", Sum(qty), whole_run),
                      ("run_max", Max(qty), whole_run))
    return {name: [(a, W.over(f, sp).alias(a)) for a, f, sp in fs]
            for name, fs in (("running", running), ("bounded", bounded),
                             ("running_global", running_global))}


def tables_of(queries) -> Tuple[str, ...]:
    """The tables a set of queries reads (``TABLES``), each once."""
    return tuple(sorted({t for q_ in queries for t in TABLES[q_]}))

# ORDER BY columns whose order the result must keep exactly (q67's
# sumsales order is checked through rk, its rank within the category)
ORDER_KEYS = {"q3": ("d_year", "sum_agg", "i_brand_id"),
              "q7": ("i_item_id",),
              "q42": ("sum_agg", "d_year", "i_category_id", "i_category"),
              "q44": ("rnk",),
              "q52": ("d_year", "ext_price", "i_brand_id"),
              "q67": ("i_category", "rk"),
              "q96": ("cnt",),
              # q40 and q43 order by their group keys; q93 by a double sum
              # (checked by ORDER_BY below); the rest have no order
              "q9": (), "q28": (), "q40": ("w_state", "i_item_id"),
              "q43": ("s_store_name", "s_store_id"), "q87": (), "q88": (),
              "q93": (), "q97": (),
              # the breadth slice: each query's ORDER BY columns (q39 and
              # q85 without their trailing double, which follows a total
              # key); global aggregates have none
              "q1": ("c_customer_id",), "q13": (),
              "q14": ("i_brand_id", "i_class_id", "i_category_id"),
              "q16": (), "q17": ("i_item_id", "i_item_desc", "s_state"),
              "q25": ("i_item_id", "i_item_desc", "s_store_id",
                      "s_store_name"),
              "q26": ("i_item_id",), "q27": ("i_item_id", "s_state"),
              "q29": ("i_item_id", "i_item_desc", "s_store_id",
                      "s_store_name"),
              "q30": ("c_customer_id", "ctr_total_return"), "q32": (),
              "q34": ("c_last_name", "c_first_name", "c_salutation",
                      "c_preferred_cust_flag", "ss_ticket_number"),
              "q37": ("i_item_id",), "q38": (), "q39": ("w1", "i1"),
              "q41": ("i_product_name",), "q48": (),
              "q50": ("s_store_name", "s_store_id"),
              "q55": ("ext_price", "i_brand_id"),
              "q62": ("w_warehouse_name", "sm_type", "web_name"),
              "q64": ("i_product_name", "s_store_name"),
              "q65": ("s_store_name", "i_item_desc"),
              "q69": ("cd_gender", "cd_marital_status",
                      "cd_education_status"),
              "q73": ("cnt", "c_last_name"),
              "q78": ("ss_customer_sk", "ss_item_sk"),
              "q79": ("c_last_name", "c_first_name", "s_city", "profit",
                      "ss_ticket_number"),
              "q81": ("c_customer_id", "ctr_total_return"),
              "q82": ("i_item_id",), "q84": ("c_customer_id",),
              "q85": ("r_reason_desc",), "q92": (), "q94": (),
              "q99": ("w_warehouse_name", "sm_type", "cc_name"),
              # the union slice (q22's qoh is an average of integers:
              # one exact sum over one count on every engine)
              "q5": ("channel", "id"), "q6": ("cnt", "ca_state"),
              "q8": ("s_store_name",),
              "q10": ("cd_gender", "cd_marital_status",
                      "cd_education_status"),
              "q15": ("ca_zip",),
              "q18": ("ca_country", "ca_state", "ca_county", "i_item_id"),
              "q19": ("ext_price", "i_brand", "i_brand_id", "i_manufact_id",
                      "i_manufact"),
              "q22": ("qoh", "i_product_name", "i_brand", "i_class",
                      "i_category"),
              "q23": (), "q24": ("c_last_name", "c_first_name",
                                 "s_store_name"),
              "q33": ("total_sales", "mid"),
              "q35": ("ca_state", "cd_gender", "cd_marital_status"),
              "q45": ("ca_zip", "ca_city"),
              "q46": ("c_last_name", "c_first_name", "home_city",
                      "bought_city", "ss_ticket_number"),
              "q56": ("total_sales", "iid"), "q60": ("iid", "total_sales"),
              "q66": ("w_warehouse_name",),
              "q68": ("c_last_name", "ss_ticket_number"),
              "q71": ("ext_price", "i_brand_id", "t_hour"),
              "q72": ("no_promo", "i_item_desc", "w_warehouse_name",
                      "sold_week"),
              "q76": ("channel", "col_name", "d_year", "d_qoy",
                      "i_category"),
              "q77": ("channel", "id"), "q80": ("channel", "id"),
              # q91 orders by a double sum: checked by ORDER_BY below
              "q91": (), "q95": (),
              # the decimal slice (q12/q20/q98 without their trailing
              # double ratio, which follows the item's id and text; q75's
              # qty2 is a sum of whole-number doubles, exact)
              "q2": ("wk1",), "q4": ("sid",), "q11": ("sid",),
              "q74": ("sid",),
              "q12": ("i_category", "i_class", "i_item_id", "i_item_desc"),
              "q20": ("i_category", "i_class", "i_item_id", "i_item_desc"),
              "q98": ("i_category", "i_class", "i_item_id", "i_item_desc"),
              "q21": ("w_warehouse_name", "i_item_id"), "q31": ("county",),
              "q54": ("segment",), "q58": ("item_id", "ss_rev"),
              "q59": ("name1", "id1", "wk1"), "q61": (),
              "q75": ("qty2", "b1"), "q83": ("item_id", "sr_qty"),
              "q90": (), "q36": ("i_category", "rank_within_parent"),
              "q49": ("channel", "return_rank", "item"),
              "q51": ("w_item", "w_date"),
              "q53": ("avg_quarterly_sales", "sum_sales", "i_manufact_id"),
              "q63": ("i_manager_id", "avg_monthly_sales", "sum_sales"),
              # the window slice
              "q47": ("i_category", "i_brand", "s_store_name", "d_moy"),
              "q57": ("sum_sales", "cc_name"),
              "q70": ("s_state", "rank_within_parent"),
              "q86": ("i_category", "rank_within_parent"),
              "q89": ("s_store_name", "i_category", "i_class", "i_brand",
                      "d_moy")}

# queries whose ORDER BY keys do not order every row totally, with their
# LIMIT: where rows tie at the cut, two correct engines may keep different
# rows of the last tie group. q64 and q65 sort by the store's name, which
# several stores share; q73 by (cnt, c_last_name), shared by many tickets;
# q68 by (c_last_name, ss_ticket_number), which a ticket's rows of several
# bought cities share. q57 sorts by (sum_sales, cc_name), which call
# centers of one name may share; q86 by (category, rank), which tied sums
# share; q89 by keys without s_company_name, which its groups add.
# (q1, q30 and q81 tie only on rows whose every column is equal; q34 and
# q79 end in the ticket number, which fixes the row.) ``check_rows``
# compares the rows before the last tie group exactly and the group by
# its count.
TIED_AT_LIMIT = {"q64": 100, "q65": 100, "q73": 100, "q68": 100,
                 "q75": 100, "q36": 100, "q57": 100, "q86": 100,
                 "q89": 100}

# ORDER BY specs checked on a result's own values, where a key is a double
# sum whose last bits depend on the order of the additions
ORDER_BY = {"q93": (("sumsales", True), ("ss_customer_sk", True)),
            "q91": (("returns_loss", False),)}

# the queries whose result shows nothing (``informative`` false) on the
# tables of seed 0 at a scale factor: too few items or sales pass their
# filters. At SF 0.01 q41, q65, q8, q46 and q68 return no row and q32 and
# q92 one null sum; at SF 0.1 q92 still sums no row and q8 finds no store
# whose zip prefix a preferred customer shares (it does at SF 0.15; q46
# and q68 show values from SF 0.07). q58 finds no item whose three
# channels' week revenues lie within 10% of their mean below SF 0.2. q76
# (``EMPTY_ALWAYS``) is empty at every SF.
EMPTY_AT_SF = {0.01: ("q32", "q41", "q65", "q92", "q8", "q46", "q68",
                      "q76", "q58"),
               0.1: ("q92", "q8", "q76", "q58"), 1.0: ("q76",)}
# q76 selects the sales rows whose promotion key is null, and the
# generators (the reference's) write no null promotion key, so its result
# is empty at every SF; it is held on tables with seeded null promotion
# keys instead (``with_null_promotions``)
EMPTY_ALWAYS = ("q76",)


def with_null_promotions(tables: Dict[str, pa.Table], seed: int = 0,
                         share: float = 0.1) -> Dict[str, pa.Table]:
    """``tables`` with a seeded ``share`` of each sales table's promotion
    keys set to null (so q76 has rows to count)."""
    out = dict(tables)
    rng = np.random.default_rng(seed)
    for name, c in (("store_sales", "ss_promo_sk"),
                    ("catalog_sales", "cs_promo_sk"),
                    ("web_sales", "ws_promo_sk")):
        if name not in tables:
            continue
        t = tables[name]
        i = t.column_names.index(c)
        keys = t.column(c).combine_chunks()
        mask = rng.random(t.num_rows) < share
        out[name] = t.set_column(i, c, pa.array(
            keys.to_numpy(zero_copy_only=False), keys.type, mask=mask))
    return out


def informative(rows: List[dict]) -> bool:
    """Whether a result shows anything: some value that is neither null nor
    zero (a global aggregate over no row gives one row of nulls and zero
    counts, which two engines agree on whatever their joins did)."""
    def shows(v) -> bool:
        number = isinstance(v, (int, float, decimal.Decimal))
        return v is not None and not (number and v == 0)

    return any(shows(v) for r in rows for v in r.values())


def df_tables(tables: Dict[str, pa.Table], conf=None,
              batch_rows: int = 1 << 20, device=None, partitions: int = 1,
              shuffle_partitions: int = 4) -> Dict[str, object]:
    """One DataFrame per table, each on ``device`` (``cuda`` by default),
    read as ``partitions`` source splits and planned with
    ``shuffle_partitions`` reduce partitions."""
    from spark_rapids_tpu_torch.plan import from_arrow

    out = {}
    for k, v in tables.items():
        df = from_arrow(v, conf, batch_rows=batch_rows, device=device,
                        partitions=partitions)
        df.shuffle_partitions = shuffle_partitions
        out[k] = df
    return out


# ---------------------------------------------------------------------------
# pandas reference answers
# ---------------------------------------------------------------------------


def _unscaled(arr: pa.ChunkedArray) -> np.ndarray:
    """int64 unscaled values of a non-null decimal(p <= 18) column."""
    a = arr.combine_chunks()
    limbs = np.frombuffer(a.buffers()[1], dtype=np.int64,
                          count=2 * len(a), offset=a.offset * 16)
    return limbs[0::2].copy()


def _avg_half_up(total: np.ndarray, count: np.ndarray,
                 shift_digits: int) -> np.ndarray:
    """round_half_up(total * 10**shift / count), exact in Python ints."""
    out = []
    k = 10 ** shift_digits
    for t, c in zip(total.tolist(), count.tolist()):
        q, r = divmod(abs(t) * k, c)
        q += 2 * r >= c
        out.append(-q if t < 0 else q)
    return np.array(out, dtype=np.int64)


def _rows(df: pd.DataFrame) -> List[dict]:
    return [{k: (v.item() if isinstance(v, np.generic) else v)
             for k, v in r.items()} for r in df.to_dict("records")]


def pandas_q44(t: Dict[str, pa.Table]) -> List[dict]:
    ss = t["store_sales"]
    df = pd.DataFrame({"item": ss.column("ss_item_sk").to_numpy(),
                       "profit": _unscaled(ss.column("ss_net_profit"))})
    g = df.groupby("item").profit.agg(["sum", "count"]).reset_index()
    # decimal(7,2) averaged into decimal(11,6): 4 more digits, HALF_UP
    g["avg"] = _avg_half_up(g["sum"].to_numpy(), g["count"].to_numpy(), 4)
    best = g.sort_values(["avg", "item"], kind="stable").head(10)
    worst = g.sort_values(["avg", "item"], ascending=[False, True],
                          kind="stable").head(10)
    it = t["item"].to_pandas()
    name = dict(zip(it.i_item_sk, it.i_product_name))
    return [{"rnk": r + 1, "best_performing": name[b],
             "worst_performing": name[w]}
            for r, (b, w) in enumerate(zip(best.item.tolist(),
                                           worst.item.tolist()))]


def pandas_q67(t: Dict[str, pa.Table]) -> List[dict]:
    ss = t["store_sales"]
    sales = pd.DataFrame({
        "ss_sold_date_sk": ss.column("ss_sold_date_sk").to_numpy(),
        "ss_store_sk": ss.column("ss_store_sk").to_numpy(),
        "ss_item_sk": ss.column("ss_item_sk").to_numpy(),
        # decimal(7,2) times a double is a double (Spark casts the decimal)
        "amount": (_unscaled(ss.column("ss_sales_price")) / 100.0
                   * ss.column("ss_quantity").to_numpy())})
    dd = t["date_dim"].to_pandas()
    dd = dd[(dd.d_month_seq >= 12) & (dd.d_month_seq <= 23)]
    st = t["store"].to_pandas()[["s_store_sk", "s_store_id"]]
    it = t["item"].to_pandas()[["i_item_sk", "i_category", "i_class",
                                "i_brand", "i_product_name"]]
    j = (sales.merge(dd[["d_date_sk", "d_year", "d_qoy", "d_moy"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(st, left_on="ss_store_sk", right_on="s_store_sk")
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk"))
    keys = ["i_category", "i_class", "i_brand", "i_product_name", "d_year",
            "d_qoy", "d_moy", "s_store_id"]
    g = j.groupby(keys).amount.sum().reset_index(name="sumsales")
    g["rk"] = (g.groupby("i_category").sumsales
               .rank(method="min", ascending=False).astype(np.int32))
    g = g[g.rk <= 10].sort_values(["i_category", "sumsales", "rk"],
                                  ascending=[True, False, True],
                                  kind="stable").head(100)
    return _rows(g[["i_category", "i_class", "i_brand", "i_product_name",
                    "d_year", "sumsales", "rk"]])


def _decimals(unscaled, scale: int) -> List[decimal.Decimal]:
    return [decimal.Decimal(int(u)).scaleb(-scale) for u in unscaled]


def _sales(t: Dict[str, pa.Table], cols, money=()) -> pd.DataFrame:
    """store_sales columns as a frame; ``money`` columns as int64 unscaled
    decimal(7,2) values."""
    ss = t["store_sales"]
    out = {c: ss.column(c).to_numpy() for c in cols}
    out.update({c: _unscaled(ss.column(c)) for c in money})
    return pd.DataFrame(out)


def _brand_sales(t: Dict[str, pa.Table], dates: pd.DataFrame,
                 items: pd.DataFrame, keys, name: str) -> pd.DataFrame:
    """sum(ss_ext_sales_price) of the sales on ``dates`` of ``items``,
    grouped by ``keys`` (exact, in unscaled int64)."""
    sales = _sales(t, ["ss_sold_date_sk", "ss_item_sk"],
                   ["ss_ext_sales_price"])
    j = (sales.merge(dates[["d_date_sk", "d_year"]],
                     left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(items, left_on="ss_item_sk", right_on="i_item_sk"))
    return j.groupby(keys).ss_ext_sales_price.sum().reset_index(name=name)


def _with_decimals(g: pd.DataFrame, cols, scale: int) -> List[dict]:
    rows = _rows(g)
    for r in rows:
        for c in cols:
            r[c] = decimal.Decimal(int(r[c])).scaleb(-scale)
    return rows


def pandas_q3(t: Dict[str, pa.Table]) -> List[dict]:
    dd = t["date_dim"].to_pandas()
    it = t["item"].to_pandas()
    it = it[(it.i_manufact_id >= 100) & (it.i_manufact_id <= 150)]
    g = _brand_sales(t, dd[dd.d_moy == 11],
                     it[["i_item_sk", "i_brand", "i_brand_id"]],
                     ["d_year", "i_brand", "i_brand_id"], "sum_agg")
    g = g.sort_values(["d_year", "sum_agg", "i_brand_id"],
                      ascending=[True, False, True], kind="stable").head(100)
    return _with_decimals(g, ["sum_agg"], 2)


def pandas_q7(t: Dict[str, pa.Table]) -> List[dict]:
    money = ["ss_list_price", "ss_coupon_amt", "ss_sales_price"]
    sales = _sales(t, ["ss_cdemo_sk", "ss_sold_date_sk", "ss_promo_sk",
                       "ss_item_sk", "ss_quantity"], money)
    cd = t["customer_demographics"].to_pandas()
    cd = cd[(cd.cd_gender == "M") & (cd.cd_marital_status == "S")
            & (cd.cd_education_status == "College")]
    dd = t["date_dim"].to_pandas()
    dd = dd[dd.d_year == 2000]
    pr = t["promotion"].to_pandas()
    pr = pr[(pr.p_channel_email == "N") | (pr.p_channel_event == "N")]
    it = t["item"].to_pandas()[["i_item_sk", "i_item_id"]]
    j = (sales.merge(cd[["cd_demo_sk"]], left_on="ss_cdemo_sk",
                     right_on="cd_demo_sk")
         .merge(dd[["d_date_sk"]], left_on="ss_sold_date_sk",
                right_on="d_date_sk")
         .merge(pr[["p_promo_sk"]], left_on="ss_promo_sk",
                right_on="p_promo_sk")
         .merge(it, left_on="ss_item_sk", right_on="i_item_sk"))
    g = j.groupby("i_item_id").agg(
        agg1=("ss_quantity", "mean"), n=("ss_quantity", "size"),
        **{c: (c, "sum") for c in money}).reset_index()
    g = g.sort_values("i_item_id", kind="stable").head(100)
    out = []
    for r in _rows(g):
        row = {"i_item_id": r["i_item_id"], "agg1": r["agg1"]}
        for name, c in zip(("agg2", "agg3", "agg4"), money):
            # decimal(7,2) averaged into decimal(11,6): 4 more digits
            row[name] = _decimals(_avg_half_up(
                np.array([r[c]]), np.array([r["n"]]), 4), 6)[0]
        out.append(row)
    return out


def pandas_q42(t: Dict[str, pa.Table]) -> List[dict]:
    dd = t["date_dim"].to_pandas()
    it = t["item"].to_pandas()[["i_item_sk", "i_category_id", "i_category"]]
    g = _brand_sales(t, dd[(dd.d_moy == 11) & (dd.d_year == 2000)], it,
                     ["d_year", "i_category_id", "i_category"], "sum_agg")
    g = g.sort_values(["sum_agg", "d_year", "i_category_id", "i_category"],
                      ascending=[False, True, True, True],
                      kind="stable").head(100)
    return _with_decimals(g, ["sum_agg"], 2)


def pandas_q52(t: Dict[str, pa.Table]) -> List[dict]:
    dd = t["date_dim"].to_pandas()
    it = t["item"].to_pandas()[["i_item_sk", "i_brand", "i_brand_id"]]
    g = _brand_sales(t, dd[(dd.d_moy == 11) & (dd.d_year == 2000)], it,
                     ["d_year", "i_brand", "i_brand_id"], "ext_price")
    g = g.sort_values(["d_year", "ext_price", "i_brand_id"],
                      ascending=[True, False, True], kind="stable").head(100)
    return _with_decimals(g, ["ext_price"], 2)


def pandas_q96(t: Dict[str, pa.Table]) -> List[dict]:
    sales = _sales(t, ["ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk"])
    td = t["time_dim"].to_pandas()
    td = td[(td.t_hour == 20) & (td.t_minute >= 30)]
    hd = t["household_demographics"].to_pandas()
    hd = hd[hd.hd_dep_count == 7]
    st = t["store"].to_pandas()
    st = st[st.s_store_name == "ese"]
    j = (sales.merge(td[["t_time_sk"]], left_on="ss_sold_time_sk",
                     right_on="t_time_sk")
         .merge(hd[["hd_demo_sk"]], left_on="ss_hdemo_sk",
                right_on="hd_demo_sk")
         .merge(st[["s_store_sk"]], left_on="ss_store_sk",
                right_on="s_store_sk"))
    return [{"cnt": len(j)}]


def _frame(t: Dict[str, pa.Table], name: str, cols,
           money=()) -> pd.DataFrame:
    """Columns of one table as a frame; ``money`` columns as int64 unscaled
    decimal(7,2) values (null-free in the generated tables)."""
    tb = t[name]
    out = {c: tb.column(c).to_numpy(zero_copy_only=False) for c in cols}
    out.update({c: _unscaled(tb.column(c)) for c in money})
    return pd.DataFrame(out)


def _dec(v, scale: int):
    return None if v is None else decimal.Decimal(int(v)).scaleb(-scale)


def _avg_dec(vals: np.ndarray):
    """A decimal(7,2) average as Spark's decimal(11,6) (HALF_UP), or null
    over no values."""
    if len(vals) == 0:
        return None
    return _dec(_avg_half_up(np.array([int(vals.sum())]),
                             np.array([len(vals)]), 4)[0], 6)


def pandas_q9(t: Dict[str, pa.Table]) -> List[dict]:
    ss = _frame(t, "store_sales", ["ss_quantity"],
                ["ss_ext_discount_amt", "ss_net_paid"])
    row = {}
    for i, (lo, hi) in enumerate(Q9_BUCKETS):
        b = ss[(ss.ss_quantity >= lo) & (ss.ss_quantity <= hi)]
        row[f"avg_disc_b{i}"] = _avg_dec(b.ss_ext_discount_amt.to_numpy())
        row[f"avg_paid_b{i}"] = _avg_dec(b.ss_net_paid.to_numpy())
        row[f"cnt_b{i}"] = len(b)
    return [row]


def pandas_q28(t: Dict[str, pa.Table]) -> List[dict]:
    ss = _frame(t, "store_sales", ["ss_quantity"],
                ["ss_list_price", "ss_coupon_amt"])
    row = {}
    for i, (qlo, qhi, plo, phi) in enumerate(Q28_BUCKETS):
        # unscaled cents against the bounds in cents (exact: the bounds
        # are whole)
        lp, cp = ss.ss_list_price, ss.ss_coupon_amt
        b = ss[(ss.ss_quantity >= qlo) & (ss.ss_quantity <= qhi)
               & (((lp >= plo * 100) & (lp <= phi * 100))
                  | ((cp >= plo * 1000) & (cp <= phi * 1000)))]
        v = b.ss_list_price.to_numpy()
        row[f"b{i}_avg"] = _avg_dec(v)
        row[f"b{i}_cnt"] = len(v)
        row[f"b{i}_cntd"] = len(np.unique(v))
    return [row]


def pandas_q40(t: Dict[str, pa.Table]) -> List[dict]:
    pivot = 900
    cs = _frame(t, "catalog_sales", ["cs_order_number", "cs_item_sk",
                                     "cs_warehouse_sk", "cs_sold_date_sk"],
                ["cs_sales_price"])
    cr = _frame(t, "catalog_returns", ["cr_order_number", "cr_item_sk"],
                ["cr_refunded_cash"])
    wh = t["warehouse"].to_pandas()[["w_warehouse_sk", "w_state"]]
    it = _frame(t, "item", ["i_item_sk", "i_item_id"], ["i_current_price"])
    it = it[(it.i_current_price >= 99) & (it.i_current_price <= 5000)]
    dd = t["date_dim"].to_pandas()[["d_date_sk"]]
    dd = dd[(dd.d_date_sk >= pivot - 30) & (dd.d_date_sk <= pivot + 30)]
    j = (cs.merge(cr, how="left", left_on=["cs_order_number", "cs_item_sk"],
                  right_on=["cr_order_number", "cr_item_sk"])
         .merge(wh, left_on="cs_warehouse_sk", right_on="w_warehouse_sk")
         .merge(it[["i_item_sk", "i_item_id"]], left_on="cs_item_sk",
                right_on="i_item_sk")
         .merge(dd, left_on="cs_sold_date_sk", right_on="d_date_sk"))
    net = (j.cs_sales_price - j.cr_refunded_cash.fillna(0)).astype(np.int64)
    j = j.assign(before=np.where(j.d_date_sk < pivot, net, 0),
                 after=np.where(j.d_date_sk >= pivot, net, 0))
    g = (j.groupby(["w_state", "i_item_id"])[["before", "after"]].sum()
         .reset_index().sort_values(["w_state", "i_item_id"],
                                    kind="stable").head(100))
    return [{"w_state": r["w_state"], "i_item_id": r["i_item_id"],
             "sales_before": _dec(r["before"], 2),
             "sales_after": _dec(r["after"], 2)} for r in _rows(g)]


def pandas_q43(t: Dict[str, pa.Table]) -> List[dict]:
    ss = _sales(t, ["ss_sold_date_sk", "ss_store_sk"], ["ss_sales_price"])
    dd = t["date_dim"].to_pandas()
    dd = dd[dd.d_year == 2000][["d_date_sk", "d_day_name"]]
    st = t["store"].to_pandas()[["s_store_sk", "s_store_name", "s_store_id"]]
    j = (ss.merge(dd, left_on="ss_sold_date_sk", right_on="d_date_sk")
         .merge(st, left_on="ss_store_sk", right_on="s_store_sk"))
    out = []
    for (name, sid), g in sorted(j.groupby(["s_store_name", "s_store_id"])):
        row = {"s_store_name": name, "s_store_id": sid}
        for nm in Q43_DAYS:
            v = g.ss_sales_price[g.d_day_name == nm]
            row[f"{nm[:3].lower()}_sales"] = (_dec(int(v.sum()), 2)
                                              if len(v) else None)
        out.append(row)
    return out[:100]


def pandas_q87(t: Dict[str, pa.Table]) -> List[dict]:
    dd = t["date_dim"].to_pandas()
    dd = dd[(dd.d_month_seq >= 12) & (dd.d_month_seq <= 23)][["d_date_sk"]]
    cu = t["customer"].to_pandas()[["c_customer_sk", "c_last_name",
                                    "c_first_name"]]

    def chan(fact, datecol, custcol):
        f = _frame(t, fact, [datecol, custcol])
        j = (f.merge(dd, left_on=datecol, right_on="d_date_sk")
             .merge(cu, left_on=custcol, right_on="c_customer_sk"))
        return set(zip(j.c_last_name, j.c_first_name))
    ss = chan("store_sales", "ss_sold_date_sk", "ss_customer_sk")
    cs = chan("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk")
    ws = chan("web_sales", "ws_sold_date_sk", "ws_bill_customer_sk")
    return [{"num_customers": len(ss - cs - ws)}]


def pandas_q88(t: Dict[str, pa.Table]) -> List[dict]:
    ss = _sales(t, ["ss_hdemo_sk", "ss_store_sk", "ss_sold_time_sk"])
    hd = t["household_demographics"].to_pandas()
    dep, veh = hd.hd_dep_count, hd.hd_vehicle_count
    hd = hd[((dep == 4) & (veh <= 6)) | ((dep == 2) & (veh <= 4))
            | ((dep == 0) & (veh <= 2))][["hd_demo_sk"]]
    st = t["store"].to_pandas()
    st = st[st.s_store_name == "ese"][["s_store_sk"]]
    td = t["time_dim"].to_pandas()[["t_time_sk", "t_hour", "t_minute"]]
    j = (ss.merge(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk")
         .merge(st, left_on="ss_store_sk", right_on="s_store_sk")
         .merge(td, left_on="ss_sold_time_sk", right_on="t_time_sk"))
    # a sum over no rows is null
    return [{name: (int(((j.t_hour == h) & (j.t_minute >= lo)
                         & (j.t_minute <= hi)).sum()) if len(j) else None)
             for h, lo, hi, name in Q88_SLOTS}]


def pandas_q93(t: Dict[str, pa.Table]) -> List[dict]:
    ss = _sales(t, ["ss_ticket_number", "ss_item_sk", "ss_customer_sk",
                    "ss_quantity"], ["ss_sales_price"])
    sr = _frame(t, "store_returns", ["sr_ticket_number", "sr_item_sk",
                                     "sr_reason_sk", "sr_return_quantity"])
    rs = t["reason"].to_pandas()
    reasons = set(rs.r_reason_sk[rs.r_reason_desc == "Did not fit"])
    j = ss.merge(sr, how="left", left_on=["ss_ticket_number", "ss_item_sk"],
                 right_on=["sr_ticket_number", "sr_item_sk"])
    j = j[j.sr_reason_sk.isin(reasons)]
    # decimal(7,2) times a double is a double (Spark casts the decimal)
    price = j.ss_sales_price / 100.0
    qty = np.where(j.sr_return_quantity.isna(), j.ss_quantity,
                   j.ss_quantity - j.sr_return_quantity)
    g = (j.assign(v=qty * price).groupby("ss_customer_sk").v.sum()
         .reset_index(name="sumsales")
         .sort_values(["sumsales", "ss_customer_sk"], kind="stable")
         .head(100))
    return _rows(g)


def pandas_q97(t: Dict[str, pa.Table]) -> List[dict]:
    dd = t["date_dim"].to_pandas()
    dd = dd[(dd.d_month_seq >= 12) & (dd.d_month_seq <= 23)][["d_date_sk"]]

    def pairs(fact, datecol, cust, item):
        f = _frame(t, fact, [datecol, cust, item])
        j = f.merge(dd, left_on=datecol, right_on="d_date_sk")
        return set(zip(j[cust], j[item]))
    s = pairs("store_sales", "ss_sold_date_sk", "ss_customer_sk",
              "ss_item_sk")
    c = pairs("catalog_sales", "cs_sold_date_sk", "cs_bill_customer_sk",
              "cs_item_sk")
    return [{"store_only": len(s - c), "catalog_only": len(c - s),
             "store_and_catalog": len(s & c)}]


PANDAS = {"q3": pandas_q3, "q7": pandas_q7, "q42": pandas_q42,
          "q44": pandas_q44, "q52": pandas_q52, "q67": pandas_q67,
          "q96": pandas_q96, "q9": pandas_q9, "q28": pandas_q28,
          "q40": pandas_q40, "q43": pandas_q43, "q87": pandas_q87,
          "q88": pandas_q88, "q93": pandas_q93, "q97": pandas_q97}


def check_rows(name: str, got: List[dict], exp: List[dict]) -> Tuple[bool,
                                                                    str]:
    """(ok, reason): ``rows_match`` (rel 1e-6) and the ORDER BY columns of
    ``ORDER_KEYS`` exactly in order. For a query of ``TIED_AT_LIMIT`` cut
    at its limit, the rows of the last tie group (equal ORDER BY keys) are
    held by their count and keys only."""
    from spark_rapids_tpu_torch.bench.tpch import rows_match

    if [list(r) for r in got[:1]] != [list(r) for r in exp[:1]]:
        return False, "column names differ"
    keys = ORDER_KEYS[name]
    if len(got) == len(exp) == TIED_AT_LIMIT.get(name):
        last = tuple(got[-1][k] for k in keys)
        if tuple(exp[-1][k] for k in keys) != last:
            return False, f"the last rows' {keys} differ"
        got = [r for r in got if tuple(r[k] for k in keys) != last]
        exp = [r for r in exp if tuple(r[k] for k in keys) != last]
    if not rows_match(got, exp):
        return False, "rows differ"
    if ([tuple(r[k] for k in keys) for r in got]
            != [tuple(r[k] for k in keys) for r in exp]):
        return False, f"ORDER BY order of {keys} differs"
    spec = ORDER_BY.get(name)
    if spec is not None and not _sorted_by(got, spec):
        return False, f"rows are not in ORDER BY {spec} order"
    return True, ""


def _sorted_by(rows: List[dict], spec) -> bool:
    """Whether ``rows`` are in the order of ``spec`` ((column, ascending),
    ...; no nulls) by their own values."""
    def key(r):
        return tuple(r[c] if up else -r[c] for c, up in spec)

    return all(key(a) <= key(b) for a, b in zip(rows, rows[1:]))

