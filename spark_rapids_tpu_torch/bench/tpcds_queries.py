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

from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs.expr import (
    And, Average, Count, EqualTo, GreaterThanOrEqual, LessThanOrEqual,
    Multiply, Or, Sum, col, lit,
)
from spark_rapids_tpu_torch.exprs.window import Rank, over, window_spec

D = Dict[str, "object"]


def asc(c, nf=None):
    return SortOrder(col(c) if isinstance(c, str) else c, nulls_first=nf)


def desc(c, nf=None):
    return SortOrder(col(c) if isinstance(c, str) else c, ascending=False,
                     nulls_first=nf)


def _between(c, lo, hi):
    c = col(c) if isinstance(c, str) else c
    return And(GreaterThanOrEqual(c, lit(lo)), LessThanOrEqual(c, lit(hi)))


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


# the TPC-DS half of bench.py's headline suite, in its order
HEADLINE = ("q3", "q7", "q42", "q52", "q96")

# ORDER BY columns whose order the result must keep exactly (q67's
# sumsales order is checked through rk, its rank within the category)
ORDER_KEYS = {"q3": ("d_year", "sum_agg", "i_brand_id"),
              "q7": ("i_item_id",),
              "q42": ("sum_agg", "d_year", "i_category_id", "i_category"),
              "q44": ("rnk",),
              "q52": ("d_year", "ext_price", "i_brand_id"),
              "q67": ("i_category", "rk"),
              "q96": ("cnt",)}


def df_tables(tables: Dict[str, pa.Table], conf=None,
              batch_rows: int = 1 << 20, device=None) -> Dict[str, object]:
    """One DataFrame per table, each on ``device`` (``cuda`` by default)."""
    from spark_rapids_tpu_torch.plan import from_arrow

    return {k: from_arrow(v, conf, batch_rows=batch_rows, device=device)
            for k, v in tables.items()}


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


PANDAS = {"q3": pandas_q3, "q7": pandas_q7, "q42": pandas_q42,
          "q44": pandas_q44, "q52": pandas_q52, "q67": pandas_q67,
          "q96": pandas_q96}


def check_rows(name: str, got: List[dict], exp: List[dict]) -> Tuple[bool,
                                                                    str]:
    """(ok, reason): ``rows_match`` (rel 1e-6) and the ORDER BY columns of
    ``ORDER_KEYS`` exactly in order."""
    from spark_rapids_tpu_torch.bench.tpch import rows_match

    if [list(r) for r in got[:1]] != [list(r) for r in exp[:1]]:
        return False, "column names differ"
    if not rows_match(got, exp):
        return False, "rows differ"
    keys = ORDER_KEYS[name]
    if ([tuple(r[k] for k in keys) for r in got]
            != [tuple(r[k] for k in keys) for r in exp]):
        return False, f"ORDER BY order of {keys} differs"
    return True, ""

