"""TPC-DS q44 and q67 on the port's DataFrame front end (counterpart of
spark_rapids_tpu/bench/tpcds_queries.py), written as the reference writes
them, plus a pandas reference answer for each.

Both queries rank rows with a window over decimal money columns: q44 ranks
items by their average net profit (decimal(7,2) averaged into
decimal(11,6)) in both directions, q67 ranks aggregated sales
(decimal(7,2) times a double quantity, summed as double) within each
category. The pandas references compute the same answers independently:
q44's averages exactly in integers (HALF_UP at scale 6), q67's sums in
float64. Results are compared with ``tpch.rows_match`` (rel 1e-6 on
doubles, exact keys and counts) and the ORDER BY columns in order.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa

from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs.expr import (
    And, Average, GreaterThanOrEqual, LessThanOrEqual, Multiply, Sum, col,
    lit,
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


# ORDER BY columns whose order the result must keep exactly (q67's
# sumsales order is checked through rk, its rank within the category)
ORDER_KEYS = {"q44": ("rnk",), "q67": ("i_category", "rk")}


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


PANDAS = {"q44": pandas_q44, "q67": pandas_q67}


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

