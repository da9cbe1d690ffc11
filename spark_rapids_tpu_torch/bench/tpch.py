"""TPC-H-derived data and the Q1/Q3/Q5/Q6 DataFrame queries (counterpart of
spark_rapids_tpu/bench/tpch.py), plus the pandas reference answers and the
row comparison of the repo's ``bench.py``.

Generation is seeded and deterministic per (table, scale, seed),
approximating dbgen's column domains; lineitem has 6M * SF rows.
"""

from __future__ import annotations

import datetime
from typing import Dict

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs.expr import (
    Add, And, Average, Count, GreaterThanOrEqual, LessThan, Multiply,
    Subtract, Sum, col, lit,
)


def _date_i(y, m, d) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _notnull(t: pa.Table) -> pa.Table:
    """TPC-H columns are NOT NULL; declare it so the engine can skip
    null-tracking work (e.g. per-aggregate validity rows in the dense path)."""
    schema = pa.schema([f.with_nullable(False) for f in t.schema])
    return t.cast(schema)


_EPOCH_1992 = _date_i(1992, 1, 1)
_DAYS_7Y = _date_i(1998, 12, 31) - _EPOCH_1992

NATIONS = 25
REGIONS = 5


def gen_lineitem(sf: float, seed: int = 0) -> pa.Table:
    n = int(6_000_000 * sf)
    rng = np.random.default_rng(seed)
    orderkey = rng.integers(1, int(1_500_000 * sf) * 4 + 1, n)
    shipdate = _EPOCH_1992 + rng.integers(0, _DAYS_7Y + 1, n)
    qty = rng.integers(1, 51, n).astype(np.float64)
    price = np.round(rng.uniform(900.0, 105000.0, n), 2)
    discount = np.round(rng.integers(0, 11, n) * 0.01, 2)
    tax = np.round(rng.integers(0, 9, n) * 0.01, 2)
    rf = rng.integers(0, 3, n)
    returnflag = np.array(["A", "N", "R"])[rf]
    linestatus = np.where(shipdate > _date_i(1995, 6, 17), "O", "F")
    return _notnull(pa.table({
        "l_orderkey": pa.array(orderkey, pa.int64()),
        "l_quantity": pa.array(qty, pa.float64()),
        "l_extendedprice": pa.array(price, pa.float64()),
        "l_discount": pa.array(discount, pa.float64()),
        "l_tax": pa.array(tax, pa.float64()),
        "l_returnflag": pa.array(returnflag, pa.string()),
        "l_linestatus": pa.array(linestatus, pa.string()),
        "l_shipdate": pa.array(shipdate.astype(np.int32), pa.int32()).cast(
            pa.date32()),
        "l_suppkey": pa.array(rng.integers(1, max(int(10_000 * sf), 10) + 1, n),
                              pa.int64()),
    }))


def gen_orders(sf: float, seed: int = 1) -> pa.Table:
    n = int(1_500_000 * sf)
    rng = np.random.default_rng(seed)
    orderdate = _EPOCH_1992 + rng.integers(0, _DAYS_7Y - 150, n)
    return _notnull(pa.table({
        "o_orderkey": pa.array(np.arange(1, 4 * n + 1, 4), pa.int64()),
        "o_custkey": pa.array(rng.integers(1, max(int(150_000 * sf), 10) + 1, n),
                              pa.int64()),
        "o_orderdate": pa.array(orderdate.astype(np.int32), pa.int32()).cast(
            pa.date32()),
        "o_shippriority": pa.array(np.zeros(n, np.int32), pa.int32()),
    }))


def gen_customer(sf: float, seed: int = 2) -> pa.Table:
    n = max(int(150_000 * sf), 10)
    rng = np.random.default_rng(seed)
    segs = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
                     "HOUSEHOLD"])
    return _notnull(pa.table({
        "c_custkey": pa.array(np.arange(1, n + 1), pa.int64()),
        "c_mktsegment": pa.array(segs[rng.integers(0, 5, n)], pa.string()),
        "c_nationkey": pa.array(rng.integers(0, NATIONS, n), pa.int64()),
    }))


def gen_supplier(sf: float, seed: int = 3) -> pa.Table:
    n = max(int(10_000 * sf), 10)
    rng = np.random.default_rng(seed)
    return _notnull(pa.table({
        "s_suppkey": pa.array(np.arange(1, n + 1), pa.int64()),
        "s_nationkey": pa.array(rng.integers(0, NATIONS, n), pa.int64()),
    }))


def gen_nation(seed: int = 4) -> pa.Table:
    rng = np.random.default_rng(seed)
    names = [f"NATION_{i:02d}" for i in range(NATIONS)]
    return _notnull(pa.table({
        "n_nationkey": pa.array(np.arange(NATIONS), pa.int64()),
        "n_name": pa.array(names, pa.string()),
        "n_regionkey": pa.array(rng.integers(0, REGIONS, NATIONS), pa.int64()),
    }))


def gen_region() -> pa.Table:
    names = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
    return _notnull(pa.table({
        "r_regionkey": pa.array(np.arange(REGIONS), pa.int64()),
        "r_name": pa.array(names, pa.string()),
    }))


def tables_for(sf: float, seed: int = 0) -> Dict[str, pa.Table]:
    return {
        "lineitem": gen_lineitem(sf, seed),
        "orders": gen_orders(sf, seed + 1),
        "customer": gen_customer(sf, seed + 2),
        "supplier": gen_supplier(sf, seed + 3),
        "nation": gen_nation(seed + 4),
        "region": gen_region(),
    }


def df_tables(tables: Dict[str, pa.Table], conf=None,
              batch_rows: int = 1 << 20, device=None) -> Dict[str, object]:
    """One DataFrame per table, each on ``device`` (``cuda`` by default)."""
    from spark_rapids_tpu_torch.plan import from_arrow

    return {k: from_arrow(v, conf, batch_rows=batch_rows, device=device)
            for k, v in tables.items()}


def df_q1(d) -> "object":
    li = d["lineitem"].filter(
        LessThan(col("l_shipdate"), lit(_date_i(1998, 9, 3), T.DATE)))
    disc_price = Multiply(col("l_extendedprice"),
                          Subtract(lit(1.0), col("l_discount")))
    charge = Multiply(disc_price, Add(lit(1.0), col("l_tax")))
    return (li.group_by("l_returnflag", "l_linestatus")
            .agg(Sum(col("l_quantity")).alias("sum_qty"),
                 Sum(col("l_extendedprice")).alias("sum_base_price"),
                 Sum(disc_price).alias("sum_disc_price"),
                 Sum(charge).alias("sum_charge"),
                 Average(col("l_quantity")).alias("avg_qty"),
                 Average(col("l_extendedprice")).alias("avg_price"),
                 Average(col("l_discount")).alias("avg_disc"),
                 Count().alias("count_order"))
            .sort("l_returnflag", "l_linestatus"))


def df_q3(d) -> "object":
    cust = d["customer"].filter(col("c_mktsegment").eq("BUILDING"))
    ords = d["orders"].filter(
        LessThan(col("o_orderdate"), lit(_date_i(1995, 3, 15), T.DATE)))
    line = d["lineitem"].filter(
        GreaterThanOrEqual(col("l_shipdate"), lit(_date_i(1995, 3, 16),
                                                  T.DATE)))
    oc = ords.join(cust, left_on="o_custkey", right_on="c_custkey")
    # fact side probes: lineitem LEFT so the (unique-keyed) oc result is the
    # broadcast build side — the dense direct-address join path
    j = line.join(oc, left_on="l_orderkey", right_on="o_orderkey")
    return (j.group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg(Sum(Multiply(col("l_extendedprice"),
                              Subtract(lit(1.0), col("l_discount"))))
                 .alias("revenue"))
            .sort(SortOrder(col("revenue"), ascending=False),
                  SortOrder(col("o_orderdate")), limit=10))


def df_q5(d) -> "object":
    reg = d["region"].filter(col("r_name").eq("ASIA"))
    nat = d["nation"].join(reg, left_on="n_regionkey", right_on="r_regionkey")
    sup = d["supplier"].join(nat, left_on="s_nationkey",
                             right_on="n_nationkey")
    ords = d["orders"].filter(
        And(GreaterThanOrEqual(col("o_orderdate"),
                               lit(_date_i(1994, 1, 1), T.DATE)),
            LessThan(col("o_orderdate"), lit(_date_i(1995, 1, 1), T.DATE))))
    co = ords.join(d["customer"], left_on="o_custkey", right_on="c_custkey")
    lco = d["lineitem"].join(co, left_on="l_orderkey", right_on="o_orderkey")
    ls = lco.join(sup, left_on=["l_suppkey", "c_nationkey"],
                  right_on=["s_suppkey", "s_nationkey"])
    return (ls.group_by("n_name")
            .agg(Sum(Multiply(col("l_extendedprice"),
                              Subtract(lit(1.0), col("l_discount"))))
                 .alias("revenue"))
            .sort(SortOrder(col("revenue"), ascending=False)))


def df_q6(d) -> "object":
    li = d["lineitem"].filter(And(
        And(
            And(GreaterThanOrEqual(col("l_shipdate"),
                                   lit(_date_i(1994, 1, 1), T.DATE)),
                LessThan(col("l_shipdate"), lit(_date_i(1995, 1, 1),
                                                T.DATE))),
            And(GreaterThanOrEqual(col("l_discount"), lit(0.05 - 1e-9)),
                LessThan(col("l_discount"), lit(0.07 + 1e-9))),
        ),
        LessThan(col("l_quantity"), lit(24.0))))
    return li.agg(Sum(Multiply(col("l_extendedprice"), col("l_discount")))
                  .alias("revenue"))


DF_QUERIES = {"q1": df_q1, "q3": df_q3, "q5": df_q5, "q6": df_q6}


# ---------------------------------------------------------------------------
# pandas reference answers and row comparison (copied from bench.py)
# ---------------------------------------------------------------------------


def cpu_tpch(li, orders, cust, supp, nation, region):
    df = li.to_pandas()
    odf = orders.to_pandas()
    cdf = cust.to_pandas()
    sdf = supp.to_pandas()
    ndf = nation.to_pandas()
    rdf = region.to_pandas()
    ship = df.l_shipdate.to_numpy().astype("datetime64[D]").astype(np.int64)
    lo = (np.datetime64("1994-01-01") - np.datetime64("1970-01-01")).astype(int)
    hi = (np.datetime64("1995-01-01") - np.datetime64("1970-01-01")).astype(int)
    cut = (np.datetime64("1998-09-03") - np.datetime64("1970-01-01")).astype(int)

    def q6():
        m = ((ship >= lo) & (ship < hi)
             & (df.l_discount.to_numpy() >= 0.05 - 1e-9)
             & (df.l_discount.to_numpy() < 0.07 + 1e-9)
             & (df.l_quantity.to_numpy() < 24))
        return float((df.l_extendedprice.to_numpy()[m]
                      * df.l_discount.to_numpy()[m]).sum())

    def q1():
        f = df[ship < cut].copy()
        f["disc_price"] = f.l_extendedprice * (1 - f.l_discount)
        f["charge"] = f.disc_price * (1 + f.l_tax)
        return (f.groupby(["l_returnflag", "l_linestatus"], sort=True)
                .agg(sum_qty=("l_quantity", "sum"),
                     sum_base=("l_extendedprice", "sum"),
                     sum_disc=("disc_price", "sum"),
                     sum_charge=("charge", "sum"),
                     avg_qty=("l_quantity", "mean"),
                     avg_price=("l_extendedprice", "mean"),
                     avg_disc=("l_discount", "mean"),
                     n=("l_quantity", "size")))

    def q3():
        c = cdf[cdf.c_mktsegment == "BUILDING"]
        o = odf[odf.o_orderdate.to_numpy().astype("datetime64[D]")
                < np.datetime64("1995-03-15")]
        ll = df[df.l_shipdate.to_numpy().astype("datetime64[D]")
                >= np.datetime64("1995-03-16")]
        oc = o.merge(c, left_on="o_custkey", right_on="c_custkey")
        j = ll.merge(oc, left_on="l_orderkey", right_on="o_orderkey")
        j["rev"] = j.l_extendedprice * (1 - j.l_discount)
        return (j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"])
                .agg(revenue=("rev", "sum")).reset_index()
                .sort_values(["revenue", "o_orderdate"],
                             ascending=[False, True]).head(10))

    def q5():
        r = rdf[rdf.r_name == "ASIA"]
        n = ndf.merge(r, left_on="n_regionkey", right_on="r_regionkey")
        s = sdf.merge(n, left_on="s_nationkey", right_on="n_nationkey")
        od = odf.o_orderdate.to_numpy().astype("datetime64[D]")
        o = odf[(od >= np.datetime64("1994-01-01"))
                & (od < np.datetime64("1995-01-01"))]
        co = o.merge(cdf, left_on="o_custkey", right_on="c_custkey")
        lco = df.merge(co, left_on="l_orderkey", right_on="o_orderkey")
        ls = lco.merge(s, left_on=["l_suppkey", "c_nationkey"],
                       right_on=["s_suppkey", "s_nationkey"])
        ls["rev"] = ls.l_extendedprice * (1 - ls.l_discount)
        return (ls.groupby("n_name").agg(revenue=("rev", "sum"))
                .reset_index().sort_values("revenue", ascending=False))

    return {"q1": q1, "q3": q3, "q5": q5, "q6": q6}


def _canon(rows):
    def key(v):
        if v is None:
            return (0, "")
        if isinstance(v, float):
            return (1, round(v, 6))
        if isinstance(v, int):
            return (1, float(v))
        return (2, str(v))

    return sorted((tuple(r.values()) for r in rows),
                  key=lambda t: tuple(key(v) for v in t))


def rows_match(a, b, rel=1e-6):
    """Canonically sorted row-set equality; floats agree within ``rel``
    (sums taken in another order differ in their last digits)."""
    ca, cb = _canon(a), _canon(b)
    if len(ca) != len(cb):
        return False
    for ra, rb in zip(ca, cb):
        if len(ra) != len(rb):
            return False
        for va, vb in zip(ra, rb):
            if isinstance(va, float) or isinstance(vb, float):
                if va is None or vb is None:
                    return False
                if abs(va - vb) > rel * max(1.0, abs(va), abs(vb)):
                    return False
            elif va != vb:
                return False
    return True
