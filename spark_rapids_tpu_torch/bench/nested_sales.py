"""The nested sales pass: the nested types, BINARY and JSON over a
ticket-basket table made from the TPC-DS tables of ``tpcds_schema`` (none
cut), on the card and on the CPU engine.

``tables_for(sf)`` gives item, and two tables built from store_sales:

- ``tickets``, one row per ``ss_ticket_number`` (baskets hold 1-20 lines):
  ``ticket`` BIGINT; ``basket_id`` BINARY, the 16-byte BLAKE2b digest of
  the ticket number; ``items`` array<int> of the lines' ``ss_item_sk`` in
  line order; ``qty`` map<int,int>, one entry per distinct item with its
  quantities summed (keys ascending); ``head`` struct<customer_sk,
  store_sk, sold_date_sk> of the ticket's first line; ``doc``, the ticket
  as JSON text, ``{"store":S,"customer":C,"lines":[{"item":I,"qty":Q,
  "paid":"12.34"},...]}``. The generator leaves no key null, so a seeded
  4% of the tickets get a null customer (in ``head`` and as JSON null in
  ``doc``), dsdgen's share of null foreign keys;
- ``lines``, store_sales' rows as (``basket_id``, ``ss_ticket_number``,
  ``ss_item_sk``, ``ss_quantity``, ``ss_store_sk``): the exploded side of
  H4's join.

The queries take the DataFrames of ``df_tables`` (or, H1, the tables
themselves: its exec nodes are composed directly, as the reference's
planner has no Generate node):

- H1: posexplode(items) (``GenerateExec``) joined with item by the hash
  join exec and grouped by ``i_category`` (count, sum of ``pos``);
  ``arrow_h1`` computes it with pyarrow's ``list_flatten`` and
  ``list_parent_indices``;
- H2: size, element_at of the array (1 and -1) and of the map (by the
  first item), the size of map_keys, array_contains, ``head.store_sk``
  and a named_struct's field read back, grouped by ``head.store_sk``;
- H3: get_json_object of ``$.store``, ``$.customer``,
  ``$.lines[0].item``, ``$.lines[1].paid`` and ``$['store']`` cast and
  grouped by the store; ``json_h3`` computes it with Python's ``json``;
  ``h3_rejected`` reads ``$.lines[*].item``, outside the device's path
  grammar, so its projection (over every 10th ticket) runs on the CPU
  engine;
- H4G, H4J: ``basket_id`` as a group key (lines per basket, the first 100
  baskets in byte order: an ORDER BY ... LIMIT) and as a join key
  (lines, probing, against tickets, whose ticket numbers must agree);
- H5: collect_list and collect_set of the first item's ``i_category`` per
  store and the sizes of map_values, with JsonToStructsText of every
  1000th ticket's ``doc`` (CPU-engine nodes);
- H6: a running sum of size(items) over ``head.store_sk`` partitions
  ordered by ticket, summed per store.

H7 (partitioned) is H2 and H4 with 4 splits and 4 shuffle partitions. A
nested column never crosses an exchange there (the shuffle's wire format
has no code for one): H2's exchange carries its partial aggregate and
H4's join reads projected BINARY and integer columns.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.bench import scalar_sales as SS
from spark_rapids_tpu_torch.bench.scalar_sales import Lib, port_lib

TABLES = ("store_sales", "item")
ORDER_KEYS = {"H1": ("i_category",), "H2": ("store",), "H3": ("store",),
              "H3R": ("store",), "H4G": ("basket_id",), "H4J": ("n",),
              "H5": ("store",), "H6": ("store",)}
PARTITIONED = ("H2", "H4G", "H4J")
# H7: the fast path off, and H4J's join shuffled (no broadcast), so that
# BINARY keys cross the hash exchanges
H7_CONF = {"spark.rapids.gpu.fastpath.enabled": "false",
           "spark.rapids.gpu.sql.join.broadcastRowThreshold": 0}
NULL_CUSTOMER_SHARE = 0.04
H3_PATHS = (("store", "$.store"), ("customer", "$.customer"),
            ("item0", "$.lines[0].item"), ("paid1", "$.lines[1].paid"),
            ("store_q", "$['store']"))
H3_REJECTED_PATH = "$.lines[*].item"
H3R_EVERY = 10


def _ticket_runs(ticket: np.ndarray):
    """(first row of each ticket, rows a ticket): store_sales' rows of a
    ticket are adjacent."""
    starts = np.flatnonzero(np.r_[True, ticket[1:] != ticket[:-1]])
    return starts, np.diff(np.r_[starts, len(ticket)])


def _offsets(sizes: np.ndarray) -> pa.Array:
    return pa.array(np.r_[0, np.cumsum(sizes)].astype(np.int32), pa.int32())


def nested_tables(ss: pa.Table, seed: int = 0) -> Dict[str, pa.Table]:
    """``tickets`` and ``lines`` (see the module docstring) from
    store_sales."""
    ticket = np.asarray(ss.column("ss_ticket_number"), np.int64)
    item = np.asarray(ss.column("ss_item_sk"), np.int64).astype(np.int32)
    qty = np.asarray(ss.column("ss_quantity")).astype(np.int32)
    starts, sizes = _ticket_runs(ticket)
    nt = len(starts)
    tick = ticket[starts]
    basket = pa.array([hashlib.blake2b(int(t).to_bytes(8, "little"),
                                       digest_size=16).digest()
                       for t in tick.tolist()], pa.binary())
    items = pa.ListArray.from_arrays(_offsets(sizes), pa.array(item))
    # qty: per ticket, one entry per distinct item (keys ascending)
    tid = np.repeat(np.arange(nt), sizes)
    order = np.lexsort((item, tid))
    t_s, i_s, q_s = tid[order], item[order], qty[order]
    first = np.r_[True, (t_s[1:] != t_s[:-1]) | (i_s[1:] != i_s[:-1])]
    at = np.flatnonzero(first)
    qmap = pa.MapArray.from_arrays(
        _offsets(np.bincount(t_s[at], minlength=nt)),
        pa.array(i_s[at]), pa.array(np.add.reduceat(q_s, at)))
    rng = np.random.default_rng(seed + 17)
    no_cust = rng.random(nt) < NULL_CUSTOMER_SHARE
    cust = np.asarray(ss.column("ss_customer_sk"), np.int64)[starts]
    store = np.asarray(ss.column("ss_store_sk"), np.int64)[starts]
    date = np.asarray(ss.column("ss_sold_date_sk"), np.int64)[starts]
    head = pa.StructArray.from_arrays(
        [pa.array(cust.astype(np.int32), mask=no_cust),
         pa.array(store.astype(np.int32)), pa.array(date.astype(np.int32))],
        ["customer_sk", "store_sk", "sold_date_sk"])
    lines = pc.binary_join_element_wise(
        '{"item":', pc.cast(pa.array(item), pa.string()), ',"qty":',
        pc.cast(pa.array(qty), pa.string()), ',"paid":"',
        pc.cast(ss.column("ss_net_paid").combine_chunks(), pa.string()),
        '"}', "")
    joined = pc.binary_join(pa.ListArray.from_arrays(_offsets(sizes), lines),
                            ",")
    cust_txt = pc.fill_null(pc.cast(pa.array(cust, mask=no_cust),
                                    pa.string()), "null")
    doc = pc.binary_join_element_wise(
        '{"store":', pc.cast(pa.array(store), pa.string()), ',"customer":',
        cust_txt, ',"lines":[', joined, "]}", "")
    tickets = pa.table({"ticket": pa.array(tick), "basket_id": basket,
                        "items": items, "qty": qmap, "head": head,
                        "doc": doc})
    lines_t = pa.table({
        "basket_id": basket.take(pa.array(tid)),
        "ss_ticket_number": pa.array(ticket),
        "ss_item_sk": ss.column("ss_item_sk"),
        "ss_quantity": pa.array(qty.astype(np.int64)),
        "ss_store_sk": ss.column("ss_store_sk")})
    return {"tickets": tickets, "lines": lines_t}


def tables_for(sf: float, seed: int = 0) -> Dict[str, pa.Table]:
    from spark_rapids_tpu_torch.bench import tpcds_schema as S

    base = S.tables_for(sf, seed, names=TABLES)
    out = nested_tables(base["store_sales"], seed)
    out["item"] = base["item"].select(["i_item_sk", "i_category"])
    return out


def df_tables(tables, conf=None, batch_rows: int = 1 << 22, device=None,
              partitions: int = 1, shuffle_partitions: int = 4):
    from spark_rapids_tpu_torch.bench import tpcds_queries as Q

    return Q.df_tables(tables, conf, batch_rows=batch_rows, device=device,
                       partitions=partitions,
                       shuffle_partitions=shuffle_partitions)


# ---------------------------------------------------------------------------
# H1: exec nodes composed directly
# ---------------------------------------------------------------------------


def h1_sources(tables, device, batch_rows: int = 1 << 22):
    """H1's inputs uploaded once: the tickets' (ticket, items) and item,
    each a ``BatchSourceExec``."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import (
        batch_from_arrow, dictionary_encode_table)
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec

    def source(t: pa.Table):
        enc, cache = dictionary_encode_table(t), {}
        return BatchSourceExec([[batch_from_arrow(
            enc.slice(i, batch_rows), device, dict_cache=cache)
            for i in range(0, max(t.num_rows, 1), batch_rows)]],
            T.Schema.from_arrow(t.schema), device)

    return (source(tables["tickets"].select(["ticket", "items"])),
            source(tables["item"]))


def h1_plan(sources):
    """posexplode(items) joined with item, grouped by i_category: the
    GenerateExec, HashJoinExec and HashAggregateExec of the port over
    ``h1_sources``."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.generate import GenerateExec
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exec.project import ProjectExec
    from spark_rapids_tpu_torch.exprs import expr as E

    col = E.col
    tickets, item = sources
    gen = GenerateExec(col("items"), tickets, position=True)
    lhs = ProjectExec([col("pos"), E.Alias(E.Cast(col("col"), T.LONG),
                                           "item_sk")], gen)
    j = HashJoinExec([col("item_sk")], [col("i_item_sk")], "inner", lhs,
                     item)
    return HashAggregateExec(
        [col("i_category")], [E.Alias(E.Count(), "n"),
                              E.Alias(E.Sum(col("pos")), "sum_pos")], j)


def h1_rows(tables, device) -> List[dict]:
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    out = execute_to_arrow(h1_plan(h1_sources(tables, device))).to_pylist()
    return sorted(out, key=lambda r: r["i_category"])


def arrow_h1(tables) -> List[dict]:
    """H1 by pyarrow's list kernels and pandas."""
    import pandas as pd

    items = tables["tickets"].column("items").combine_chunks()
    parent = np.asarray(pc.list_parent_indices(items))
    offs = np.asarray(items.offsets)
    pos = np.arange(len(parent)) - offs[parent]
    df = pd.DataFrame({"item_sk": np.asarray(pc.list_flatten(items),
                                             np.int64), "pos": pos})
    it = tables["item"].to_pandas()
    g = df.merge(it, left_on="item_sk", right_on="i_item_sk").groupby(
        "i_category").agg(n=("pos", "size"), sum_pos=("pos", "sum"))
    return [{"i_category": k, "n": int(r.n), "sum_pos": int(r.sum_pos)}
            for k, r in g.sort_index().iterrows()]


# ---------------------------------------------------------------------------
# H2-H6: DataFrame queries
# ---------------------------------------------------------------------------


def h2(d, L: Lib = None):
    L = L or port_lib()
    E, T = L.E, L.T
    col, lit = E.col, E.lit
    head, items, qty = col("head"), col("items"), col("qty")
    p = d["tickets"].select(
        E.Alias(E.GetStructField(head, "store_sk"), "store"),
        E.Alias(E.Size(items), "n_items"),
        E.Alias(E.ElementAt(items, lit(1)), "first_item"),
        E.Alias(E.ElementAt(items, lit(-1)), "last_item"),
        E.Alias(E.ElementAt(qty, E.ElementAt(items, lit(1))), "first_qty"),
        E.Alias(E.Size(E.MapKeys(qty)), "n_distinct"),
        E.Alias(E.Cast(E.ArrayContains(items, lit(1000)), T.INT), "has"),
        E.Alias(E.GetStructField(E.CreateNamedStruct(
            ["c", "t"], E.GetStructField(head, "customer_sk"),
            col("ticket")), "c"), "cust"))
    return p.group_by("store").agg(
        E.Alias(E.Count(), "n"),
        *[E.Alias(E.Sum(col(c)), f"sum_{c}") for c in (
            "n_items", "first_item", "last_item", "first_qty",
            "n_distinct", "has", "cust")],
        E.Alias(E.Count(col("cust")), "n_cust")).sort(
        L.SortOrder(col("store")))


def h3(d, L: Lib = None, rejected: bool = False):
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    doc = col("doc")
    js = {n: E.GetJsonObject(doc, p) for n, p in H3_PATHS}
    cols = [E.Alias(E.Cast(js["store"], T.INT), "store"),
            E.Alias(E.Cast(js["customer"], T.LONG), "customer"),
            E.Alias(E.Cast(js["item0"], T.LONG), "item0"),
            E.Alias(E.Cast(js["paid1"], T.DOUBLE), "paid1"),
            E.Alias(E.Cast(E.EqualTo(js["store_q"], js["store"]), T.INT),
                    "same")]
    tickets = d["tickets"]
    if rejected:
        cols.append(E.Alias(E.Length(E.GetJsonObject(doc, H3_REJECTED_PATH)),
                            "star"))
        tickets = tickets.filter(_sampled(E, col("ticket")))
    aggs = [E.Alias(E.Count(), "n"),
            E.Alias(E.Sum(col("customer")), "sum_customer"),
            E.Alias(E.Count(col("customer")), "n_customer"),
            E.Alias(E.Sum(col("item0")), "sum_item0"),
            E.Alias(E.Sum(col("paid1")), "sum_paid1"),
            E.Alias(E.Count(col("paid1")), "n_paid1"),
            E.Alias(E.Sum(col("same")), "sum_same")]
    if rejected:
        aggs.append(E.Alias(E.Count(col("star")), "n_star"))
    return tickets.select(*cols).group_by("store").agg(*aggs).sort(
        L.SortOrder(col("store")))


def _sampled(E, ticket):
    """Every ``H3R_EVERY``-th ticket: H3R's CPU projection parses those."""
    return E.EqualTo(E.Remainder(ticket, E.lit(H3R_EVERY)), E.lit(0))


def h3_rejected(d, L: Lib = None):
    return h3(d, L, rejected=True)


def json_h3(tables, rejected: bool = False) -> List[dict]:
    """H3 by Python's ``json`` (``$.lines[*].item`` is no path of the
    subset, so H3R's ``n_star`` counts 0)."""
    out: Dict[int, dict] = {}
    tk = tables["tickets"]
    for ticket, text in zip(tk.column("ticket").to_pylist(),
                            tk.column("doc").to_pylist()):
        if rejected and ticket % H3R_EVERY:
            continue
        o = json.loads(text)
        g = out.setdefault(o["store"], {
            "store": o["store"], "n": 0, "sum_customer": 0,
            "n_customer": 0, "sum_item0": 0, "sum_paid1": 0.0,
            "n_paid1": 0, "sum_same": 0})
        g["n"] += 1
        if o["customer"] is not None:
            g["sum_customer"] += o["customer"]
            g["n_customer"] += 1
        g["sum_item0"] += o["lines"][0]["item"]
        if len(o["lines"]) > 1:
            g["sum_paid1"] += float(o["lines"][1]["paid"])
            g["n_paid1"] += 1
        g["sum_same"] += 1
    rows = [out[k] for k in sorted(out)]
    for r in rows:
        for k in ("sum_customer", "sum_paid1"):
            if not r[k.replace("sum_", "n_")]:
                r[k] = None
        if rejected:
            r["n_star"] = 0
    return rows


def h4_group(d, L: Lib = None):
    L = L or port_lib()
    E = L.E
    col = E.col
    g = d["lines"].group_by("basket_id").agg(
        E.Alias(E.Count(), "n"),
        E.Alias(E.Sum(col("ss_quantity")), "qty"),
        E.Alias(E.Min(col("ss_ticket_number")), "ticket"))
    return g.sort(L.SortOrder(col("basket_id")), limit=100)


def h4_join(d, L: Lib = None):
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    t = d["tickets"].select(E.Alias(col("basket_id"), "b2"), col("ticket"))
    ln = d["lines"].select(col("basket_id"), col("ss_ticket_number"),
                           col("ss_quantity"))
    j = ln.join(t, left_on="basket_id", right_on="b2")
    p = j.select(E.Alias(E.Cast(E.Not(E.EqualTo(col("ticket"),
                                                col("ss_ticket_number"))),
                                T.INT), "bad"), col("ss_quantity"))
    return p.group_by().agg(E.Alias(E.Count(), "n"),
                            E.Alias(E.Sum(col("bad")), "bad"),
                            E.Alias(E.Sum(col("ss_quantity")), "qty"))


def h5(d, L: Lib = None):
    L = L or port_lib()
    E, T = L.E, L.T
    col = E.col
    t = d["tickets"]
    first = t.select(E.Alias(E.GetStructField(col("head"), "store_sk"),
                             "store"),
                     E.Alias(E.Cast(E.ElementAt(col("items"), E.lit(1)),
                                    T.LONG), "first"),
                     E.Alias(E.Size(E.MapValues(col("qty"))), "n_vals"))
    j = first.join(d["item"], left_on="first", right_on="i_item_sk")
    sampled = t.filter(E.EqualTo(E.Remainder(col("ticket"), E.lit(1000)),
                                 E.lit(0))).select(
        E.Alias(E.GetStructField(col("head"), "store_sk"), "s2"),
        E.Alias(E.Length(E.JsonToStructsText(col("doc"))), "doc_len"))
    docs = sampled.group_by("s2").agg(E.Alias(E.Sum(col("doc_len")),
                                              "sum_doc_len"))
    g = j.group_by("store").agg(
        E.Alias(E.CollectList(col("i_category")), "cats"),
        E.Alias(E.CollectSet(col("i_category")), "cat_set"),
        E.Alias(E.Sum(col("n_vals")), "sum_vals"))
    return g.join(docs, left_on="store", right_on="s2", how="left").select(
        col("store"), E.Alias(E.Size(col("cats")), "n_cats"),
        col("cat_set"), col("sum_vals"), col("sum_doc_len")).sort(
        L.SortOrder(col("store")))


def h6(d, L: Lib = None):
    L = L or port_lib()
    E, W = L.E, L.W
    col = E.col
    s = d["tickets"].select(
        E.Alias(E.GetStructField(col("head"), "store_sk"), "store"),
        col("ticket"), E.Alias(E.Size(col("items")), "n"))
    running = W.WindowSpec((col("store"),), (L.SortOrder(col("ticket")),),
                           W.WindowFrame("rows", None, 0))
    w = s.with_window(E.Alias(W.WindowExpression(E.Sum(col("n")), running),
                              "run"))
    return w.group_by("store").agg(
        E.Alias(E.Sum(col("run")), "sum_run"),
        E.Alias(E.Max(col("run")), "max_run"),
        E.Alias(E.Count(), "n")).sort(L.SortOrder(col("store")))


QUERIES = {"H2": h2, "H3": h3, "H3R": h3_rejected, "H4G": h4_group,
           "H4J": h4_join, "H5": h5, "H6": h6}


def check_rows(name: str, got, exp):
    """(ok, reason): ``scalar_sales.check_rows`` with this pass's ORDER BY
    keys."""
    return SS.check_rows(name, got, exp, ORDER_KEYS)
