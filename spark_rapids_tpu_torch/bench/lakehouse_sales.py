"""A lakehouse pass over the TPC-DS store_sales and item tables: Delta and
Iceberg tables, the dataframe cache, Expand, the bloom filter, Z-order
and the ML handoff, each as its users run it, with a plain reference of
the same operations in ``pyarrow.compute`` over the in-memory tables.

1. A Delta fact table (a date-partitioned fact table taking late
   corrections): store_sales sorted by ``ss_sold_date_sk``, its first
   quarter version 0 and three appends of a quarter each (versions 1-3,
   four files); version 4 a DELETE of November 1999's sales of more than
   50 units (deletion vectors on the files holding that month); version 5
   an UPDATE setting ``ss_ext_sales_price`` to ``ss_ext_list_price`` in
   November 2001 (copy-on-write, the predicate and projection on the
   device). Both change q3, whose filter reads every November.
2. A Delta dimension (a slowly changing dimension kept by MERGE): item,
   merged on ``i_item_sk`` with 2,000 of its items whose
   ``i_manufact_id`` becomes 128 (inside q3's filter) and 500 new items.
3. An Iceberg table over the Parquet pass's store_sales files
   (``bench/parquet_sales.py``), its metadata written with the port's
   ``write_avro``: ``v1.metadata.json``, ``version-hint.text``, an Avro
   manifest list and an Avro manifest.
4. Reads: q3 over store_sales at version 5 and item at version 1, at
   version 3 (time travel), and over the Iceberg table with the
   dimensions' files; the dataframe cache of a November filter (a
   ``df.cache()``); a ROLLUP(i_category, i_class) of
   ``ss_ext_sales_price`` over store_sales joined with item through
   ``ExpandExec`` (3 projections, the official q36/q70/q86 shape; the
   grouping sets' queries); a bloom filter over the Music items' keys
   probed with every ``ss_item_sk`` (a join's runtime filter); Z-order
   and Hilbert orders over two keys and the Z-curve of three (OPTIMIZE
   ZORDER BY); a feature matrix for a model (the ML handoff).

``run_pass`` runs it all; ``plain_fact``, ``plain_item`` and
``plain_rollup`` are the plain reference: the same results made by
``pyarrow.compute``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.bench.parquet_sales import clustered_fact
from spark_rapids_tpu_torch.exprs import expr as E

FACT, DIM = "store_sales", "item"
FACT_FILES = 4
DELETE_YEAR, UPDATE_YEAR = 1999, 2001
DELETE_QUANTITY = 50
MERGE_MATCHED, MERGE_NEW = 2000, 500
MERGE_MANUFACT = 128
ROLLUP_KEYS = ("i_category", "i_class")
ROLLUP_VALUE = "ss_ext_sales_price"
BLOOM_CATEGORY = "Music"
BLOOM_HASHES = 3
Z_KEYS = ("ss_item_sk", "ss_customer_sk")
Z3_KEYS = Z_KEYS + ("ss_sold_date_sk",)  # the pair first
FEATURES = ("ss_quantity", "ss_wholesale_cost", "ss_list_price",
            "ss_sales_price")
LABEL = "ss_net_profit"


def november_keys(date_dim: pa.Table, year: int) -> List[int]:
    """The date keys of November of ``year``."""
    m = pc.and_(pc.equal(date_dim["d_year"], year),
                pc.equal(date_dim["d_moy"], 11))
    return sorted(date_dim.filter(m)["d_date_sk"].to_pylist())


def _in(name: str, keys: List[int]) -> E.Expression:
    return E.In(E.col(name), [E.lit(k) for k in keys])


def delete_condition(date_dim: pa.Table) -> E.Expression:
    return E.And(_in("ss_sold_date_sk", november_keys(date_dim,
                                                      DELETE_YEAR)),
                 E.GreaterThan(E.col("ss_quantity"),
                               E.lit(float(DELETE_QUANTITY))))


def update_condition(date_dim: pa.Table) -> E.Expression:
    return _in("ss_sold_date_sk", november_keys(date_dim, UPDATE_YEAR))


def fact_versions(store_sales: pa.Table) -> List[pa.Table]:
    """store_sales by date, cut into the four commits' tables."""
    t = clustered_fact(store_sales)
    q = -(-t.num_rows // FACT_FILES)
    return [t.slice(i * q, q) for i in range(FACT_FILES)]


def merge_source(item: pa.Table, seed: int = 0) -> pa.Table:
    """``MERGE_MATCHED`` of item's rows (chosen from ``seed``) with
    ``i_manufact_id`` 128, then ``MERGE_NEW`` new items: copies of other
    rows under new keys past the largest."""
    rng = np.random.default_rng(seed)
    n = item.num_rows
    pick = rng.choice(n, min(MERGE_MATCHED, n), replace=False)
    new = rng.choice(n, MERGE_NEW, replace=n < MERGE_NEW)
    matched = item.take(pa.array(np.sort(pick)))
    added = item.take(pa.array(new))
    top = pc.max(item["i_item_sk"]).as_py()
    added = added.set_column(
        added.schema.get_field_index("i_item_sk"), "i_item_sk",
        pa.array(np.arange(top + 1, top + 1 + len(new)), pa.int64()))
    src = pa.concat_tables([matched, added])
    mi = src.schema.get_field_index("i_manufact_id")
    return src.set_column(mi, src.schema.field(mi),
                          pa.array([MERGE_MANUFACT] * src.num_rows,
                                   src.schema.field(mi).type))


def build_delta(tables: Dict[str, pa.Table], root: str, device=None,
                seed: int = 0) -> dict:
    """The Delta fact table (versions 0-5) and item (versions 0-1) under
    ``root``: ``{"fact": DeltaTable, "item": DeltaTable, "versions":
    [...], "source": the merge's source}``."""
    from spark_rapids_tpu_torch.delta import DeltaTable

    parts = fact_versions(tables[FACT])
    fact = DeltaTable.create(os.path.join(root, FACT), parts[0], device)
    versions = [0] + [fact.append(p) for p in parts[1:]]
    versions.append(fact.delete(delete_condition(tables["date_dim"])))
    versions.append(fact.update(
        update_condition(tables["date_dim"]),
        {"ss_ext_sales_price": E.col("ss_ext_list_price")}))
    item = DeltaTable.create(os.path.join(root, DIM), tables[DIM], device)
    src = merge_source(tables[DIM], seed)
    item_v = item.merge(src, "i_item_sk", "i_item_sk",
                        when_matched_update={"i_manufact_id":
                                             "i_manufact_id"})
    return {"fact": fact, "item": item, "versions": versions,
            "item_version": item_v, "source": src}


def plain_fact(store_sales: pa.Table, date_dim: pa.Table) -> pa.Table:
    """Version 5 made by ``pyarrow.compute``: November 1999's rows of
    more than 50 units gone, November 2001's sales price its list price."""
    t = clustered_fact(store_sales)
    d = t["ss_sold_date_sk"]
    gone = pc.and_(pc.is_in(d, pa.array(november_keys(date_dim,
                                                      DELETE_YEAR))),
                   pc.greater(t["ss_quantity"], float(DELETE_QUANTITY)))
    t = t.filter(pc.invert(pc.fill_null(gone, False)))
    upd = pc.fill_null(pc.is_in(t["ss_sold_date_sk"], pa.array(
        november_keys(date_dim, UPDATE_YEAR))), False)
    i = t.schema.get_field_index("ss_ext_sales_price")
    return t.set_column(i, t.schema.field(i), pc.if_else(
        upd, t["ss_ext_list_price"], t["ss_ext_sales_price"]))


def plain_item(item: pa.Table, source: pa.Table) -> pa.Table:
    """Version 1 made by ``pyarrow.compute``: the matched items' manufact
    ids from the source, the new items appended."""
    hit = pc.is_in(item["i_item_sk"], source["i_item_sk"])
    mi = item.schema.get_field_index("i_manufact_id")
    updated = item.set_column(mi, item.schema.field(mi), pc.if_else(
        hit, pa.scalar(MERGE_MANUFACT, item.schema.field(mi).type),
        item["i_manufact_id"]))
    new = source.filter(pc.invert(pc.is_in(source["i_item_sk"],
                                           item["i_item_sk"])))
    return pa.concat_tables([updated, new.cast(item.schema)])


def write_iceberg(root: str, data_files: List[str]) -> None:
    """Iceberg metadata over ``data_files`` (absolute paths) under
    ``root/metadata``: an Avro manifest and manifest list written with the
    port's ``write_avro``, ``v1.metadata.json`` and ``version-hint.text``."""
    from spark_rapids_tpu_torch.io.avro import write_avro

    meta = os.path.join(root, "metadata")
    os.makedirs(meta, exist_ok=True)
    manifest = os.path.join(meta, "manifest-1.avro")
    mlist = os.path.join(meta, "snap-1.avro")
    write_avro(manifest, pa.table({
        "status": pa.array([1] * len(data_files), pa.int32()),
        "file_path": pa.array(data_files, pa.string()),
        "file_format": pa.array(["PARQUET"] * len(data_files), pa.string()),
        "record_count": pa.array([_rows(p) for p in data_files],
                                 pa.int64())}))
    write_avro(mlist, pa.table({
        "manifest_path": pa.array([manifest], pa.string()),
        "added_snapshot_id": pa.array([1], pa.int64())}))
    md = {"format-version": 1, "location": root,
          "current-snapshot-id": 1,
          "snapshots": [{"snapshot-id": 1, "manifest-list": mlist}]}
    with open(os.path.join(meta, "v1.metadata.json"), "w") as f:
        json.dump(md, f)
    with open(os.path.join(meta, "version-hint.text"), "w") as f:
        f.write("1")


def _rows(path: str) -> int:
    import pyarrow.parquet as pq

    return pq.ParquetFile(path).metadata.num_rows


def rollup(join_plan):
    """ROLLUP(i_category, i_class) of ``ss_ext_sales_price`` over a
    physical plan with those columns (one partition): ``ExpandExec`` of
    the three grouping sets, with the grouping id ``g`` (0, 1, 3), under a
    complete aggregate."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.expand import ExpandExec

    cat, cls = ROLLUP_KEYS
    none = E.lit(None, T.STRING)
    exp = ExpandExec([
        [E.col(cat), E.col(cls), E.col(ROLLUP_VALUE), E.Alias(E.lit(0), "g")],
        [E.col(cat), E.Alias(none, cls), E.col(ROLLUP_VALUE),
         E.Alias(E.lit(1), "g")],
        [E.Alias(none, cat), E.Alias(none, cls), E.col(ROLLUP_VALUE),
         E.Alias(E.lit(3), "g")]], join_plan)
    return exp, HashAggregateExec(
        [E.col(cat), E.col(cls), E.col("g")],
        [E.Alias(E.Sum(E.col(ROLLUP_VALUE)), "total")], exp)


def plain_rollup(store_sales: pa.Table, item: pa.Table) -> List[tuple]:
    """The rollup's rows by three ``pyarrow`` group-bys, sorted:
    (category, class, g, total)."""
    j = store_sales.select(["ss_item_sk", ROLLUP_VALUE]).join(
        item.select(["i_item_sk", *ROLLUP_KEYS]), "ss_item_sk",
        "i_item_sk", join_type="inner")
    out = []
    for keys, g in ((list(ROLLUP_KEYS), 0), ([ROLLUP_KEYS[0]], 1), ([], 3)):
        if keys:
            agg = j.group_by(keys).aggregate([(ROLLUP_VALUE, "sum")])
            for r in agg.to_pylist():
                out.append((r[ROLLUP_KEYS[0]], r.get(ROLLUP_KEYS[1]), g,
                            r[f"{ROLLUP_VALUE}_sum"]))
        else:
            out.append((None, None, g, pc.sum(j[ROLLUP_VALUE]).as_py()))
    return sorted(out, key=repr)


def bloom_build_keys(item: pa.Table) -> pa.Table:
    return item.filter(pc.equal(item["i_category"], BLOOM_CATEGORY)) \
        .select(["i_item_sk"])


CLUSTERING_PARTS = ("bloom", "z", "hilbert", "z3")


def clustering(tables: Dict[str, pa.Table], device, part: str,
               timed=None) -> dict:
    """One part of steps 7-8 on ``device``: ``"bloom"`` (the filter's bits
    at the session's default size and ``BLOOM_HASHES`` hashes over the
    Music items' keys, and its mask over every ``ss_item_sk``), ``"z"``
    and ``"hilbert"`` (the orders over ``Z_KEYS``) or ``"z3"`` (the Z-curve
    of ``Z3_KEYS``). ``timed(name, fn)`` times each call."""
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exec import bloom as BL
    from spark_rapids_tpu_torch.exec import zorder as Z

    timed = timed or (lambda name, fn: fn())
    if part == "bloom":
        n_bits = BL.default_bits()
        bb = batch_from_arrow(bloom_build_keys(tables[DIM]), device)
        pb = batch_from_arrow(tables[FACT].select(["ss_item_sk"]), device)
        bits = timed("bloom_build", lambda: BL.build_bloom_filter(
            bb, (0,), n_bits, BLOOM_HASHES))
        return {"bits": bits, "mask": timed("bloom_probe", lambda:
                                            BL.might_contain(
                                                pb, (0,), bits, n_bits,
                                                BLOOM_HASHES))}
    zb = batch_from_arrow(tables[FACT].select(list(Z3_KEYS)), device)
    if part == "z3":
        return {"z3": timed("interleave_3", lambda: Z.interleave_bits(
            zb, (0, 1, 2)))}
    return {part: timed(f"zorder_{part}", lambda: Z.zorder_sort_indices(
        zb, (0, 1), part))}


def digest(t) -> str:
    """A tensor's dtype, shape and bytes, hashed: equal digests from two
    devices mean equal results, without moving them."""
    import hashlib

    a = t.detach().cpu().contiguous().numpy()
    h = hashlib.sha256(f"{a.dtype}{a.shape}".encode())
    h.update(a.tobytes())
    return h.hexdigest()


def run_pass(tables: Dict[str, pa.Table],
             parquet_paths: Dict[str, List[str]], work_dir: str,
             device=None, conf=None, batch_rows: int = 1 << 22,
             run_query=None, seed: int = 0) -> dict:
    """The whole pass on ``device``; ``tables`` are q3's in-memory TPC-DS
    tables (store_sales, item, date_dim) and ``parquet_paths`` their
    Parquet files (``bench/parquet_sales.write_tables``): the Iceberg
    table is made over store_sales' files, and its q3 reads the
    dimensions' files. ``run_query(name, df)`` runs each query
    (``df.to_arrow()`` by default) and returns its rows. Returns every
    step's outputs and host walls; the callers hold them against the
    plain reference and against the CPU."""
    import time

    import torch

    from spark_rapids_tpu_torch.bench import tpcds_queries as Q
    from spark_rapids_tpu_torch.columnar.batch import (
        batch_to_arrow, resolve_device)
    from spark_rapids_tpu_torch.delta.log import read_dv
    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
    from spark_rapids_tpu_torch.iceberg import IcebergTable
    from spark_rapids_tpu_torch.plan import from_arrow, read_parquet
    from spark_rapids_tpu_torch.plan.cache import CachedRelation
    from spark_rapids_tpu_torch.plan.ml import feature_matrix

    dev = resolve_device(device)
    run_query = run_query or (lambda name, df: df.to_arrow().to_pylist())
    out: dict = {"walls": {}}
    walls = out["walls"]

    def timed(name, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return r

    def frame(t):
        return from_arrow(t, conf, batch_rows=batch_rows, device=dev)

    # 1-2. the Delta tables
    delta = timed("delta_build", lambda: build_delta(
        tables, os.path.join(work_dir, "delta"), dev, seed))
    fact, item = delta["fact"], delta["item"]
    out["versions"], out["item_version"] = (delta["versions"],
                                            delta["item_version"])
    snaps = {}
    for v in range(len(delta["versions"])):
        snap = fact.log.snapshot(v)
        snaps[v] = {"num_records": snap.num_records,
                    "files": len(snap.files),
                    "dv_rows": sum(len(read_dv(fact.path, f.deletion_vector))
                                   for f in snap.files
                                   if f.deletion_vector)}
    out["snapshots"] = snaps
    v4, v5 = (fact.log.snapshot(4), fact.log.snapshot(5))
    out["files_rewritten"] = len({f.path for f in v4.files}
                                 - {f.path for f in v5.files})
    # 3. reads: q3 at version 5 with item at version 1, and at version 3
    fact5 = timed("delta_read_v5", fact.to_arrow)
    fact3 = fact.to_arrow(3)
    item1 = item.to_arrow()
    out["rows_read"] = {5: fact5.num_rows, 3: fact3.num_rows,
                        "item": item1.num_rows}
    out["item_records"] = item.log.snapshot().num_records
    dims = {n: t for n, t in tables.items() if n not in (FACT, DIM)}
    d5 = {FACT: frame(fact5), DIM: frame(item1),
          **{n: frame(t) for n, t in dims.items()}}
    d3 = {FACT: frame(fact3), DIM: frame(tables[DIM]),
          **{n: frame(t) for n, t in dims.items()}}
    out["q3_v5"] = timed("q3_v5", lambda: run_query(
        "q3_v5", Q.QUERIES["q3"](d5)))
    out["q3_v3"] = timed("q3_v3", lambda: run_query(
        "q3_v3", Q.QUERIES["q3"](d3)))
    out["frames_v5"] = d5
    # 4. Iceberg over the Parquet pass's store_sales files
    ice_root = os.path.join(work_dir, "iceberg")
    fact_files = parquet_paths[FACT]
    timed("iceberg_write", lambda: write_iceberg(ice_root, fact_files))
    ice = IcebergTable(ice_root)
    out["iceberg_files"] = ice.data_files()
    pred = E.LessThanOrEqual(
        E.col("ss_sold_date_sk"),
        E.lit(november_keys(tables["date_dim"], DELETE_YEAR)[-1]))

    def scan_counts(node):
        for b in node.execute_all():
            pass
        return {k: node.metrics[k].value
                for k in ("numRowGroups", "numPrunedRowGroups")}
    out["iceberg_scan"] = timed("iceberg_scan", lambda: scan_counts(
        ice.scan_exec(columns=["ss_sold_date_sk"], predicate=pred,
                      device=dev)))
    out["direct_scan"] = scan_counts(ParquetScanExec(
        fact_files, columns=["ss_sold_date_sk"], predicate=pred, device=dev))
    di = {n: read_parquet(parquet_paths[n], conf=conf, device=dev)
          for n in tables if n != FACT}
    di[FACT] = read_parquet(ice.data_files(), conf=conf, device=dev)
    out["q3_iceberg"] = timed("q3_iceberg", lambda: run_query(
        "q3_iceberg", Q.QUERIES["q3"](di)))
    # 5. the dataframe cache of a November filter
    ss_frame = frame(tables[FACT])
    nov = sorted(k for y in range(1998, 2003)
                 for k in november_keys(tables["date_dim"], y))
    nov_df = ss_frame.filter(_in("ss_sold_date_sk", nov))
    rel = timed("cache_build", lambda: CachedRelation.cache(
        nov_df.physical_plan(), device=dev))
    uncached = nov_df.to_arrow()

    def read(rel):
        return pa.concat_tables(batch_to_arrow(b, rel.output_schema)
                                for b in rel.execute_all())
    reads = [timed(f"cache_read_{i}", lambda: read(rel)) for i in (1, 2)]
    out["cache"] = {
        "bytes": rel.cached_bytes(), "arrow_bytes": uncached.nbytes,
        "rows": uncached.num_rows, "decode_ns": rel.metrics[
            "decodeTimeNs"].value,
        "equal": all(r.equals(uncached) for r in reads),
        "same_relation": CachedRelation.cache(
            nov_df.physical_plan(), device=dev) is rel}
    # 6. Expand: ROLLUP over store_sales joined with item
    j = ss_frame.join(frame(tables[DIM]), left_on="ss_item_sk",
                      right_on="i_item_sk").select(
        E.col(ROLLUP_KEYS[0]), E.col(ROLLUP_KEYS[1]), E.col(ROLLUP_VALUE))
    j.shuffle_partitions = 1
    jplan = j.physical_plan()
    exp_node, agg = rollup(jplan)

    def run_rollup():
        rows = [tuple(r.values()) for b in agg.execute_all()
                for r in batch_to_arrow(b, agg.output_schema).to_pylist()]
        return sorted(rows, key=repr)
    from spark_rapids_tpu_torch.plan.dataframe import finish_run
    try:
        out["rollup"] = timed("rollup", run_rollup)
    finally:
        finish_run(jplan, True)
    out["rollup_rows_in"] = exp_node.metrics["numOutputRows"].value
    out["rollup_partitions"] = jplan.num_partitions()
    # 7-8. the bloom filter over the Music items, probed by store_sales;
    # Z-order and Hilbert orders and the Z-curve of three keys
    outs = {part: clustering(tables, dev, part, timed)
            for part in CLUSTERING_PARTS}
    bits, mask = outs["bloom"]["bits"], outs["bloom"]["mask"]
    build = bloom_build_keys(tables[DIM])
    probe = tables[FACT]["ss_item_sk"]
    exact = np.isin(pc.fill_null(probe, -1).to_numpy(),
                    build["i_item_sk"].to_numpy())
    m = mask.cpu().numpy()
    out["bloom"] = {"bits": bits, "mask": mask, "num_bits": int(
                        bits.numel()),
                    "build_rows": build.num_rows,
                    "false_negatives": int((exact & ~m).sum()),
                    "members": int(exact.sum()),
                    "false_positive_share": float(
                        (m & ~exact).sum() / max(int((~exact).sum()), 1))}
    out["zorder"] = {k: outs[k][k] for k in ("z", "hilbert", "z3")}
    out["digests"] = {f"{part}.{k}": digest(v)
                      for part, o in outs.items() for k, v in o.items()}
    # 9. the ML handoff of a filtered store_sales
    ml_df = ss_frame.filter(E.GreaterThan(E.col("ss_quantity"),
                                          E.lit(float(DELETE_QUANTITY)))) \
        .select(*[E.col(c) for c in (*FEATURES, LABEL)])
    x, y = timed("feature_matrix", lambda: feature_matrix(
        ml_df, list(FEATURES), LABEL))
    host = ml_df.to_arrow()
    want = np.stack([pc.fill_null(host[c].cast(pa.float64()), np.nan)
                     .to_numpy().astype(np.float32)
                     for c in (*FEATURES, LABEL)], axis=1)
    got = torch.cat([x, y[:, None]], 1).cpu().numpy()
    out["ml"] = {"shape": tuple(x.shape), "device": x.device.type,
                 "equal": bool(np.array_equal(got, want, equal_nan=True))}
    return out
