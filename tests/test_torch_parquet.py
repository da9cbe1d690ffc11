"""The port's Parquet scan (``exec/scan.ParquetScanExec``, the CPU
engine's ``CpuParquetScanExec``, ``read_parquet``) held against the JAX
package on the same files, made from numpy seeds: the three reader types,
static row-group pruning (its three counts equal to the reference's device
path, for int, double, string, DATE, TIMESTAMP and DECIMAL literals), a
DataFrame over a file, nested columns read on both engines and a plan's
STRUCT output written back, the broadcast join chosen over four files,
the dynamic filters' dedupe by the reuse rewrite, the logical/device/CPU
triple, the types pyarrow reads from a file, string columns across chunks
with dictionaries of their own, and a raising query over Parquet leaving
nothing behind.

Tolerance: exact (rows compared as Python values).
"""

import datetime
import decimal
import glob
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.batch import batch_to_arrow as jax_to_arrow
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exec.scan import ParquetScanExec as JScan
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu.plan import read_parquet as jax_read_parquet
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec.base import DeviceExec
from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.plan import cpu as PCPU
from spark_rapids_tpu_torch.plan import from_arrow, read_parquet
from spark_rapids_tpu_torch.plan import logical as PL
from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

COUNTS = ("numRowGroups", "numPrunedRowGroups", "numDynPrunedRowGroups")
NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
JAX_NO_FASTPATH = {"spark.rapids.tpu.fastpath.enabled": "false",
                   "spark.rapids.tpu.plan.cache.enabled": "false"}


def run(node):
    out = []
    for p in range(node.num_partitions()):
        for b in node.execute(p):
            out.extend(batch_to_arrow(b, node.output_schema).to_pylist())
    return out


def jax_run(node):
    out = []
    for p in range(node.num_partitions()):
        for b in node.execute(p):
            out.extend(jax_to_arrow(b, node.output_schema).to_pylist())
    return out


def counts(node):
    return {k: node.metrics[k].value for k in COUNTS}


def _canon(rows):
    return sorted(rows, key=repr)


def _scan_files(tmp_path, seed=21):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(3):
        n = 100 + i * 10
        a = rng.integers(0, 50, n)
        s = [f"s{j % 7}" if j % 11 else None for j in range(n)]
        t = pa.table({"a": pa.array(a, pa.int64()),
                      "s": pa.array(s, pa.string())})
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(t, p, row_group_size=32)
        paths.append(p)
    return paths


@pytest.mark.parametrize("reader_type",
                         ["PERFILE", "MULTITHREADED", "COALESCING"])
def test_parquet_scan_reader_types_match_the_reference(tmp_path,
                                                       reader_type):
    paths = _scan_files(tmp_path)
    node = ParquetScanExec(paths, reader_type=reader_type,
                           target_batch_rows=64, device="cpu")
    got = run(node)
    exp = jax_run(JScan(paths, reader_type=reader_type,
                        target_batch_rows=64, min_bucket=16))
    assert got == exp
    assert len(got) == 330
    assert counts(node) == {"numRowGroups": 12, "numPrunedRowGroups": 0,
                            "numDynPrunedRowGroups": 0}
    # 64-row chunks: each its own upload, timed on the host
    assert node.metrics["numOutputBatches"].value == 6
    assert node.metrics["scanTimeNs"].value > 0
    assert node.metrics["uploadTimeNs"].value > 0


def test_parquet_scan_partitions_split_files_round_robin(tmp_path):
    paths = _scan_files(tmp_path)
    node = ParquetScanExec(paths, n_partitions=2, target_batch_rows=64,
                           device="cpu")
    assert node.num_partitions() == 2
    jnode = JScan(paths, n_partitions=2, target_batch_rows=64,
                  min_bucket=16)
    for p in range(2):
        got = [r for b in node.execute(p)
               for r in batch_to_arrow(b, node.output_schema).to_pylist()]
        exp = [r for b in jnode.execute(p)
               for r in jax_to_arrow(b, jnode.output_schema).to_pylist()]
        assert got == exp


def test_parquet_scan_pruning_matches_the_reference(tmp_path):
    t = pa.table({"a": pa.array(list(range(1000)), pa.int64())})
    p = str(tmp_path / "x.parquet")
    pq.write_table(t, p, row_group_size=100)
    node = ParquetScanExec([p], predicate=PE.col("a") > 899,
                           target_batch_rows=512, device="cpu")
    jnode = JScan([p], predicate=JE.col("a") > 899, target_batch_rows=512,
                  min_bucket=16)
    got = run(node)
    assert got == jax_run(jnode)
    # only the last row group is read; the filter itself comes later
    assert [r["a"] for r in got] == list(range(900, 1000))
    assert counts(node) == counts(jnode) == {
        "numRowGroups": 10, "numPrunedRowGroups": 9,
        "numDynPrunedRowGroups": 0}


def _typed_table():
    n = 400
    i = np.arange(n)
    base = datetime.datetime(2024, 1, 1)
    return pa.table({
        "i": pa.array(i, pa.int64()),
        "d": pa.array(i * 0.5, pa.float64()),
        "s": pa.array([f"k{j:04d}" for j in i]),
        "dt": pa.array([datetime.date(2020, 1, 1)
                        + datetime.timedelta(days=int(j)) for j in i],
                       pa.date32()),
        "ts": pa.array([base + datetime.timedelta(hours=int(j))
                        for j in i], pa.timestamp("us")),
        "ts_utc": pa.array([base + datetime.timedelta(hours=int(j))
                            for j in i], pa.timestamp("us", tz="UTC")),
        "dec": pa.array([decimal.Decimal(int(j)).scaleb(-2) for j in i],
                        pa.decimal128(9, 2)),
    })


def _typed_predicates(M):
    c, lit = M.col, M.lit
    return {
        "int_lt": M.LessThan(c("i"), lit(150)),
        "double_ge": M.GreaterThanOrEqual(c("d"), lit(120.0)),
        "string_eq": M.EqualTo(c("s"), lit("k0333")),
        "date_gt": M.GreaterThan(c("dt"), lit(datetime.date(2020, 9, 1))),
        "date_flipped": M.LessThan(lit(datetime.date(2020, 9, 1)),
                                   c("dt")),
        "timestamp_le": M.LessThanOrEqual(
            c("ts"), lit(datetime.datetime(2024, 1, 5))),
        # a zoned column's statistics are aware datetimes, which a naive
        # literal does not compare with: nothing is pruned, in both
        "timestamp_utc_le": M.LessThanOrEqual(
            c("ts_utc"), lit(datetime.datetime(2024, 1, 5))),
        "decimal_eq": M.EqualTo(c("dec"), lit(decimal.Decimal("2.50"))),
        "or_of_two": M.Or(M.LessThan(c("i"), lit(20)),
                          M.GreaterThan(c("i"), lit(380))),
    }


@pytest.mark.parametrize("case", sorted(_typed_predicates(PE)))
def test_typed_row_group_pruning_counts_equal_the_reference(tmp_path, case):
    """The literal's Python value against the footer statistics: the
    port's DATE and TIMESTAMP literals hold days and microseconds, the
    reference's the date and datetime; the counts are the same."""
    p = str(tmp_path / "typed.parquet")
    pq.write_table(_typed_table(), p, row_group_size=50)
    node = ParquetScanExec([p], predicate=_typed_predicates(PE)[case],
                           device="cpu")
    jnode = JScan([p], predicate=_typed_predicates(JE)[case],
                  min_bucket=16)
    got, exp = run(node), jax_run(jnode)
    assert counts(node) == counts(jnode)
    assert counts(node)["numRowGroups"] == 8
    assert got == exp
    assert (counts(node)["numPrunedRowGroups"] > 0) == (
        case != "timestamp_utc_le")


def test_pruning_off_reads_every_row_group(tmp_path):
    p = str(tmp_path / "typed.parquet")
    pq.write_table(_typed_table(), p, row_group_size=50)
    conf = RapidsConf(
        {"spark.rapids.gpu.sql.parquet.rowGroupPruning.enabled": "false"})
    node = ParquetScanExec([p], predicate=PE.col("i") < 10, device="cpu",
                           conf=conf)
    assert len(run(node)) == 400
    assert counts(node)["numPrunedRowGroups"] == 0


def test_parquet_dataframe_matches_the_reference(tmp_path):
    rng = np.random.default_rng(9)
    t = pa.table({"k": pa.array(rng.integers(0, 10, 300), pa.int64()),
                  "v": pa.array(rng.normal(size=300)),
                  "s": pa.array([f"x{int(i)}" for i in
                                 rng.integers(0, 5, 300)])})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p)
    got = (read_parquet(p, columns=["k", "v"], device="cpu")
           .filter(PE.EqualTo(PE.col("k"), PE.lit(3)))
           .agg(PE.Alias(PE.Count(), "n")).collect())
    exp = (jax_read_parquet(p, columns=["k", "v"])
           .filter(JE.col("k").eq(3)).agg(JE.Count().alias("n")).collect())
    assert got == exp == [{"n": sum(1 for k in t.column("k").to_pylist()
                                    if k == 3)}]


def _nested_table():
    return pa.table({
        "s": pa.array(
            [{"a": 1, "b": "x", "d": 1.5}, None,
             {"a": 3, "b": None, "d": -2.25}, {"a": None, "b": "w", "d": 0.0},
             {"a": 5, "b": "zz", "d": 9.75}],
            pa.struct([("a", pa.int64()), ("b", pa.string()),
                       ("d", pa.float64())])),
        "m": pa.array(
            [[(1, 10.5), (2, 20.5)], [], None, [(7, 70.0)],
             [(1, 11.0), (3, 33.0), (5, 55.0)]],
            pa.map_(pa.int64(), pa.float64())),
        "arr": pa.array([[1, 2, 3], [], [9], None, [4, 5]],
                        pa.list_(pa.int64())),
        "bin": pa.array([b"\x00a", None, b"", b"zz", b"\xff"], pa.binary()),
        "k": pa.array([2, 1, 3, 7, 1], pa.int64()),
        "v": pa.array([10, 20, 30, 40, 50], pa.int64()),
    })


@pytest.mark.parametrize("enabled", [True, False])
def test_nested_parquet_matches_the_reference(tmp_path, enabled):
    path = str(tmp_path / "nested.parquet")
    pq.write_table(_nested_table(), path)
    conf = RapidsConf({"spark.rapids.gpu.sql.enabled": enabled})
    df = read_parquet(path, conf=conf, device="cpu")
    assert ("!" in df.explain()) != enabled
    rows = df.select(
        PE.Alias(PE.GetStructField(PE.col("s"), "a"), "a"),
        PE.Alias(PE.Size(PE.col("m")), "sz"),
        PE.Alias(PE.ElementAt(PE.col("arr"), PE.lit(1)), "a1"),
        PE.col("bin"), PE.col("s"), PE.col("m"), PE.col("arr")).collect()
    jconf = JConf({"spark.rapids.tpu.sql.enabled": enabled})
    exp = jax_read_parquet(path, conf=jconf).select(
        JE.GetStructField(JE.col("s"), "a").alias("a"),
        JE.Size(JE.col("m")).alias("sz"),
        JE.ElementAt(JE.col("arr"), JE.lit(1)).alias("a1"),
        JE.col("bin"), JE.col("s"), JE.col("m"), JE.col("arr")).collect()
    assert rows == exp
    assert rows[0]["a"] == 1 and rows[0]["sz"] == 2
    assert rows[2] ["a"] == 3 and rows[2]["sz"] == -1


def test_nested_parquet_with_null_elements_runs_on_the_cpu_engine(tmp_path):
    """An array with a null element has no device layout: the planner
    reads the file's nested columns and keeps the scan and its readers on
    the CPU engine; the rows are the reference CPU engine's."""
    t = pa.table({"arr": pa.array([[1, None], [2], None, []],
                                  pa.list_(pa.int64())),
                  "k": pa.array([1, 2, 3, 4], pa.int64())})
    path = str(tmp_path / "nulls.parquet")
    pq.write_table(t, path)
    df = read_parquet(path, device="cpu").select(
        PE.Alias(PE.Size(PE.col("arr")), "n"), PE.col("k"))
    plan = df.explain()
    assert "element nulls in arrays are not on the device" in plan
    exp = jax_read_parquet(path, conf=JConf(
        {"spark.rapids.tpu.sql.enabled": False})).select(
        JE.Size(JE.col("arr")).alias("n"), JE.col("k")).collect()
    assert df.collect() == exp


def test_struct_output_written_back_matches_the_reference(tmp_path):
    from spark_rapids_tpu_torch.io import write_columnar

    df = from_arrow(_nested_table(), RapidsConf(), device="cpu").select(
        PE.Alias(PE.CreateNamedStruct(("k", "v"), PE.col("k"),
                                      PE.col("v")), "kv"))
    plan = df.physical_plan()
    stats = write_columnar(plan.execute_all(), plan.output_schema,
                           str(tmp_path / "out"))
    assert stats.num_files == 1 and stats.num_rows == 5
    back = pq.read_table(glob.glob(str(tmp_path / "out" / "*.parquet"))[0])
    jout = jax_from_arrow(_nested_table(), JConf({})).select(
        JE.CreateNamedStruct(("k", "v"), JE.col("k"),
                             JE.col("v")).alias("kv")).to_arrow()
    p = str(tmp_path / "ref.parquet")
    pq.write_table(jout, p)
    assert back.to_pylist() == pq.read_table(p).to_pylist()
    assert back.to_pylist()[0]["kv"] == {"k": 2, "v": 10}


def _fact_dim(tmp_path):
    fact = pa.table({"fk": pa.array(np.arange(5000) % 50, pa.int64()),
                     "v": pa.array(np.arange(5000), pa.int64())})
    dim = pa.table({"dk": pa.array(np.arange(50), pa.int64()),
                    "name": pa.array([f"d{i}" for i in range(50)])})
    paths = []
    for i in range(4):  # four files: a four-partition probe side
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(fact.slice(i * 1250, 1250), p)
        paths.append(p)
    return paths, dim


def test_broadcast_join_over_four_files_matches_the_reference(tmp_path):
    from spark_rapids_tpu_torch.exec.join_bcast import BroadcastHashJoinExec

    paths, dim = _fact_dim(tmp_path)
    conf = RapidsConf(NO_FASTPATH)
    df = read_parquet(paths, conf=conf, device="cpu").join(
        from_arrow(dim, conf, device="cpu"), left_on="fk", right_on="dk")
    node = df.physical_plan()
    found = []

    def walk(n):
        found.append(n)
        for c in n.children:
            walk(c)

    walk(node)
    assert any(isinstance(n, BroadcastHashJoinExec) for n in found)
    scan = next(n for n in found if isinstance(n, ParquetScanExec))
    assert scan.num_partitions() == 4
    rows = execute_to_arrow(node).to_pylist()
    jconf = JConf(JAX_NO_FASTPATH)
    exp = jax_read_parquet(paths, conf=jconf).join(
        jax_from_arrow(dim, jconf), left_on="fk", right_on="dk").collect()
    assert len(rows) == 5000
    assert _canon(rows) == _canon(exp)
    # every key of the files is a dimension key: nothing pruned
    assert counts(scan) == {"numRowGroups": 4, "numPrunedRowGroups": 0,
                            "numDynPrunedRowGroups": 0}


def test_dpp_subquery_dedupe(tmp_path):
    """Equal (build, key, column) pruning filters on two scans merge into
    one object, so the key set is collected once."""
    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.exec.dpp import DynamicPruningFilter
    from spark_rapids_tpu_torch.exec.misc import UnionExec
    from spark_rapids_tpu_torch.plan import reuse as PR

    t = pa.table({"k": pa.array(np.arange(100) % 7, pa.int64())})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path)
    conf = RapidsConf(NO_FASTPATH)

    def build():
        return from_arrow(t, conf, device="cpu").select(
            PE.col("k")).physical_plan()

    scans = []
    for _ in range(2):
        s = ParquetScanExec([path], device="cpu")
        s.dynamic_filters = [DynamicPruningFilter(build(), 0, "k")]
        scans.append(s)
    root = UnionExec(scans[0].output_schema, *scans)
    R.reset_counters()
    PR.apply_reuse(root, conf)
    assert scans[1].dynamic_filters[0] is scans[0].dynamic_filters[0]
    assert R.counters()["reuse_subqueries_total"] >= 1


def test_the_logical_device_and_cpu_scan_triple():
    """The converter builds the device scan and its CPU twin from the
    logical node, with one execution surface."""
    from spark_rapids_tpu.exec import ParquetScanExec as JX
    from spark_rapids_tpu.plan import cpu as JPC
    from spark_rapids_tpu.plan import logical as JL

    for cls in (ParquetScanExec, PCPU.CpuParquetScanExec):
        for attr in ("output_schema", "num_partitions", "execute",
                     "explain", "node_description"):
            assert hasattr(cls, attr), (cls, attr)
        assert issubclass(cls, DeviceExec)
    assert issubclass(PCPU.CpuParquetScanExec, PCPU.CpuExec)
    assert not issubclass(ParquetScanExec, PCPU.CpuExec)
    assert issubclass(JPC.CpuParquetScanExec, JPC.CpuExec)
    assert not issubclass(JX, JPC.CpuExec)
    import dataclasses

    # the reference's fields, then the port's device
    assert [f.name for f in dataclasses.fields(PL.ParquetScan)] == [
        f.name for f in dataclasses.fields(JL.ParquetScan)] + ["device"]


@pytest.mark.parametrize("enabled", [True, False])
def test_the_converter_places_the_scan_by_the_conf(tmp_path, enabled):
    paths = _scan_files(tmp_path)
    conf = RapidsConf({"spark.rapids.gpu.sql.enabled": enabled})
    node = read_parquet(paths, conf=conf, device="cpu").physical_plan()
    want = ParquetScanExec if enabled else PCPU.CpuParquetScanExec
    while not isinstance(node, want):
        node = node.children[0]
    assert node.num_partitions() == 1  # the fast path: 330 rows
    exp = jax_read_parquet(paths, conf=JConf(
        {"spark.rapids.tpu.sql.enabled": enabled})).collect()
    got = read_parquet(paths, conf=conf, device="cpu").collect()
    assert _canon(got) == _canon(exp)


def test_file_types_read_as_the_reference_reads_them(tmp_path):
    """What pyarrow writes to a file: timestamps in ns and us, date32,
    decimals of precision <= 18 and > 18, large strings and binaries."""
    n = 50
    i = np.arange(n)
    base = datetime.datetime(2023, 3, 1, 12)
    t = pa.table({
        "ts_ns": pa.array([base + datetime.timedelta(seconds=int(j))
                           for j in i], pa.timestamp("ns")),
        "ts_us": pa.array([base + datetime.timedelta(minutes=int(j))
                           for j in i], pa.timestamp("us")),
        "d": pa.array([datetime.date(2001, 1, 1)
                       + datetime.timedelta(days=int(j)) for j in i],
                      pa.date32()),
        "dec18": pa.array([decimal.Decimal(int(j) * 1000003).scaleb(-4)
                           if j % 9 else None for j in i],
                          pa.decimal128(18, 4)),
        "dec30": pa.array([decimal.Decimal(int(j) * 10 ** 20 + 7).scaleb(-3)
                           for j in i], pa.decimal128(30, 3)),
        "ls": pa.array([f"v{j % 5}" if j % 4 else None for j in i],
                       pa.large_string()),
        "lb": pa.array([bytes([j % 256]) * (j % 3) for j in i],
                       pa.large_binary()),
    })
    p = str(tmp_path / "types.parquet")
    pq.write_table(t, p, row_group_size=16)
    node = ParquetScanExec([p], target_batch_rows=20, device="cpu")
    got = pa.Table.from_pylist(run(node), node.output_schema.to_arrow())
    exp = pq.read_table(p)
    for name in t.column_names:
        g, e = got.column(name), exp.column(name)
        if pa.types.is_timestamp(e.type):
            e = e.cast(pa.timestamp("us")).cast(pa.int64())
            g = g.cast(pa.int64())
        else:
            e = e.cast(g.type)
        assert g.to_pylist() == e.to_pylist(), name
    # the columns the reference's scan carries, value for value
    cols = ["d", "dec18", "ls"]
    jgot = jax_run(JScan([p], columns=cols, target_batch_rows=20,
                         min_bucket=16))
    assert [{c: r[c] for c in cols} for r in run(ParquetScanExec(
        [p], columns=cols, target_batch_rows=20, device="cpu"))] == jgot


def _string_files(tmp_path, seed=5):
    """Three files of several row groups; each 100-row chunk uploads with
    its own sorted dictionary, so chunks do not share codes."""
    rng = np.random.default_rng(seed)
    paths = []
    for f in range(3):
        n = 400
        t = pa.table({
            "s": pa.array([f"s{int(v)}" for v in rng.integers(0, 12, n)]),
            "g": pa.array([f"g{int(v)}" if v else None
                           for v in rng.integers(0, 6, n)]),
            "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
        p = str(tmp_path / f"s{f}.parquet")
        pq.write_table(t, p, row_group_size=70)
        paths.append(p)
    dim = pa.table({"s": pa.array([f"s{i}" for i in range(0, 12, 2)]),
                    "w": pa.array(np.arange(6), pa.int64())})
    return paths, dim


def _string_queries(M, f, d, Ord):
    return {
        "group": f.group_by("s", "g").agg(M.Sum(M.col("v")).alias("t"),
                                          M.Count().alias("n")),
        "join": f.join(d, on="s").select("s", "g", "v", "w"),
        "sort": f.sort(Ord(M.col("g")), Ord(M.col("s")), Ord(M.col("v"))),
        "distinct": f.group_by("g").agg(),
    }


@pytest.mark.parametrize("q", ["group", "join", "sort", "distinct"])
@pytest.mark.parametrize("fastpath", [True, False])
def test_string_columns_across_chunk_dictionaries(tmp_path, q, fastpath):
    from spark_rapids_tpu.exec.sort import SortOrder as JOrd
    from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd

    paths, dim = _string_files(tmp_path)
    conf = RapidsConf({} if fastpath else NO_FASTPATH)
    pf = read_parquet(paths, conf=conf, device="cpu")
    pd_ = from_arrow(dim, conf, device="cpu")
    jconf = JConf({"spark.rapids.tpu.plan.cache.enabled": "false"}
                  if fastpath else JAX_NO_FASTPATH)
    jf = jax_read_parquet(paths, conf=jconf)
    jd = jax_from_arrow(dim, jconf)
    got = _string_queries(PE, pf, pd_, POrd)[q].collect()
    exp = _string_queries(JE, jf, jd, JOrd)[q].collect()
    if q == "sort":
        assert got == exp
    else:
        assert _canon(got) == _canon(exp)


def _shuffle_files():
    from spark_rapids_tpu_torch.shuffle.manager import get_manager

    d = get_manager(RapidsConf(NO_FASTPATH))._local_dir
    return sorted(os.listdir(d)) if d and os.path.isdir(d) else []


def test_a_raising_query_over_parquet_leaves_nothing_behind(tmp_path):
    """An ANSI cast of 'x' over four files (the fast path off): the query
    raises, and no shuffle file, scan thread or pool byte is left."""
    from spark_rapids_tpu_torch.mem.pool import get_pool

    n = 4000
    vals = [str(i % 97) for i in range(n)]
    vals[n // 2] = "x"
    t = pa.table({"k": pa.array([i % 13 for i in range(n)], pa.int64()),
                  "s": pa.array(vals)})
    paths = []
    for i in range(4):
        p = str(tmp_path / f"r{i}.parquet")
        pq.write_table(t.slice(i * 1000, 1000), p, row_group_size=250)
        paths.append(p)
    before = _shuffle_files()
    threads = {th.name for th in threading.enumerate()}
    df = read_parquet(paths, conf=RapidsConf(NO_FASTPATH), device="cpu")
    q = df.select(PE.col("k"), PE.Alias(
        PE.Cast(PE.col("s"), PT.INT, ansi=True), "i")).group_by("k").agg(
        PE.Alias(PE.Sum(PE.col("i")), "t"))
    plan = q.physical_plan()
    assert "HashPartitioner(4)" in plan.explain()
    with pytest.raises(ValueError, match="'x'"):
        execute_to_arrow(plan)
    assert cleaner.sweep() == []
    assert _shuffle_files() == before
    assert get_pool(device="cpu").used == 0
    left = {th.name for th in threading.enumerate()} - threads
    assert not [n for n in left if n.startswith(("srgpu-scan",
                                                 "srgpu-prefetch",
                                                 "srgpu-pq-meta"))], left


@pytest.mark.parametrize("name", [
    "PATHS_TO_REPLACE", "DPP_ENABLED", "DPP_MAX_KEYS",
    "SCAN_ROW_GROUP_PRUNING", "SCAN_COMBINE_WINDOW", "SCAN_METADATA_THREADS",
    "FILECACHE_MAX_BYTES", "WRITER_ASYNC_MAX_IN_FLIGHT"])
def test_file_input_keys_have_the_references_defaults_and_are_read(name):
    """Each file-input key the port declares has the reference's default
    and is read outside ``conf.py``. The reference's reader type, reader
    threads and file cache switch, which nothing there reads, are not
    declared (ROADMAP queue 3)."""
    import re

    from spark_rapids_tpu.config import conf as JC
    from spark_rapids_tpu_torch.config import conf as C

    assert getattr(C, name).default == getattr(JC, name).default
    for unread in ("PARQUET_READER_TYPE", "PARQUET_READER_THREADS",
                   "FILECACHE_ENABLED"):
        assert hasattr(JC, unread) and not hasattr(C, unread)
    pkg = os.path.dirname(os.path.dirname(C.__file__))
    readers = []
    for d, _, fs in os.walk(pkg):
        for f in fs:
            if f.endswith(".py") and f != "conf.py":
                with open(os.path.join(d, f)) as fh:
                    if re.search(rf"\b{name}\b", fh.read()):
                        readers.append(f)
    assert readers, name


def test_the_schema_is_the_first_files(tmp_path):
    """The scan's schema is the first file's, as in the reference: a
    later file's int32 column is read as the first file's int64, on both
    of the port's engines and on the reference's device path. The
    reference's CPU engine concatenates the files' tables uncast and
    raises (ROADMAP queue 3)."""
    import pyarrow.lib

    p1, p2 = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"x": pa.array([1, 2], pa.int64())}), p1)
    pq.write_table(pa.table({"x": pa.array([3], pa.int32())}), p2)
    exp = jax_read_parquet([p1, p2], conf=JConf(
        {"spark.rapids.tpu.plan.cache.enabled": "false"})).collect()
    assert _canon(exp) == [{"x": 1}, {"x": 2}, {"x": 3}]
    for enabled in (True, False):
        df = read_parquet([p1, p2], conf=RapidsConf(
            {"spark.rapids.gpu.sql.enabled": enabled}), device="cpu")
        assert df.schema.fields[0].dtype == PT.LONG
        got = df.to_arrow()
        assert got.schema.field("x").type == pa.int64()
        assert _canon(got.to_pylist()) == _canon(exp)
    with pytest.raises(pyarrow.lib.ArrowInvalid, match="Schema"):
        jax_read_parquet([p1, p2], conf=JConf(
            {"spark.rapids.tpu.sql.enabled": False,
             "spark.rapids.tpu.plan.cache.enabled": "false"})).collect()


def test_the_fast_path_counts_bytes_on_disk(tmp_path):
    """A Parquet leaf counts its files' sizes on disk, an in-memory table
    its Arrow bytes, as in the reference: 20,000 equal int64 values are
    160,000 bytes in memory and a few hundred on disk, so under a 50,000
    byte bound the file plans one partition and the table its splits;
    both shapes are the reference's."""
    from spark_rapids_tpu.plan.overrides import Overrides as JOverrides
    from spark_rapids_tpu_torch.plan.overrides import Overrides

    t = pa.table({"k": pa.array(np.zeros(20_000, np.int64))})
    paths = []
    for i in range(4):
        p = str(tmp_path / f"z{i}.parquet")
        pq.write_table(t.slice(i * 5000, 5000), p)
        paths.append(p)
    conf = RapidsConf({"spark.rapids.gpu.fastpath.maxBytes": 50_000})
    jconf = JConf({"spark.rapids.tpu.fastpath.maxBytes": 50_000,
                   "spark.rapids.tpu.plan.cache.enabled": "false"})
    on_disk = read_parquet(paths, conf=conf, device="cpu").plan
    in_memory = from_arrow(t, conf, batch_rows=5000, device="cpu",
                           partitions=4).plan
    assert Overrides(conf)._fastpath_eligible(on_disk)
    assert not Overrides(conf)._fastpath_eligible(in_memory)
    assert JOverrides(jconf)._fastpath_eligible(
        jax_read_parquet(paths, conf=jconf).plan)
    assert not JOverrides(jconf)._fastpath_eligible(
        jax_from_arrow(t, jconf, batch_rows=5000, partitions=4).plan)
    agg = [df.group_by("k").agg(PE.Alias(PE.Count(), "n"))
           for df in (read_parquet(paths, conf=conf, device="cpu"),
                      from_arrow(t, conf, batch_rows=5000, device="cpu",
                                 partitions=4))]
    assert "HashPartitioner" not in agg[0].physical_plan().explain()
    assert "HashPartitioner(4)" in agg[1].physical_plan().explain()
    assert agg[0].collect() == agg[1].collect() == [{"k": 0, "n": 20_000}]


def test_paths_are_rewritten_before_the_fast_path_is_decided(tmp_path):
    """The port rewrites scan paths before it reads a footer, so a
    rewritten path can take the fast path; the reference decides the fast
    path on the raw path first, fails to read it and plans without it."""
    from spark_rapids_tpu.io.paths import PATHS_TO_REPLACE as JKEY
    from spark_rapids_tpu.plan.overrides import Overrides as JOverrides
    from spark_rapids_tpu_torch.io.paths import PATHS_TO_REPLACE
    from spark_rapids_tpu_torch.plan.overrides import (
        Overrides, apply_path_rules)

    real = tmp_path / "real"
    real.mkdir()
    pq.write_table(pa.table({"x": pa.array([1, 2, 3], pa.int64())}),
                   real / "f.parquet")
    conf = RapidsConf({PATHS_TO_REPLACE.key: f"fake://t->{real}"})
    plan = read_parquet("fake://t/f.parquet", conf=conf, device="cpu").plan
    assert Overrides(conf)._fastpath_eligible(apply_path_rules(plan, conf))
    jconf = JConf({JKEY.key: f"fake://t->{real}"})
    assert not JOverrides(jconf)._fastpath_eligible(
        jax_read_parquet("fake://t/f.parquet", conf=jconf).plan)
