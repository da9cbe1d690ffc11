"""Partitioned execution of the port (source splits, partial/final
aggregates, the shuffle exchange, broadcast and shuffled joins) on the
CPU:

- plan shape: for a dozen small DataFrames, the port's physical tree as
  (operator kind, partitioner kind, partition count) equals the JAX
  package's, both with 4 source splits, 4 shuffle partitions and the fast
  path off: once with AQE, exchange reuse and prefetch off on both sides
  (the plain shape), once with them at their defaults on both (the
  reference's dynamic partition pruning, fusion, streaming windows and
  plan cache off: the port has none);
- TPC-H Q1/Q3/Q5/Q6 at SF 0.01 with 4 splits against the JAX package's
  device path with 4 splits;
- all 99 TPC-DS queries at SF 0.01 with 4 splits and 4 shuffle
  partitions against the port's own one-partition rows (which the other
  TPC-DS tests hold against the reference), under the equivalence bar
  (``check_rows``: rel 1e-6 on doubles, everything else exact, ORDER BY
  order, the last tie group of a LIMIT by its keys and size);
- edge cases: empty splits and empty reduce partitions, shuffled joins on
  a string key, writer threads 1 against 4, a CPU-engine node over a
  4-split device child, the partition numbering of a union, and a join
  whose sides' partition counts differ raising.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.bench import tpch as JTPCH
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exec.sort import SortOrder as JOrd
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS
from spark_rapids_tpu_torch.bench import tpch as PTPCH
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.base import BatchSourceExec
from spark_rapids_tpu_torch.exec.join import HashJoinExec
from spark_rapids_tpu_torch.exec.misc import UnionExec
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import window as PW
from spark_rapids_tpu_torch.plan import cpu as PCPU
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
from spark_rapids_tpu_torch.shuffle.exchange_exec import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.partition import SinglePartitioner

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
# AQE, exchange reuse, prefetch and streaming windows off: the plain plan
# shape
PLAIN = {"spark.rapids.gpu.sql.adaptive.enabled": "false",
         "spark.rapids.gpu.sql.exchange.reuse.enabled": "false",
         "spark.rapids.gpu.sql.prefetch.enabled": "false",
         "spark.rapids.gpu.sql.window.streaming.enabled": "false"}
# the reference with the plan features the port does not have turned off
JAX_DEFAULTS = {
    "spark.rapids.tpu.fastpath.enabled": "false",
    "spark.rapids.tpu.sql.dynamicPartitionPruning.enabled": "false",
    "spark.rapids.tpu.sql.fusion.enabled": "false",
    "spark.rapids.tpu.plan.cache.enabled": "false"}
# ... and AQE, exchange reuse, prefetch and streaming windows off too
JAX_PLAIN = dict(JAX_DEFAULTS, **{
    "spark.rapids.tpu.sql.adaptive.enabled": "false",
    "spark.rapids.tpu.sql.exchange.reuse.enabled": "false",
    "spark.rapids.tpu.sql.prefetch.enabled": "false",
    "spark.rapids.tpu.sql.window.streaming.enabled": "false"})
BCAST = 1000  # broadcastRowThreshold of the plan-shape cases


# ---------------------------------------------------------------------------
# plan shape against the reference
# ---------------------------------------------------------------------------


def _facts(n=4000, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 60, n), pa.int64()),
        "v": pa.array(rng.integers(-500, 500, n), pa.int64()),
        "x": pa.array(rng.normal(0, 10, n)),
        "s": pa.array([f"s{int(i)}" for i in rng.integers(0, 30, n)]),
    })


def _dims(n, seed=2):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(np.arange(n) % 60, pa.int64()),
                     "w": pa.array(rng.integers(0, 9, n), pa.int64())})


def _shape_cases():
    """name -> builder(M, f, small, big) of one DataFrame, where M is the
    package's (expr, window, SortOrder) and f/small/big its DataFrames."""

    def win(M, f, key):
        E, W, Ord = M
        spec = W.WindowSpec((key,), (Ord(E.col("v")),))
        return f.with_window(E.Alias(W.WindowExpression(W.Rank(), spec),
                                     "r"))

    cases = {
        "agg_keyed": lambda M, f, s, b: f.group_by("k").agg(
            M[0].Sum(M[0].col("v")).alias("sv")),
        "agg_global": lambda M, f, s, b: f.agg(
            M[0].Sum(M[0].col("v")).alias("sv"), M[0].Count().alias("n")),
        "agg_string_key": lambda M, f, s, b: f.group_by("s").agg(
            M[0].Count().alias("n")),
        "window_column_key": lambda M, f, s, b: win(M, f, M[0].col("k")),
        "window_expression_key": lambda M, f, s, b: win(
            M, f, M[0].Add(M[0].col("k"), M[0].lit(1))),
        "sort_numeric": lambda M, f, s, b: f.sort(M[2](M[0].col("v"))),
        "sort_string": lambda M, f, s, b: f.sort(M[2](M[0].col("s"))),
        "sort_two_keys": lambda M, f, s, b: f.sort(M[2](M[0].col("k")),
                                                   M[2](M[0].col("v"))),
        "sort_limit": lambda M, f, s, b: f.sort(M[2](M[0].col("v")),
                                                limit=25),
        "union": lambda M, f, s, b: f.select("k").union(
            s.select("k")).group_by("k").agg(M[0].Count().alias("n")),
    }
    for how in ("inner", "left", "right", "full", "left_semi", "left_anti"):
        cases[f"join_{how}_small"] = (
            lambda M, f, s, b, how=how: f.join(s, on="k", how=how))
        cases[f"join_{how}_big"] = (
            lambda M, f, s, b, how=how: f.join(b, on="k", how=how))
    return cases


SHAPES = _shape_cases()


def plan_shape(node):
    """(kind, detail) of every operator of a physical tree, depth first;
    projections and filters are left out (the reference folds a filter
    into a partial aggregate). Counts nothing that would write an
    exchange: a union's partition count is read as the planner reads
    it."""
    from spark_rapids_tpu.shuffle.aqe import planning_scope as jscope
    from spark_rapids_tpu_torch.shuffle.aqe import planning_scope as pscope

    out = []

    def walk(n, depth):
        name = type(n).__name__
        kind = None
        if name in ("BatchSourceExec", "ParquetScanExec"):
            kind = ("scan", n.num_partitions())
        elif name == "HashAggregateExec":
            kind = ("aggregate", n.mode)
        elif name == "ShuffleExchangeExec":
            kind = ("exchange", type(n.partitioner).__name__,
                    n.partitioner.num_partitions)
        elif name in ("BroadcastHashJoinExec", "HashJoinExec"):
            kind = (name, n.join_type)
        elif name in ("SortExec", "WindowExec", "LocalLimitExec",
                      "GlobalLimitExec", "_Gather", "CoalesceBatchesExec",
                      "AQEShuffleReadExec", "SkewAwareShuffleReadExec",
                      "PrefetchExec", "ReplayExec", "ReusedExchangeExec",
                      "ReusedBroadcastExec"):
            kind = (name,)
        elif name == "UnionExec":
            with jscope(), pscope():
                kind = ("union", n.num_partitions())
        elif name not in ("ProjectExec", "FilterExec"):
            raise AssertionError(f"unexpected operator {name}")
        if kind is not None:
            out.append((depth,) + kind)
            depth += 1
        for c in n.children:
            walk(c, depth)

    walk(node, 0)
    return out


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_shape_matches_the_reference(case):
    _check_plan_shape(case, dict(NO_FASTPATH, **PLAIN), JAX_PLAIN)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_shape_matches_the_reference_at_the_defaults(case):
    """AQE readers, skew-paired readers, replayed broadcast builds,
    prefetch boundaries and streaming windows over out-of-core sorts
    where the reference's planner places them."""
    jax_conf = JAX_DEFAULTS
    if case == "window_expression_key":
        # the reference streams this window over an out-of-core sort of
        # the expression key, which its sort cannot run (a reference
        # fault, tests/test_torch_oversized.py::
        # test_reference_streams_a_window_its_sort_cannot_run); the port
        # keeps the reference's single-batch plan there
        jax_conf = dict(JAX_DEFAULTS, **{
            "spark.rapids.tpu.sql.window.streaming.enabled": "false"})
    _check_plan_shape(case, NO_FASTPATH, jax_conf)


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_plan_shape_over_parquet_matches_the_reference_at_the_defaults(
        case, tmp_path):
    """The fact table read from four Parquet files (four scan partitions)
    instead of four in-memory splits, dynamic partition pruning on in
    both planners: the same operators where the reference places them,
    the same scans given a dynamic filter, and the rows of the in-memory
    plan."""
    import pyarrow.parquet as pqw

    from spark_rapids_tpu.plan import read_parquet as jax_read_parquet
    from spark_rapids_tpu_torch.plan import read_parquet

    f, small, big = _facts(), _dims(200), _dims(3000, 3)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"f{i}.parquet")
        pqw.write_table(f.slice(i * 1000, 1000), p, row_group_size=250)
        paths.append(p)
    pconf = RapidsConf(dict(NO_FASTPATH, **{
        "spark.rapids.gpu.sql.join.broadcastRowThreshold": BCAST}))
    jax_conf = dict(JAX_DEFAULTS, **{
        "spark.rapids.tpu.sql.dynamicPartitionPruning.enabled": "true",
        "spark.rapids.tpu.sql.join.broadcastRowThreshold": BCAST})
    if case == "window_expression_key":  # as in the in-memory test
        jax_conf["spark.rapids.tpu.sql.window.streaming.enabled"] = "false"
    jconf = JConf(jax_conf)
    pdf = [read_parquet(paths, conf=pconf, device="cpu")] + [
        port_from_arrow(t, pconf, batch_rows=500, device="cpu",
                        partitions=4) for t in (small, big)]
    jdf = [jax_read_parquet(paths, conf=jconf)] + [
        jax_from_arrow(t, jconf, batch_rows=500, partitions=4)
        for t in (small, big)]
    pq_ = SHAPES[case]((PE, PW, POrd), *pdf)
    jq = SHAPES[case]((JE, JW, JOrd), *jdf)
    pplan, jplan = pq_.physical_plan(), jq.physical_plan()
    got = plan_shape(pplan)
    assert got == plan_shape(jplan)
    assert any(k[1:] == ("scan", 4) for k in got)
    assert _dpp_scans(pplan) == _dpp_scans(jplan)
    one = [port_from_arrow(t, RapidsConf(), batch_rows=500, device="cpu")
           for t in (f, small, big)]
    exp = SHAPES[case]((PE, PW, POrd), *one).collect()
    rows = execute_to_arrow(pplan).to_pylist()
    if case == "sort_limit":
        assert [r["v"] for r in rows] == [r["v"] for r in exp]
        return
    assert PTPCH.rows_match(_canon(rows), _canon(exp))


def _dpp_scans(node):
    """The dynamic filters of each Parquet scan, as (column, key index),
    depth first."""
    out = []
    if type(node).__name__ == "ParquetScanExec":
        out.append(tuple((f.column, f.key_index)
                         for f in node.dynamic_filters))
    for c in node.children:
        out.extend(_dpp_scans(c))
    return out


def _check_plan_shape(case, port_conf, jax_conf):
    f, small, big = _facts(), _dims(200), _dims(3000, 3)
    pconf = RapidsConf(dict(port_conf, **{
        "spark.rapids.gpu.sql.join.broadcastRowThreshold": BCAST}))
    jconf = JConf(dict(jax_conf, **{
        "spark.rapids.tpu.sql.join.broadcastRowThreshold": BCAST}))
    pdf = [port_from_arrow(t, pconf, batch_rows=500, device="cpu",
                           partitions=4) for t in (f, small, big)]
    jdf = [jax_from_arrow(t, jconf, batch_rows=500, partitions=4)
           for t in (f, small, big)]
    pq = SHAPES[case]((PE, PW, POrd), *pdf)
    jq = SHAPES[case]((JE, JW, JOrd), *jdf)
    got = plan_shape(pq.physical_plan())
    assert got == plan_shape(jq.physical_plan())
    assert any(k[1] in ("exchange", "BroadcastHashJoinExec", "_Gather")
               for k in got)
    # the partitioned rows are the one-partition rows
    one = [port_from_arrow(t, RapidsConf(), batch_rows=500, device="cpu")
           for t in (f, small, big)]
    exp = SHAPES[case]((PE, PW, POrd), *one).collect()
    rows = pq.collect()
    if case.startswith("sort_") and case != "sort_limit":
        key = "s" if case == "sort_string" else "k" if "two" in case else "v"
        assert [r[key] for r in rows] == [r[key] for r in exp]
    if case == "sort_limit":
        assert [r["v"] for r in rows] == [r["v"] for r in exp]
        return
    assert PTPCH.rows_match(_canon(rows), _canon(exp))


def _canon(rows):
    return sorted(rows, key=lambda r: repr(sorted(
        (k, repr(v)) for k, v in r.items())))


# ---------------------------------------------------------------------------
# TPC-H against the reference's device path
# ---------------------------------------------------------------------------

_TPCH = {}


def _tpch_tables():
    if "t" not in _TPCH:
        _TPCH["t"] = PTPCH.tables_for(0.01, seed=7)
    return _TPCH["t"]


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6"])
def test_tpch_four_splits_match_the_reference(q):
    t = _tpch_tables()
    jd = JTPCH.df_tables(t, JConf(JAX_PLAIN), shuffle_partitions=4,
                         partitions=4, batch_rows=4096)
    exp = JTPCH.DF_QUERIES[q](jd).to_arrow().to_pylist()
    d = PTPCH.df_tables(t, RapidsConf(NO_FASTPATH), batch_rows=4096,
                        device="cpu", partitions=4, shuffle_partitions=4)
    df = PTPCH.DF_QUERIES[q](d)
    plan = df.physical_plan()
    got = execute_to_arrow(plan).to_pylist()
    assert len(got) == len(exp) and len(got) > 0
    assert PTPCH.rows_match(got, exp)
    order = {"q1": ("l_returnflag", "l_linestatus"), "q3": ("l_orderkey",),
             "q5": ("n_name",), "q6": ()}[q]
    assert ([tuple(r[k] for k in order) for r in got]
            == [tuple(r[k] for k in order) for r in exp])
    ops = [type(n).__name__ for n in _walk(plan)]
    assert "ShuffleExchangeExec" in ops or "BroadcastHashJoinExec" in ops


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


# ---------------------------------------------------------------------------
# all 99 TPC-DS queries: 4 splits against one partition
# ---------------------------------------------------------------------------

_DS = {}


def _ds_tables():
    if "t" not in _DS:
        _DS["t"] = PS.tables_for(0.01, names=PS.ALL_TABLES)
    return _DS["t"]


@pytest.mark.parametrize("q", sorted(PQ.QUERIES, key=lambda s: int(s[1:])))
def test_tpcds_four_splits_match_one_partition(q):
    t = _ds_tables()
    # 2048-row batches: every fact table has at least four at SF 0.01
    one = PQ.df_tables(t, batch_rows=2048, device="cpu", partitions=1,
                       shuffle_partitions=1)
    exp = PQ.QUERIES[q](one).to_arrow().to_pylist()
    four = PQ.df_tables(t, RapidsConf(NO_FASTPATH), batch_rows=2048,
                        device="cpu", partitions=4, shuffle_partitions=4)
    df = PQ.QUERIES[q](four)
    assert "!" not in df.explain()
    plan = df.physical_plan()
    got = execute_to_arrow(plan).to_pylist()
    ok, why = PQ.check_rows(q, got, exp)
    assert ok, why
    for n in _walk(plan):  # every scan in min(4, batches) source splits
        if isinstance(n, BatchSourceExec):
            rows = sum(b.num_rows for part in n._parts for b in part)
            assert n.num_partitions() == min(4, max(1, -(-rows // 2048)))


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------


def _four(t, conf=None, **kw):
    return port_from_arrow(t, RapidsConf(dict(NO_FASTPATH, **(conf or {}))),
                           batch_rows=500, device="cpu", partitions=4, **kw)


def test_empty_splits_and_empty_reduce_partitions():
    f, s = _facts(), _dims(200)
    none = PE.LessThan(PE.col("v"), PE.lit(-10**6))
    empty = _four(f).filter(none)
    # a global aggregate over splits that are all empty: one row, count 0
    got = empty.agg(PE.Count().alias("n"), PE.Sum(PE.col("v")).alias("sv")
                    ).collect()
    assert got == [{"n": 0, "sv": None}]
    assert empty.group_by("k").agg(PE.Count().alias("n")).collect() == []
    assert empty.sort("v").collect() == []
    # one key: three of four reduce partitions are empty
    one_key = _four(f).filter(PE.EqualTo(PE.col("k"), PE.lit(7)))
    got = one_key.group_by("k").agg(PE.Count().alias("n")).collect()
    assert got == [{"k": 7, "n": sum(1 for k in f.column("k").to_pylist()
                                     if k == 7)}]
    # every broadcast join type with an empty build side and an empty
    # probe side
    sdf = _four(s)
    nobuild = sdf.filter(PE.LessThan(PE.col("w"), PE.lit(-1)))
    n = f.num_rows
    for how, rows in (("inner", 0), ("left", n), ("left_semi", 0),
                      ("left_anti", n)):
        q = _four(f).join(nobuild, on="k", how=how)
        plan = q.physical_plan()
        assert type(plan).__name__ == "BroadcastHashJoinExec"
        assert execute_to_arrow(plan).num_rows == rows
        assert _four(f).filter(none).join(sdf, on="k", how=how).collect() \
            == []
    # splits with no batch at all: a partial aggregate yields nothing, and
    # the final one row, count 0 (Spark's answer; ROADMAP queue 3)
    sch = PT.Schema.from_arrow(f.schema)
    nothing = BatchSourceExec([[], []], sch, device="cpu")
    partial = HashAggregateExec([], [PE.Count().alias("n"),
                                     PE.Max(PE.col("x")).alias("mx")],
                                nothing, mode="partial")
    assert list(partial.execute(0)) == []
    final = HashAggregateExec.final_from_partial(
        partial, ShuffleExchangeExec(SinglePartitioner(), partial))
    assert execute_to_arrow(final).to_pylist() == [{"n": 0, "mx": None}]
    # a shuffled full join of an empty side keeps the other side's rows
    big = _four(_dims(3000, 3), {
        "spark.rapids.gpu.sql.join.broadcastRowThreshold": 10})
    got = big.filter(PE.LessThan(PE.col("w"), PE.lit(-1))).join(
        big, on="k", how="full").collect()
    assert len(got) == 3000


@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti",
                                 "full"])
def test_shuffled_join_on_string_keys_matches_one_partition(how):
    """Both sides hash-exchanged on a string key (each read chunk with a
    dictionary of its own): rows equal to one partition's, and not
    empty."""
    f = _facts()
    rng = np.random.default_rng(4)
    names = pa.table({
        "s": pa.array([f"s{i}" for i in range(0, 45, 3) for _ in range(4)]),
        "w": pa.array(rng.integers(0, 9, 60), pa.int64())})
    # the plain plan shape: the sides are the exchanges themselves
    shuffled = dict(PLAIN, **{
        "spark.rapids.gpu.sql.join.broadcastRowThreshold": 10})
    q = _four(f, shuffled).join(_four(names, shuffled), on="s", how=how)
    plan = q.physical_plan()
    joins = [n for n in _walk(plan) if isinstance(n, HashJoinExec)]
    assert joins and all(isinstance(j.left, ShuffleExchangeExec) and
                         isinstance(j.right, ShuffleExchangeExec)
                         for j in joins)
    got = execute_to_arrow(plan).to_pylist()
    one = [port_from_arrow(t, RapidsConf(), batch_rows=500, device="cpu")
           for t in (f, names)]
    exp = one[0].join(one[1], on="s", how=how).collect()
    assert got and PTPCH.rows_match(_canon(got), _canon(exp))


def test_writer_threads_one_and_four_give_identical_rows():
    f = _facts(6000, 5)
    rows = []
    for threads in (1, 4):
        d = _four(f, {"spark.rapids.gpu.shuffle.writeThreads": threads})
        q = d.join(_four(_dims(3000, 3), {
            "spark.rapids.gpu.sql.join.broadcastRowThreshold": 10}),
            on="k").group_by("s").agg(PE.Sum(PE.col("w")).alias("sw"),
                                      PE.Count().alias("n"))
        rows.append(q.collect())
    assert rows[0] == rows[1]  # the same rows in the same order


def test_cpu_node_reads_every_partition_of_a_device_child():
    """A CPU-engine aggregate (COUNT(DISTINCT) over a nullable key stays
    on the CPU engine) and a CPU-engine sort over a 4-split device scan
    read all four splits."""
    f = _facts()
    d = _four(f)
    q = d.group_by("s").agg(PE.CountDistinct(PE.col("k")).alias("dk"),
                            PE.Count().alias("n"))
    assert any("! Aggregate" in ln for ln in q.explain().splitlines())
    plan = q.physical_plan()
    assert isinstance(plan, PCPU.CpuExec)
    assert plan.children[0].num_partitions() == 4
    got = {r["s"]: (r["dk"], r["n"]) for r in q.collect()}
    exp = {}
    for s, k in zip(f.column("s").to_pylist(), f.column("k").to_pylist()):
        ks, n = exp.get(s, (set(), 0))
        exp[s] = (ks | {k}, n + 1)
    assert got == {s: (len(ks), n) for s, (ks, n) in exp.items()}
    off = _four(f, {"spark.rapids.gpu.sql.enabled": "false"})
    assert len(off.sort("v").collect()) == f.num_rows
    assert len(off.limit(3900).collect()) == 3900


def test_union_numbers_partitions_as_the_reference():
    f = _facts(1000)
    parts = [[PB.batch_from_arrow(f.slice(i * 100, 100), "cpu")]
             for i in range(5)]
    sch = PT.Schema.from_arrow(f.schema)
    a = BatchSourceExec(parts[:2], sch)
    b = BatchSourceExec(parts[2:], sch)
    for u in (UnionExec(sch, a, b),
              PCPU.CpuUnionExec(sch, a, b, device="cpu")):
        assert u.num_partitions() == 5
        for p in range(5):
            got = (list(u.execute_host(p)) if isinstance(u, PCPU.CpuExec)
                   else [PB.batch_to_arrow(x, sch) for x in u.execute(p)])
            assert [t.to_pylist() for t in got] == [
                f.slice(p * 100, 100).to_pylist()]
    # through the planner: a union of a 4-split and a 1-split source has
    # five partitions, and an aggregate above it exchanges them
    f = _facts(2000)
    q = _four(f).select("k").union(port_from_arrow(
        f, RapidsConf(NO_FASTPATH), batch_rows=500, device="cpu").select("k"))
    plan = q.physical_plan()
    assert isinstance(plan, UnionExec) and plan.num_partitions() == 5
    agg = q.group_by("k").agg(PE.Count().alias("n")).physical_plan()
    assert any(isinstance(n, ShuffleExchangeExec) for n in _walk(agg))
    assert sum(r["n"] for r in execute_to_arrow(agg).to_pylist()) == 4000


def test_join_with_unequal_partition_counts_raises():
    f = _facts(400)
    sch = PT.Schema.from_arrow(f.schema)
    two = BatchSourceExec([[PB.batch_from_arrow(f.slice(0, 200), "cpu")],
                           [PB.batch_from_arrow(f.slice(200), "cpu")]], sch)
    one = BatchSourceExec([[PB.batch_from_arrow(f, "cpu")]], sch)
    j = HashJoinExec([PE.col("k")], [PE.col("k")], "inner", two, one)
    with pytest.raises(ValueError, match="co-partitioned"):
        list(j.execute(1))
