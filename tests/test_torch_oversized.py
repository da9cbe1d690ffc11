"""State larger than the device pool, on the port (spark_rapids_tpu_torch)
against the reference (spark_rapids_tpu): the aggregate's hash
repartition, the out-of-core sort, the streaming windows and their plan,
capped-pool TPC-H with spills to host and disk, injected OOMs, and the
task semaphore across threads."""

import threading

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS
from spark_rapids_tpu_torch.bench import tpch as PTPCH
from spark_rapids_tpu_torch.columnar.batch import (
    batch_from_arrow, batch_to_arrow)
from spark_rapids_tpu_torch.config import conf as PC
from spark_rapids_tpu_torch.exec import aggregate as PAGG
from spark_rapids_tpu_torch.exec import sort as PSORT
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.base import BatchSourceExec
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import window as PW
from spark_rapids_tpu_torch.mem import cleaner, pool as PP, retry as PR
from spark_rapids_tpu_torch.mem import semaphore as PSEM
from spark_rapids_tpu_torch.mem import spill as PSP
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_pool():
    """Each test sizes its own pool; the process pool comes back after."""
    PP.set_pool(None)
    yield
    PP.set_pool(None)
    PC.set_active(None)


def _framework_counters():
    return PSP.get_framework().counters()


def _assert_released(pool):
    assert pool.used == 0
    fw = PSP.get_framework()
    assert fw.handles() == []
    assert not [x for x in cleaner.sweep() if x.startswith("HbmPool")
                or fw.spill_dir in x]


# ---------------------------------------------------------------------------
# the aggregate's hash repartition (tests/test_agg_repartition.py's tables)
# ---------------------------------------------------------------------------


def _agg_table(n=20_000, n_keys=5000, seed=7):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, n_keys, n), pa.int64()),
        "s": pa.array([f"g{x:04d}" for x in rng.integers(0, 3000, n)]),
        "v": pa.array(rng.integers(-100, 100, n), pa.int64()),
    })


def _port_agg(table, batch_rows=1024):
    schema = PT.Schema.from_arrow(table.schema)
    batches = [batch_from_arrow(table.slice(i, batch_rows), device="cpu")
               for i in range(0, table.num_rows, batch_rows)]
    return HashAggregateExec([PE.col("k"), PE.col("s")],
                             [PE.Sum(PE.col("v")).alias("sv"),
                              PE.Count(PE.col("v")).alias("cv")],
                             BatchSourceExec([batches], schema))


def _ref_base(table):
    """The reference's rows with its repartition off."""
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.batch import (
        batch_from_arrow as rbatch, batch_to_arrow as rto)
    from spark_rapids_tpu.config import conf as C
    from spark_rapids_tpu.exec import BatchSourceExec as RSource
    from spark_rapids_tpu.exec import HashAggregateExec as RAgg
    from spark_rapids_tpu.exprs.expr import Count, Sum, col

    C.set_active(C.RapidsConf(
        {"spark.rapids.tpu.sql.agg.repartition.enabled": False}))
    try:
        schema = T.Schema.from_arrow(table.schema)
        batches = [rbatch(table.slice(i, 1024), 16)
                   for i in range(0, table.num_rows, 1024)]
        node = RAgg([col("k"), col("s")], [Sum(col("v")).alias("sv"),
                                           Count(col("v")).alias("cv")],
                    RSource([batches], schema))
        out = []
        for b in node.execute_all():
            out.extend(rto(b, node.output_schema).to_pylist())
    finally:
        C.set_active(None)
    return sorted((r["k"], r["s"], r["sv"], r["cv"]) for r in out)


def _run_port(node):
    out = []
    for b in node.execute_all():
        out.extend(batch_to_arrow(b, node.output_schema).to_pylist())
    return sorted((r["k"], r["s"], r["sv"], r["cv"]) for r in out)


def test_repartition_recurses_and_spills_buckets_with_the_reference_rows():
    """The reference's recursion case (its own test of it fails, ROADMAP
    queue 3, so rows are held against its rows with repartition off):
    a one-byte target, 4 buckets a level, depth 3, under a pool that
    cannot hold every bucket."""
    t = _agg_table()
    base = _ref_base(t)
    pool = PP.HbmPool(1 << 18)
    PP.set_pool(pool)
    PC.set_active(PC.RapidsConf({
        "spark.rapids.gpu.sql.agg.repartition.targetBytes": 1,
        "spark.rapids.gpu.sql.agg.repartition.numBuckets": 4,
        "spark.rapids.gpu.sql.agg.repartition.maxDepth": 3}))
    node = _port_agg(t)
    c0 = _framework_counters()
    got = _run_port(node)
    c1 = _framework_counters()
    assert got == base
    assert node.max_repartition_depth >= 2
    assert node.metrics["numRepartitions"].value > 1
    assert c1["spilled_to_host"] > c0["spilled_to_host"]
    assert c1["chunks_written"] > c0["chunks_written"]
    _assert_released(pool)


def test_capped_pool_completes_by_repartition_not_split_retry(monkeypatch):
    t = _agg_table()
    base = _ref_base(t)
    pool = PP.HbmPool(1 << 20)  # target = limit // 4, below the state
    PP.set_pool(pool)
    PC.set_active(PC.RapidsConf())
    monkeypatch.setattr(
        HashAggregateExec, "_merge_last_resort",
        lambda self, hs, fw: pytest.fail("split-retry last resort reached"))
    s0 = PAGG.repartition_snapshot()
    node = _port_agg(t)
    assert _run_port(node) == base
    assert PAGG.repartition_snapshot()["total"] > s0["total"]
    assert node.metrics["numRepartitions"].value > 0
    _assert_released(pool)


def test_a_refused_direct_merge_repartitions():
    """Partials under the target but above the pool: pinning them all for
    the direct merge is refused, and the merge repartitions from the
    handles instead, as the reference's does."""
    t = _agg_table()
    base = _ref_base(t)
    pool = PP.HbmPool(1 << 18)
    PP.set_pool(pool)
    PC.set_active(PC.RapidsConf({
        "spark.rapids.gpu.sql.agg.repartition.targetBytes": 1 << 30,
        "spark.rapids.gpu.memory.retry.maxAttempts": 1}))
    node = _port_agg(t)
    assert _run_port(node) == base
    assert node.metrics["numRepartitions"].value > 0
    _assert_released(pool)


def test_repartition_off_merges_once():
    t = _agg_table(4000)
    # the merge pins every partial: the pool holds the whole state
    PP.set_pool(PP.HbmPool(1 << 20))
    PC.set_active(PC.RapidsConf(
        {"spark.rapids.gpu.sql.agg.repartition.enabled": "false"}))
    node = _port_agg(t)
    got = _run_port(node)
    assert node.metrics["numRepartitions"].value == 0
    PC.set_active(PC.RapidsConf(
        {"spark.rapids.gpu.sql.agg.repartition.targetBytes": 1}))
    node = _port_agg(t)
    assert _run_port(node) == got
    assert node.metrics["numRepartitions"].value > 0


def test_last_resort_merges_piece_by_piece():
    """At the deepest level with a bucket the pool cannot hold whole."""
    t = _agg_table(8000, n_keys=3000)
    base = _ref_base(t)
    pool = PP.HbmPool(1 << 15)
    PP.set_pool(pool)
    PC.set_active(PC.RapidsConf({
        "spark.rapids.gpu.sql.agg.repartition.targetBytes": 1,
        "spark.rapids.gpu.sql.agg.repartition.numBuckets": 2,
        "spark.rapids.gpu.sql.agg.repartition.maxDepth": 1}))
    calls = []
    orig = HashAggregateExec._merge_last_resort

    def spy(self, hs, fw):
        calls.append(len(hs))
        return orig(self, hs, fw)

    HashAggregateExec._merge_last_resort = spy
    try:
        got = _run_port(_port_agg(t))
    finally:
        HashAggregateExec._merge_last_resort = orig
    assert got == base and calls
    _assert_released(pool)


# ---------------------------------------------------------------------------
# the out-of-core sort
# ---------------------------------------------------------------------------


def _sort_table(n=6000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array([None if i % 23 == 0 else int(x) for i, x in
                       enumerate(rng.integers(0, 40, n))], pa.int32()),
        "f": pa.array(np.where(rng.random(n) < 0.05, np.nan,
                               rng.integers(-20, 20, n).astype(float))),
        "s": pa.array([None if i % 17 == 0 else "k" + "x" * int(j) + str(m)
                       for i, (j, m) in enumerate(zip(
                           rng.integers(0, 12, n), rng.integers(0, 9, n)))]),
        "id": pa.array(np.arange(n), pa.int64()),
    })


def _port_sort(t, keys, out_of_core, batch_rows=400, target=700):
    schema = PT.Schema.from_arrow(t.schema)
    batches = [batch_from_arrow(t.slice(i, batch_rows), device="cpu")
               for i in range(0, t.num_rows, batch_rows)]
    node = PSORT.SortExec(
        [PSORT.SortOrder(PE.col(k), asc) for k, asc in keys],
        BatchSourceExec([batches], schema), out_of_core=out_of_core,
        target_rows=target)
    out = [batch_to_arrow(b, schema) for b in node.execute(0)]
    return pa.concat_tables(out).to_pylist(), node


def _ref_sort(t, keys, batch_rows=400, target=700):
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.batch import (
        batch_from_arrow as rbatch, batch_to_arrow as rto)
    from spark_rapids_tpu.config import conf as C
    from spark_rapids_tpu.exec import BatchSourceExec as RSource
    from spark_rapids_tpu.exec.sort import SortExec, SortOrder
    from spark_rapids_tpu.exprs.expr import col

    C.set_active(C.RapidsConf(
        {"spark.rapids.tpu.sql.sort.outOfCore.maxMergeRuns": 4}))
    try:
        schema = T.Schema.from_arrow(t.schema)
        batches = [rbatch(t.slice(i, batch_rows), 16)
                   for i in range(0, t.num_rows, batch_rows)]
        node = SortExec([SortOrder(col(k), asc) for k, asc in keys],
                        RSource([batches], schema), out_of_core=True,
                        target_rows=target)
        out = [rto(b, schema) for b in node.execute(0)]
    finally:
        C.set_active(None)
    return pa.concat_tables(out).to_pylist()


def _nan_safe(rows):
    return [{k: ("nan" if isinstance(v, float) and v != v else v)
             for k, v in r.items()} for r in rows]


@pytest.mark.parametrize("keys", [
    [("k", True), ("id", True)],
    [("f", False), ("id", True)],
    [("s", True), ("id", False)],
])
def test_out_of_core_sort_matches_the_reference(keys):
    t = _sort_table()
    PC.set_active(PC.RapidsConf(
        {"spark.rapids.gpu.sql.sort.outOfCore.maxMergeRuns": 4}))
    got, node = _port_sort(t, keys, True)
    assert node.metrics["sortRuns"].value == 15
    assert node.metrics["sortPremerges"].value > 0
    assert node.metrics["sortMergeBatches"].value > 1
    assert _nan_safe(got) == _nan_safe(_ref_sort(t, keys))


@pytest.mark.parametrize("max_runs", [2, 4])
@pytest.mark.parametrize("keys", [[("k", True)], [("k", False)],
                                  [("s", True)], [("f", True)],
                                  [("s", False), ("k", True)]])
def test_out_of_core_sort_equals_the_in_core_sort_ties_included(
        keys, max_runs):
    """Ties keep their input order: the whole rows, not just the keys,
    equal the in-core sort's, under a pool the runs do not fit in, with
    pre-merges of 2 or 4 runs. A pre-merge pins its group whole, as the
    reference's does, so the pool is the most an uncapped run pinned at
    once."""
    t = _sort_table()
    PC.set_active(PC.RapidsConf({
        "spark.rapids.gpu.sql.sort.outOfCore.maxMergeRuns": max_runs}))
    PP.set_pool(PP.HbmPool(1 << 34))
    _port_sort(t, keys, True)
    c = _framework_counters()
    pool = PP.HbmPool(max(c["max_pinned_bytes"], c["max_handle_bytes"]))
    assert pool.limit < PP.get_pool().max_used
    PP.set_pool(pool)
    c0 = _framework_counters()
    got, node = _port_sort(t, keys, True)
    exp, _ = _port_sort(t, keys, False)
    assert _nan_safe(got) == _nan_safe(exp)
    assert node.metrics["sortPremerges"].value >= 15 // max_runs
    assert _framework_counters()["spilled_to_host"] > c0["spilled_to_host"]
    _assert_released(pool)


def test_merge_path_key_is_accepted_and_changes_nothing():
    """``sort.outOfCore.mergePath`` (the reference's binary-search merge)
    is accepted; every merge set is a stable sort either way."""
    t = _sort_table()
    rows = []
    for on in ("true", "false"):
        PC.set_active(PC.RapidsConf({
            "spark.rapids.gpu.sql.sort.outOfCore.mergePath": on,
            "spark.rapids.gpu.sql.sort.outOfCore.maxMergeRuns": 4}))
        rows.append(_nan_safe(_port_sort(t, [("k", True)], True)[0]))
    assert rows[0] == rows[1]


# ---------------------------------------------------------------------------
# streaming windows (tests/test_window_stream.py's inputs, with null keys)
# ---------------------------------------------------------------------------


def _win_table(rng, n=400):
    return pa.table({
        "g": pa.array([None if i % 19 == 0 else int(x) for i, x in
                       enumerate(rng.integers(0, 3, n))], pa.int64()),
        "o": pa.array(rng.permutation(n) // 2, pa.int64()),  # ties
        "v": pa.array([None if i % 13 == 0 else int(x) for i, x in
                       enumerate(rng.integers(0, 100, n))], pa.int64()),
        "f": pa.array(rng.uniform(-5, 5, n), pa.float64()),
    })


def _win_exprs(M, kind, partitioned=True):
    E, W, Ord = M
    sp = W.WindowSpec((E.col("g"),) if partitioned else (),
                      (Ord(E.col("o")),))

    def fr(frame):
        return W.WindowSpec(sp.partition_by, sp.order_by, frame)

    running = W.WindowFrame("rows", W.UNBOUNDED, 0)
    bounded = W.WindowFrame("rows", -3, 2)
    if kind == "running":
        return [W.WindowExpression(W.RowNumber(), sp).alias("rn"),
                W.WindowExpression(W.Rank(), sp).alias("rk"),
                W.WindowExpression(W.DenseRank(), sp).alias("dr"),
                W.WindowExpression(E.Sum(E.col("v")), fr(running)).alias(
                    "rs"),
                W.WindowExpression(E.Count(E.col("v")), fr(running)).alias(
                    "rc"),
                W.WindowExpression(E.Min(E.col("v")), fr(running)).alias(
                    "rm"),
                W.WindowExpression(E.Max(E.col("v")), fr(running)).alias(
                    "rx")]
    port = E.__name__.startswith("spark_rapids_tpu_torch")
    # the reference's device Lag reads ahead (ROADMAP queue 3): the port's
    # Lag(v, k) is held against its Lead(v, -k)
    lag2 = (W.Lag(E.col("v"), 2) if port else W.Lead(E.col("v"), -2))
    lag1 = (W.Lag(E.col("v"), 1, E.lit(-1)) if port
            else W.Lead(E.col("v"), -1, E.lit(-1)))
    return [W.WindowExpression(W.Lead(E.col("v"), 3), sp).alias("ld"),
            W.WindowExpression(lag2, sp).alias("lg"),
            W.WindowExpression(lag1, sp).alias("lgd"),
            W.WindowExpression(E.Sum(E.col("v")), fr(bounded)).alias("bs"),
            W.WindowExpression(E.Max(E.col("v")), fr(bounded)).alias("bm"),
            W.WindowExpression(E.Count(E.col("v")), fr(bounded)).alias(
                "bc"),
            W.WindowExpression(E.Average(E.col("f")), fr(bounded)).alias(
                "ba")]


def _port_window(t, kind, batch_rows, streaming=True):
    from spark_rapids_tpu_torch.exec.sort import SortOrder

    conf = PC.RapidsConf({
        "spark.rapids.gpu.sql.window.streaming.enabled": streaming,
        "spark.rapids.gpu.sql.sort.outOfCore.targetRows": 48,
        "spark.rapids.gpu.sql.sort.outOfCore.maxMergeRuns": 4})
    df = port_from_arrow(t, conf, batch_rows=batch_rows, device="cpu")
    df = df.with_window(*_win_exprs((PE, PW, SortOrder), kind))
    plan = df.physical_plan()
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    return execute_to_arrow(plan).to_pylist(), plan


def _ref_window(t, kind, batch_rows):
    from spark_rapids_tpu.config.conf import RapidsConf
    from spark_rapids_tpu.exec.sort import SortOrder
    from spark_rapids_tpu.exprs import expr as E
    from spark_rapids_tpu.exprs import window as W
    from spark_rapids_tpu.plan import from_arrow

    conf = RapidsConf({"spark.rapids.tpu.plan.cache.enabled": "false"})
    df = from_arrow(t, conf, batch_rows=batch_rows).with_window(
        *_win_exprs((E, W, SortOrder), kind))
    return df.collect()


def _close(a, b):
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if ra.keys() != rb.keys():
            return False
        for k in ra:
            x, y = ra[k], rb[k]
            if isinstance(x, float) and isinstance(y, float):
                if abs(x - y) > 1e-9 * max(1.0, abs(x), abs(y)):
                    return False
            elif x != y:
                return False
    return True


def _key(r):
    return (r["g"] is None, r["g"] or 0, r["o"], r["v"] is None,
            r["v"] or 0, r["f"])


@pytest.mark.parametrize("kind", ["running", "bounded"])
def test_streaming_window_matches_the_reference(kind):
    t = _win_table(np.random.default_rng(1234))
    got, plan = _port_window(t, kind, batch_rows=32)
    win = plan
    while type(win).__name__ != "WindowExec":
        win = win.children[0]
    assert win._mode is not None and win._mode[0] == kind
    srt = win.children[0]
    assert type(srt).__name__ == "SortExec" and srt.out_of_core
    assert srt.metrics["sortPremerges"].value > 0
    assert win.metrics["streamedBatches"].value > 3
    ref = _ref_window(t, kind, batch_rows=32)
    assert _close(sorted(got, key=_key), sorted(ref, key=_key))
    # and the port's single-batch window, in the same order
    off, _ = _port_window(t, kind, batch_rows=1 << 20, streaming=False)
    assert _close(got, off)


# hand-cut presorted batches: the planner's out-of-core sort cuts only
# where the first sort key changes, so a window partitioned by it never
# continues into the next batch; these cuts put partitions, peer runs and
# null keys across batch edges, with one-row batches inside peer runs
_CUTS = (1, 5, 37, 2, 64, 1, 1, 11, 90, 3, 48, 7)


def _presorted_table(seed, n=600, partitioned=True):
    """Rows sorted by (g, o) with nulls first, as the out-of-core sort
    emits them: g in {null, 0, 1, 2} (a single partition when not
    ``partitioned``), o with ties and nulls, v and f with nulls."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n) if partitioned else np.zeros(n, np.int64)
    g_null = (g == 3) if partitioned else np.zeros(n, bool)
    o = rng.integers(0, n // 4, n)
    o_null = rng.random(n) < 0.04
    order = np.lexsort((o, ~o_null, g, ~g_null))
    g, g_null, o, o_null = g[order], g_null[order], o[order], o_null[order]
    v = rng.integers(0, 100, n)
    v_null = rng.random(n) < 0.08
    return pa.table({
        "g": pa.array([None if gn else int(x) for x, gn in zip(g, g_null)],
                      pa.int64()),
        "o": pa.array([None if on else int(x) for x, on in zip(o, o_null)],
                      pa.int64()),
        "v": pa.array([None if vn else int(x) for x, vn in zip(v, v_null)],
                      pa.int64()),
        "f": pa.array(rng.uniform(-5, 5, n), pa.float64()),
    })


def _cut(t):
    """``t`` as slices of the ``_CUTS`` sizes, in turn."""
    out, i, j = [], 0, 0
    while i < t.num_rows:
        k = _CUTS[j % len(_CUTS)]
        out.append(t.slice(i, k))
        i, j = i + k, j + 1
    return out


def _port_window_on(slices, exprs, streaming):
    from spark_rapids_tpu_torch.exec.window import WindowExec

    schema = PT.Schema.from_arrow(slices[0].schema)
    node = WindowExec(exprs, BatchSourceExec(
        [[batch_from_arrow(x, device="cpu") for x in slices]], schema),
        streaming=streaming)
    rows = [r for b in node.execute(0)
            for r in batch_to_arrow(b, node.output_schema).to_pylist()]
    return rows, node


def _ref_window_on(slices, exprs):
    from spark_rapids_tpu import types as T
    from spark_rapids_tpu.columnar.batch import (
        batch_from_arrow as rbatch, batch_to_arrow as rto)
    from spark_rapids_tpu.exec import BatchSourceExec as RSource
    from spark_rapids_tpu.exec.window import WindowExec

    schema = T.Schema.from_arrow(slices[0].schema)
    node = WindowExec(exprs, RSource([[rbatch(x, 16) for x in slices]],
                                     schema), streaming=True)
    return [r for b in node.execute(0)
            for r in rto(b, node.output_schema).to_pylist()]


@pytest.mark.parametrize("partitioned", [True, False],
                         ids=["partitioned", "one_partition"])
@pytest.mark.parametrize("kind", ["running", "bounded"])
def test_streaming_window_carries_across_hand_cut_batches(kind, partitioned):
    """The running carry and the bounded context where partitions, peer
    runs and null keys continue across batch edges: against the
    reference's streaming window on the same cuts, and against the
    port's single-batch window over the whole table."""
    from spark_rapids_tpu.exec.sort import SortOrder as JOrd
    from spark_rapids_tpu.exprs import expr as JE
    from spark_rapids_tpu.exprs import window as JW

    t = _presorted_table(11, partitioned=partitioned)
    slices = _cut(t)
    exprs = _win_exprs((PE, PW, PSORT.SortOrder), kind, partitioned)
    got, node = _port_window_on(slices, exprs, streaming=True)
    assert node._mode is not None and node._mode[0] == kind
    if kind == "running":  # the bounded mode joins batches under k rows
        assert node.metrics["streamedBatches"].value == len(slices)
    # the cuts do put partitions and peer runs across edges
    ends = np.cumsum([x.num_rows for x in slices])[:-1]
    g, o = t.column("g").to_pylist(), t.column("o").to_pylist()
    assert sum(g[e - 1] == g[e] for e in ends) > len(ends) // 2
    assert sum(g[e - 1] == g[e] and o[e - 1] == o[e] for e in ends) >= 2
    ref = _ref_window_on(slices, _win_exprs((JE, JW, JOrd), kind,
                                            partitioned))
    assert _close(got, ref)
    whole, _ = _port_window_on([t], exprs, streaming=False)
    assert _close(got, whole)


def test_running_carry_ignores_the_data_under_null_keys():
    """A null key's data slot may hold anything (a gather's or an outer
    join's filler): the carry compares validity there, not data."""
    from spark_rapids_tpu_torch.exec.window import WindowExec

    t = _presorted_table(23)
    slices = _cut(t)
    exprs = _win_exprs((PE, PW, PSORT.SortOrder), "running")
    schema = PT.Schema.from_arrow(t.schema)
    rng = np.random.default_rng(0)
    batches = []
    for x in slices:
        b = batch_from_arrow(x, device="cpu")
        for c in b.columns[:2]:  # g and o
            junk = torch.from_numpy(rng.integers(-9, 9, b.num_rows))
            c.data[~c.validity] = junk[~c.validity].to(c.data.dtype)
        batches.append(b)
    node = WindowExec(exprs, BatchSourceExec([batches], schema),
                      streaming=True)
    got = [r for b in node.execute(0)
           for r in batch_to_arrow(b, node.output_schema).to_pylist()]
    whole, _ = _port_window_on([t], exprs, streaming=False)
    assert got == whole


def test_running_rank_ties_across_batch_edges():
    """Long peer runs cut at every few rows, batches of one row inside
    them: rank, dense_rank and row_number continue as over one batch."""
    n = 300
    t = pa.table({"g": pa.array([i // 150 for i in range(n)], pa.int64()),
                  "o": pa.array([i // 7 for i in range(n)], pa.int64()),
                  "v": pa.array(list(range(n)), pa.int64()),
                  "f": pa.array([0.0] * n, pa.float64())})
    slices = _cut(t)
    exprs = _win_exprs((PE, PW, PSORT.SortOrder), "running")
    on, _ = _port_window_on(slices, exprs, streaming=True)
    off, _ = _port_window_on([t], exprs, streaming=False)
    assert on == off


def test_streaming_off_gives_the_single_batch_plan():
    t = _win_table(np.random.default_rng(7))
    _, plan = _port_window(t, "running", batch_rows=32, streaming=False)
    names = []
    node = plan
    while node.children:
        names.append(type(node).__name__)
        node = node.children[0]
    assert "CoalesceBatchesExec" in names and "SortExec" not in names


def test_reference_streams_a_window_its_sort_cannot_run():
    """A reference fault (ROADMAP queue 3): at its defaults it streams a
    window partitioned by an expression over an out-of-core sort of that
    expression, which its sort refuses at run time; the port keeps the
    single-batch plan and runs it."""
    from spark_rapids_tpu.config.conf import RapidsConf as JConf
    from spark_rapids_tpu.exec.sort import SortOrder as JOrd
    from spark_rapids_tpu.exprs import expr as JE
    from spark_rapids_tpu.exprs import window as JW
    from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
    from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd

    rng = np.random.default_rng(1)
    t = pa.table({"k": pa.array(rng.integers(0, 60, 2000), pa.int64()),
                  "v": pa.array(rng.integers(-500, 500, 2000), pa.int64())})

    def build(df, M):
        E, W, Ord = M
        spec = W.WindowSpec((E.Add(E.col("k"), E.lit(1)),),
                            (Ord(E.col("v")),))
        return df.with_window(E.Alias(W.WindowExpression(W.Rank(), spec),
                                      "r"))

    jdf = build(jax_from_arrow(t, JConf(
        {"spark.rapids.tpu.plan.cache.enabled": "false"})),
        (JE, JW, JOrd))
    jplan = jdf.physical_plan()
    assert type(jplan.children[0]).__name__ == "SortExec"
    assert jplan.children[0].out_of_core
    with pytest.raises(AssertionError, match="column refs"):
        jdf.collect()
    pdf = build(port_from_arrow(t, PC.RapidsConf(), device="cpu"),
                (PE, PW, POrd))
    pplan = pdf.physical_plan()
    assert type(pplan.children[0]).__name__ == "CoalesceBatchesExec"
    assert len(pdf.collect()) == 2000


# ---------------------------------------------------------------------------
# q44's plan at the defaults
# ---------------------------------------------------------------------------


def _window_shape(node):
    """(window streams, its child's kind) of every window of a plan."""
    out = []
    stack = [node]
    while stack:
        n = stack.pop()
        if type(n).__name__ == "WindowExec":
            c = n.children[0]
            out.append((bool(getattr(n, "streaming", False)),
                        type(c).__name__,
                        bool(getattr(c, "out_of_core", False))))
        stack.extend(n.children)
    return sorted(out)


@pytest.fixture(scope="module")
def _ds_tables():
    return PS.tables_for(0.01, names=PS.ALL_TABLES)


def test_q44_plan_streams_as_the_reference(_ds_tables):
    from spark_rapids_tpu.bench import tpcds_queries as JQ
    from spark_rapids_tpu.config import conf as JC
    from spark_rapids_tpu.plan import from_arrow as jax_from_arrow

    names = ["store_sales", "item"]
    tables = {k: _ds_tables[k] for k in names}
    # fusion off: the port has no fused stages (queue 1 item 5)
    jd = {k: jax_from_arrow(v, JC.RapidsConf(
        {"spark.rapids.tpu.plan.cache.enabled": "false",
         "spark.rapids.tpu.sql.fusion.enabled": "false"}))
        for k, v in tables.items()}
    ref = _window_shape(JQ.QUERIES["q44"](jd).physical_plan())
    d = PQ.df_tables(tables, device="cpu")
    got = _window_shape(PQ.QUERIES["q44"](d).physical_plan())
    assert got == ref == [(True, "SortExec", True)] * 2
    on = PQ.QUERIES["q44"](d).to_arrow().to_pylist()
    off = PQ.QUERIES["q44"](PQ.df_tables(tables, PC.RapidsConf(
        {"spark.rapids.gpu.sql.window.streaming.enabled": "false"}),
        device="cpu")).to_arrow().to_pylist()
    assert on == off and PQ.informative(on)


def test_only_q44_streams_among_the_tpcds_queries(_ds_tables):
    """Every other window query keeps the single-batch window: string or
    float keys, or a function outside the streaming set."""
    d = PQ.df_tables(_ds_tables, device="cpu")
    streaming, single = [], []
    for q in sorted(PQ.QUERIES):
        shape = _window_shape(PQ.QUERIES[q](d).physical_plan())
        if any(s[0] for s in shape):
            streaming.append(q)
        elif shape:
            single.append(q)
    assert streaming == ["q44"]
    assert len(single) == 14, single


# ---------------------------------------------------------------------------
# TPC-H under a capped pool
# ---------------------------------------------------------------------------

_CAPPED = {"spark.rapids.gpu.fastpath.enabled": "false"}


def _tpch(q, tables, conf):
    d = PTPCH.df_tables(tables, PC.RapidsConf(conf), batch_rows=1024,
                        device="cpu", partitions=4, shuffle_partitions=4)
    return PTPCH.DF_QUERIES[q](d).to_arrow().to_pylist()


@pytest.fixture(scope="module")
def _h_tables():
    return PTPCH.tables_for(0.01, seed=7)


def _cap_of(fw_counters):
    """The least pool an uncapped run shows every handle and every set of
    handles pinned at once to fit in."""
    return max(fw_counters["max_handle_bytes"],
               fw_counters["max_pinned_bytes"])


@pytest.mark.parametrize("q", ["q3", "q5"])
def test_tpch_under_a_capped_pool_equals_uncapped(q, _h_tables, tmp_path):
    """At the least pool that holds every handle and every pinned build
    set: equal rows, no registration split, the pool's high-water mark
    within the cap, a repartitioned aggregate's buckets accounted."""
    PP.set_pool(PP.HbmPool(1 << 34))
    base = _tpch(q, _h_tables, _CAPPED)
    cap = _cap_of(PSP.get_framework().counters())
    assert cap > 0
    pool = PP.HbmPool(cap)
    PP.set_pool(pool)
    conf = dict(_CAPPED, **{
        "spark.rapids.gpu.memory.host.spillStorageSize": cap // 16,
        "spark.rapids.gpu.sql.agg.repartition.targetBytes": cap // 16,
        "spark.rapids.gpu.memory.spillDir": str(tmp_path)})
    PC.set_active(PC.RapidsConf(conf))
    PR.STATS.reset()
    got = _tpch(q, _h_tables, conf)
    assert PTPCH.rows_match(got, base)
    assert PR.STATS.snapshot()["splits"] == 0
    assert 0 < pool.max_used <= cap
    _assert_released(pool)
    assert not list(tmp_path.iterdir())


def test_streaming_window_runs_outgrow_a_capped_pool(tmp_path):
    """The out-of-core sort's runs under the least pool that holds every
    pinned pre-merge group: the runs left over spill to host and on to
    disk, and the carried window equals the uncapped one."""
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    t = _win_table(np.random.default_rng(5), n=3000)
    exprs = _win_exprs((PE, PW, SortOrder), "running", partitioned=False)
    settings = {"spark.rapids.gpu.sql.sort.outOfCore.maxMergeRuns": 16,
                "spark.rapids.gpu.sql.sort.outOfCore.targetRows": 400,
                "spark.rapids.gpu.memory.spillDir": str(tmp_path)}

    def run():
        df = port_from_arrow(t, PC.RapidsConf(settings), batch_rows=128,
                             device="cpu").with_window(*exprs)
        return execute_to_arrow(df.physical_plan()).to_pylist()

    PP.set_pool(PP.HbmPool(1 << 34))
    base = run()
    cap = _cap_of(PSP.get_framework().counters())
    assert cap < PP.get_pool().max_used
    pool = PP.HbmPool(cap)
    PP.set_pool(pool)
    PSP.SpillFramework(pool, host_limit_bytes=cap // 16,
                       spill_dir=str(tmp_path))
    PR.STATS.reset()
    assert run() == base
    c = PSP.get_framework().counters()
    assert c["spilled_to_host"] > 0 and c["spilled_to_disk"] > 0
    assert c["unspilled"] > 0 and PR.STATS.snapshot()["splits"] == 0
    _assert_released(pool)
    assert not list(tmp_path.iterdir())


def test_injected_ooms_are_recovered(_h_tables):
    # planned afresh: a tree served by the plan memo replays its broadcast
    # builds, so its run makes fewer allocations for the injector to count
    capped = dict(_CAPPED, **{"spark.rapids.gpu.plan.cache.enabled": "false"})
    PP.set_pool(PP.HbmPool(1 << 34))
    base = _tpch("q3", _h_tables, capped)
    pool = PP.HbmPool(1 << 34)
    PP.set_pool(pool)
    me = threading.get_ident()
    injs = [PP.OomInjector("SPLIT", skip=0, count=1, thread_id=me),
            PP.OomInjector("RETRY", skip=3, count=2, thread_id=me)]

    class Chain:
        def on_alloc(self):
            for inj in injs:
                if inj.count > 0:
                    inj.on_alloc()
                    return

    pool.set_injector(Chain())
    PR.STATS.reset()
    got = _tpch("q3", _h_tables, capped)
    stats = PR.STATS.snapshot()
    assert PTPCH.rows_match(got, base)
    assert [i.injected for i in injs] == [1, 2]
    assert stats["splits"] >= 1 and stats["retries"] >= 2
    _assert_released(pool)


# ---------------------------------------------------------------------------
# the task semaphore across threads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("permits", [1, 2])
def test_two_threads_share_the_semaphore(permits, _h_tables):
    conf = dict(_CAPPED, **{
        "spark.rapids.gpu.sql.concurrentGpuTasks": permits})
    serial = {q: _tpch(q, _h_tables, conf) for q in ("q1", "q6")}
    sem = PSEM.get_task_semaphore(PC.RapidsConf(conf))
    w0 = sem.snapshot()["wait_count"]
    sem.max_holders = 0
    got, errors = {}, []

    def run(q):
        try:
            got[q] = _tpch(q, _h_tables, conf)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(q,))
               for q in ("q1", "q6")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    for q in serial:
        assert PTPCH.rows_match(got[q], serial[q])
    snap = sem.snapshot()
    assert snap["permits"] == permits
    assert 1 <= snap["max_holders"] <= permits
    assert snap["holders"] == {}
    if permits == 1:
        assert snap["wait_count"] > w0
