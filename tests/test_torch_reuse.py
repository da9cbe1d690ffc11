"""Exchange and broadcast reuse of the port (spark_rapids_tpu_torch
plan/reuse.py and exec/reuse.py) on the CPU:

- fingerprints ignore attribute names and keep literals;
- equal CTE subtrees collapse to one exchange (1 and 4 writer threads),
  and reuse off leaves the plan alone; two joins sharing a broadcast
  build build it once; a broadcast build holds its rows once (the join's
  build is the replayed batch);
- the shared entry's reference count and replay, a cache cap denying
  admission (the read passes through with the same rows), and eviction
  of the lowest-scored idle entry;
- TPC-DS q2 at SF 0.002 with 2 shuffle partitions reuses an exchange,
  with bytes saved, as many as the reference's plan of it; q4, q11 and
  q74 with 4 splits reuse what the reference's plans reuse;
- TPC-H Q1/Q3/Q5/Q6 and the TPC-DS queries that read a CTE more than
  once give identical rows with reuse on and off.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS
from spark_rapids_tpu_torch.bench import tpch as PTPCH
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec import reuse as R
from spark_rapids_tpu_torch.exec.dpp import ReplayExec
from spark_rapids_tpu_torch.exec.join_bcast import BroadcastHashJoinExec
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.plan import reuse as PR
from spark_rapids_tpu_torch.plan.dataframe import DataFrame, execute_to_arrow
from spark_rapids_tpu_torch.shuffle.exchange_exec import ShuffleExchangeExec

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
REUSE_OFF = {"spark.rapids.gpu.sql.exchange.reuse.enabled": "false"}
MEMO_OFF = {"spark.rapids.gpu.plan.cache.enabled": "false"}


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _count(plan, cls):
    return sum(isinstance(n, cls) for n in _walk(plan))


def _facts(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(rng.integers(0, 40, n), pa.int64()),
                     "v": pa.array(rng.integers(-500, 500, n), pa.int64()),
                     "x": pa.array(rng.normal(0, 10, n))})


def _dims(n=40, seed=2):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(np.arange(n), pa.int64()),
                     "w": pa.array(rng.integers(0, 9, n), pa.int64())})


def _df(t, extra=None, **kw):
    conf = RapidsConf(dict(NO_FASTPATH, **(extra or {})))
    return port_from_arrow(t, conf, batch_rows=500, device="cpu",
                           partitions=4, **kw)


def _canon(rows):
    return sorted(rows, key=lambda r: repr(sorted(
        (k, repr(v)) for k, v in r.items())))


# ---------------------------------------------------------------------------
# fingerprints and the rewrite
# ---------------------------------------------------------------------------


def test_fingerprint_ignores_names_and_keeps_literals():
    d = _df(_facts())

    def fp(df):
        return PR.plan_fingerprint(df.physical_plan())

    plus = lambda n, name: d.select(  # noqa: E731
        PE.col("k"), PE.Alias(PE.Add(PE.col("v"), PE.lit(n)), name))
    assert fp(plus(1, "a")) == fp(plus(1, "b"))
    assert fp(plus(1, "a")) != fp(plus(2, "a"))
    flt = lambda n: d.filter(PE.GreaterThan(PE.col("v"),  # noqa: E731
                                            PE.lit(n)))
    assert fp(flt(3)) == fp(flt(3)) and fp(flt(3)) != fp(flt(4))

    def exchange_fp(name, key):
        plan = d.group_by(key).agg(PE.Sum(PE.col("v")).alias(name)
                                   ).physical_plan()
        ex, = [n for n in _walk(plan) if isinstance(n, ShuffleExchangeExec)]
        return PR.plan_fingerprint(ex)

    assert exchange_fp("s", "k") == exchange_fp("t", "k")
    assert exchange_fp("s", "k") != exchange_fp("s", "v")
    # another source table, equal in content, is another source
    other = _df(_facts())
    assert fp(d.select("k")) != fp(other.select("k"))


def _cte_query(extra):
    """A CTE (an aggregate) read twice and joined with itself on a
    shuffled join: its partial-aggregate exchange is the repeat."""
    d = _df(_facts(), dict(extra, **{
        "spark.rapids.gpu.sql.join.broadcastRowThreshold": 0}))
    cte = d.group_by("k").agg(PE.Sum(PE.col("v")).alias("sv"),
                              PE.Count().alias("n"))
    a = cte.select(PE.col("k"), PE.Alias(PE.col("sv"), "a"))
    b = cte.select(PE.Alias(PE.col("k"), "k2"), PE.Alias(PE.col("n"), "b"))
    return a.join(b, left_on="k", right_on="k2")


@pytest.mark.parametrize("threads", [1, 4])
def test_equal_cte_subtrees_collapse_to_one_exchange(threads):
    w = {"spark.rapids.gpu.shuffle.writeThreads": threads}
    R.reset_counters()
    plan = _cte_query(w).physical_plan()
    assert R.counters()["reuse_exchanges_total"] == 1
    assert _count(plan, R.ReusedExchangeExec) == 1
    kept = [n for n in _walk(plan) if isinstance(n, ShuffleExchangeExec)
            and n._shared is not None]
    assert len(kept) == 1 and kept[0].reuse_id is not None
    got = execute_to_arrow(plan).to_pylist()
    assert R.counters()["reuse_bytes_saved_total"] > 0
    off = _cte_query(dict(w, **REUSE_OFF)).physical_plan()
    assert _count(off, R.ReusedExchangeExec) == 0
    # what the rewrite would alias: the partial aggregate's exchange, twice
    groups = PR.duplicate_groups(off)
    assert [(g["root"], g["occurrences"]) for g in groups] == [
        ("ShuffleExchange HashPartitioner(4)", 2)]
    assert all(n.reuse_id is None and n._shared is None for n in _walk(off)
               if isinstance(n, ShuffleExchangeExec))
    exp = execute_to_arrow(off).to_pylist()
    assert got and _canon(got) == _canon(exp)
    # the plan runs again: the entry released and read afresh
    assert kept[0]._shared.refs() == 2
    assert _canon(execute_to_arrow(plan).to_pylist()) == _canon(exp)


def test_a_broadcast_build_runs_once_when_two_joins_share_it(monkeypatch):
    builds = []
    real = BroadcastHashJoinExec._build

    def counting(self, batches):
        builds.append(self)
        return real(self, batches)

    monkeypatch.setattr(BroadcastHashJoinExec, "_build", counting)
    f, s = _facts(), _dims()
    q = _df(f).join(_df(s), on="k").union(
        _df(f).filter(PE.GreaterThan(PE.col("v"), PE.lit(0))).join(
            _df(s), on="k"))
    R.reset_counters()
    plan = q.physical_plan()
    assert R.counters()["reuse_broadcasts_total"] == 1
    assert _count(plan, ReplayExec) == 1
    assert _count(plan, R.ReusedBroadcastExec) == 1
    joins = [n for n in _walk(plan) if isinstance(n, BroadcastHashJoinExec)]
    assert len(joins) == 2 and joins[0]._shared_broadcast is \
        joins[1]._shared_broadcast is not None
    got = execute_to_arrow(plan).to_pylist()
    assert len(builds) == 1
    assert all(j.join_path == "ht" for j in joins)
    exp = DataFrame(q.plan, RapidsConf(dict(NO_FASTPATH, **REUSE_OFF)),
                    q.shuffle_partitions).collect()
    assert len(builds) == 3  # reuse off: each join builds its own
    assert got and _canon(got) == _canon(exp)


def test_a_broadcast_build_is_the_replayed_batch_not_a_copy():
    """A build side of 5 batches in 4 splits: ``ReplayExec`` keeps its
    rows as one batch, and the join's build is that batch. Planned with
    the plan memo off: a memoised tree drops its builds when its run
    ends, and this test reads them after the run."""
    f, s = _facts(), _dims(2500, seed=3)
    q = _df(f, MEMO_OFF).join(_df(s, MEMO_OFF), on="k")
    plan = q.physical_plan()
    (join,) = [n for n in _walk(plan)
               if isinstance(n, BroadcastHashJoinExec)]
    (replay,) = [n for n in _walk(plan) if isinstance(n, ReplayExec)]
    assert replay.child.num_partitions() == 4
    got = execute_to_arrow(plan).to_pylist()
    held = replay.materialized()
    assert [len(p) for p in held] == [1, 0, 0, 0]
    assert held[0][0].num_rows == 2500
    assert join._broadcast[0] is held[0][0]
    exp = DataFrame(q.plan, RapidsConf(dict(NO_FASTPATH)), 1).collect()
    assert got and _canon(got) == _canon(exp)


# ---------------------------------------------------------------------------
# the shared entry and the cache
# ---------------------------------------------------------------------------


def _batches(n, seed=0):
    t = _facts(n, seed)
    return [PB.batch_from_arrow(t.slice(i, 100), "cpu")
            for i in range(0, n, 100)]


def test_the_shared_entry_counts_consumers_and_replays():
    cache = R.MaterializationCache()
    entry = R.SharedExchangeEntry(RapidsConf(), cache)
    entry.retain(2)
    calls = []
    data = _batches(300)

    def producer():
        calls.append(1)
        return iter(data)

    R.reset_counters()
    first = list(entry.read(0, producer))
    second = list(entry.read(0, producer))
    assert len(calls) == 1 and first == data
    assert all(a is b for a, b in zip(first, second))
    nbytes = sum(R.batch_nbytes(b) for b in data)
    assert R.counters()["reuse_bytes_saved_total"] == nbytes
    assert cache.stats() == {"bytes_used": nbytes, "entries": 1}
    entry.release()
    assert entry.cached_partitions() == 1 and entry.refs() == 1
    entry.release()  # the last consumer: released, count restored
    assert entry.cached_partitions() == 0 and entry.refs() == 2
    assert cache.stats() == {"bytes_used": 0, "entries": 0}
    list(entry.read(0, producer))
    assert len(calls) == 2


def test_the_shared_entry_under_concurrent_readers():
    """16 threads (more than the cores) read 4 partitions of one entry at
    a short switch interval: each partition is produced once, every
    reader gets its batches, and the cache's bytes are the entry's."""
    import sys
    import threading

    cache = R.MaterializationCache()
    entry = R.SharedExchangeEntry(RapidsConf(), cache)
    entry.retain(16)
    parts = {p: _batches(200, p) for p in range(4)}
    produced = {p: 0 for p in parts}
    lock = threading.Lock()
    failures = []

    def producer(p):
        with lock:
            produced[p] += 1
        return iter(parts[p])

    def reader(i):
        for k in range(8):
            p = (i + k) % 4
            got = list(entry.read(p, lambda p=p: producer(p)))
            if [id(b) for b in got] != [id(b) for b in parts[p]]:
                failures.append((i, p))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not failures and produced == {p: 1 for p in parts}
    assert cache.stats()["bytes_used"] == sum(
        R.batch_nbytes(b) for bs in parts.values() for b in bs)
    for _ in range(16):
        entry.release()
    assert cache.stats() == {"bytes_used": 0, "entries": 0}


def test_a_capped_cache_denies_admission_and_passes_through():
    conf = RapidsConf({"spark.rapids.gpu.sql.exchange.reuse.cache.maxBytes":
                       100})
    cache = R.MaterializationCache()
    entry = R.SharedExchangeEntry(conf, cache)
    entry.retain(2)
    calls = []
    data = _batches(300, 1)

    def producer():
        calls.append(1)
        return iter(data)

    assert list(entry.read(0, producer)) == data
    assert list(entry.read(0, producer)) == data
    assert len(calls) == 2 and entry.cached_partitions() == 0
    assert cache.stats()["bytes_used"] == 0
    # through a plan: the same rows as reuse off
    capped = {"spark.rapids.gpu.sql.exchange.reuse.cache.maxBytes": 0}
    got = _cte_query(capped).collect()
    assert _canon(got) == _canon(_cte_query(REUSE_OFF).collect())


def test_eviction_removes_the_lowest_scored_idle_entry():
    def entries(n, max_entries):
        conf = RapidsConf({
            "spark.rapids.gpu.sql.exchange.reuse.cache.maxEntries":
                max_entries})
        cache = R.MaterializationCache()
        out = [R.SharedExchangeEntry(conf, cache) for _ in range(n)]
        for e in out:
            e.retain(2)
        return out

    big_data, small_data = _batches(1000, 2), _batches(100, 3)
    big, small, new = entries(3, 2)
    list(big.read(0, lambda: iter(big_data)))
    list(small.read(0, lambda: iter(small_data)))
    R.reset_counters()
    # a third entry: the idle entry of fewer bytes (lower log2) goes
    list(new.read(0, lambda: iter(small_data)))
    assert small.cached_partitions() == 0 and big.cached_partitions() == 1
    assert new.cached_partitions() == 1
    c = R.counters()
    assert c["reuse_evict_total"] == 1
    assert c["reuse_evict_bytes_total"] == sum(R.batch_nbytes(b)
                                               for b in small_data)
    # an entry with a replay in flight is never evicted: the new entry is
    # denied and passes through; once the replay ends, it is evicted
    held, denied, later = entries(3, 1)
    list(held.read(0, lambda: iter(small_data)))
    replay = held.read(0, lambda: iter(small_data))
    next(replay)
    assert list(denied.read(0, lambda: iter(big_data))) == big_data
    assert R.counters()["reuse_evict_skipped_active_total"] == 1
    assert denied.cached_partitions() == 0 and held.cached_partitions() == 1
    list(replay)
    list(later.read(0, lambda: iter(big_data)))
    assert held.cached_partitions() == 0 and later.cached_partitions() == 1


# ---------------------------------------------------------------------------
# TPC-DS q2 and the reference's plans
# ---------------------------------------------------------------------------


def _reference_reuse(q, tables, conf, **kw):
    """(reused exchanges, reused broadcasts) the reference's planner
    places in its plan of ``q``."""
    from spark_rapids_tpu.bench import tpcds_queries as JQ
    from spark_rapids_tpu.config.conf import RapidsConf as JConf
    from spark_rapids_tpu.exec import reuse as JR
    from spark_rapids_tpu.plan import from_arrow as jax_from_arrow

    shuffle_partitions = kw.pop("shuffle_partitions")
    d = {}
    for k, v in tables.items():
        df = jax_from_arrow(v, JConf(dict(conf, **{
            "spark.rapids.tpu.plan.cache.enabled": "false"})), **kw)
        df.shuffle_partitions = shuffle_partitions
        d[k] = df
    JR.reset_counters()
    JQ.QUERIES[q](d).physical_plan()
    c = JR.counters()
    return c["reuse_exchanges_total"], c["reuse_broadcasts_total"]


def test_q2_reuses_an_exchange_as_the_reference_plans_it():
    tables = PS.tables_for(0.002, seed=42, names=PQ.TABLES["q2"])

    def run(extra):
        d = PQ.df_tables(tables, RapidsConf(extra), device="cpu",
                         shuffle_partitions=2)
        plan = PQ.QUERIES["q2"](d).physical_plan()
        return plan, execute_to_arrow(plan)

    R.reset_counters()
    plan, on = run({})
    c = R.counters()
    assert c["reuse_exchanges_total"] >= 1
    assert c["reuse_bytes_saved_total"] > 0
    assert _count(plan, R.ReusedExchangeExec) == c["reuse_exchanges_total"]
    _, off = run(REUSE_OFF)
    assert on.num_rows > 0 and on.equals(off)
    assert (c["reuse_exchanges_total"], c["reuse_broadcasts_total"]) == \
        _reference_reuse("q2", tables, {}, shuffle_partitions=2)


@pytest.mark.parametrize("q", ["q4", "q11", "q74"])
def test_four_split_reuse_equals_the_reference(q):
    """The year-over-year CTE queries with 4 splits: every channel's
    total aggregates one year's rows, so no exchange repeats, and their
    broadcast builds repeat as often as in the reference's plans."""
    tables = PS.tables_for(0.01, names=PQ.TABLES[q])
    d = PQ.df_tables(tables, RapidsConf(NO_FASTPATH), batch_rows=2048,
                     device="cpu", partitions=4)
    R.reset_counters()
    plan = PQ.QUERIES[q](d).physical_plan()
    c = R.counters()
    assert c["reuse_broadcasts_total"] >= 1
    assert (c["reuse_exchanges_total"], c["reuse_broadcasts_total"]) == \
        _reference_reuse(q, tables,
                         {"spark.rapids.tpu.fastpath.enabled": "false"},
                         batch_rows=2048, partitions=4, shuffle_partitions=4)
    assert _count(plan, R.ReusedBroadcastExec) == c["reuse_broadcasts_total"]


# ---------------------------------------------------------------------------
# reuse on and off, the port alone
# ---------------------------------------------------------------------------

_DS = {}


def _ds_tables():
    if "t" not in _DS:
        _DS["t"] = PS.tables_for(0.01, names=PS.ALL_TABLES)
    return _DS["t"]


CTE_QUERIES = ["q2", "q4", "q11", "q31", "q39", "q47", "q59", "q74", "q75"]


@pytest.mark.parametrize("q", ["tpch_q1", "tpch_q3", "tpch_q5", "tpch_q6"]
                         + CTE_QUERIES)
def test_reuse_on_and_off_give_identical_rows(q):
    rows = []
    for extra in ({}, REUSE_OFF):
        conf = RapidsConf(dict(NO_FASTPATH, **extra))
        if q.startswith("tpch_"):
            t = PTPCH.tables_for(0.01, seed=7)
            d = PTPCH.df_tables(t, conf, batch_rows=4096, device="cpu",
                                partitions=4, shuffle_partitions=4)
            df = PTPCH.DF_QUERIES[q[5:]](d)
        else:
            d = PQ.df_tables(_ds_tables(), conf, batch_rows=2048,
                             device="cpu", partitions=4)
            df = PQ.QUERIES[q](d)
        rows.append(execute_to_arrow(df.physical_plan()))
    assert rows[0].num_rows > 0 and rows[0].equals(rows[1])
