"""Read-ahead of the port (spark_rapids_tpu_torch/exec/pipeline.py and the
exchange's read-ahead) on the CPU:

- the prefetch iterator keeps order and runs to the end, raises a
  background exception in its consumer, unblocks a waiting producer on
  ``close`` and runs ahead of its consumer;
- ``insert_prefetch`` wraps exactly the exchanges, reused exchanges, AQE
  readers and CPU-to-device transitions (an exchange under an AQE reader
  stays bare), and nothing when prefetch is off or on the fast path;
- the exchange reads the next reduce partition ahead, and an AQE reader
  its next spec, their rows those of no read-ahead, and ``cleanup`` stops
  it; a query's rows with prefetch on and off are the same.
"""

import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench import tpch as PTPCH
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec import pipeline as PP
from spark_rapids_tpu_torch.exec.base import BatchSourceExec
from spark_rapids_tpu_torch.exec.reuse import ReusedExchangeExec
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import cpu as PCPU
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
from spark_rapids_tpu_torch.shuffle import partition as PPart
from spark_rapids_tpu_torch.shuffle.aqe import AQEShuffleReadExec
from spark_rapids_tpu_torch.shuffle.exchange_exec import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
PREFETCH_OFF = {"spark.rapids.gpu.sql.prefetch.enabled": "false"}


def _wait_until(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            return False
        time.sleep(0.005)
    return True


# ---------------------------------------------------------------------------
# the iterator
# ---------------------------------------------------------------------------


def test_the_iterator_keeps_order_and_runs_to_the_end():
    for depth in (1, 2, 5):
        it = PP.PrefetchIterator(iter(range(100)), depth=depth)
        assert list(it) == list(range(100))
        with pytest.raises(StopIteration):
            next(it)
        it.close()
    assert list(PP.PrefetchIterator(iter([]))) == []


def test_a_background_exception_is_raised_in_the_consumer():
    def source():
        yield 1
        yield 2
        raise ValueError("broken source")

    it = PP.PrefetchIterator(source(), depth=4)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(ValueError, match="broken source"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    it.close()


def test_close_unblocks_a_waiting_producer():
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    it = PP.PrefetchIterator(endless(), depth=1)
    assert next(it) == 0
    # the producer fills the queue and waits on it
    assert _wait_until(lambda: it._q.full())
    t0 = time.monotonic()
    it.close()
    assert time.monotonic() - t0 < 5.0
    assert not it._thread.is_alive() and closed == [True]
    it.close()  # idempotent


def test_the_iterator_runs_ahead_of_its_consumer():
    produced = []

    def source():
        for i in range(10):
            produced.append(i)
            yield i

    depth = 3
    with PP.PrefetchIterator(source(), depth=depth) as it:
        assert next(it) == 0
        # the queue refills while the consumer does nothing: depth
        # queued, one more in the worker's hand
        assert _wait_until(lambda: len(produced) == depth + 2)
        assert list(it) == list(range(1, 10))


def test_the_worker_runs_on_the_source_device_and_sees_no_conf_change():
    """The worker reads nothing of the active conf: a plan built under one
    conf prefetches by it while another conf is active."""
    t = pa.table({"k": pa.array(np.arange(2000) % 7, pa.int64())})
    d = port_from_arrow(t, RapidsConf(dict(NO_FASTPATH, **{
        "spark.rapids.gpu.sql.prefetch.depth": 3})), batch_rows=250,
        device="cpu", partitions=4)
    plan = d.group_by("k").agg(PE.Count().alias("n")).physical_plan()
    pre = [n for n, _ in _walk(plan) if isinstance(n, PP.PrefetchExec)]
    assert pre and all(p.depth == 3 for p in pre)
    C.set_active(RapidsConf(PREFETCH_OFF))
    try:
        got = execute_to_arrow(plan).to_pylist()
    finally:
        C.set_active(None)
    assert sorted((r["k"], r["n"]) for r in got) == [
        (k, sum(1 for i in range(2000) if i % 7 == k)) for k in range(7)]


# ---------------------------------------------------------------------------
# insert_prefetch
# ---------------------------------------------------------------------------


def _walk(node, parent=None):
    yield node, parent
    for c in node.children:
        yield from _walk(c, node)


EXCHANGES = (ShuffleExchangeExec, ReusedExchangeExec)


def _stays_bare(node, parent) -> bool:
    """A boundary kind that ``insert_prefetch`` leaves bare: an exchange
    under an AQE reader, a CPU-engine node at the root or under another."""
    if isinstance(node, EXCHANGES):
        return isinstance(parent, AQEShuffleReadExec)
    return parent is None or isinstance(parent, PCPU.CpuExec)


def _mixed_query(extra=None, **kw):
    """String ordering filters on the CPU engine (one over the other)
    under device aggregates, a reused exchange under a join, a union and
    a range sort."""
    rng = np.random.default_rng(3)
    n = 3000
    f = pa.table({"k": pa.array(rng.integers(0, 30, n), pa.int64()),
                  "v": pa.array(rng.integers(0, 100, n), pa.int64()),
                  "s": pa.array([f"s{i}" for i in rng.integers(0, 9, n)])})
    conf = RapidsConf(dict(NO_FASTPATH, **(extra or {})))
    d = port_from_arrow(f, conf, batch_rows=400, device="cpu",
                        partitions=4, **kw)
    cpu_filter = d.filter(PE.LessThan(PE.col("s"), PE.lit("s5")))
    counted = cpu_filter.group_by("k").agg(PE.Count().alias("x"))
    distinct = cpu_filter.filter(PE.GreaterThan(PE.col("s"), PE.lit(
        "s1"))).group_by("s").agg(PE.Max(PE.col("k")).alias("x"))
    agg = d.group_by("k").agg(PE.Sum(PE.col("v")).alias("sv"))
    a = agg.select(PE.col("k"), PE.Alias(PE.col("sv"), "a"))
    b = agg.select(PE.Alias(PE.col("k"), "k2"), PE.Alias(PE.col("sv"), "b"))
    joined = a.join(b, left_on="k", right_on="k2").select(
        PE.Alias(PE.col("a"), "x"))
    return joined.union(counted.select("x")).union(
        distinct.select("x")).sort("x")


def test_insert_prefetch_wraps_exactly_the_boundaries():
    plan = _mixed_query().physical_plan()
    nodes = list(_walk(plan))
    kinds = {type(n).__name__ for n, _ in nodes}
    assert {"PrefetchExec", "AQEShuffleReadExec", "ReusedExchangeExec",
            "ShuffleExchangeExec"} <= kinds
    assert any(isinstance(n, PCPU.CpuExec) for n, _ in nodes)
    kinds_wrapped = EXCHANGES + (AQEShuffleReadExec, PCPU.CpuExec)
    for n, parent in nodes:
        if isinstance(n, PP.PrefetchExec):
            assert isinstance(n.child, kinds_wrapped), n.child
        elif isinstance(n, kinds_wrapped):
            assert isinstance(parent, PP.PrefetchExec) != _stays_bare(
                n, parent), (n, parent)
        else:
            assert not isinstance(parent, PP.PrefetchExec), (n, parent)
    assert any(isinstance(n, EXCHANGES) and isinstance(
        p, AQEShuffleReadExec) for n, p in nodes)
    # a CPU-engine node under a CPU-engine parent stays bare
    assert any(isinstance(n, PCPU.CpuExec) and isinstance(p, PCPU.CpuExec)
               for n, p in nodes)
    # the rows are those of the bare plan
    off = _mixed_query(PREFETCH_OFF).physical_plan()
    assert not any(isinstance(n, PP.PrefetchExec) for n, _ in _walk(off))
    assert execute_to_arrow(plan).equals(execute_to_arrow(off))


def test_the_fast_path_places_no_prefetch():
    t = pa.table({"k": pa.array(np.arange(500) % 5, pa.int64())})
    d = port_from_arrow(t, RapidsConf(), batch_rows=100, device="cpu",
                        partitions=4)
    q = d.union(d).group_by("k").agg(PE.Count().alias("n"))
    plan = q.physical_plan()
    assert any(isinstance(n, ShuffleExchangeExec) for n, _ in _walk(plan))
    assert not any(isinstance(n, PP.PrefetchExec) for n, _ in _walk(plan))
    assert sorted(r["n"] for r in execute_to_arrow(plan).to_pylist()) == \
        [200] * 5


# ---------------------------------------------------------------------------
# the exchange's read-ahead
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache_only", [False, True])
def test_the_exchange_reads_the_next_partition_ahead(tmp_path, cache_only):
    rng = np.random.default_rng(5)
    t = pa.table({"k": pa.array(rng.integers(0, 1000, 4000), pa.int64()),
                  "x": pa.array(rng.normal(0, 1, 4000))})
    sch = PT.Schema.from_arrow(t.schema)
    src = BatchSourceExec([[PB.batch_from_arrow(t.slice(i, 1000), "cpu")]
                           for i in range(0, 4000, 1000)], sch)
    rows = {}
    for ahead in (True, False):
        C.set_active(RapidsConf({} if ahead else PREFETCH_OFF))
        try:
            mgr = ShuffleManager(local_dir=str(tmp_path / str(ahead)),
                                 cache_only=cache_only)
            ex = ShuffleExchangeExec(PPart.HashPartitioner([0], 5), src,
                                     manager=mgr, target_batch_rows=300)
        finally:
            C.set_active(None)
        assert ex.read_ahead == ahead
        out = []
        for p in range(5):
            out.append([r for b in ex.execute(p)
                        for r in PB.batch_to_arrow(b, sch).to_pylist()])
            if ahead and p < 4:
                # the next one is being read
                assert ex._ahead.pending() == {p + 1}
            else:
                assert not ex._ahead.pending()
        rows[ahead] = out
        assert ex.metrics["shuffleBytesRead"].value == mgr.bytes_written
        ex.cleanup()
        assert not ex._ahead.running() and not ex._ahead.pending()
        if not cache_only:
            assert list((tmp_path / str(ahead)).iterdir()) == []
    assert rows[True] == rows[False]
    assert sum(len(p) for p in rows[True]) == 4000


def test_cleanup_stops_a_read_ahead_in_flight(tmp_path):
    t = pa.table({"k": pa.array(np.arange(3000) % 97, pa.int64())})
    sch = PT.Schema.from_arrow(t.schema)
    src = BatchSourceExec([[PB.batch_from_arrow(t.slice(i, 1000), "cpu")]
                           for i in range(0, 3000, 1000)], sch)
    mgr = ShuffleManager(local_dir=str(tmp_path))
    gate = threading.Event()
    real = mgr.read_partition

    def slow(reg, partition, counts=None):
        if partition == 1:
            gate.wait(5)
        return real(reg, partition, counts)

    mgr.read_partition = slow
    ex = ShuffleExchangeExec(PPart.HashPartitioner([0], 3), src, manager=mgr)
    first = list(ex.execute(0))
    assert first and ex._ahead.pending() == {1}
    gate.set()
    ex.cleanup()
    assert list(tmp_path.iterdir()) == []
    # read again from the start: written again, the same rows
    assert sum(b.num_rows for p in range(3) for b in ex.execute(p)) == 3000
    ex.cleanup()


def test_an_aqe_reader_reads_its_next_spec_ahead(tmp_path):
    """Five reduce partitions under a 1-byte advisory size keep five
    specs; with prefetch on, reading spec i starts spec i + 1, the rows
    are those of no read-ahead, and the execution's cleanup stops the
    thread before the exchange deletes its blocks."""
    rng = np.random.default_rng(6)
    t = pa.table({"k": pa.array(rng.integers(0, 1000, 4000), pa.int64()),
                  "x": pa.array(rng.normal(0, 1, 4000))})
    sch = PT.Schema.from_arrow(t.schema)
    rows = {}
    for ahead in (True, False):
        conf = RapidsConf(dict(
            {} if ahead else PREFETCH_OFF,
            **{"spark.rapids.gpu.sql.adaptive.advisoryPartitionSizeBytes":
               1}))
        src = BatchSourceExec([[PB.batch_from_arrow(t.slice(i, 1000),
                                                    "cpu")]
                               for i in range(0, 4000, 1000)], sch)
        mgr = ShuffleManager(local_dir=str(tmp_path / str(ahead)))
        ex = ShuffleExchangeExec(PPart.HashPartitioner([0], 5), src,
                                 manager=mgr, target_batch_rows=300)
        reader = AQEShuffleReadExec(ex, conf)
        assert reader.read_ahead == ahead
        out = []
        for p in range(reader.num_partitions()):
            out.append([r for b in reader.execute(p)
                        for r in PB.batch_to_arrow(b, sch).to_pylist()])
            assert reader._ahead.pending() == ({p + 1} if ahead and p < 4
                                               else set())
        assert len(out) == 5
        assert not ex._ahead.pending()  # the exchange is not read directly
        assert reader.metrics["shuffleBytesRead"].value == mgr.bytes_written
        # the next spec read ahead, then the plan's cleanup
        list(reader.execute(0))
        assert reader._ahead.pending() == ({1} if ahead else set())
        execute_to_arrow(reader)
        assert not reader._ahead.running() and not reader._ahead.pending()
        assert list((tmp_path / str(ahead)).iterdir()) == []
        rows[ahead] = out
    assert rows[True] == rows[False]
    assert sum(len(p) for p in rows[True]) == 4000


@pytest.mark.parametrize("q", ["q3", "q5"])
def test_prefetch_on_and_off_give_the_same_rows(q):
    t = PTPCH.tables_for(0.01, seed=7)
    rows = []
    for extra in ({}, PREFETCH_OFF):
        d = PTPCH.df_tables(t, RapidsConf(dict(NO_FASTPATH, **extra)),
                            batch_rows=4096, device="cpu", partitions=4)
        plan = PTPCH.DF_QUERIES[q](d).physical_plan()
        has = any(isinstance(n, PP.PrefetchExec) for n, _ in _walk(plan))
        assert has == (not extra)
        rows.append(execute_to_arrow(plan))
    assert rows[0].num_rows > 0 and rows[0].equals(rows[1])
