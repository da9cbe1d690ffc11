"""The plan memo (``plan/plan_cache.py``) and the small-query fast path on
the port, against the JAX package's memo over the same sequences
(``tests/test_plan_cache.py``: a warm repeat hits, a conf change, a
literal change and an output rename miss, an intermediate rename hits,
disabled, the LRU, the epoch bump, a dead table; the three fast-path
cases), with the port's counters moving as the reference's. Then what
the port adds: a Parquet file rewritten under the same path (the
reference serves its tree, stale rows and all; the port keys the files'
sizes and modification times), two threads running one query, one
run's metrics read with the memo off, and an idle memoised tree holding
no shuffle file, pool bytes, spill handle or thread.
"""

import gc
import os
import threading
import weakref

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.plan as JP
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import plan_cache as jplan_cache
from spark_rapids_tpu_torch.config import conf as PC
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.mem.semaphore import get_task_semaphore
from spark_rapids_tpu_torch.plan import plan_cache
from spark_rapids_tpu_torch.plan.dataframe import from_arrow, read_parquet

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


class _Pkg:
    """One package's surface for the shared sequences."""

    def __init__(self, name):
        self.name = name
        self.E = JE if name == "jax" else PE
        self.memo = jplan_cache if name == "jax" else plan_cache
        self.prefix = "spark.rapids.tpu." if name == "jax" else \
            "spark.rapids.gpu."

    def conf(self, **kv):
        C = JC if self.name == "jax" else PC
        return C.RapidsConf({self.prefix + k: v for k, v in kv.items()})

    def frame(self, table, conf):
        if self.name == "jax":
            return JP.from_arrow(table, conf=conf)
        return from_arrow(table, conf=conf, device="cpu")


PKGS = (_Pkg("jax"), _Pkg("port"))


def _table(n=500, seed=0):
    # a fresh table object a call: memo keys pin the table's identity
    return pa.table({"a": [(i * 7 + seed) % 97 for i in range(n)],
                     "b": [float(i + seed) for i in range(n)]})


def _agg_query(pkg, table, conf, out_name="s"):
    E = pkg.E
    return (pkg.frame(table, conf).filter(E.col("a") > E.lit(10))
            .group_by(E.col("a"))
            .agg(E.Alias(E.Sum(E.col("b")), out_name)))


def _deltas(seq):
    """``seq(pkg)`` on both packages: each one's counter deltas (and
    whatever ``seq`` returns), which must be equal. Each memo starts
    empty: the plans other tests left there would be evicted at other
    times in the two."""
    out = {}
    for pkg in PKGS:
        pkg.memo.clear()
        c0 = pkg.memo.counters()
        res = seq(pkg)
        c1 = pkg.memo.counters()
        out[pkg.name] = ({k: c1[k] - c0[k] for k in c1
                          if k != "plan_cache_size"}, res)
    assert out["port"][0] == out["jax"][0]
    return out["port"]


def test_warm_repeat_hits():
    def seq(pkg):
        t, conf = _table(), pkg.conf()
        first = _agg_query(pkg, t, conf).to_arrow()
        c1 = pkg.memo.counters()
        second = _agg_query(pkg, t, conf).to_arrow()
        c2 = pkg.memo.counters()
        assert c2["plan_cache_hit_total"] == c1["plan_cache_hit_total"] + 1
        assert second.equals(first)
        return sorted(first.to_pylist(), key=repr)

    d, rows = _deltas(seq)
    assert d["plan_cache_miss_total"] == 1 and d["plan_cache_hit_total"] == 1
    assert len(rows) == 86


def test_conf_change_misses():
    def seq(pkg):
        t = _table(seed=1)
        base = pkg.conf()
        _agg_query(pkg, t, base).to_arrow()
        for override in ({"sql.exchange.reuse.enabled": False},
                         {"sql.agg.repartition.targetBytes": 123456}):
            c0 = pkg.memo.counters()
            _agg_query(pkg, t, pkg.conf(**override)).to_arrow()
            c1 = pkg.memo.counters()
            assert c1["plan_cache_hit_total"] == c0["plan_cache_hit_total"]
            assert c1["plan_cache_miss_total"] > c0["plan_cache_miss_total"]

    d, _ = _deltas(seq)
    assert d["plan_cache_hit_total"] == 0 and d["plan_cache_miss_total"] == 3


def test_literal_change_misses_rename_hits():
    def seq(pkg):
        E = pkg.E
        t, conf = _table(seed=2), pkg.conf()

        def q(mid, cutoff):
            return (pkg.frame(t, conf)
                    .select(E.Alias(E.col("a"), mid),
                            E.Alias(E.col("b"), "bb"))
                    .filter(E.col(mid) > E.lit(cutoff))
                    .select(E.Alias(E.col(mid), "out"), E.col("bb")))

        first = q("x", 5).to_arrow()
        c0 = pkg.memo.counters()
        renamed = q("y", 5).to_arrow()
        c1 = pkg.memo.counters()
        assert c1["plan_cache_hit_total"] == c0["plan_cache_hit_total"] + 1
        assert renamed.equals(first)
        q("x", 6).to_arrow()
        c2 = pkg.memo.counters()
        assert c2["plan_cache_hit_total"] == c1["plan_cache_hit_total"]
        assert c2["plan_cache_miss_total"] == c1["plan_cache_miss_total"] + 1

    _deltas(seq)


def test_output_rename_misses():
    def seq(pkg):
        t, conf = _table(seed=3), pkg.conf()
        _agg_query(pkg, t, conf, out_name="s").to_arrow()
        c0 = pkg.memo.counters()
        out = _agg_query(pkg, t, conf, out_name="renamed").to_arrow()
        assert pkg.memo.counters()["plan_cache_hit_total"] == \
            c0["plan_cache_hit_total"]
        assert "renamed" in out.column_names

    _deltas(seq)


def test_disabled_never_caches():
    def seq(pkg):
        t = _table(seed=4)
        conf = pkg.conf(**{"plan.cache.enabled": False})
        _agg_query(pkg, t, conf).to_arrow()
        _agg_query(pkg, t, conf).to_arrow()

    d, _ = _deltas(seq)
    assert d["plan_cache_hit_total"] == d["plan_cache_miss_total"] == 0


def test_lru_eviction():
    def seq(pkg):
        conf = pkg.conf(**{"plan.cache.maxEntries": 2})
        pkg.memo.clear()
        for t in [_table(seed=10 + i) for i in range(3)]:
            _agg_query(pkg, t, conf).to_arrow()
        assert pkg.memo.counters()["plan_cache_size"] <= 2

    d, _ = _deltas(seq)
    assert d["plan_cache_evict_total"] == 1


def test_max_entries_is_at_least_one():
    with pytest.raises(ValueError, match="maxEntries"):
        PC.RapidsConf({"spark.rapids.gpu.plan.cache.maxEntries": 0})


def test_epoch_bump_invalidates():
    def seq(pkg):
        t, conf = _table(seed=5), pkg.conf()
        _agg_query(pkg, t, conf).to_arrow()
        pkg.memo.bump_epoch()
        c0 = pkg.memo.counters()
        _agg_query(pkg, t, conf).to_arrow()
        c1 = pkg.memo.counters()
        assert c1["plan_cache_hit_total"] == c0["plan_cache_hit_total"]
        assert c1["plan_cache_miss_total"] == c0["plan_cache_miss_total"] + 1

    _deltas(seq)


def test_dead_table_entry_invalidated():
    """An entry whose pinned table died is never served (a reused id must
    not alias a new table onto a stale plan); on the port it is dropped,
    and its tree's device batches go with it."""
    def seq(pkg):
        conf = pkg.conf()
        t = _table(seed=6)
        df = _agg_query(pkg, t, conf)
        df.to_arrow()
        pinned = []
        key = pkg.memo.build_key(df.plan, conf, df.shuffle_partitions,
                                 pinned)
        assert key is not None and pkg.memo.lookup(key) is not None
        del df, t, pinned
        gc.collect()
        assert pkg.memo.lookup(key) is None

    _deltas(seq)
    conf = PC.RapidsConf()
    t = _table(seed=7)
    df = _agg_query(PKGS[1], t, conf)
    plan = df.physical_plan()
    src = plan
    while src.children:
        src = src.children[0]
    batch = weakref.ref(src._parts[0][0].columns[0].data)
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    execute_to_arrow(plan)
    before = plan_cache.counters()["plan_cache_size"]
    del df, t, plan, src
    gc.collect()
    cleaner.run_deferred()
    assert batch() is None
    assert plan_cache.counters()["plan_cache_size"] == before - 1


# -- the small-query fast path ---------------------------------------------

def test_fastpath_no_prefetch_threads_bit_identical():
    t = _table(n=200, seed=7)
    on = PC.RapidsConf()
    off = PC.RapidsConf({"spark.rapids.gpu.fastpath.enabled": False})
    sem = get_task_semaphore()
    before = {th.name for th in threading.enumerate()}
    acquires = sem.acquire_count
    df = _agg_query(PKGS[1], t, on)
    assert getattr(df.physical_plan(), "_fastpath", False) is True
    fast = df.to_arrow()
    new = [n for n in {th.name for th in threading.enumerate()} - before
           if n.startswith("srgpu-prefetch")]
    assert new == []
    assert sem.acquire_count == acquires
    slow_df = _agg_query(PKGS[1], t, off)
    assert getattr(slow_df.physical_plan(), "_fastpath", False) is False
    assert fast.equals(slow_df.to_arrow())


def test_fastpath_threshold_disqualifies_large_input():
    big = pa.table({"a": list(range(200_000)), "b": [0.0] * 200_000})
    df = from_arrow(big, conf=PC.RapidsConf(), device="cpu")
    node = df.filter(PE.col("a") > PE.lit(1)).physical_plan()
    assert getattr(node, "_fastpath", False) is False


def test_offpath_takes_semaphore():
    big = pa.table({"a": list(range(200_000)), "b": [0.0] * 200_000})
    sem = get_task_semaphore()
    acquires = sem.acquire_count
    from_arrow(big, conf=PC.RapidsConf(), device="cpu").filter(
        PE.col("a") > PE.lit(1)).to_arrow()
    assert sem.acquire_count > acquires


# -- what the port adds ----------------------------------------------------

def test_a_file_rewritten_under_the_same_path(tmp_path):
    """Reference fault: the reference keys a Parquet scan by its paths,
    so a broadcast join whose build file was rewritten is served the tree
    that replays the old build. The port keys the files' sizes and
    modification times, plans again and reads the new rows."""
    probe, build = str(tmp_path / "p.parquet"), str(tmp_path / "b.parquet")

    def write_build(n, w):
        pq.write_table(pa.table({"k": list(range(n)), "w": [w] * n}), build)
        st = os.stat(build)
        os.utime(build, ns=(st.st_atime_ns, st.st_mtime_ns + n))

    pq.write_table(pa.table({"k": list(range(10)), "v": [1.0] * 10}), probe)

    def seq(pkg):
        write_build(5, 2.0)
        conf = pkg.conf()

        def run():
            if pkg.name == "jax":
                a, b = (JP.read_parquet(probe, conf=conf),
                        JP.read_parquet(build, conf=conf))
            else:
                a, b = (read_parquet(probe, conf=conf, device="cpu"),
                        read_parquet(build, conf=conf, device="cpu"))
            return sorted((r["k"], r["w"])
                          for r in a.join(b, on="k").collect())

        first = run()
        write_build(3, 3.0)
        return first, run(), pkg.memo.counters()

    got = {}
    for pkg in PKGS:
        c0 = pkg.memo.counters()
        first, second, c1 = seq(pkg)
        got[pkg.name] = (first, second,
                         c1["plan_cache_hit_total"] - c0["plan_cache_hit_total"])
    old = [(k, 2.0) for k in range(5)]
    assert got["jax"] == (old, old, 1)
    assert got["port"] == (old, [(k, 3.0) for k in range(3)], 0)


def test_two_threads_running_one_query():
    """A tree is lent to one run at a time: a thread asking for a busy
    entry's key plans its own tree and counts a miss; every run gives the
    same rows."""
    t, conf = _table(seed=8), PC.RapidsConf()
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    c0 = plan_cache.counters()
    plan_a = _agg_query(PKGS[1], t, conf).physical_plan()  # lent to A
    box = {}
    th = threading.Thread(target=lambda: box.update(
        b=_agg_query(PKGS[1], t, conf).physical_plan()))
    th.start()
    th.join()
    plan_b = box["b"]
    c1 = plan_cache.counters()
    assert plan_b is not plan_a
    assert c1["plan_cache_miss_total"] - c0["plan_cache_miss_total"] == 2
    assert c1["plan_cache_hit_total"] == c0["plan_cache_hit_total"]
    expected = sorted(execute_to_arrow(plan_a).to_pylist(), key=repr)
    results, errors = [], []

    def worker():
        try:
            for _ in range(3):
                results.append(sorted(
                    _agg_query(PKGS[1], t, conf).to_arrow().to_pylist(),
                    key=repr))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == []
    assert len(results) == 6 and all(r == expected for r in results)
    c2 = plan_cache.counters()
    runs = (c2["plan_cache_hit_total"] - c1["plan_cache_hit_total"]
            + c2["plan_cache_miss_total"] - c1["plan_cache_miss_total"])
    assert runs == 6
    # every run has ended: the entry's last tree is idle again
    assert _agg_query(PKGS[1], t, conf).to_arrow().sort_by("a").equals(
        execute_to_arrow(plan_b).sort_by("a"))
    assert plan_cache.counters()["plan_cache_hit_total"] == \
        c2["plan_cache_hit_total"] + 1
    assert cleaner.sweep() == []


def test_one_runs_metrics_with_the_memo_off():
    """Metrics add up over the runs of one tree, as in the reference: a
    served tree's counts include its earlier runs. Planned with the key
    false, a run's metrics are its own."""
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    t = _table(seed=9)

    def rows_out(conf):
        plan = _agg_query(PKGS[1], t, conf).physical_plan()
        execute_to_arrow(plan)
        return plan.metrics["numOutputRows"].value

    on = PC.RapidsConf()
    assert [rows_out(on) for _ in range(3)] == [86, 172, 258]
    off = PC.RapidsConf({"spark.rapids.gpu.plan.cache.enabled": False})
    assert [rows_out(off) for _ in range(2)] == [86, 86]


def test_an_idle_memoised_tree_holds_nothing():
    """Between runs a memoised tree holds no shuffle file, no pool bytes,
    no spill handle and no thread: a partitioned query with a range sort
    (whose planning samples its child) run three times, twice served."""
    from spark_rapids_tpu_torch.mem.pool import get_pool
    from spark_rapids_tpu_torch.shuffle.manager import get_manager

    conf = PC.RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"})
    t = _table(n=4000, seed=11)

    def run():
        df = from_arrow(t, conf=conf, batch_rows=500, device="cpu",
                        partitions=4)
        df.shuffle_partitions = 4
        q = df.group_by("a").agg(PE.Alias(PE.Sum(PE.col("b")), "s")).sort(
            "a")
        return q.to_arrow()

    d = get_manager(conf)._local_dir
    files = (lambda: sorted(os.listdir(d)) if d and os.path.isdir(d)
             else [])
    before = files()
    c0 = plan_cache.counters()
    first = run()
    # the process-wide shuffle manager's writer pool starts with the first
    # shuffle; a tree's own threads (prefetch, read-ahead) end with its run
    threads = {th.name for th in threading.enumerate()}
    for _ in range(2):
        assert run().equals(first)
        assert cleaner.sweep() == [] and files() == before
        assert get_pool().used == 0
        assert {th.name for th in threading.enumerate()} <= threads
    c1 = plan_cache.counters()
    assert c1["plan_cache_hit_total"] - c0["plan_cache_hit_total"] == 2


def _join_tables(seed):
    rng = np.random.default_rng(seed)
    facts = pa.table({"k": pa.array(rng.integers(0, 40, 3000), pa.int64()),
                      "v": pa.array(rng.integers(-500, 500, 3000),
                                    pa.int64())})
    dims = pa.table({"k": pa.array(np.arange(40), pa.int64()),
                     "w": pa.array(rng.integers(0, 9, 40), pa.int64())})
    return facts, dims


def _bcast_query(facts, dims, conf):
    """A broadcast join under an aggregate, its facts in 4 splits."""
    left = from_arrow(facts, conf=conf, batch_rows=500, device="cpu",
                      partitions=4)
    return (left.join(from_arrow(dims, conf=conf, device="cpu"), on="k")
            .group_by("w").agg(PE.Alias(PE.Sum(PE.col("v")), "s")))


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def test_an_idle_memoised_tree_holds_no_broadcast_build(monkeypatch):
    """Going idle, a memoised tree drops what its run built: the broadcast
    build's hash table is collected and no build or replayed build side
    stays on the tree. A served run builds again, as often as a run of a
    tree planned afresh (the memo off) does, and gives the same rows."""
    from spark_rapids_tpu_torch.exec.dpp import ReplayExec
    from spark_rapids_tpu_torch.exec.join_bcast import BroadcastHashJoinExec
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    built = []
    real = BroadcastHashJoinExec._build

    def recording(self, batches):
        out = real(self, batches)
        built.append([weakref.ref(t) for t in _tensors(out[1])])
        return out

    monkeypatch.setattr(BroadcastHashJoinExec, "_build", recording)
    facts, dims = _join_tables(seed=12)
    on = PC.RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"})
    off = PC.RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false",
                         "spark.rapids.gpu.plan.cache.enabled": "false"})
    c0 = plan_cache.counters()
    first = _bcast_query(facts, dims, on).to_arrow().sort_by("w")
    assert len(built) == 1 and built[0]
    gc.collect()
    assert all(ref() is None for ref in built[0])
    plan = _bcast_query(facts, dims, on).physical_plan()  # served
    joins = [n for n in _walk(plan) if isinstance(n, BroadcastHashJoinExec)]
    replays = [n for n in _walk(plan) if isinstance(n, ReplayExec)]
    assert joins and replays
    assert all(j._broadcast is None for j in joins)
    assert all(r.materialized() is None for r in replays)
    assert execute_to_arrow(plan).sort_by("w").equals(first)
    served = len(built) - 1
    assert _bcast_query(facts, dims, off).to_arrow().sort_by("w").equals(
        first)
    assert served == len(built) - 1 - served == 1
    c1 = plan_cache.counters()
    assert c1["plan_cache_hit_total"] - c0["plan_cache_hit_total"] == 1


def test_a_kept_tree_run_again_takes_turns_with_the_memo(monkeypatch):
    """A caller keeps its tree and runs it again after its first run gave
    it back to the memo, while another thread is served the same tree:
    the runs of the one tree take turns, and all give the same rows."""
    import time

    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

    facts, dims = _join_tables(seed=13)
    conf = PC.RapidsConf({"spark.rapids.gpu.fastpath.enabled": "false"})
    plan = _bcast_query(facts, dims, conf).physical_plan()
    expected = execute_to_arrow(plan).sort_by("w")
    active, overlaps = {}, []
    lock = threading.Lock()
    real = type(plan).execute

    def execute(self, partition):
        with lock:
            active[id(self)] = active.get(id(self), 0) + 1
            if active[id(self)] > 1:
                overlaps.append(id(self))
        try:
            time.sleep(0.005)  # widens the window two runs would share
            yield from real(self, partition)
        finally:
            with lock:
                active[id(self)] -= 1

    monkeypatch.setattr(type(plan), "execute", execute)
    results, errors = [], []

    def keeper():
        try:
            for _ in range(4):
                results.append(execute_to_arrow(plan).sort_by("w"))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    def borrower():
        try:
            for _ in range(4):
                results.append(
                    _bcast_query(facts, dims, conf).to_arrow().sort_by("w"))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=keeper),
               threading.Thread(target=borrower)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert errors == [] and overlaps == []
    assert len(results) == 8 and all(r.equals(expected) for r in results)
    assert cleaner.sweep() == []
