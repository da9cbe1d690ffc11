"""The port's memory runtime (spark_rapids_tpu_torch/mem/) against the
reference's (spark_rapids_tpu/mem/): the pool, the retry loop, the task
semaphore and the leak sweep on the same scripted operations, and the
spill framework's round trips through the host and disk tiers."""

import decimal
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch.columnar.batch import (
    batch_from_arrow, batch_to_arrow, dictionary_encode_table)
from spark_rapids_tpu_torch.mem import cleaner as PC
from spark_rapids_tpu_torch.mem import pool as PP
from spark_rapids_tpu_torch.mem import retry as PR
from spark_rapids_tpu_torch.mem import semaphore as PS
from spark_rapids_tpu_torch.mem import spill as PSP
from spark_rapids_tpu_torch import types as PT

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


def _ref():
    from spark_rapids_tpu.mem import cleaner, pool, retry, semaphore
    return pool, retry, semaphore, cleaner


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

# (op, bytes): allocations and releases against a 1000-byte limit; the
# spill callback frees what the script's spill column says
SCRIPT = [("alloc", 300), ("alloc", 500), ("alloc", 300), ("release", 500),
          ("alloc", 300), ("alloc", 400), ("alloc", 100), ("release", 300),
          ("alloc", 500), ("alloc", 1000), ("release", 300),
          ("alloc", 1000), ("release", 1000), ("alloc", 0)]


def _run_script(pool_mod, spill_frees):
    pool = pool_mod.HbmPool(1000)
    held = {"n": 0}

    def spill_fn(needed):
        # frees up to ``spill_frees`` of the live bytes, as a framework
        # spilling its oldest handles would
        freed = min(spill_frees, pool.used)
        pool.release(freed)
        held["n"] += 1
        return freed

    if spill_frees is not None:
        pool.set_spill_fn(spill_fn)
    trace = []
    for op, n in SCRIPT:
        try:
            if op == "alloc":
                pool.allocate(n)
            else:
                pool.release(min(n, pool.used))
            trace.append((op, n, "ok", pool.used, pool.free))
        except (pool_mod.RetryOOM, pool_mod.SplitAndRetryOOM) as e:
            trace.append((op, n, type(e).__name__, pool.used, pool.free))
    return trace, (pool.max_used, pool.alloc_count, pool.oom_count,
                   pool.spill_request_count)


@pytest.mark.parametrize("spill_frees", [None, 0, 200, 10_000])
def test_pool_script_matches_the_reference(spill_frees):
    rpool = _ref()[0]
    assert _run_script(PP, spill_frees) == _run_script(rpool, spill_frees)


@pytest.mark.parametrize("kind,skip,count", [("RETRY", 0, 1),
                                             ("SPLIT", 2, 2),
                                             ("RETRY", 5, 3)])
def test_oom_injection_matches_the_reference(kind, skip, count):
    rpool = _ref()[0]
    traces = []
    for mod in (PP, rpool):
        pool = mod.HbmPool(1 << 20)
        pool.set_injector(mod.OomInjector(kind, skip=skip, count=count))
        trace = []
        for i in range(8):
            try:
                pool.allocate(10)
                trace.append("ok")
            except (mod.RetryOOM, mod.SplitAndRetryOOM) as e:
                trace.append(type(e).__name__)
        traces.append((trace, pool.used, pool.alloc_count))
    assert traces[0] == traces[1]
    assert traces[0][0].count("ok") == 8 - count


def test_injector_on_one_thread_leaves_other_threads_alone():
    pool = PP.HbmPool(1 << 20)
    inj = PP.OomInjector("RETRY", count=1, thread_id=threading.get_ident())
    pool.set_injector(inj)
    errors = []

    def other():
        try:
            pool.allocate(10)
        except PP.RetryOOM as e:
            errors.append(e)

    t = threading.Thread(target=other)
    t.start()
    t.join()
    assert not errors and inj.count == 1
    with pytest.raises(PP.RetryOOM, match="injected"):
        pool.allocate(10)
    pool.allocate(10)
    assert pool.used == 20


def test_an_allocation_above_the_whole_limit_asks_for_a_split():
    """No spill can make room for more than the limit: the port raises
    SplitAndRetryOOM at once where the reference raises RetryOOM (which
    its retry loop can only repeat)."""
    rpool = _ref()[0]
    ref = rpool.HbmPool(100)
    with pytest.raises(rpool.RetryOOM):
        ref.allocate(101)
    port = PP.HbmPool(100)
    with pytest.raises(PP.SplitAndRetryOOM):
        port.allocate(101)
    assert port.used == 0 and port.oom_count == 1


def test_query_budget_raises_its_own_error():
    pool = PP.HbmPool(1000)
    pool.set_query_budget("q1", 100)
    pool.allocate(60, tag="q1")
    with pytest.raises(PP.QueryBudgetExceeded):
        pool.allocate(60, tag="q1")
    pool.allocate(500)  # untagged bytes are not the query's
    pool.release(60, tag="q1")
    pool.allocate(100, tag="q1")
    pool.clear_query_budget("q1")
    assert pool.used == 600


def test_pool_limit_on_the_cpu_is_max_bytes_or_16_gib():
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    cpu = torch.device("cpu")
    assert PP.pool_limit(RapidsConf(), cpu) == int((16 << 30) * 0.85)
    assert PP.pool_limit(RapidsConf(
        {"spark.rapids.gpu.memory.pool.maxBytes": "12345"}), cpu) == 12345
    assert PP.pool_limit(RapidsConf(
        {"spark.rapids.gpu.memory.pool.fraction": "0.5"}), cpu) == 8 << 30


# ---------------------------------------------------------------------------
# the spill framework
# ---------------------------------------------------------------------------


def _table(n=300):
    rng = np.random.default_rng(5)
    t = pa.table({
        "a": pa.array([None if i % 7 == 0 else int(x) for i, x in
                       enumerate(rng.integers(-10**12, 10**12, n))],
                      pa.int64()),
        "f": pa.array(rng.normal(size=n)),
        "s": pa.array([None if i % 11 == 0 else "x" * int(k) for i, k in
                       enumerate(rng.integers(0, 20, n))]),
        "e": pa.array([["north", "south", None, "east"][i % 4]
                       for i in range(n)]),
        "w": pa.array([None if i % 5 == 0 else decimal.Decimal(
                           int(x) * 10**12 + int(y)).scaleb(-2)
                       for i, (x, y) in enumerate(zip(
                           rng.integers(-10**13, 10**13, n),
                           rng.integers(0, 10**12, n)))],
                      pa.decimal128(30, 2)),
        "m": pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in
                       rng.integers(-10**9, 10**9, n)], pa.decimal128(12, 2)),
        "d": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                      pa.int32()).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.5),
    })
    return dictionary_encode_table(t, ["e"])


def _assert_bit_equal(a, b):
    assert a.num_rows == b.num_rows
    for ca, cb in zip(a.columns, b.columns):
        assert ca.dtype == cb.dtype
        assert ca.data.dtype == cb.data.dtype
        assert torch.equal(ca.data, cb.data)
        assert torch.equal(ca.validity, cb.validity)
        assert (ca.offsets is None) == (cb.offsets is None)
        if ca.offsets is not None:
            assert torch.equal(ca.offsets, cb.offsets)
        assert ca.dictionary is cb.dictionary


def _codecs():
    out = ["none", "zlib"]
    for name, mod in (("lz4", "lz4.frame"), ("zstd", "zstandard")):
        try:
            __import__(mod)
            out.append(name)
        except ImportError:
            pass
    return out


@pytest.mark.parametrize("codec", _codecs())
@pytest.mark.parametrize("tier", ["HOST", "DISK"])
def test_spill_round_trip_is_bit_equal(codec, tier, tmp_path):
    t = _table()
    b = batch_from_arrow(t, device="cpu")
    pool = PP.HbmPool(1 << 30)
    fw = PSP.SpillFramework(pool, host_limit_bytes=1 if tier == "DISK"
                            else 1 << 30, spill_dir=str(tmp_path),
                            chunk_bytes=4096, codec=codec)
    h = PSP.SpillableBatch(b, fw)
    assert pool.used == h.nbytes == PSP.batch_nbytes(b)
    assert fw.spill_device_bytes(1) == h.nbytes
    assert h.state == tier and pool.used == 0
    c = fw.counters()
    assert c["spilled_to_host"] == 1
    assert c["chunks_written"] == -(-h.nbytes // 4096)
    assert c["spilled_to_disk"] == (1 if tier == "DISK" else 0)
    with h as got:
        _assert_bit_equal(b, got)
        schema = PT.Schema.from_arrow(t.schema)
        assert batch_to_arrow(got, schema).equals(batch_to_arrow(b, schema))
    assert h.state == "DEVICE" and pool.used == h.nbytes
    assert not list(tmp_path.iterdir())  # the disk copy is gone
    h.close()
    assert pool.used == 0 and h.state == "CLOSED"


def test_missing_codec_fails_when_the_framework_is_made():
    try:
        import lz4.frame  # noqa: F401
        pytest.skip("lz4 is importable here")
    except ImportError:
        pass
    pool = PP.HbmPool(1000)
    with pytest.raises(ValueError, match="lz4"):
        PSP.SpillFramework(pool, codec="lz4")
    with pytest.raises(ValueError, match="unknown spill codec"):
        PSP.SpillFramework(pool, codec="snappy")


@pytest.mark.parametrize("tier", ["HOST", "DISK"])
def test_corrupt_chunk_raises_and_gives_the_bytes_back(tier, tmp_path):
    b = batch_from_arrow(_table(), device="cpu")
    pool = PP.HbmPool(1 << 30)
    fw = PSP.SpillFramework(pool, host_limit_bytes=1 if tier == "DISK"
                            else 1 << 30, spill_dir=str(tmp_path),
                            chunk_bytes=4096, codec="zlib")
    h = PSP.SpillableBatch(b, fw)
    fw.spill_device_bytes(1)
    if tier == "HOST":
        ch = h._chunks[1]
        ch.payload = bytes([ch.payload[0] ^ 0xFF]) + ch.payload[1:]
    else:
        with open(h._disk_path, "r+b") as f:
            f.seek(5)
            f.write(b"\x00\x01\x02")
    with pytest.raises(PSP.SpillCorruptionError):
        h.get()
    assert pool.used == 0 and h._pins == 0
    h.close()
    assert not list(tmp_path.iterdir())


def test_spill_takes_the_oldest_unpinned_handles_and_cascades(tmp_path):
    pool = PP.HbmPool(1 << 30)
    fw = PSP.SpillFramework(pool, host_limit_bytes=5000,
                            spill_dir=str(tmp_path), chunk_bytes=4096)
    bs = [batch_from_arrow(pa.table({"a": pa.array(
        np.arange(i * 500, i * 500 + 500))}), device="cpu")
        for i in range(4)]
    hs = [PSP.SpillableBatch(b, fw) for b in bs]
    pinned = hs[0].get()
    assert fw.spill_device_bytes(hs[1].nbytes + 1) == 2 * hs[1].nbytes
    assert [h.state for h in hs] == ["DEVICE", "DISK", "HOST", "DEVICE"]
    assert fw.host_used == hs[2].nbytes
    assert torch.equal(pinned.columns[0].data, bs[0].columns[0].data)
    hs[0].unpin()
    for h, b in zip(hs, bs):
        with h as got:
            _assert_bit_equal(b, got)
    for h in hs:
        h.close()
    assert pool.used == 0 and fw.host_used == 0
    assert not list(tmp_path.iterdir())


def test_registration_under_retry_splits_a_batch_past_the_limit():
    b = batch_from_arrow(pa.table({"a": pa.array(np.arange(1000))}),
                         device="cpu")
    pool = PP.HbmPool(5000)
    fw = PSP.SpillFramework(pool)
    PR.STATS.reset()
    hs = list(PSP.spillable([b], fw))
    # 9,000 bytes against 5,000: halves, the first spilled for the second
    assert [h.num_rows for h in hs] == [500, 500]
    assert PR.STATS.snapshot()["splits"] == 1
    assert [h.state for h in hs] == ["HOST", "DEVICE"]
    parts = []
    for h in hs:
        parts.append(h.get().columns[0].data)
        h.unpin()
    assert torch.equal(torch.cat(parts), b.columns[0].data)
    for h in hs:
        h.close()
    assert pool.used == 0


# ---------------------------------------------------------------------------
# the retry loop
# ---------------------------------------------------------------------------


def _halves(xs):
    if len(xs) <= 1:
        raise RuntimeError("cannot split")
    k = len(xs) // 2
    return [xs[:k], xs[k:]]


def _retry_run(retry_mod, pool_mod, plan):
    """with_retry over list inputs: ``plan`` maps (input, attempt) to the
    OOM to raise."""
    calls = []

    def fn(xs):
        key = (tuple(xs), sum(1 for c in calls if c == tuple(xs)))
        calls.append(tuple(xs))
        kind = plan.get(key)
        if kind == "RETRY":
            raise pool_mod.RetryOOM("scripted")
        if kind == "SPLIT":
            raise pool_mod.SplitAndRetryOOM("scripted")
        return sum(xs)

    out = list(retry_mod.with_retry([[1, 2, 3, 4], [5, 6], [7]], fn,
                                    split_fn=_halves, max_attempts=4))
    return out, calls


@pytest.mark.parametrize("plan", [
    {},
    {((1, 2, 3, 4), 0): "RETRY", ((1, 2, 3, 4), 1): "RETRY"},
    {((1, 2, 3, 4), 0): "SPLIT", ((3, 4), 0): "SPLIT"},
    {((5, 6), 0): "RETRY", ((5, 6), 1): "SPLIT", ((7,), 0): "RETRY"},
])
def test_with_retry_matches_the_reference(plan):
    rpool, rretry = _ref()[:2]
    assert _retry_run(PR, PP, plan) == _retry_run(rretry, rpool, plan)


def test_with_retry_gives_up_after_max_attempts_as_the_reference():
    rpool, rretry = _ref()[:2]
    plan = {((7,), i): "RETRY" for i in range(10)}
    with pytest.raises(PP.RetryOOM):
        _retry_run(PR, PP, plan)
    with pytest.raises(rpool.RetryOOM):
        _retry_run(rretry, rpool, plan)


def test_with_retry_does_not_catch_other_errors():
    def fn(x):
        raise MemoryError("not a pool OOM")

    with pytest.raises(MemoryError):
        list(PR.with_retry([[1]], fn))


def test_split_batch_half_rows_match_the_reference():
    from spark_rapids_tpu.columnar.batch import (
        batch_from_arrow as rbatch, batch_to_arrow as rto)
    from spark_rapids_tpu import types as RT

    t = _table(301).select(["a", "f", "s", "m", "d", "b"])
    port = PR.split_batch_half(batch_from_arrow(t, device="cpu"))
    ref = _ref()[1].split_batch_half(rbatch(t))
    ps, rs = PT.Schema.from_arrow(t.schema), RT.Schema.from_arrow(t.schema)
    for p, r in zip(port, ref):
        assert batch_to_arrow(p, ps).to_pylist() == \
            rto(r, rs).to_pylist()
    with pytest.raises(PP.SplitAndRetryOOM):
        PR.split_batch_half(batch_from_arrow(t.slice(0, 1), device="cpu"))


def test_get_with_retry_retries_a_refused_unspill():
    b = batch_from_arrow(pa.table({"a": pa.array(np.arange(100))}),
                         device="cpu")
    pool = PP.HbmPool(1 << 20)
    fw = PSP.SpillFramework(pool)
    h = PSP.SpillableBatch(b, fw)
    fw.spill_device_bytes(1)
    pool.set_injector(PP.OomInjector("SPLIT", count=1))
    PR.STATS.reset()
    got = PR.get_with_retry(h)
    assert torch.equal(got.columns[0].data, b.columns[0].data)
    assert PR.STATS.snapshot()["retries"] == 1
    h.unpin()
    h.close()
    assert pool.used == 0


# ---------------------------------------------------------------------------
# the task semaphore
# ---------------------------------------------------------------------------


def _grant_order(sem_mod, waiters, permits=1):
    """Task ids in the order they were granted: the main thread holds
    the permits, each waiter queues (one at a time, so arrival order is
    the list's), then the permits go back."""
    sem = sem_mod.TaskSemaphore(permits=permits,
                                starvation_ns=60_000_000_000)
    for i in range(permits):
        sem.acquire(("main", i))
    order, lock = [], threading.Lock()

    def run(tid, prio):
        sem.acquire(tid, priority=prio)
        with lock:
            order.append(tid)
        time.sleep(0.01)
        sem.release(tid)

    threads = []
    for tid, prio in waiters:
        th = threading.Thread(target=run, args=(tid, prio))
        th.start()
        threads.append(th)
        while str(tid) not in sem.snapshot()["waiters"]:
            time.sleep(0.001)
    for i in range(permits):
        sem.release(("main", i))
    for th in threads:
        th.join()
    snap = sem.snapshot()
    return order, snap["acquire_count"], snap["max_waiters"]


@pytest.mark.parametrize("waiters", [
    [("a", 0), ("b", 0), ("c", 0)],
    [("a", 0), ("b", 5), ("c", 1), ("d", 5)],
    [("a", -1), ("b", 0), ("c", 9)],
])
def test_grant_order_under_priority_matches_the_reference(waiters):
    rsem = _ref()[2]
    assert _grant_order(PS, waiters) == _grant_order(rsem, waiters)


def test_semaphore_reentry_timeout_cancel_and_resize():
    sem = PS.TaskSemaphore(permits=1)
    assert sem.acquire("a") and sem.acquire("a")  # re-entrant
    assert sem.acquire("b", timeout_ms=20) is False
    with pytest.raises(KeyError):
        sem.acquire("c", cancel_check=lambda: (_ for _ in ()).throw(
            KeyError("cancelled")))
    snap = sem.snapshot()
    assert snap["timeout_count"] == 1 and snap["cancel_count"] == 1
    assert snap["waiters"] == {} and snap["holders"] == {"a": 2}
    sem.resize(2)
    assert sem.acquire("b", timeout_ms=1000)
    sem.release("a")
    sem.release("a")
    sem.release("b")
    assert sem.snapshot()["holders"] == {}
    with sem.held("z"):
        assert sem.held_by("z")
    assert not sem.held_by("z")


def test_process_semaphore_follows_the_conf():
    from spark_rapids_tpu_torch.config.conf import RapidsConf

    sem = PS.get_task_semaphore(RapidsConf(
        {"spark.rapids.gpu.sql.concurrentGpuTasks": "3"}))
    assert sem.permits == 3
    assert PS.get_task_semaphore(RapidsConf()) is sem
    assert sem.permits == 2


# ---------------------------------------------------------------------------
# the leak sweep
# ---------------------------------------------------------------------------


def test_sweep_reports_what_the_reference_reports():
    rpool, _, _, rclean = _ref()
    reports = []
    for pool_mod, clean in ((PP, PC), (rpool, rclean)):
        pool = pool_mod.HbmPool(1000)
        pool.allocate(987)
        # (the reference adds its memtrack attribution when that is on)
        leaks = [x for x in clean.sweep()
                 if x.startswith("HbmPool") and "987 bytes" in x]
        pool.release(987)
        after = [x for x in clean.sweep()
                 if x.startswith("HbmPool") and "987 bytes" in x]
        reports.append((leaks, after))
    assert reports[0] == reports[1]
    assert reports[0][0] == ["HbmPool: 987 bytes outstanding (allocs=1)"]


def test_sweep_reports_live_handles_and_orphan_files(tmp_path):
    b = batch_from_arrow(pa.table({"a": pa.array(np.arange(100))}),
                         device="cpu")
    pool = PP.HbmPool(1 << 20)
    fw = PSP.SpillFramework(pool, host_limit_bytes=1,
                            spill_dir=str(tmp_path))
    h = PSP.SpillableBatch(b, fw)
    assert any("unclosed handles" in x for x in PC.sweep())
    fw.spill_device_bytes(1)
    assert h.state == "DISK"
    assert not any(str(tmp_path) in x for x in PC.sweep())
    (tmp_path / "stray.spill.chunks").write_bytes(b"x")
    assert any("1 orphan spill files" in x and str(tmp_path) in x
               for x in PC.sweep())
    (tmp_path / "stray.spill.chunks").unlink()
    h.close()
    with pytest.raises(AssertionError, match="HbmPool"):
        pool.allocate(5)
        PC.assert_clean()
    pool.release(5)
    assert not [x for x in PC.sweep() if str(tmp_path) in x]


def test_sweep_reports_a_shuffle_never_cleaned(tmp_path):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

    m = ShuffleManager(local_dir=str(tmp_path), writer_threads=1)
    schema = T.Schema([T.Field("a", T.LONG)])
    reg = m.register(schema, 2)
    m.write_map_output(reg, {0: [pa.table({"a": pa.array([1, 2])})]}, 0)
    assert any(f"shuffle {reg.shuffle_id} never cleaned" in x
               for x in PC.sweep() if "ShuffleManager" in x)
    m.cleanup(reg)
    assert m.registrations() == {}
    m.writer_pool.shutdown()
