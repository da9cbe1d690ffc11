"""What a reused plan runs (counterpart of spark_rapids_tpu/exec/reuse.py;
Spark's ReusedExchangeExec, the reference replaying one broadcast across
its consumers). The plan-time rewrite is ``plan/reuse.py``.

- ``ReusedExchangeExec`` and ``ReusedBroadcastExec``: leaves that alias the
  exchange or broadcast build a reuse group keeps. The kept node is an
  attribute, not a child, so plan walks stay trees and the shared subtree
  runs once.
- ``SharedExchangeEntry``: the reduce partitions of a kept exchange read
  directly by several consumers. The first read of a partition runs it
  and holds its device batches; the others replay them. It is counted per
  consumer and releases what it holds when the last one is cleaned up,
  so a plan run again reads afresh.
- ``MaterializationCache``: the process's caps on what the entries hold
  (``spark.rapids.gpu.sql.exchange.reuse.cache.maxBytes``/``maxEntries``).
  When a new partition does not fit, idle entries are evicted by
  ascending retention score (``EVICT_COST_WEIGHT * log2(bytes + 1)`` plus
  a recency term halving every ``EVICT_RECENCY_HALFLIFE_S`` seconds since
  the last read; the reference's default ``eviction.costWeight`` and
  ``eviction.recencyHalfLifeS``, constants until a workload sets them);
  an entry with a replay in flight is never evicted. What still
  does not fit is not held: its later readers read the shuffle again
  (one map-side write all the same), so the caps bound memory, never
  the rows. Batches are held as spillable handles (``mem/spill.py``), so
  pool pressure sheds them to the host like any operator's state; a
  partition the pool refuses is not held either. Only direct reads of a
  kept exchange go through its entry: at the defaults an AQE reader reads a hash or range exchange's
  blocks itself, so an entry holds the partition of a reused single
  exchange, or any kept exchange's partitions with AQE off.
- ``SharedBroadcast``: one prepared broadcast build (the batch and its
  hash table or sorted hashes) shared by broadcast joins with equal
  build sides and build keys (``exec/join_bcast.py``).

Counters (``counters()``): ``reuse_exchanges_total`` and
``reuse_broadcasts_total`` (aliases the rewrite placed),
``reuse_subqueries_total`` (dynamic pruning filters merged or pointed at
a surviving build), ``reuse_bytes_saved_total`` (bytes not written, read
or built again), ``reuse_evict_total``, ``reuse_evict_bytes_total`` and
``reuse_evict_skipped_active_total``.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from typing import Callable, Dict, Iterator, List, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.base import DeviceExec
from spark_rapids_tpu_torch.mem import cleaner, retry, spill

# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

_counters_lock = threading.Lock()
_counters: Dict[str, int] = {
    "reuse_exchanges_total": 0,
    "reuse_broadcasts_total": 0,
    "reuse_subqueries_total": 0,
    "reuse_bytes_saved_total": 0,
    "reuse_evict_total": 0,
    "reuse_evict_bytes_total": 0,
    "reuse_evict_skipped_active_total": 0,
}


def note(name: str, n: int = 1) -> None:
    with _counters_lock:
        _counters[name] += int(n)


def counters() -> Dict[str, int]:
    with _counters_lock:
        return dict(_counters)


def reset_counters() -> None:
    with _counters_lock:
        for k in _counters:
            _counters[k] = 0


def batch_nbytes(b: ColumnarBatch) -> int:
    """Device bytes of a batch's tensors (a dictionary column's dictionary
    and a nested column's children included)."""
    total = 0
    cols = list(b.columns)
    while cols:
        c = cols.pop()
        for t in (c.data, c.validity, c.offsets):
            if t is not None:
                total += t.numel() * t.element_size()
        if c.dictionary is not None:
            cols.append(c.dictionary)
        cols.extend(c.children or ())
    return total


# ---------------------------------------------------------------------------
# the cache's caps and eviction
# ---------------------------------------------------------------------------

# the retention score's weights: the reference's defaults of
# spark.rapids.tpu.sql.exchange.reuse.eviction.costWeight and
# .recencyHalfLifeS
EVICT_COST_WEIGHT = 1.0
EVICT_RECENCY_HALFLIFE_S = 300.0


class CacheLimits:
    """The cache settings of one plan, read from its conf at plan time."""

    def __init__(self, conf: C.RapidsConf):
        self.max_bytes = C.REUSE_CACHE_MAX_BYTES.get(conf)
        self.max_entries = C.REUSE_CACHE_MAX_ENTRIES.get(conf)
        self.evict = C.REUSE_EVICT_ENABLED.get(conf)


class MaterializationCache:
    """Byte and entry accounting over the held partitions of every
    ``SharedExchangeEntry`` (see the module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.bytes_used = 0
        self.entry_count = 0
        # id(entry) -> {"ref", "nbytes", "last_access"}: admitted entries
        self._registry: Dict[int, Dict] = {}

    def admit(self, entry: "SharedExchangeEntry", nbytes: int) -> bool:
        lim = entry.limits
        if self._admit(entry, nbytes, lim):
            return True
        if not lim.evict:
            return False
        self._make_room(entry, nbytes, lim)
        return self._admit(entry, nbytes, lim)

    def _admit(self, entry, nbytes: int, lim: CacheLimits) -> bool:
        with self._lock:
            rec = self._registry.get(id(entry))
            if rec is None and self.entry_count >= lim.max_entries:
                return False
            if self.bytes_used + nbytes > lim.max_bytes:
                return False
            if rec is None:
                rec = self._registry[id(entry)] = {
                    "ref": weakref.ref(entry), "nbytes": 0}
                self.entry_count += 1
            self.bytes_used += nbytes
            rec["nbytes"] += nbytes
            rec["last_access"] = time.monotonic()
            return True

    def touch(self, entry) -> None:
        """A replay: the entry's recency restarts."""
        with self._lock:
            rec = self._registry.get(id(entry))
            if rec is not None:
                rec["last_access"] = time.monotonic()

    @staticmethod
    def _retention(rec: Dict, now: float) -> float:
        recency = 2.0 ** (-(now - rec["last_access"])
                          / EVICT_RECENCY_HALFLIFE_S)
        return EVICT_COST_WEIGHT * math.log2(rec["nbytes"] + 1) + recency

    def _make_room(self, entry, nbytes: int, lim: CacheLimits) -> None:
        """Evict idle entries, lowest retention first, until ``nbytes``
        of ``entry`` would fit. Runs without the cache lock: eviction
        comes back through ``evict``."""
        now = time.monotonic()
        with self._lock:
            candidates = []
            for eid, rec in self._registry.items():
                victim = rec["ref"]()
                if eid == id(entry) or victim is None:
                    continue
                candidates.append((self._retention(rec, now), eid,
                                   victim))
            need_entry = id(entry) not in self._registry
        candidates.sort(key=lambda c: (c[0], c[1]))
        for _score, _eid, victim in candidates:
            with self._lock:
                if (self.bytes_used + nbytes <= lim.max_bytes
                        and (not need_entry
                             or self.entry_count < lim.max_entries)):
                    return
            freed = victim.evict_cached()
            if freed < 0:
                note("reuse_evict_skipped_active_total")
            elif freed > 0:
                note("reuse_evict_total")
                note("reuse_evict_bytes_total", freed)

    def give_back(self, entry, nbytes: int) -> None:
        """Return ``nbytes`` admitted for ``entry`` and not held."""
        with self._lock:
            rec = self._registry.get(id(entry))
            if rec is not None:
                rec["nbytes"] -= nbytes
                self.bytes_used -= nbytes

    def evict(self, entry) -> None:
        """Drop an entry's accounting (it holds nothing any more)."""
        self._forget(id(entry))

    def _forget(self, eid: int) -> None:
        with self._lock:
            rec = self._registry.pop(eid, None)
            if rec is not None:
                self.bytes_used -= rec["nbytes"]
                self.entry_count -= 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"bytes_used": self.bytes_used,
                    "entries": self.entry_count}


MATERIALIZATION_CACHE = MaterializationCache()


class _Held:
    """One held reduce partition: its batches' spillable handles and
    their bytes."""

    __slots__ = ("handles", "nbytes")

    def __init__(self, handles: List[spill.SpillableBatch], nbytes: int):
        self.handles = handles
        self.nbytes = nbytes

    def close(self) -> None:
        for h in self.handles:
            h.close()


def _hold(batches: List[ColumnarBatch], nbytes: int) -> Optional[_Held]:
    """The batches as spillable handles, or None (nothing held) when the
    pool refuses one of them."""
    handles = []
    for b in batches:
        h = spill.try_spillable(b)
        if h is None:
            for held in handles:
                held.close()
            return None
        handles.append(h)
    return _Held(handles, nbytes)


_UNCACHED = object()  # a partition the cache did not admit


def _drop_entry(cache, key: int, parts: Dict[int, object]) -> None:
    """A collected entry's release: its held partitions closed, its bytes
    given back."""
    for held in parts.values():
        if held is not _UNCACHED:
            held.close()
    parts.clear()
    cache._forget(key)


class SharedExchangeEntry:
    """The reduce partitions of a kept exchange, for its direct consumers
    (the exchange and each ``ReusedExchangeExec``).

    ``retain(n)`` at plan time counts the consumers; each one's cleanup
    calls ``release()``, and the last releases what is held and restores
    the count, so a plan run again reads afresh."""

    def __init__(self, conf: C.RapidsConf,
                 cache: Optional[MaterializationCache] = None):
        self.limits = CacheLimits(conf)
        self._cache = cache or MATERIALIZATION_CACHE
        self._lock = threading.Lock()
        self._plocks: Dict[int, threading.Lock] = {}
        self._parts: Dict[int, object] = {}
        self._initial_refs = 0
        self._refs = 0
        self._active_readers = 0  # replays in flight: no eviction
        # an entry dropped with its plan, never cleaned up, gives its
        # bytes back and closes what it holds
        weakref.finalize(self, cleaner.defer, _drop_entry, self._cache,
                         id(self), self._parts)

    def retain(self, n: int = 1) -> None:
        with self._lock:
            self._initial_refs += n
            self._refs += n

    def refs(self) -> int:
        with self._lock:
            return self._refs

    def cached_partitions(self) -> int:
        with self._lock:
            return sum(1 for v in self._parts.values() if v is not _UNCACHED)

    def _plock(self, partition: int) -> threading.Lock:
        with self._lock:
            return self._plocks.setdefault(partition, threading.Lock())

    def read(self, partition: int,
             producer: Callable[[], Iterator[ColumnarBatch]]
             ) -> Iterator[ColumnarBatch]:
        with self._plock(partition):
            with self._lock:
                held = self._parts.get(partition)
            if held is None:
                # the first read runs the partition whole, on its caller's
                # thread and under the partition's lock (a generator
                # holding the lock across yields could deadlock two
                # consumers interleaved on one thread)
                batches = list(producer())
                nbytes = sum(batch_nbytes(b) for b in batches)
                held = None
                if self._cache.admit(self, nbytes):
                    held = _hold(batches, nbytes)
                    if held is None:  # the pool refused: hold nothing
                        self._cache.give_back(self, nbytes)
                with self._lock:
                    self._parts[partition] = (held if held is not None
                                              else _UNCACHED)
                return iter(batches)
        if held is _UNCACHED:
            return producer()
        with self._lock:
            # an eviction may have come between the two locks
            held = self._parts.get(partition)
            if held is None or held is _UNCACHED:
                return producer()
            self._active_readers += 1
        self._cache.touch(self)
        note("reuse_bytes_saved_total", held.nbytes)
        return self._replay(held)

    def _replay(self, held: _Held) -> Iterator[ColumnarBatch]:
        try:
            for h in held.handles:
                b = retry.get_with_retry(h)
                try:
                    yield b
                finally:
                    h.unpin()
        finally:
            with self._lock:
                self._active_readers -= 1

    def evict_cached(self) -> int:
        """Drop every held partition (the entry stays and reads afresh);
        the bytes freed, or -1 when a replay is in flight."""
        with self._lock:
            if self._active_readers > 0:
                return -1
            held = [v for v in self._parts.values() if v is not _UNCACHED]
            for k in [k for k, v in self._parts.items()
                      if v is not _UNCACHED]:
                del self._parts[k]
        for h in held:
            h.close()
        if held:
            self._cache.evict(self)
        return sum(h.nbytes for h in held)

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            if self._refs > 0:
                return
            parts = dict(self._parts)
            self._parts.clear()  # in place: the finalizer holds it
            self._plocks = {}
            self._refs = self._initial_refs
        for held in parts.values():
            if held is not _UNCACHED:
                held.close()
        self._cache.evict(self)


class SharedBroadcast:
    """One prepared broadcast build, published by the first join of a
    group to build it and adopted by the others."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = None

    def get(self):
        with self._lock:
            return self._value

    def put(self, value) -> None:
        with self._lock:
            if self._value is None:
                self._value = value

    def clear(self) -> None:
        with self._lock:
            self._value = None


# ---------------------------------------------------------------------------
# the aliases
# ---------------------------------------------------------------------------


class ReusedExchangeExec(DeviceExec):
    """A leaf aliasing the exchange its reuse group keeps (Spark's
    ReusedExchangeExec), with the replaced exchange's schema (shuffle
    payloads are positional, so an alias of a renamed equal subtree only
    renames). AQE readers and the skew-join planner reach the kept
    exchange's registration through it (``_ensure_written``, ``manager``,
    ``partitioner``, ``target_batch_rows``), so all consumers share one
    shuffle; read directly, it reads through the shared entry."""

    def __init__(self, target, schema: T.Schema, reuse_id: int,
                 entry: Optional[SharedExchangeEntry] = None):
        super().__init__()
        self.target = target
        self._schema = schema
        self.reuse_id = reuse_id
        self.entry = entry
        self._counted_write_skip = False

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return self.target.num_partitions()

    def plan_device(self):
        return self.target.plan_device()

    @property
    def partitioner(self):
        return self.target.partitioner

    @property
    def manager(self):
        return self.target.manager

    @property
    def target_batch_rows(self) -> int:
        return self.target.target_batch_rows

    def _ensure_written(self):
        reg = self.target._ensure_written()
        if not self._counted_write_skip:
            # one write serves the group: each alias is one write saved,
            # whichever consumer wrote it
            self._counted_write_skip = True
            note("reuse_bytes_saved_total",
                 sum(self.target.manager.partition_sizes(reg)))
        return reg

    def node_description(self) -> str:
        return f"ReusedExchange (reuses #{self.reuse_id})"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        self._ensure_written()
        if self.entry is None:
            yield from self.target._produce(partition)
            return
        yield from self.entry.read(
            partition, lambda: self.target._produce(partition))

    def cleanup(self) -> None:
        self._counted_write_skip = False
        if self.entry is not None:
            self.entry.release()


class ReusedBroadcastExec(DeviceExec):
    """A leaf aliasing the broadcast build (a ``ReplayExec``) its reuse
    group keeps: it replays the kept build's batches."""

    def __init__(self, target, schema: T.Schema, reuse_id: int):
        super().__init__()
        self.target = target
        self._schema = schema
        self.reuse_id = reuse_id

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return self.target.num_partitions()

    def plan_device(self):
        return self.target.plan_device()

    def node_description(self) -> str:
        return f"ReusedBroadcast (reuses #{self.reuse_id})"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        done = self.target.materialized()
        if done is not None:
            note("reuse_bytes_saved_total",
                 sum(batch_nbytes(b) for b in done[partition]))
        yield from self.target.execute(partition)
