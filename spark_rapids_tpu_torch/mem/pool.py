"""Device-memory accounting pool with retryable OOM and test injection
(counterpart of spark_rapids_tpu/mem/pool.py; the reference plugin's RMM
pool and DeviceMemoryEventHandler escalation).

The pool accounts the framework's logical footprint, not the CUDA caching
allocator: spillable handles register their bytes at creation and at
every unspill, and a prefetch queue registers the batches it holds. When a
registration would pass the limit, the pool asks the spill framework
(``set_spill_fn``) to free that much by moving older handles to the host,
and raises ``RetryOOM`` when it still does not fit; ``mem/retry.py``
recovers it. A registration larger than the whole limit raises
``SplitAndRetryOOM`` at once (the reference raises ``RetryOOM``, which
no spill can satisfy): only its halves can fit. Freed device memory
stays in torch's cache, so the pool's ``used`` and
``torch.cuda.memory_allocated`` differ: the pool gates, the allocator is
only reported.

The limit of a CUDA device is ``spark.rapids.gpu.memory.pool.fraction``
times its total memory (``torch.cuda.mem_get_info``), or
``memory.pool.maxBytes`` where that is set; on the CPU it is ``maxBytes``
or 16 GiB. A device whose memory cannot be read raises.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

import torch

CPU_DEFAULT_BYTES = 16 << 30


class RetryOOM(RuntimeError):
    """An allocation failed but may succeed after spilling and retrying
    the same input (reference: GpuRetryOOM)."""


class SplitAndRetryOOM(RuntimeError):
    """An allocation failed and the input must be split before it is
    retried (reference: GpuSplitAndRetryOOM)."""


class CpuRetryOOM(RetryOOM):
    """The host-memory flavour (reference: CpuRetryOOM)."""


class QueryBudgetExceeded(RuntimeError):
    """An allocation would take a query past its memory budget. Not a
    ``RetryOOM``: spilling cannot shrink the query's own live bytes."""

    def __init__(self, query_id, nbytes: int, live: int, budget: int):
        super().__init__(
            f"query {query_id} over its memory budget: allocating {nbytes} "
            f"with {live} live attributed bytes against a budget of "
            f"{budget}")
        self.query_id = query_id


class OomInjector:
    """Deterministic OOM injection for tests (RmmSpark.forceRetryOOM):
    after ``skip`` allocations, raise ``count`` OOMs of ``kind`` (RETRY or
    SPLIT). ``thread_id``, when given, restricts both counts to the
    allocations of that thread (RmmSpark targets one task's thread), so
    a background prefetch worker neither takes nor consumes an injection.
    The schedule is lock-guarded: concurrent allocators must not fire it
    twice or skip it."""

    def __init__(self, kind: str = "RETRY", skip: int = 0, count: int = 1,
                 thread_id: Optional[int] = None):
        if kind not in ("RETRY", "SPLIT"):
            raise ValueError(f"OomInjector kind must be RETRY or SPLIT, "
                             f"not {kind!r}")
        self.kind = kind
        self.skip = skip
        self.count = count
        self.thread_id = thread_id
        self.injected = 0
        self._lock = threading.Lock()

    def on_alloc(self) -> None:
        if (self.thread_id is not None
                and threading.get_ident() != self.thread_id):
            return
        with self._lock:
            if self.skip > 0:
                self.skip -= 1
                return
            if self.count <= 0:
                return
            self.count -= 1
            self.injected += 1
        if self.kind == "RETRY":
            raise RetryOOM("injected retry OOM")
        raise SplitAndRetryOOM("injected split-and-retry OOM")


class HbmPool:
    """Thread-safe logical accounting of device bytes.

    ``spill_fn(bytes_needed) -> bytes_freed`` is installed by the spill
    framework; an allocation over the limit calls it outside the pool's
    lock and raises ``RetryOOM`` if the bytes still do not fit."""

    def __init__(self, limit_bytes: int):
        from spark_rapids_tpu_torch.mem import cleaner

        cleaner.register_pool(self)
        self.limit = int(limit_bytes)
        self._used = 0
        self._lock = threading.Lock()
        self._spill_fn: Optional[Callable[[int], int]] = None
        self._injector = None
        self.max_used = 0
        self.alloc_count = 0
        self.oom_count = 0
        self.spill_request_count = 0
        # query id -> budget, and the live bytes allocated under that tag
        self._query_budgets: Dict[object, int] = {}
        self._query_live: Dict[object, int] = {}

    # -- wiring --------------------------------------------------------------
    def set_spill_fn(self, fn: Optional[Callable[[int], int]]) -> None:
        self._spill_fn = fn

    def set_injector(self, injector) -> None:
        """An ``OomInjector`` (or any object with ``on_alloc``), or None."""
        self._injector = injector

    def set_query_budget(self, query_id, nbytes: int) -> None:
        """Cap the live bytes allocated with ``tag=query_id`` (0 clears)."""
        with self._lock:
            if nbytes:
                self._query_budgets[query_id] = int(nbytes)
            else:
                self._query_budgets.pop(query_id, None)

    def clear_query_budget(self, query_id) -> None:
        self.set_query_budget(query_id, 0)

    # -- accounting ----------------------------------------------------------
    @property
    def used(self) -> int:
        return self._used

    @property
    def free(self) -> int:
        return self.limit - self._used

    def _take(self, nbytes: int, tag) -> bool:
        """Account ``nbytes`` if they fit (under the lock)."""
        if self._used + nbytes > self.limit:
            return False
        self._used += nbytes
        self.max_used = max(self.max_used, self._used)
        if tag is not None and tag in self._query_budgets:
            self._query_live[tag] = self._query_live.get(tag, 0) + nbytes
        return True

    def allocate(self, nbytes: int, tag=None):
        """Account ``nbytes``; over the limit, spill and then raise
        ``RetryOOM``. ``tag`` is a query id when the caller's query has a
        budget; it is returned, for ``release``."""
        nbytes = int(nbytes)
        with self._lock:
            budget = self._query_budgets.get(tag) if tag is not None \
                else None
            if budget:
                live = self._query_live.get(tag, 0)
                if live + nbytes > budget:
                    raise QueryBudgetExceeded(tag, nbytes, live, budget)
            self.alloc_count += 1
            if self._injector is not None:
                self._injector.on_alloc()
            if self._take(nbytes, tag):
                return tag
            if nbytes > self.limit:
                # no spill makes room for it: only its halves can fit
                self.oom_count += 1
                raise SplitAndRetryOOM(
                    f"device pool limit {self.limit} is below the "
                    f"{nbytes} bytes asked for at once")
            needed = self._used + nbytes - self.limit
        freed = 0
        if self._spill_fn is not None:  # spill does host and disk I/O
            self.spill_request_count += 1
            freed = self._spill_fn(needed)
        with self._lock:
            if self._take(nbytes, tag):
                return tag
            self.oom_count += 1
            used = self._used
        raise RetryOOM(
            f"device pool exhausted: need {nbytes}, used {used}, limit "
            f"{self.limit}, spill freed {freed}")

    def release(self, nbytes: int, tag=None) -> None:
        with self._lock:
            self._used -= int(nbytes)
            if self._used < 0:
                raise AssertionError("pool accounting underflow")
            if tag is not None and tag in self._query_live:
                self._query_live[tag] -= int(nbytes)


_default_pool: Optional[HbmPool] = None
_pool_lock = threading.Lock()


def device_memory_bytes(device=None) -> int:
    """Total memory of ``device`` (``cuda`` when a card is present and
    none is named): ``torch.cuda.mem_get_info`` on a CUDA device, which
    raises when it cannot read it; 16 GiB on the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total)
    return CPU_DEFAULT_BYTES


def pool_limit(conf=None, device=None) -> int:
    """The limit ``get_pool`` gives a new pool: ``memory.pool.maxBytes``
    where set, else ``memory.pool.fraction`` of the device's memory."""
    from spark_rapids_tpu_torch.config import conf as C

    conf = conf or C.get_active()
    max_bytes = C.POOL_MAX_BYTES.get(conf)
    if max_bytes:
        return int(max_bytes)
    return int(device_memory_bytes(device) * C.POOL_FRACTION.get(conf))


def get_pool(conf=None, device=None) -> HbmPool:
    """The process's pool, sized from ``conf`` (the active conf when none
    is given) on first use; ``set_pool(None)`` makes the next call size a
    new one."""
    global _default_pool
    with _pool_lock:
        if _default_pool is None:
            _default_pool = HbmPool(pool_limit(conf, device))
        return _default_pool


def set_pool(pool: Optional[HbmPool]) -> None:
    global _default_pool
    with _pool_lock:
        _default_pool = pool
