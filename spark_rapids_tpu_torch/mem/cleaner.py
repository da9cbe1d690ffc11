"""End-of-run leak sweep (counterpart of spark_rapids_tpu/mem/cleaner.py;
the reference plugin's MemoryCleaner).

Pools, spill frameworks and shuffle managers register themselves when
they are made; ``sweep`` reports what still holds resources: a pool with
bytes outstanding, a framework with live handles or a spill file left on
disk, a shuffle manager with a shuffle that was never cleaned up whose
files still exist. ``assert_clean`` raises on a non-empty report.
"""

from __future__ import annotations

import collections
import gc
import os
import threading
import weakref
from typing import List

_lock = threading.Lock()
# releases of resources whose owner was collected: a finalizer only queues
# them (it may run inside any allocation, under any lock), and ``sweep``
# and each query run them
_deferred: "collections.deque" = collections.deque()
_drain_lock = threading.Lock()
_pools: "weakref.WeakSet" = weakref.WeakSet()
_frameworks: "weakref.WeakSet" = weakref.WeakSet()
_managers: "weakref.WeakSet" = weakref.WeakSet()


def register_pool(pool) -> None:
    with _lock:
        _pools.add(pool)


def register_framework(fw) -> None:
    with _lock:
        _frameworks.add(fw)


def register_manager(m) -> None:
    with _lock:
        _managers.add(m)


def frameworks() -> list:
    with _lock:
        return list(_frameworks)


def defer(fn, *args) -> None:
    """Queue ``fn(*args)`` for ``run_deferred`` (safe from a finalizer)."""
    _deferred.append((fn, args))


def run_deferred() -> None:
    """Run the queued releases."""
    with _drain_lock:
        while _deferred:
            fn, args = _deferred.popleft()
            fn(*args)


def sweep() -> List[str]:
    """The leak report; empty when everything was released. The queued
    releases run first, and where something is still held, garbage is
    collected and the report made again: a plan dropped without being run
    (in a reference cycle) releases its shuffles and held partitions when
    it is collected."""
    run_deferred()
    leaks = _report()
    if leaks:
        gc.collect()
        run_deferred()
        leaks = _report()
    return leaks


def _report() -> List[str]:
    leaks: List[str] = []
    with _lock:
        pools, fws, managers = list(_pools), list(_frameworks), \
            list(_managers)
    for p in pools:
        if p.used != 0:
            leaks.append(f"HbmPool: {p.used} bytes outstanding "
                         f"(allocs={p.alloc_count})")
    owned = {os.path.basename(h._disk_path) for fw in fws
             for h in fw.handles() if h._disk_path}
    for fw in fws:
        live = fw.handles()
        if live:
            leaks.append(f"SpillFramework: {len(live)} unclosed handles "
                         f"({sum(h.nbytes for h in live)} bytes)")
    for d in sorted({fw.spill_dir for fw in fws}):
        if os.path.isdir(d):
            orphans = [f for f in os.listdir(d)
                       if f.endswith(".spill.chunks") and f not in owned]
            if orphans:
                leaks.append(f"SpillFramework: {len(orphans)} orphan spill "
                             f"files in {d}")
    for m in managers:
        for sid, reg in m.registrations().items():
            files = [mo.path for mo in reg.map_outputs.values()
                     if mo.path and os.path.exists(mo.path)]
            if files:
                leaks.append(f"ShuffleManager: shuffle {sid} never cleaned "
                             f"({len(files)} files)")
    return leaks


def assert_clean() -> None:
    leaks = sweep()
    if leaks:
        raise AssertionError("resource leaks:\n" + "\n".join(leaks))
