"""The task semaphore (counterpart of spark_rapids_tpu/mem/semaphore.py;
the reference plugin's GpuSemaphore and PrioritySemaphore).

It bounds the tasks that hold the device at once
(``spark.rapids.gpu.sql.concurrentGpuTasks``): ``plan/dataframe.py``
holds a permit around each output partition's drain, except on the
small-query fast path. Waiters enter by priority, then in arrival order,
and a waiter older than ``starvation_ns`` outranks every priority. A
task that holds a permit may acquire it again (a count, released as
often). ``acquire`` can give up after ``timeout_ms`` and polls
``cancel_check`` while it waits; a waiter that leaves either way is
removed, so it never wins a later grant. ``snapshot`` shows holders and
waiters; the counters are acquisitions, waits (acquisitions that did
not enter at once) and their summed wait.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Optional

_WAIT_SLICE_S = 0.05  # wake-up of a waiter that polls cancellation


class TaskSemaphore:
    """Priority semaphore: highest priority first, FIFO within one, with
    ageing past ``starvation_ns``."""

    def __init__(self, permits: int = 2, starvation_ns: int = 5_000_000_000):
        self._permits = max(1, int(permits))
        self.starvation_ns = int(starvation_ns)
        self._cv = threading.Condition()
        # task id -> (first wait ns, priority, arrival sequence)
        self._waiters: Dict[object, tuple] = {}
        self._holders: Dict[object, int] = {}  # task id -> acquire count
        self._seq = itertools.count()
        self.total_wait_ns = 0
        self.max_waiters = 0
        self.max_holders = 0
        self.acquire_count = 0
        self.wait_count = 0
        self.timeout_count = 0
        self.cancel_count = 0

    @property
    def permits(self) -> int:
        return self._permits

    def acquire(self, task_id, timeout_ms: Optional[float] = None,
                cancel_check=None, priority: int = 0) -> bool:
        """Block until a permit is granted and return True; False after
        ``timeout_ms``. ``cancel_check`` is called every wait slice: what
        it raises removes the waiter and propagates."""
        t0 = time.perf_counter_ns()
        deadline = None if timeout_ms is None else t0 + int(timeout_ms * 1e6)
        with self._cv:
            self.acquire_count += 1
            if task_id in self._holders:  # re-entrant per task
                self._holders[task_id] += 1
                return True
            self._waiters.setdefault(task_id,
                                     (t0, int(priority), next(self._seq)))
            self.max_waiters = max(self.max_waiters, len(self._waiters))
            waited_at_all = False
            try:
                while not self._may_enter(task_id):
                    waited_at_all = True
                    if cancel_check is not None:
                        try:
                            cancel_check()
                        except BaseException:
                            self.cancel_count += 1
                            raise
                    now = time.perf_counter_ns()
                    if deadline is not None and now >= deadline:
                        self.timeout_count += 1
                        return False
                    wait_s = _WAIT_SLICE_S if cancel_check is not None \
                        else None
                    if deadline is not None:
                        remaining = (deadline - now) / 1e9
                        wait_s = (remaining if wait_s is None
                                  else min(wait_s, remaining))
                    self._cv.wait(wait_s)
            finally:
                # granted, timed out or cancelled: no ghost waiter stays
                self._waiters.pop(task_id, None)
                self._cv.notify_all()
            self._holders[task_id] = 1
            self.max_holders = max(self.max_holders, len(self._holders))
            if waited_at_all:
                self.wait_count += 1
            self.total_wait_ns += time.perf_counter_ns() - t0
        return True

    def _best_waiter(self):
        """Who enters next: aged waiters first, then the highest
        priority, then the earliest arrival."""
        now = time.perf_counter_ns()

        def rank(item):
            _tid, (t0, prio, seq) = item
            if now - t0 >= self.starvation_ns:
                prio = 1 << 30
            return (-prio, seq)

        return min(self._waiters.items(), key=rank)[0]

    def _may_enter(self, task_id) -> bool:
        if len(self._holders) >= self._permits:
            return False
        return (self._best_waiter() == task_id
                or len(self._holders) + len(self._waiters) <= self._permits)

    def release(self, task_id) -> None:
        with self._cv:
            if task_id not in self._holders:
                return
            self._holders[task_id] -= 1
            if self._holders[task_id] <= 0:
                del self._holders[task_id]
                self._cv.notify_all()

    def resize(self, permits: int) -> None:
        """A new permit count: growth wakes waiters at once, a shrink
        applies as holders release."""
        with self._cv:
            self._permits = max(1, int(permits))
            self._cv.notify_all()

    def held_by(self, task_id) -> bool:
        with self._cv:
            return task_id in self._holders

    def snapshot(self) -> Dict:
        """Holders and waiters now, and the counters."""
        now = time.perf_counter_ns()
        with self._cv:
            return {
                "permits": self._permits,
                "holders": {str(t): n for t, n in self._holders.items()},
                "waiters": {str(t): {"waited_ms": round((now - t0) / 1e6, 3),
                                     "priority": prio}
                            for t, (t0, prio, _s) in self._waiters.items()},
                "acquire_count": self.acquire_count,
                "wait_count": self.wait_count,
                "total_wait_ns": self.total_wait_ns,
                "max_waiters": self.max_waiters,
                "max_holders": self.max_holders,
                "timeout_count": self.timeout_count,
                "cancel_count": self.cancel_count,
            }

    class _Ctx:
        def __init__(self, sem: "TaskSemaphore", task_id):
            self.sem = sem
            self.task_id = task_id

        def __enter__(self):
            self.sem.acquire(self.task_id)
            return self

        def __exit__(self, *exc):
            self.sem.release(self.task_id)
            return False

    def held(self, task_id) -> "TaskSemaphore._Ctx":
        """A context manager that holds a permit for ``task_id``."""
        return TaskSemaphore._Ctx(self, task_id)


_process_sem: Optional[TaskSemaphore] = None
_process_lock = threading.Lock()


def get_task_semaphore(conf=None) -> TaskSemaphore:
    """The process's semaphore, its permits re-read from ``conf`` (the
    active conf when none is given) on every call and resized when they
    changed."""
    global _process_sem
    from spark_rapids_tpu_torch.config import conf as C

    want = max(1, C.CONCURRENT_TASKS.get(conf or C.get_active()))
    with _process_lock:
        if _process_sem is None:
            _process_sem = TaskSemaphore(permits=want)
        elif _process_sem.permits != want:
            _process_sem.resize(want)
        return _process_sem
