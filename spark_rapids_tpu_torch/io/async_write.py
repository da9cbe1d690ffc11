"""Async output with host-memory throttling.

The port's copy of spark_rapids_tpu/io/async_write.py.

Reference: io/async/ — AsyncOutputStream + ThrottlingExecutor +
TrafficController (TrafficController.scala:89) with HostMemoryThrottle:65
capping total in-flight host bytes for async writes. Same design here: a
single writer thread per stream, a shared controller that blocks producers
when in-flight bytes exceed the cap, and fail-fast propagation of writer
errors to the caller.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class HostMemoryThrottle:
    """Caps total in-flight (scheduled but unwritten) host bytes."""

    def __init__(self, max_in_flight_bytes: int):
        self.max_in_flight = max_in_flight_bytes
        self._in_flight = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    @property
    def in_flight(self) -> int:
        with self._lock:
            return self._in_flight

    def acquire(self, nbytes: int):
        with self._cv:
            # a single buffer larger than the cap must still be admitted
            # (when nothing else is in flight), or it would deadlock
            while self._in_flight > 0 and \
                    self._in_flight + nbytes > self.max_in_flight:
                self._cv.wait()
            self._in_flight += nbytes

    def release(self, nbytes: int):
        with self._cv:
            self._in_flight -= nbytes
            self._cv.notify_all()


class TrafficController:
    """Process-wide registry of throttles (TrafficController analog)."""

    _instance: Optional["TrafficController"] = None
    _lock = threading.Lock()

    def __init__(self, max_in_flight_bytes: Optional[int] = None):
        if max_in_flight_bytes is None:
            from spark_rapids_tpu_torch.config import conf as _C
            max_in_flight_bytes = _C.WRITER_ASYNC_MAX_IN_FLIGHT.get(
                _C.get_active())
        self.throttle = HostMemoryThrottle(max_in_flight_bytes)
        self._tasks = 0
        self._tlock = threading.Lock()

    @classmethod
    def initialize(cls, max_in_flight_bytes: Optional[int] = None):
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(max_in_flight_bytes)
            return cls._instance

    @classmethod
    def instance(cls) -> "TrafficController":
        return cls.initialize()

    @classmethod
    def shutdown(cls):
        with cls._lock:
            cls._instance = None

    def task_started(self):
        with self._tlock:
            self._tasks += 1

    def task_finished(self):
        with self._tlock:
            self._tasks -= 1

    @property
    def active_tasks(self) -> int:
        with self._tlock:
            return self._tasks


class AsyncOutputStream:
    """Write-behind stream: ``write(bytes)`` enqueues and returns once the
    throttle admits the buffer; a dedicated thread performs the real writes
    in order. Errors surface on the next write/close (fail-fast)."""

    _SENTINEL = object()

    def __init__(self, sink: Callable[[bytes], None],
                 throttle: Optional[HostMemoryThrottle] = None):
        self.sink = sink
        self.throttle = throttle or TrafficController.instance().throttle
        self._q: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.bytes_written = 0

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is self._SENTINEL:
                    return
                if self._error is None:
                    self.sink(item)
                    self.bytes_written += len(item)
            except BaseException as e:  # propagate on next write/close
                self._error = e
            finally:
                if item is not self._SENTINEL:
                    self.throttle.release(len(item))
                self._q.task_done()

    def _check(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def write(self, buf: bytes):
        self._check()
        self.throttle.acquire(len(buf))
        self._q.put(buf)

    def flush(self):
        """Block until every queued buffer has been handed to the sink."""
        self._q.join()
        self._check()

    def close(self):
        self._q.put(self._SENTINEL)
        self._thread.join()
        self._check()
