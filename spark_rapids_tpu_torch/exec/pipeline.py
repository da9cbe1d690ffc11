"""Read-ahead at pipeline boundaries (counterpart of
spark_rapids_tpu/exec/pipeline.py; the reference's multithreaded readers).

``PrefetchIterator`` drives a batch iterator from one background thread
into a queue of at most ``depth`` batches, so that the producer's host
work (a shuffle read's fetch and merge, an upload, a CPU-engine
operator) runs while the consumer computes on earlier batches.

On the card the worker runs on the plan's device and enqueues its work on
the stream its consumer had current when the iterator was made (torch's
current stream is per thread): the consumer's later kernels on that
stream are ordered after the worker's uploads, with no event to wait on.
An exception in the worker is raised in the consumer at its next
``next``; ``close`` (idempotent) stops the worker, unblocking it if it
waits on a full queue, and closes the source.

``insert_prefetch`` wraps the boundaries of a converted plan in
``PrefetchExec``: exchanges, reused exchanges, AQE readers (an exchange
directly under an AQE reader stays bare: the reader reads its blocks, not
its batches), file scans (``exec/scan.FileScanBase``: the decode and
upload lane) and a CPU-engine node under a device parent (the
CPU-to-device transition). With
``spark.rapids.gpu.sql.prefetch.enabled`` false it leaves the plan bare;
the planner skips it on the fast path.

Each batch a queue holds is accounted on the device pool (``mem/pool.py``)
from the worker's put to the consumer's take. When the pool refuses one
(``RetryOOM``, after it spilled what it could, or a batch above its whole
limit), the queue sheds: the worker hands the batch in hand over
unaccounted and stops, and the consumer pulls the source itself from
then on, so read-ahead only uses headroom the pool has.

``ReadAhead`` is the shuffle readers' read-ahead: while a consumer takes
one reduce partition (or one AQE spec), the host fetch and merge of the
next runs on one background thread (``shuffle/exchange_exec.py``,
``shuffle/aqe.py``).

``STATS``: batches queued now (``depth``), consumer arrivals that found
the queue empty (``stalls``), batches handed over (``items``) and queues
shed to synchronous pulls (``sheds``); ``reset`` zeroes them before a run
that reads them.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator, Optional

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.mem.pool import RetryOOM, get_pool
from spark_rapids_tpu_torch.mem.spill import batch_nbytes


class PrefetchStats:
    """The process's prefetch counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.depth = 0
        self.stalls = 0
        self.items = 0
        self.sheds = 0

    def add(self, field: str, v: int) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + v)

    def snapshot(self) -> dict:
        with self._lock:
            return {"prefetch_depth": self.depth,
                    "prefetch_stalls": self.stalls,
                    "prefetch_items": self.items,
                    "prefetch_sheds": self.sheds}

    def reset(self) -> None:
        with self._lock:
            self.depth = self.stalls = self.items = self.sheds = 0


STATS = PrefetchStats()

_ITEM, _DONE, _SHED, _ERROR = "item", "done", "shed", "error"


class PrefetchIterator:
    """Drive ``source`` on a background thread into a queue of at most
    ``depth`` items (see the module docstring). ``device`` is where the
    source's batches go: on a CUDA device the worker runs there, on the
    consumer's current stream."""

    def __init__(self, source, depth: int = 2, label: str = "prefetch",
                 device=None):
        self._source = iter(source)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._finished = False
        self._closed = False
        self._direct = False  # shed: the consumer pulls the source
        self._pool = get_pool(device=device)
        device = None if device is None else torch.device(device)
        self._stream = (torch.cuda.current_stream(device)
                        if device is not None and device.type == "cuda"
                        else None)
        self._device = device
        self._thread = threading.Thread(
            target=self._run, name=f"srgpu-prefetch-{label}", daemon=True)
        self._thread.start()

    # -- worker ------------------------------------------------------------
    def _run(self) -> None:
        try:
            if self._stream is not None:
                with torch.cuda.device(self._device), \
                        torch.cuda.stream(self._stream):
                    self._pump()
            else:
                self._pump()
        except BaseException as e:  # noqa: BLE001 - raised in the consumer
            self._put((_ERROR, e, 0))

    def _pump(self) -> None:
        while not self._stop.is_set():
            try:
                item = next(self._source)
            except StopIteration:
                self._put((_DONE, None, 0))
                return
            nbytes = (batch_nbytes(item) if isinstance(item, ColumnarBatch)
                      else 0)
            if nbytes > self._pool.limit:
                self._shed(item)  # it could never be admitted
                return
            if nbytes:
                try:
                    self._pool.allocate(nbytes)
                except RetryOOM:
                    self._shed(item)
                    return
            if not self._put((_ITEM, item, nbytes)):
                return  # closed while waiting on a full queue

    def _shed(self, item) -> None:
        """No headroom to read ahead: hand over the batch in hand
        unaccounted, and the source with it."""
        STATS.add("sheds", 1)
        if self._put((_ITEM, item, 0)):
            self._put((_SHED, None, 0))

    def _put(self, entry) -> bool:
        """A put that gives up when the iterator is closed (giving an
        item's accounted bytes back); False then."""
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.05)
            except queue.Full:
                continue
            if entry[0] == _ITEM:
                STATS.add("depth", 1)
            return True
        if entry[0] == _ITEM and entry[2]:
            self._pool.release(entry[2])
        return False

    # -- consumer ----------------------------------------------------------
    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        if self._direct:
            return next(self._source)
        try:
            kind, payload, nbytes = self._q.get_nowait()
        except queue.Empty:
            STATS.add("stalls", 1)
            kind, payload, nbytes = self._q.get()
        if kind == _ITEM:
            STATS.add("depth", -1)
            STATS.add("items", 1)
            if nbytes:
                self._pool.release(nbytes)
            return payload
        if kind == _SHED:
            # the worker has stopped and everything it made was taken
            # (FIFO): the source is the consumer's now
            self._direct = True
            return next(self._source)
        self._finished = True
        if kind == _DONE:
            raise StopIteration
        raise payload

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._drain()
        self._thread.join()
        self._drain()  # what the worker put between the drain and the join
        close = getattr(self._source, "close", None)
        if close is not None:
            close()

    def _drain(self) -> None:
        while True:
            try:
                kind, _, nbytes = self._q.get_nowait()
            except queue.Empty:
                return
            if kind == _ITEM:
                STATS.add("depth", -1)
                if nbytes:
                    self._pool.release(nbytes)

    def __enter__(self) -> "PrefetchIterator":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class ReadAhead:
    """One background thread that reads a shuffle reader's next unit
    (a reduce partition, or an AQE spec) while the current one is
    consumed; ``key`` is the unit's index. Host work only: the consumer
    uploads what ``take`` hands it on its own thread and stream."""

    def __init__(self, label: str):
        self._label = label
        self._futures: dict = {}
        self._lock = threading.Lock()
        self._pool: Optional[cf.ThreadPoolExecutor] = None

    def schedule(self, key: int, fn, *args) -> None:
        """Start ``fn(*args)`` for ``key`` unless it is already read."""
        with self._lock:
            if key in self._futures:
                return
            if self._pool is None:
                self._pool = cf.ThreadPoolExecutor(
                    1, thread_name_prefix=f"srgpu-{self._label}")
            self._futures[key] = self._pool.submit(fn, *args)

    def take(self, key: int) -> Optional[cf.Future]:
        """The read of ``key`` started ahead, or None."""
        with self._lock:
            return self._futures.pop(key, None)

    def pending(self) -> set:
        with self._lock:
            return set(self._futures)

    def running(self) -> bool:
        with self._lock:
            return self._pool is not None

    def shutdown(self) -> None:
        """Stop the thread (a read in flight ends first) and drop what was
        read ahead."""
        with self._lock:
            pool, self._pool = self._pool, None
            self._futures.clear()
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


class PrefetchExec(UnaryExec):
    """A boundary that runs its child's partition iterator ahead of its
    consumer; schema and partitions are the child's."""

    def __init__(self, child: DeviceExec, depth: int = 2):
        super().__init__(child)
        self.depth = depth

    def node_description(self) -> str:
        return f"Prefetch(depth={self.depth})"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        it = PrefetchIterator(
            self.child.execute(partition), self.depth,
            f"{type(self.child).__name__}#p{partition}", self.plan_device())
        try:
            yield from it
        finally:
            it.close()


def prefetch_settings(conf: C.RapidsConf):
    """(enabled, depth) of a conf."""
    return C.PREFETCH_ENABLED.get(conf), C.PREFETCH_DEPTH.get(conf)


def insert_prefetch(ex: DeviceExec, conf: C.RapidsConf) -> DeviceExec:
    """Wrap the pipeline boundaries of a converted plan in
    ``PrefetchExec`` (see the module docstring); the plan as it is when
    prefetch is off."""
    enabled, depth = prefetch_settings(conf)
    if not enabled:
        return ex
    from spark_rapids_tpu_torch.exec.reuse import ReusedExchangeExec
    from spark_rapids_tpu_torch.exec.scan import FileScanBase
    from spark_rapids_tpu_torch.plan.cpu import CpuExec
    from spark_rapids_tpu_torch.shuffle.aqe import AQEShuffleReadExec
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)

    exchanges = (ShuffleExchangeExec, ReusedExchangeExec)

    def walk(node: DeviceExec, parent: Optional[DeviceExec]) -> DeviceExec:
        for i, ch in enumerate(node.children):
            node.children[i] = walk(ch, node)
        if isinstance(node, PrefetchExec):
            return node
        if isinstance(node, exchanges) and isinstance(parent,
                                                      AQEShuffleReadExec):
            return node
        if isinstance(node, exchanges + (AQEShuffleReadExec, FileScanBase)):
            return PrefetchExec(node, depth)
        if (isinstance(node, CpuExec) and parent is not None
                and not isinstance(parent, CpuExec)):
            return PrefetchExec(node, depth)
        return node

    return walk(ex, None)
