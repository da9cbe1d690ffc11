"""OOM retry and split-and-retry (counterpart of
spark_rapids_tpu/mem/retry.py; the reference plugin's
RmmRapidsRetryIterator ``withRetry``/``withRetryNoSplit``).

``with_retry`` runs a function over inputs (batches or spillable handles,
a handle pinned only for its own attempt so the others stay spillable):
a ``RetryOOM`` retries the same input, on the same device, after the pool
spilled what it could (and after an optional jittered pause,
``spark.rapids.gpu.memory.retry.backoffMs``); a ``SplitAndRetryOOM``
splits the input in half by rows and runs the halves in its place.
Attempts per input are bounded (``memory.retry.maxAttempts``). Only these
two exceptions are caught: an allocator failure of torch itself is not a
pool OOM and propagates.

``STATS`` counts retries and splits for the whole process.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Iterable, Iterator, List, Optional, TypeVar

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.mem.pool import RetryOOM, SplitAndRetryOOM
from spark_rapids_tpu_torch.mem.spill import SpillableBatch, SpillFramework

B = TypeVar("B")


class RetryStats:
    """The process's retry counters: retries of one input after a
    ``RetryOOM``, splits after a ``SplitAndRetryOOM``, and the seconds
    spent in backoff pauses."""

    def __init__(self):
        self._lock = threading.Lock()
        self.retries = 0
        self.splits = 0
        self.backoff_s = 0.0

    def add(self, field: str, v) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + v)

    def snapshot(self) -> dict:
        with self._lock:
            return {"retries": self.retries, "splits": self.splits,
                    "backoff_s": self.backoff_s}

    def reset(self) -> None:
        with self._lock:
            self.retries = self.splits = 0
            self.backoff_s = 0.0


STATS = RetryStats()


def _max_attempts() -> int:
    from spark_rapids_tpu_torch.config import conf as C

    return C.RETRY_MAX_ATTEMPTS.get(C.get_active())


def _oom_backoff(attempts: int) -> None:
    """A jittered exponential pause before the next retry
    (``memory.retry.backoffMs``; 0, the default, retries at once): it
    gives other tasks' spills and frees time to land."""
    from spark_rapids_tpu_torch.config import conf as C

    base_ms = C.RETRY_BACKOFF_MS.get(C.get_active())
    if base_ms <= 0:
        return
    scale = 1 << min(attempts - 1, 5)
    pause = (base_ms / 1000.0) * scale * (0.5 + random.random())
    time.sleep(pause)
    STATS.add("backoff_s", pause)


def split_batch_half(batch: ColumnarBatch) -> List[ColumnarBatch]:
    """Two batches of the first and the second half of the rows (the
    reference's default splitter)."""
    n = batch.num_rows
    if n <= 1:
        raise SplitAndRetryOOM("cannot split a single-row batch further")
    k = n // 2
    dev = batch.columns[0].device
    first = K.gather_batch(batch, torch.arange(k, device=dev))
    second = K.gather_batch(batch, torch.arange(k, n, device=dev))
    return [first, second]


def with_retry(inputs: Iterable, fn: Callable[[ColumnarBatch], B],
               framework: Optional[SpillFramework] = None,
               split_fn: Callable[[ColumnarBatch], List[ColumnarBatch]]
               = split_batch_half,
               max_attempts: Optional[int] = None) -> Iterator[B]:
    """``fn`` over each input, under OOM retry and split-and-retry (see
    the module docstring). A handle input is closed once it is done;
    with ``framework``, the halves of a split wait as handles."""
    limit = max_attempts or _max_attempts()
    for handle in inputs:
        work: List[object] = [handle]
        while work:
            item = work.pop(0)
            attempts = 0
            while True:
                attempts += 1
                try:
                    if isinstance(item, SpillableBatch):
                        with item as batch:
                            result = fn(batch)
                        item.close()
                    else:
                        result = fn(item)
                    yield result
                    break
                except SplitAndRetryOOM:
                    STATS.add("splits", 1)
                    if isinstance(item, SpillableBatch):
                        with item as batch:
                            pieces = split_fn(batch)
                        item.close()
                    else:
                        pieces = split_fn(item)
                    if framework is not None:
                        pieces = [SpillableBatch(p, framework)
                                  for p in pieces]
                    work = list(pieces) + work
                    item = work.pop(0)
                    attempts = 0
                except RetryOOM:
                    STATS.add("retries", 1)
                    if attempts >= limit:
                        raise
                    _oom_backoff(attempts)


def with_retry_no_split(inputs: Iterable, fn: Callable[[ColumnarBatch], B],
                        max_attempts: Optional[int] = None) -> Iterator[B]:
    """Retry only, for work that cannot take split inputs (reference:
    withRetryNoSplit): a split-and-retry request raises."""

    def no_split(batch: ColumnarBatch) -> List[ColumnarBatch]:
        raise SplitAndRetryOOM("operation does not support split-retry")

    yield from with_retry(inputs, fn, framework=None, split_fn=no_split,
                          max_attempts=max_attempts)


def get_with_retry(handle: SpillableBatch,
                   max_attempts: Optional[int] = None) -> ColumnarBatch:
    """``handle.get()`` under OOM retry: a handle cannot be split, so a
    split-and-retry request retries the read like a ``RetryOOM``."""
    limit = max_attempts or _max_attempts()
    attempts = 0
    while True:
        attempts += 1
        try:
            return handle.get()
        except (RetryOOM, SplitAndRetryOOM):
            STATS.add("retries", 1)
            if attempts >= limit:
                raise
            _oom_backoff(attempts)
