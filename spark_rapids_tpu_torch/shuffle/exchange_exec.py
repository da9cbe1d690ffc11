"""Shuffle exchange operator (counterpart of
spark_rapids_tpu/shuffle/exchange_exec.py; GpuShuffleExchangeExecBase on
the write side, GpuShuffleCoalesceExec on the read side).

The exchange materializes every map output on its first read, a stage
boundary as in Spark. Each map task's device pass (its child partition
executed, every batch split by partition and brought to the host) runs on
the calling thread in map order, map 0 first; its serialization and write
go to the manager's writer pool (``spark.rapids.gpu.shuffle.writeThreads``
threads), so the host work of one map overlaps the device pass of the next
and no device work runs off the calling thread. A reduce partition then
reads its blocks from every map output in map order, merges them on the
host and uploads them to the plan's device in chunks of
``spark.rapids.gpu.shuffle.targetBatchRows`` rows, strings
dictionary-encoded under the scan's rule: each chunk has a dictionary of
its own, so no consumer may compare codes of two chunks (the hash, the
key equality and the concatenation of batches all work on values).

A map task that yields any batch is a map output, rows or not, as in the
reference (AQE's map ranges count them).

With ``spark.rapids.gpu.sql.prefetch.enabled`` (read at plan time), a
direct read of reduce partition p starts the fetch and host merge of p + 1
on one background thread (``exec/pipeline.ReadAhead``); the upload stays
on the consumer's thread, so no device work runs there. ``cleanup`` shuts
the thread down before it deletes the blocks. An exchange read directly
is one with AQE off (at the defaults an AQE reader reads the blocks, and
reads its next spec ahead the same way) or a single exchange (one
partition: nothing to read ahead).

When the plan's reuse rewrite keeps this exchange for several consumers
(``plan/reuse.py``), ``_shared`` is their ``SharedExchangeEntry``: each
reduce partition is read once and replayed to the others
(``exec/reuse.py``); ``reuse_id`` names it in ``node_description``.

Metrics: ``writeTimeNs`` (the whole write stage, the child's execution
included, as the reference times it); on the calling thread
``splitTimeNs`` (the device passes), ``waitTimeNs`` (waiting for the
writer threads after the last map) and ``readTimeNs`` (fetch, merge and
upload; a read-ahead's fetch and merge are its own thread's, and
``readAheadWaitNs`` is what the consumer waited for it);
``serializeTimeNs`` (serialization and file writes, summed over the
writer threads); ``shuffleBytesWritten``/``shuffleBytesRead`` and
``shuffleBlocksWritten``/``shuffleBlocksRead``. An AQE reader above the
exchange reads its blocks itself and counts its reads in its own metrics.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
import weakref
from typing import Iterator, Optional

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, batch_from_arrow, dictionary_encode_table)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exec.pipeline import ReadAhead
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.shuffle.manager import (
    ReadCounts, ShuffleManager, get_manager)
from spark_rapids_tpu_torch.shuffle.partition import Partitioner


class ShuffleExchangeExec(UnaryExec):
    def __init__(self, partitioner: Partitioner, child: DeviceExec,
                 manager: Optional[ShuffleManager] = None,
                 target_batch_rows: Optional[int] = None):
        super().__init__(child)
        conf = C.get_active()
        self.partitioner = partitioner
        self.manager = manager or get_manager(conf)
        self.target_batch_rows = (target_batch_rows or
                                  C.SHUFFLE_TARGET_BATCH_ROWS.get(conf))
        self.read_ahead = C.PREFETCH_ENABLED.get(conf)
        self._reg = None
        self._written = False
        self._write_lock = threading.Lock()
        self._ahead = ReadAhead("shufr")  # of (table, counts)
        # set by plan/reuse.py on the exchange a reuse group keeps
        self._shared = None
        self.reuse_id: Optional[int] = None
        for name in ("writeTimeNs", "splitTimeNs", "serializeTimeNs",
                     "waitTimeNs", "readTimeNs", "readAheadWaitNs",
                     "shuffleBytesWritten", "shuffleBytesRead",
                     "shuffleBlocksWritten", "shuffleBlocksRead"):
            self._register_metric(name)

    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def node_description(self) -> str:
        desc = f"ShuffleExchange {self.partitioner.describe()}"
        if self.reuse_id is not None:
            desc += f" [reuse #{self.reuse_id}]"
        return desc

    def _ensure_written(self):
        with self._write_lock:
            if self._written:
                return self._reg
            schema = self.child.output_schema
            reg = self.manager.register(schema,
                                        self.partitioner.num_partitions)
            pending = []
            written = False
            try:
                with self.timer("writeTimeNs"):
                    try:
                        for p in range(self.child.num_partitions()):
                            per_part = self._map_pass(p, schema)
                            if per_part is not None:
                                pending.append(
                                    self.manager.writer_pool.submit(
                                        self._write, reg, per_part, p))
                    finally:
                        # a failed map pass still waits for the writes it
                        # started before the error goes up
                        with self.timer("waitTimeNs"):
                            cf.wait(pending)
                    for f in pending:
                        f.result()
                written = True
            finally:
                if not written:  # a map pass that raised leaves no output
                    self.manager.cleanup(reg)
            self.metrics["shuffleBytesWritten"].add(reg.bytes_written)
            self.metrics["shuffleBlocksWritten"].add(reg.blocks_written)
            self._reg = reg
            # a plan dropped unrun (a range sort's sample wrote this at
            # planning) releases the shuffle when it is collected
            self._release = weakref.finalize(self, cleaner.defer,
                                             self.manager.cleanup, reg)
            self._written = True
            return reg

    def _map_pass(self, partition: int, schema):
        """One map task's device pass: the child partition's batches split
        by partition, as host tables per partition id; None when the
        child partition yields no batch."""
        per_part = None
        for b in self.child.execute(partition):
            if per_part is None:
                per_part = {}
            with self.timer("splitTimeNs"):
                for pid, tbl in self.partitioner.split(b, schema):
                    per_part.setdefault(pid, []).append(tbl)
        return per_part

    def _write(self, reg, per_part, map_id: int) -> None:
        with self.timer("serializeTimeNs"):
            self.manager.write_map_output(reg, per_part, map_id)

    def cleanup(self) -> None:
        """Release the shuffle's files or blocks (after the query's output
        is gathered), after the read-ahead thread has stopped; a later read
        writes them again. The survivor of a reuse group releases its
        consumer's hold on the shared entry."""
        self._ahead.shutdown()
        with self._write_lock:
            if self._reg is not None:
                self._release.detach()
                self.manager.cleanup(self._reg)
                self._reg = None
            self._written = False
        if self._shared is not None:
            self._shared.release()

    # -- read side ---------------------------------------------------------
    def _read_table(self, reg, partition: int):
        counts = ReadCounts()
        return self.manager.read_partition(reg, partition, counts), counts

    def _produce(self, partition: int) -> Iterator[ColumnarBatch]:
        reg = self._ensure_written()
        fut = self._ahead.take(partition)
        with self.timer("readTimeNs"):
            if fut is not None:
                with self.timer("readAheadWaitNs"):
                    table, counts = fut.result()
            else:
                table, counts = self._read_table(reg, partition)
            self.metrics["shuffleBytesRead"].add(counts.bytes)
            self.metrics["shuffleBlocksRead"].add(counts.blocks)
        nxt = partition + 1
        if self.read_ahead and nxt < self.num_partitions():
            self._ahead.schedule(nxt, self._read_table, reg, nxt)
        if table is None or table.num_rows == 0:
            return
        device = self.plan_device()
        for start in range(0, table.num_rows, self.target_batch_rows):
            with self.timer("readTimeNs"):
                chunk = dictionary_encode_table(
                    table.slice(start, self.target_batch_rows))
                batch = batch_from_arrow(chunk, device, dict_cache={})
            yield batch

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        if self._shared is None:
            yield from self._produce(partition)
            return
        # the exchange a reuse group keeps: the first consumer of a
        # partition reads it, the others replay it
        yield from self._shared.read(partition,
                                     lambda: self._produce(partition))
