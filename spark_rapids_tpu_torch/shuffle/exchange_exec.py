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

Metrics: ``writeTimeNs`` (the whole write stage, the child's execution
included, as the reference times it); on the calling thread
``splitTimeNs`` (the device passes), ``waitTimeNs`` (waiting for the
writer threads after the last map) and ``readTimeNs`` (fetch, merge and
upload); ``serializeTimeNs`` (serialization and file writes, summed over
the writer threads); ``shuffleBytesWritten``/``shuffleBytesRead`` and
``shuffleBlocksWritten``/``shuffleBlocksRead``.
"""

from __future__ import annotations

import concurrent.futures as cf
import threading
from typing import Iterator, Optional

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, batch_from_arrow, dictionary_encode_table)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.shuffle.manager import (
    ShuffleManager, get_manager)
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
        self._reg = None
        self._write_lock = threading.Lock()
        for name in ("writeTimeNs", "splitTimeNs", "serializeTimeNs",
                     "waitTimeNs", "readTimeNs", "shuffleBytesWritten",
                     "shuffleBytesRead", "shuffleBlocksWritten",
                     "shuffleBlocksRead"):
            self._register_metric(name)

    def num_partitions(self) -> int:
        return self.partitioner.num_partitions

    def node_description(self) -> str:
        return f"ShuffleExchange {self.partitioner.describe()}"

    def _ensure_written(self):
        with self._write_lock:
            if self._reg is not None:
                return self._reg
            schema = self.child.output_schema
            reg = self.manager.register(schema,
                                        self.partitioner.num_partitions)
            pending = []
            with self.timer("writeTimeNs"):
                try:
                    for p in range(self.child.num_partitions()):
                        per_part = self._map_pass(p, schema)
                        if per_part:
                            pending.append(self.manager.writer_pool.submit(
                                self._write, reg, per_part, p))
                finally:
                    # a failed map pass still waits for the writes it
                    # started before the error goes up
                    with self.timer("waitTimeNs"):
                        cf.wait(pending)
                for f in pending:
                    f.result()
            self.metrics["shuffleBytesWritten"].add(reg.bytes_written)
            self.metrics["shuffleBlocksWritten"].add(reg.blocks_written)
            self._reg = reg
            return reg

    def _map_pass(self, partition: int, schema):
        """One map task's device pass: the child partition's batches split
        by partition, as host tables per partition id."""
        per_part = {}
        for b in self.child.execute(partition):
            with self.timer("splitTimeNs"):
                for pid, tbl in self.partitioner.split(b, schema):
                    per_part.setdefault(pid, []).append(tbl)
        return per_part

    def _write(self, reg, per_part, map_id: int) -> None:
        with self.timer("serializeTimeNs"):
            self.manager.write_map_output(reg, per_part, map_id)

    def cleanup(self) -> None:
        """Release the shuffle's files or blocks (after the query's output
        is gathered); a later read writes them again."""
        with self._write_lock:
            if self._reg is not None:
                self.manager.cleanup(self._reg)
                self._reg = None

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        reg = self._ensure_written()
        with self.timer("readTimeNs"):
            before = (reg.bytes_read, reg.blocks_read)
            table = self.manager.read_partition(reg, partition)
            self.metrics["shuffleBytesRead"].add(reg.bytes_read - before[0])
            self.metrics["shuffleBlocksRead"].add(reg.blocks_read
                                                  - before[1])
        if table is None or table.num_rows == 0:
            return
        device = self.plan_device()
        for start in range(0, table.num_rows, self.target_batch_rows):
            with self.timer("readTimeNs"):
                chunk = dictionary_encode_table(
                    table.slice(start, self.target_batch_rows))
                batch = batch_from_arrow(chunk, device, dict_cache={})
            yield batch
