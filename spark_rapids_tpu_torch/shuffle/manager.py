"""Multithreaded shuffle manager (counterpart of
spark_rapids_tpu/shuffle/manager.py, RapidsShuffleInternalManagerBase's
MULTITHREADED mode).

One map output is every block one map task wrote: in MULTITHREADED mode
one data file under the manager's local directory with an index of
(offset, length) per reduce partition, in CACHE_ONLY mode the serialized
blocks in memory. The writer pool (``writer_pool``, one per manager, of
``spark.rapids.gpu.shuffle.writeThreads`` threads) runs map writes, each
serializing its partitions in turn and sealing each block with the
integrity trailer when integrity is on. A reduce partition reads its
block from every map output in map order, verifies and strips each
trailer (``integrity.BlockCorruption`` on a mismatch) and merges the
blocks into one host Arrow table. Map outputs
are kept by map index, so the rows a reduce partition reads do not depend
on the order in which map tasks finished.

The sizes AQE plans from (``partition_sizes``, ``partition_sizes_by_map``)
are the stored block lengths, trailers included, as the reference counts
them; ``read_spec`` reads several reduce partitions at once (a coalesced
read) or one partition from a range of map outputs (a skew-split read),
where a map range ``[map_start, map_end)`` counts map outputs in map
order.
"""

from __future__ import annotations

import atexit
import concurrent.futures as cf
import os
import shutil
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.shuffle import integrity as _integrity
from spark_rapids_tpu_torch.shuffle.serializer import (
    merge_tables, serialize_table)


class _MapOutput:
    __slots__ = ("path", "index", "cached")

    def __init__(self, path: Optional[str],
                 index: Dict[int, Tuple[int, int]],
                 cached: Optional[Dict[int, bytes]]):
        self.path = path
        self.index = index  # partition -> (offset, length) in the file
        self.cached = cached


class ReadCounts:
    """Bytes (trailers included) and blocks one read fetched."""

    __slots__ = ("bytes", "blocks")

    def __init__(self):
        self.bytes = 0
        self.blocks = 0


class ShuffleRegistration:
    def __init__(self, shuffle_id: int, schema: T.Schema, n_reduce: int):
        self.shuffle_id = shuffle_id
        self.schema = schema
        self.n_reduce = n_reduce
        self.map_outputs: Dict[int, _MapOutput] = {}
        self.bytes_written = 0
        self.blocks_written = 0
        self.bytes_read = 0
        self.blocks_read = 0
        self.lock = threading.Lock()


class ShuffleManager:
    """The process's shuffle service: writes map outputs and serves
    reduce partitions. ``local_dir`` defaults to a directory of its own
    under the temporary directory, removed at exit."""

    def __init__(self, local_dir: Optional[str] = None,
                 writer_threads: int = 4, codec: str = "none",
                 cache_only: bool = False, integrity: bool = True):
        self._local_dir = local_dir
        self.codec = codec
        self.cache_only = cache_only
        self.integrity = integrity
        self._next_id = 0
        self._lock = threading.Lock()
        self.writer_pool = cf.ThreadPoolExecutor(
            writer_threads, thread_name_prefix="srgpu-shufw")
        self.bytes_written = 0
        self.blocks_written = 0
        self.bytes_read = 0
        self.blocks_read = 0
        self._regs: Dict[int, ShuffleRegistration] = {}
        from spark_rapids_tpu_torch.mem import cleaner

        cleaner.register_manager(self)

    def registrations(self) -> Dict[int, ShuffleRegistration]:
        """The shuffles registered and not cleaned up yet (the leak
        sweep's view, ``mem/cleaner.py``)."""
        with self._lock:
            return dict(self._regs)

    @property
    def local_dir(self) -> str:
        with self._lock:
            if self._local_dir is None:
                self._local_dir = tempfile.mkdtemp(prefix="srgpu_shuffle_")
                atexit.register(shutil.rmtree, self._local_dir, True)
            return self._local_dir

    def register(self, schema: T.Schema, n_reduce: int
                 ) -> ShuffleRegistration:
        with self._lock:
            reg = ShuffleRegistration(self._next_id, schema, n_reduce)
            self._next_id += 1
            self._regs[reg.shuffle_id] = reg
            return reg

    # -- write side --------------------------------------------------------
    def write_map_output(self, reg: ShuffleRegistration,
                         per_part: Dict[int, List[pa.Table]],
                         map_id: int) -> None:
        """One map task's write, on the calling thread: its per-partition
        host tables (the partitioner's split of its batches) serialized
        and kept as map ``map_id``: a file, or the blocks in memory in
        CACHE_ONLY mode. Callers run it on ``writer_pool``."""
        blocks = []
        for pid, tables in sorted(per_part.items()):
            t = pa.concat_tables(tables) if len(tables) > 1 else tables[0]
            blob = serialize_table(t, self.codec)
            # the trailer goes outside the wire frame: the merge walks
            # frames positionally
            blocks.append((pid, _integrity.seal(blob) if self.integrity
                           else blob))
        nbytes = sum(len(b) for _, b in blocks)
        with reg.lock:
            if map_id in reg.map_outputs:
                raise ValueError(f"shuffle {reg.shuffle_id} already holds "
                                 f"map output {map_id}")
        index: Dict[int, Tuple[int, int]] = {}
        if self.cache_only:
            out = _MapOutput(None, index, dict(blocks))
        else:
            os.makedirs(self.local_dir, exist_ok=True)
            path = os.path.join(self.local_dir,
                                f"shuffle_{reg.shuffle_id}_{map_id}.data")
            off = 0
            with open(path, "wb") as f:
                for pid, blob in blocks:
                    f.write(blob)
                    index[pid] = (off, len(blob))
                    off += len(blob)
            out = _MapOutput(path, index, None)
        with reg.lock:
            reg.map_outputs[map_id] = out
            reg.bytes_written += nbytes
            reg.blocks_written += len(blocks)
        with self._lock:
            self.bytes_written += nbytes
            self.blocks_written += len(blocks)

    # -- stats (AQE) -------------------------------------------------------
    def _outputs(self, reg: ShuffleRegistration) -> List[_MapOutput]:
        with reg.lock:
            return [reg.map_outputs[m] for m in sorted(reg.map_outputs)]

    @staticmethod
    def _block_len(mo: _MapOutput, partition: int) -> int:
        if mo.cached is not None:
            return len(mo.cached.get(partition, b""))
        loc = mo.index.get(partition)
        return loc[1] if loc else 0

    def num_map_outputs(self, reg: ShuffleRegistration) -> int:
        with reg.lock:
            return len(reg.map_outputs)

    def partition_sizes(self, reg: ShuffleRegistration) -> List[int]:
        """Stored bytes per reduce partition, summed over the map outputs
        (Spark's MapOutputStatistics.bytesByPartitionId)."""
        outputs = self._outputs(reg)
        return [sum(self._block_len(mo, p) for mo in outputs)
                for p in range(reg.n_reduce)]

    def partition_sizes_by_map(self, reg: ShuffleRegistration,
                               partition: int) -> List[int]:
        """Stored bytes of one reduce partition per map output, in map
        order (skew splitting)."""
        return [self._block_len(mo, partition) for mo in self._outputs(reg)]

    # -- read side ---------------------------------------------------------
    def _fetch_blocks(self, reg: ShuffleRegistration, partition: int,
                      map_start: int = 0, map_end: Optional[int] = None,
                      counts: Optional[ReadCounts] = None) -> List[bytes]:
        """A reduce partition's verified blocks from map outputs
        ``[map_start, map_end)``, in map order; ``counts`` adds the bytes
        and blocks read."""
        outputs = self._outputs(reg)[map_start:map_end]
        blocks = []
        for mo in outputs:
            if mo.cached is not None:
                blob = mo.cached.get(partition)
            else:
                loc = mo.index.get(partition)
                blob = None
                if loc is not None:
                    with open(mo.path, "rb") as f:
                        f.seek(loc[0])
                        blob = f.read(loc[1])
            if blob is None:
                continue
            blocks.append(_integrity.unseal(blob) if self.integrity
                          else blob)
            with reg.lock:
                reg.bytes_read += len(blob)
                reg.blocks_read += 1
            with self._lock:
                self.bytes_read += len(blob)
                self.blocks_read += 1
            if counts is not None:
                counts.bytes += len(blob)
                counts.blocks += 1
        return blocks

    def read_partition(self, reg: ShuffleRegistration, partition: int,
                       counts: Optional[ReadCounts] = None
                       ) -> Optional[pa.Table]:
        """A reduce partition merged into one host table (None: no row)."""
        return self.read_spec(reg, [partition], counts=counts)

    def read_spec(self, reg: ShuffleRegistration, partitions,
                  map_start: int = 0, map_end: Optional[int] = None,
                  counts: Optional[ReadCounts] = None
                  ) -> Optional[pa.Table]:
        """Reduce ``partitions`` (an AQE coalesced read), each from map
        outputs ``[map_start, map_end)`` (an AQE skew-split read), merged
        in partition then map order into one host table (None: no row)."""
        blocks: List[bytes] = []
        for p in partitions:
            blocks.extend(self._fetch_blocks(reg, p, map_start, map_end,
                                             counts))
        return merge_tables(blocks, reg.schema)

    def cleanup(self, reg: ShuffleRegistration) -> None:
        """Delete a shuffle's files and blocks."""
        with reg.lock:
            for mo in reg.map_outputs.values():
                if mo.path and os.path.exists(mo.path):
                    os.unlink(mo.path)
            reg.map_outputs.clear()
        with self._lock:
            self._regs.pop(reg.shuffle_id, None)


_managers: Dict[tuple, ShuffleManager] = {}
_default_manager: Optional[ShuffleManager] = None
_mgr_lock = threading.Lock()


def get_manager(conf: Optional[C.RapidsConf] = None) -> ShuffleManager:
    """The manager set by ``set_manager``, else the process's manager for
    the conf's shuffle mode, codec, integrity setting and writer threads
    (the active conf when none is given)."""
    conf = conf or C.get_active()
    with _mgr_lock:
        if _default_manager is not None:
            return _default_manager
        key = (conf[C.SHUFFLE_MODE], conf[C.SHUFFLE_COMPRESS],
               conf[C.SHUFFLE_INTEGRITY], conf[C.SHUFFLE_WRITE_THREADS])
        m = _managers.get(key)
        if m is None:
            m = _managers[key] = ShuffleManager(
                codec=key[1], cache_only=key[0] == "CACHE_ONLY",
                integrity=key[2], writer_threads=key[3])
        return m


def set_manager(m: Optional[ShuffleManager]) -> None:
    global _default_manager
    with _mgr_lock:
        _default_manager = m
