"""The materialized broadcast build (counterpart of ``ReplayExec`` in
spark_rapids_tpu/exec/dpp.py).

``ReplayExec`` runs its child once, every partition, under a lock, and
replays the rows on every later read: the planner puts it under each
broadcast join's build side, so that a reused broadcast
(``exec/reuse.ReusedBroadcastExec``) and the join share one execution of
the build subtree. Its consumers are broadcast builds, which read every
partition and concatenate, so it keeps the rows concatenated, as one
batch in partition 0 (the other partitions replay nothing): the join's
build is then that very batch (``kernels.concat_device`` of one batch is
the batch), not a second copy. It stays on the device (build sides are
dimension-sized) for the plan's life, or until its run ends when the plan
memo keeps the plan (``drop_run_state``).

``DynamicPruningFilter`` (dynamic partition pruning; the reference's
GpuSubqueryBroadcastExec analog) collects the distinct values of a join's
build-side key once, at the probe scan's first task planning, and answers
whether a parquet row group's [min, max] statistics may hold any of them
(``exec/scan.ParquetScanExec._dyn_prune``). Its build is the join's own
materialization: the broadcast's ``ReplayExec``, the raw right exchange of
a shuffled join (not its AQE reader: consulting the reader from inside the
probe side's exchange write would re-enter the skew planner), or a
``ReplayExec`` that the join then reads too. A key set above
``max_values`` distinct values, or holding a NaN, disables the filter
(every row group may match).
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional

import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, batch_to_arrow)
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec


class ReplayExec(UnaryExec):
    def __init__(self, child: DeviceExec):
        super().__init__(child)
        self._cache: Optional[List[List[ColumnarBatch]]] = None
        self._lock = threading.Lock()
        # set by plan/reuse.py when other builds replay this one
        self.reuse_id: Optional[int] = None

    def node_description(self) -> str:
        desc = "Replay (materialized build side)"
        if self.reuse_id is not None:
            desc += f" [reuse #{self.reuse_id}]"
        return desc

    def materialized(self) -> Optional[List[List[ColumnarBatch]]]:
        """The replayed batches per partition, None before the first
        read."""
        with self._lock:
            return self._cache

    def _materialize(self) -> List[List[ColumnarBatch]]:
        with self._lock:
            if self._cache is None:
                n = self.child.num_partitions()
                parts = [b for p in range(n) for b in self.child.execute(p)]
                self._cache = ([[K.concat_device(parts)] if parts else []]
                               + [[] for _ in range(n - 1)])
            return self._cache

    def num_partitions(self) -> int:
        return self.child.num_partitions()

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        yield from self._materialize()[partition]

    def drop_run_state(self) -> None:
        with self._lock:
            self._cache = None


class DynamicPruningFilter:
    """The distinct values of a build plan's key column ``key_index``,
    consulted by the probe scan's row-group pruner for its ``column``."""

    def __init__(self, build: DeviceExec, key_index: int, column: str,
                 max_values: int = 1 << 16):
        self.build = build
        self.key_index = key_index
        self.column = column  # the scan-side column the keys prune
        self.max_values = max_values
        self._values: Optional[List] = None
        self._overflow = False
        self._done = False
        self._lock = threading.Lock()

    def _collect(self) -> None:
        """Arrow set operations per batch and an incremental cap check, so
        an oversized build gives up early."""
        chunks: List[pa.Array] = []
        upper = 0  # the sum of per-chunk distinct counts bounds the total
        schema = self.build.output_schema

        def merge() -> int:
            m = pc.unique(pa.concat_arrays(
                [c.cast(chunks[0].type) for c in chunks]))
            chunks[:] = [m]
            return len(m)

        for p in range(self.build.num_partitions()):
            for b in self.build.execute(p):
                t = batch_to_arrow(b, schema)
                u = pc.unique(t.column(self.key_index).combine_chunks())
                chunks.append(u.drop_null())
                upper += len(chunks[-1])
                if upper > self.max_values:
                    upper = merge()  # compacted: the true count so far
                    if upper > self.max_values:
                        self._overflow = True
                        return
        if not chunks:
            self._values = []
            return
        merge()
        vals = chunks[0].to_pylist()
        if any(isinstance(v, float) and v != v for v in vals):
            # a NaN compares false with everything: bisect cannot use it
            self._overflow = True
            return
        # one Arrow column: its values are of one type and order
        self._values = sorted(vals)

    def values(self) -> Optional[List]:
        """The sorted distinct keys, or None when pruning is disabled."""
        with self._lock:
            if not self._done:
                self._collect()
                self._done = True
            return None if self._overflow else self._values

    def reset(self) -> None:
        """Forget the collected keys: the next run collects again."""
        with self._lock:
            self._values = None
            self._overflow = False
            self._done = False

    def may_match(self, mn, mx) -> bool:
        """Could a collected key fall inside [mn, mx]? True on unknown
        statistics or a disabled filter."""
        from spark_rapids_tpu_torch.exec.scan import values_may_overlap

        vals = self.values()
        if vals is None:
            return True
        return values_may_overlap(vals, mn, mx)

    def describe(self) -> str:
        if not self._done:
            return f"dpp[{self.column}] (pending)"
        if self._overflow:
            return f"dpp[{self.column}] (disabled)"
        return f"dpp[{self.column}] ({len(self._values)} keys)"
