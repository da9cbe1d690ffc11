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
dimension-sized) for the plan's life.

The reference's ``DynamicPruningFilter`` prunes file scans by a build
side's keys; the port has no file scan yet, so it is not here.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
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
