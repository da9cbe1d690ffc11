"""Broadcast hash join (counterpart of ``BroadcastHashJoinExec`` in
spark_rapids_tpu/exec/join_bcast.py, GpuBroadcastHashJoinExecBase).

The build (right) side executes once, under a lock, across all of its
partitions; its probe structure (the hash table, or the sorted hashes) is
prepared once and probed by every left partition, so the join has the
left side's partitions and neither side is exchanged. Join types follow
the broadcast restriction: inner, left, left_semi and left_anti, which
need no flag over build rows across probe partitions. Every probe path
and output rule is ``HashJoinExec``'s.

When broadcast joins of one plan have equal build sides and build keys,
the reuse rewrite gives them one ``SharedBroadcast`` (``plan/reuse.py``):
the first to build publishes its prepared build, and the others adopt it
instead of concatenating and hashing the same rows again (each counts the
adopted build's path in its own metrics).
"""

from __future__ import annotations

import threading

from spark_rapids_tpu_torch.exec import reuse
from spark_rapids_tpu_torch.exec.join import HashJoinExec


class BroadcastHashJoinExec(HashJoinExec):
    BROADCAST_TYPES = ("inner", "left", "left_semi", "left_anti")

    def __init__(self, left_keys, right_keys, join_type, left, right,
                 max_candidate_rows=None, condition=None):
        if join_type not in self.BROADCAST_TYPES:
            raise ValueError(f"a broadcast build side does not support a "
                             f"{join_type} join")
        super().__init__(left_keys, right_keys, join_type, left, right,
                         max_candidate_rows, condition)
        self._broadcast = None
        self._bcast_lock = threading.Lock()
        # set by plan/reuse.py when other joins share this build
        self._shared_broadcast = None
        self._register_metric("broadcastTimeNs")

    def num_partitions(self) -> int:
        return self.left.num_partitions()

    def node_description(self) -> str:
        return "Broadcast" + super().node_description()

    def _build_side(self, partition: int):
        with self._bcast_lock:
            if self._broadcast is not None:
                return self._broadcast
            holder = self._shared_broadcast
            shared = holder.get() if holder is not None else None
            if shared is not None:
                build, prep = shared
                if prep is not None:
                    self.metrics["hashTableJoins" if prep[0] == "ht"
                                 else "sortedHashJoins"].add(1)
                reuse.note("reuse_bytes_saved_total",
                           reuse.batch_nbytes(build))
                self._broadcast = shared
                return shared
            with self.timer("broadcastTimeNs"):
                self._broadcast = self._build(self.right.execute_all())
            if holder is not None:
                holder.put(self._broadcast)
            return self._broadcast

    def drop_run_state(self) -> None:
        """Forget the build, and the value of the build it shares: the
        next run builds again (a memoised plan between its runs)."""
        with self._bcast_lock:
            self._broadcast = None
        if self._shared_broadcast is not None:
            self._shared_broadcast.clear()
