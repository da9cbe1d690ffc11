"""The Parquet-encoded dataframe cache (counterpart of
spark_rapids_tpu/plan/cache.py; the reference plugin's
ParquetCachedBatchSerializer behind ``df.cache()``).

Each cached batch is one in-memory zstd Parquet blob on the host; a read
decodes it and uploads it to the relation's device, trading decode time
(``decodeTimeNs``) for a resident footprint far below the batches'. Decimals
of precision up to 18 are stored as integers, as the port's writer stores
them (``io/writer.py``); the values read back are the same.
"""

from __future__ import annotations

import io
import threading
from collections import OrderedDict
from typing import Iterator, List, Tuple

import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, batch_from_arrow, batch_to_arrow, resolve_device)
from spark_rapids_tpu_torch.exec.base import DeviceExec

# (fingerprint, compression) -> (source root, relation): caching a subtree
# equal to one cached already returns its relation without running it.
# The root is held strongly, as the reference holds it: a fingerprint
# holds object ids (source batches, shuffle managers) that stay valid only
# while those objects live; the LRU bounds what it pins.
_MEMO_CAP = 16
_memo: "OrderedDict[tuple, Tuple[DeviceExec, CachedRelation]]" = \
    OrderedDict()
_memo_lock = threading.Lock()


class CachedRelation(DeviceExec):
    """A plan's output, materialised as one Parquet blob a batch, read
    back onto ``device`` (``cuda`` unless named; without a card it
    raises)."""

    def __init__(self, blobs_per_partition: List[List[bytes]],
                 schema: T.Schema, device=None):
        super().__init__()
        self._blobs = blobs_per_partition
        self._schema = schema
        self.device = resolve_device(device)
        self._register_metric("decodeTimeNs")

    @staticmethod
    def cache(node: DeviceExec, compression: str = "zstd",
              device=None) -> "CachedRelation":
        """Run ``node`` once and keep every batch as Parquet bytes; its
        shuffles are released after the run. A second cache of a subtree
        with an equal fingerprint (``plan/reuse.plan_fingerprint``: the
        same plan renamed, say) returns the first relation."""
        from spark_rapids_tpu_torch.plan.dataframe import finish_run
        from spark_rapids_tpu_torch.plan.reuse import plan_fingerprint

        dev = resolve_device(device)
        key = (plan_fingerprint(node), compression, str(dev))
        with _memo_lock:
            hit = _memo.get(key)
            if hit is not None:
                _memo.move_to_end(key)
        if hit is not None:
            finish_run(node, True)  # a tree lent by the plan memo goes back
            return hit[1]
        schema = node.output_schema
        parts: List[List[bytes]] = []
        ok = False
        try:
            for p in range(node.num_partitions()):
                blobs = []
                for b in node.execute(p):
                    buf = io.BytesIO()
                    pq.write_table(batch_to_arrow(b, schema), buf,
                                   compression=compression,
                                   store_decimal_as_integer=True)
                    blobs.append(buf.getvalue())
                parts.append(blobs)
            ok = True
        finally:
            finish_run(node, ok)
        rel = CachedRelation(parts, schema, dev)
        with _memo_lock:
            _memo[key] = (node, rel)
            while len(_memo) > _MEMO_CAP:
                _memo.popitem(last=False)
        return rel

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return len(self._blobs)

    def plan_device(self):
        return self.device

    def cached_bytes(self) -> int:
        return sum(len(b) for bs in self._blobs for b in bs)

    def node_description(self) -> str:
        return (f"CachedRelation [{self.num_partitions()} parts, "
                f"{self.cached_bytes()} bytes]")

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for blob in self._blobs[partition]:
            with self.timer("decodeTimeNs"):
                b = batch_from_arrow(pq.read_table(io.BytesIO(blob)),
                                     self.device)
            yield b
