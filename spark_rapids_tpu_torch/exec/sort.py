"""In-core sort with an optional limit (counterpart of
spark_rapids_tpu/exec/sort.py, plus the top-k shape of its
take_ordered_and_project).

The partition's batches are concatenated on the device, one stable
lexicographic argsort orders the rows (Spark null and NaN order), and one
gather emits them, cut to ``limit`` rows when given.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import expr as E


@dataclasses.dataclass(frozen=True)
class SortOrder:
    child: E.Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = Spark default for direction

    def __repr__(self):
        return f"{self.child!r} {'ASC' if self.ascending else 'DESC'}"


class SortExec(UnaryExec):
    def __init__(self, orders: Sequence[SortOrder], child: DeviceExec,
                 limit: Optional[int] = None):
        super().__init__(child)
        self.orders = list(orders)
        self.limit = limit
        schema = child.output_schema
        self._specs = []
        for o in self.orders:
            bound = E.resolve(o.child, schema)
            if not isinstance(bound, E.ColumnRef):
                raise NotImplementedError("sort keys must be column refs")
            self._specs.append(K.SortSpec(bound.index, o.ascending,
                                          o.nulls_first))
        self._register_metric("sortTimeNs")

    def node_description(self) -> str:
        lim = f" limit={self.limit}" if self.limit is not None else ""
        return f"Sort [{', '.join(map(repr, self.orders))}]{lim}"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute(partition))
        if not batches:
            return
        with self.timer("sortTimeNs"):
            batch = K.concat_device(batches)
            idx = K.sort_indices(batch, self._specs)
            if self.limit is not None:
                idx = idx[: self.limit]
            out = K.gather_batch(batch, idx)
        yield out


class LimitExec(UnaryExec):
    """First ``n`` rows of the partition, after ``offset`` rows."""

    def __init__(self, n: int, child: DeviceExec, offset: int = 0):
        super().__init__(child)
        self.n = n
        self.offset = offset

    def node_description(self) -> str:
        return f"Limit {self.n} offset={self.offset}"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        skip, remaining = self.offset, self.n
        for b in self.child.execute(partition):
            if remaining <= 0:
                return
            lo = min(skip, b.num_rows)
            skip -= lo
            hi = min(b.num_rows, lo + remaining)
            if hi > lo:
                idx = torch.arange(lo, hi, device=b.columns[0].device)
                remaining -= hi - lo
                yield K.gather_batch(b, idx)
