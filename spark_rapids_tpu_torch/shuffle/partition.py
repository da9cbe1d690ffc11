"""Device-side partitioning of shuffle writes (counterpart of
spark_rapids_tpu/shuffle/partition.py; partition ids are bit-equal to the
reference's).

``Partitioner.split`` is one device pass per batch: the partition id of
every row, a stable order by id, one gather, and the per-partition counts
read to the host once; the sorted batch then goes to the host as one
Arrow table, sliced per partition. Torch operations only: the reference
does the same pass in XLA ``jnp``, not in a kernel of its own.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, batch_to_arrow
from spark_rapids_tpu_torch.exec import kernels as K


class Partitioner:
    num_partitions: int = 1

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        """The target partition of each row (int64, in [0, n))."""
        raise NotImplementedError

    def split(self, batch: ColumnarBatch, schema: T.Schema
              ) -> List[Tuple[int, pa.Table]]:
        """(partition id, host table) of each partition with rows, in id
        order; rows keep their order within a partition."""
        n = self.num_partitions
        if batch.num_rows == 0:
            return []
        if n == 1:
            return [(0, batch_to_arrow(batch, schema))]
        pid = self.partition_ids(batch)
        order = torch.sort(pid, stable=True).indices
        counts = torch.bincount(pid, minlength=n).cpu().tolist()
        table = batch_to_arrow(K.gather_batch(batch, order), schema)
        out = []
        start = 0
        for p, c in enumerate(counts):
            if c > 0:
                out.append((p, table.slice(start, c)))
            start += c
        return out

    def describe(self) -> str:
        return f"{type(self).__name__}({self.num_partitions})"


class HashPartitioner(Partitioner):
    """The key columns' 64-bit hash (``kernels.hash_keys``: a dictionary
    string hashes by value, a null key as the null constant) modulo n, as
    an unsigned number: the hash is carried as int64 bits, so it is split
    as ``h = 2 * (h >>> 1) + (h & 1)`` to take the unsigned remainder."""

    def __init__(self, key_cols: Sequence[int], num_partitions: int):
        self.key_cols = tuple(key_cols)
        self.num_partitions = num_partitions

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        h = K.hash_keys(batch, list(self.key_cols))
        n = self.num_partitions
        return ((K._lsr(h, 1) % n) * 2 + (h & 1)) % n


class RoundRobinPartitioner(Partitioner):
    def __init__(self, num_partitions: int, start: int = 0):
        self.num_partitions = num_partitions
        self.start = start

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        i = torch.arange(batch.num_rows, device=batch.columns[0].device)
        return (i + self.start) % self.num_partitions


class SinglePartitioner(Partitioner):
    num_partitions = 1

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        return torch.zeros(batch.num_rows, dtype=torch.int64,
                           device=batch.columns[0].device)


class RangePartitioner(Partitioner):
    """Range partitions of one numeric, decimal or date sort key by sampled
    bounds (GpuRangePartitioner): a row's partition is the number of
    bounds at or below its value, compared as doubles as the reference
    compares them; a descending key negates values and bounds. Nulls go to
    the first partition (nulls first) or the last. A NaN key, the largest
    double in Spark's order, goes to the last partition ascending and the
    first descending."""

    def __init__(self, bounds, key_col: int, ascending: bool = True,
                 nulls_first: Optional[bool] = None):
        self.bounds = np.asarray(bounds, dtype=np.float64)
        self.key_col = key_col
        self.ascending = ascending
        # Spark's default: ASC NULLS FIRST, DESC NULLS LAST
        self.nulls_first = ascending if nulls_first is None else nulls_first
        self.num_partitions = len(self.bounds) + 1

    def partition_ids(self, batch: ColumnarBatch) -> torch.Tensor:
        col = batch.columns[self.key_col]
        data = col.data.double()
        if not self.ascending:
            data = -data
        bounds = torch.from_numpy(self.bounds).to(data.device)
        pid = torch.searchsorted(bounds, data, right=True)
        last = self.num_partitions - 1
        pid = torch.where(torch.isnan(data),
                          torch.full_like(pid, last if self.ascending else 0),
                          pid)
        null_pid = 0 if self.nulls_first else last
        return torch.where(col.validity, pid, torch.full_like(pid, null_pid))

    @staticmethod
    def from_sample(values: np.ndarray, num_partitions: int, key_col: int,
                    ascending: bool = True,
                    nulls_first: Optional[bool] = None) -> "RangePartitioner":
        qs = np.linspace(0, 1, num_partitions + 1)[1:-1]
        bounds = np.quantile(values, qs) if len(values) else np.zeros(0)
        if not ascending:
            bounds = -bounds[::-1]
        return RangePartitioner(np.asarray(bounds), key_col, ascending,
                                nulls_first)
