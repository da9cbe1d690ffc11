"""Operators without a kernel of their own (counterpart of
spark_rapids_tpu/exec/misc.py): coalesce, limits, the top-k of a sort with
a limit, union and the Bernoulli sample.

``SampleExec`` keeps each row with probability ``fraction``, by a uniform
draw from a ``torch.Generator`` on the batch's device seeded from (seed,
partition, batch index): the same seed gives the same rows on one device.
The reference draws from ``jax.random`` keys folded with the same
coordinates, so the two do not keep the same rows (a known deliberate
difference); both keep a row where the draw is below the fraction.

``UnionExec`` numbers partitions as the reference's (GpuUnionExec): the
partitions of each child become partitions of the union, child by child.
Its children already carry the union's column types (the planner casts a
branch that differs), and batches of different children may hold
different string dictionaries: every consumer that concatenates batches
decodes them then (``kernels.concat_device``).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exec.sort import SortExec, SortOrder


class SampleExec(UnaryExec):
    """Seeded Bernoulli row sample without replacement (GpuSampleExec)."""

    def __init__(self, fraction: float, seed: int, child: DeviceExec):
        super().__init__(child)
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"sample fraction {fraction} is outside [0, 1]")
        self.fraction = fraction
        self.seed = seed

    def node_description(self) -> str:
        return f"Sample {self.fraction} seed={self.seed}"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for bi, b in enumerate(self.child.execute(partition)):
            dev = b.columns[0].device
            gen = torch.Generator(device=dev)
            gen.manual_seed(hash((self.seed, partition, bi)) & ((1 << 63)
                                                               - 1))
            u = torch.rand(b.num_rows, generator=gen, device=dev)
            yield K.gather_batch(b, K.filter_indices(u < self.fraction))


class CoalesceBatchesExec(UnaryExec):
    """Concatenate a partition's batches up to ``target_rows`` rows
    (TargetSize), or all of them into one (``require_single``,
    RequireSingleBatch)."""

    def __init__(self, child: DeviceExec, target_rows: int = 1 << 20,
                 require_single: bool = False):
        super().__init__(child)
        self.target_rows = target_rows
        self.require_single = require_single
        self._register_metric("concatTimeNs")

    def node_description(self) -> str:
        goal = ("RequireSingleBatch" if self.require_single
                else f"TargetSize({self.target_rows})")
        return f"CoalesceBatches [{goal}]"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        pending: List[ColumnarBatch] = []
        rows = 0
        for b in self.child.execute(partition):
            if (not self.require_single and rows
                    and rows + b.num_rows > self.target_rows):
                yield self._flush(pending)
                pending, rows = [], 0
            pending.append(b)
            rows += b.num_rows
        if pending:
            yield self._flush(pending)

    def _flush(self, pending: List[ColumnarBatch]) -> ColumnarBatch:
        if len(pending) == 1:
            return pending[0]
        with self.timer("concatTimeNs"):
            return K.concat_device(pending)


def _rows(b: ColumnarBatch, lo: int, hi: int) -> ColumnarBatch:
    """Rows [lo, hi) of a batch."""
    if lo == 0 and hi == b.num_rows:
        return b
    return K.gather_batch(b, torch.arange(lo, hi,
                                          device=b.columns[0].device))


class LocalLimitExec(UnaryExec):
    """The first ``limit`` rows of each partition."""

    def __init__(self, limit: int, child: DeviceExec):
        super().__init__(child)
        self.limit = limit

    def node_description(self) -> str:
        return f"LocalLimit {self.limit}"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        remaining = self.limit
        for b in self.child.execute(partition):
            if remaining <= 0:
                return
            take = min(b.num_rows, remaining)
            remaining -= take
            yield _rows(b, 0, take)


class GlobalLimitExec(UnaryExec):
    """The first ``limit`` rows after ``offset`` rows, across the child's
    partitions in order: one partition."""

    def __init__(self, limit: int, child: DeviceExec, offset: int = 0):
        super().__init__(child)
        self.limit = limit
        self.offset = offset

    def num_partitions(self) -> int:
        return 1

    def node_description(self) -> str:
        return f"GlobalLimit {self.limit} offset={self.offset}"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        skip, remaining = self.offset, self.limit
        for p in range(self.child.num_partitions()):
            for b in self.child.execute(p):
                if remaining <= 0:
                    return
                lo = min(skip, b.num_rows)
                skip -= lo
                hi = min(b.num_rows, lo + remaining)
                if hi > lo:
                    remaining -= hi - lo
                    yield _rows(b, lo, hi)


class _Gather(UnaryExec):
    """All the child's partitions as one, in partition order."""

    def num_partitions(self) -> int:
        return 1

    def node_description(self) -> str:
        return "Gather"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for p in range(self.child.num_partitions()):
            yield from self.child.execute(p)


def take_ordered_and_project(orders: Sequence[SortOrder], limit: int,
                             child: DeviceExec) -> DeviceExec:
    """A sort with a limit (GpuTakeOrderedAndProjectExec): each partition
    sorted and cut to ``limit`` rows, then those gathered into one
    partition, sorted again and cut. Each sort gathers only its ``limit``
    rows, so the limits above them pass their batches through; in one
    partition the first sort is the whole answer."""
    top = SortExec(orders, child, limit=limit)
    if child.num_partitions() == 1:
        return top
    return GlobalLimitExec(limit, SortExec(
        orders, _Gather(LocalLimitExec(limit, top)), limit=limit))


class UnionExec(DeviceExec):
    def __init__(self, schema: T.Schema, *children: DeviceExec):
        super().__init__(*children)
        for c in children:
            got = [f.dtype for f in c.output_schema]
            if got != [f.dtype for f in schema]:
                raise ValueError(f"union child types {got} differ from the "
                                 f"union's {schema}")
        self._schema = schema

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return sum(c.num_partitions() for c in self.children)

    def node_description(self) -> str:
        return f"Union [{len(self.children)} children]"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for c in self.children:
            n = c.num_partitions()
            if partition < n:
                yield from c.execute(partition)
                return
            partition -= n
