"""Operators without a kernel of their own (counterpart of the union part of
spark_rapids_tpu/exec/misc.py).

``UnionExec`` is the one-partition counterpart of the reference's
``UnionExec``. The reference gives each child's partitions partition
numbers of their own; the port plans one partition and has no exchange, so
a union with a partition per child would feed only partition 0 to a
single-partition aggregate, sort or join build above it and drop the other
branches without an error. The port's union yields every child's batches
in one partition instead, in child order. Its children already carry the
union's column types (the planner casts a branch that differs), and
batches of different children may hold different string dictionaries:
every consumer that concatenates batches decodes them then
(``kernels.concat_device``).
"""

from __future__ import annotations

from typing import Iterator

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import DeviceExec


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
        return 1

    def node_description(self) -> str:
        return f"Union [{len(self.children)} children, one partition]"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for c in self.children:
            for p in range(c.num_partitions()):
                yield from c.execute(p)
