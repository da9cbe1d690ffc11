"""Generate: explode and posexplode of an array column (counterpart of
spark_rapids_tpu/exec/generate.py).

Each element of a row's array becomes a row of its own, the row's other
columns repeated; posexplode adds the element's 0-based position. The
output holds the child's other columns, then ``pos`` (posexplode) and
``col``, and drops the array column, as Spark's requiredChildOutput does.
With ``outer`` a row whose array is null or empty gives one row with a
null element (and a null position) as well; as in the reference, those
rows come in a batch of their own after the batch's expansion.

The expansion is one pass over the batch: the per-row element counts (a
null array counts 0), one host read of their sum, the row of each output
element (``repeat_interleave``), and gathers of the elements and of the
repeated columns by those rows.
"""

from __future__ import annotations

from typing import Iterator

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import expr as E


class GenerateExec(UnaryExec):
    """explode / posexplode (``position``) of one array column, with the
    ``outer`` variants."""

    def __init__(self, generator: E.Expression, child: DeviceExec,
                 outer: bool = False, position: bool = False,
                 element_name: str = "col", pos_name: str = "pos"):
        super().__init__(child)
        cs = child.output_schema
        bound = E.resolve(generator, cs)
        if not isinstance(bound, E.ColumnRef):
            raise NotImplementedError(
                "the generator must be a column reference (project it "
                "first)")
        if not isinstance(bound.dtype, T.ArrayType):
            raise NotImplementedError(f"explode needs an array, not "
                                      f"{bound.dtype}")
        self.generator = generator
        self.outer = outer
        self.position = position
        self._gen = bound.index
        self._elem_t = bound.dtype.element
        self._keep = [i for i in range(len(cs)) if i != self._gen]
        fields = [cs[i] for i in self._keep]
        if position:
            fields.append(T.Field(pos_name, T.INT, outer))
        fields.append(T.Field(element_name, self._elem_t, True))
        self._schema = T.Schema(fields)
        self._register_metric("generateTimeNs")

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def node_description(self) -> str:
        fn = "posexplode" if self.position else "explode"
        return (f"Generate {fn}{'_outer' if self.outer else ''}"
                f"({self.generator!r})")

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for b in self.child.execute(partition):
            with self.timer("generateTimeNs"):
                yield from self._generate(b)

    def _generate(self, b: ColumnarBatch) -> Iterator[ColumnarBatch]:
        col = b.columns[self._gen]
        dev = col.device
        lens = torch.where(col.validity, col.offsets[1:] - col.offsets[:-1],
                           torch.zeros_like(col.validity, dtype=torch.int32)
                           ).long()
        total = int(lens.sum())
        rows = torch.repeat_interleave(torch.arange(b.num_rows, device=dev),
                                       lens, output_size=total)
        starts = torch.cumsum(lens, 0) - lens
        pos = torch.arange(total, device=dev) - starts[rows]
        src = col.offsets[:-1].long()[rows] + pos
        ones = torch.ones(total, dtype=torch.bool, device=dev)
        cols = K.gather_columns([b.columns[i] for i in self._keep], rows)
        if self.position:
            cols.append(DeviceColumn(T.INT, pos.int(), ones))
        cols.append(DeviceColumn(self._elem_t, col.data[src], ones))
        yield ColumnarBatch(cols, total)
        if self.outer:
            idx = K.filter_indices(lens == 0)
            m = idx.numel()
            if m:
                cols = K.gather_columns([b.columns[i] for i in self._keep],
                                        idx)
                if self.position:
                    cols.append(K.null_column(T.INT, m, dev))
                cols.append(K.null_column(self._elem_t, m, dev))
                yield ColumnarBatch(cols, m)
