"""Projection and filter (counterpart of spark_rapids_tpu/exec/project.py)."""

from __future__ import annotations

from typing import Iterator, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E


class ProjectExec(UnaryExec):
    def __init__(self, exprs: Sequence[E.Expression], child: DeviceExec):
        super().__init__(child)
        self.exprs = list(exprs)
        self._bound = tuple(EV.bind_projection(self.exprs,
                                               child.output_schema))
        self._schema = EV.output_schema(self._bound)

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def node_description(self) -> str:
        return f"Project [{', '.join(map(repr, self.exprs))}]"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute(partition):
            yield EV.project_batch(batch, self._bound)


class FilterExec(UnaryExec):
    """Predicate, then one compaction gather of the kept rows (one host
    sync a batch: the kept row count)."""

    def __init__(self, condition: E.Expression, child: DeviceExec):
        super().__init__(child)
        self.condition = condition
        self._bound = E.resolve(condition, child.output_schema)

    def node_description(self) -> str:
        return f"Filter [{self.condition!r}]"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute(partition):
            pred = EV.eval_expr(self._bound, EV.EvalContext(batch))
            idx = K.filter_indices(pred.data & pred.validity)
            yield K.gather_batch(batch, idx)
