"""Expand: grouping sets, ROLLUP and CUBE (counterpart of
spark_rapids_tpu/exec/expand.py; the reference plugin's GpuExpandExec).

Each input row gives one output row per projection list: every list is
evaluated over the batch and the results are concatenated on the device
(``concat_device``). The output schema is the first list's, as the
reference's. No planner rule places it; callers compose it over a plan,
under an aggregate, as Spark's Expand sits under the grouping sets'
aggregate.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E


class ExpandExec(UnaryExec):
    def __init__(self, projections: Sequence[Sequence[E.Expression]],
                 child: DeviceExec):
        super().__init__(child)
        if not projections or any(len(p) != len(projections[0])
                                  for p in projections):
            raise ValueError("Expand takes projection lists of one length")
        self.projections = [list(p) for p in projections]
        cs = child.output_schema
        self._bound = [tuple(EV.bind_projection(p, cs))
                       for p in self.projections]
        self._schema = EV.output_schema(self._bound[0])
        for b in self._bound[1:]:
            for f, e in zip(self._schema, b):
                if e.dtype != f.dtype:
                    raise ValueError(f"Expand column {f.name}: {e.dtype} "
                                     f"where the first list has {f.dtype}")

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def node_description(self) -> str:
        return f"Expand [{len(self.projections)} projections]"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute(partition):
            pieces = [EV.project_batch(batch, b) for b in self._bound]
            yield K.concat_device(self._share_dictionaries(pieces))

    def _share_dictionaries(self, pieces):
        """A null literal beside a dictionary string column (a grouping
        set's rolled-up key) becomes a dictionary column of that
        dictionary, every row null, so the concatenation keeps the codes
        instead of decoding every piece."""
        for c in range(len(self._schema)):
            dict_col = next((p.columns[c] for p in pieces
                             if p.columns[c].is_dict), None)
            if dict_col is None:
                continue
            for p, bound in zip(pieces, self._bound):
                e = bound[c]
                e = e.child if isinstance(e, E.Alias) else e
                if isinstance(e, E.Literal) and e.value is None:
                    n = p.num_rows
                    p.columns[c] = DeviceColumn(
                        dict_col.dtype,
                        torch.zeros(n, dtype=dict_col.data.dtype,
                                    device=dict_col.data.device),
                        torch.zeros(n, dtype=torch.bool,
                                    device=dict_col.data.device),
                        None, dict_col.dictionary)
        return pieces

