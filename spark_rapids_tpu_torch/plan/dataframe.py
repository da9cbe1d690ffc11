"""DataFrame front end (counterpart of spark_rapids_tpu/plan/dataframe.py):
builders over the logical plan, executed as one partition on the batches'
device.
"""

from __future__ import annotations

from typing import List, Optional

import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    batch_to_arrow, resolve_device)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.plan import logical as L


def _cols(ks) -> List[E.Expression]:
    ks = ks if isinstance(ks, (list, tuple)) else [ks]
    return [E.col(k) if isinstance(k, str) else k for k in ks]


class DataFrame:
    def __init__(self, plan: L.LogicalPlan,
                 conf: Optional[C.RapidsConf] = None):
        self.plan = plan
        self.conf = conf

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self.conf)

    def select(self, *exprs) -> "DataFrame":
        return self._with(L.Project(_cols(list(exprs)), self.plan))

    def filter(self, condition: E.Expression) -> "DataFrame":
        return self._with(L.Filter(condition, self.plan))

    where = filter

    def group_by(self, *keys) -> "GroupedDataFrame":
        return GroupedDataFrame(self, _cols(list(keys)))

    def agg(self, *aggs) -> "DataFrame":
        return GroupedDataFrame(self, []).agg(*aggs)

    def sort(self, *orders, limit: Optional[int] = None) -> "DataFrame":
        os_: List[SortOrder] = []
        for o in orders:
            if isinstance(o, str):
                os_.append(SortOrder(E.col(o)))
            elif isinstance(o, SortOrder):
                os_.append(o)
            else:
                os_.append(SortOrder(o))
        return self._with(L.Sort(os_, self.plan, limit=limit))

    order_by = sort

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             left_on=None, right_on=None) -> "DataFrame":
        if on is not None:
            left_on = right_on = on
        return self._with(L.Join(self.plan, other.plan, _cols(left_on),
                                 _cols(right_on), how))

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return self._with(L.Limit(n, self.plan, offset))

    @property
    def schema(self) -> T.Schema:
        return self.plan.schema

    def physical_plan(self):
        from spark_rapids_tpu_torch.plan.overrides import Overrides

        return Overrides(self.conf).apply(self.plan)

    def explain(self) -> str:
        return self.physical_plan().explain()

    def to_arrow(self) -> pa.Table:
        node = self.physical_plan()
        schema = node.output_schema
        tables = [batch_to_arrow(b, schema) for b in node.execute_all()]
        if not tables:
            return schema.to_arrow().empty_table()
        return pa.concat_tables(tables)

    def collect(self) -> List[dict]:
        return self.to_arrow().to_pylist()


class GroupedDataFrame:
    def __init__(self, df: DataFrame, keys: List[E.Expression]):
        self.df = df
        self.keys = keys

    def agg(self, *aggs) -> DataFrame:
        return self.df._with(L.Aggregate(self.keys, list(aggs), self.df.plan))


def from_arrow(table: pa.Table, conf: Optional[C.RapidsConf] = None,
               batch_rows: int = 1 << 20, device=None) -> DataFrame:
    """A DataFrame over an Arrow table, uploaded in ``batch_rows`` batches
    to ``device`` (``cuda`` by default; raises when no card is present)."""
    dev = resolve_device(device)
    return DataFrame(L.InMemoryScan(table, batch_rows, str(dev)), conf)
