"""Logical plan nodes (counterpart of spark_rapids_tpu/plan/logical.py for
the nodes the slice plans): InMemoryScan, Project, Filter, Aggregate, Sort,
Join and Limit. They hold structure and schemas only; ``overrides.py``
converts them into physical operators.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E


class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class InMemoryScan(LogicalPlan):
    table: pa.Table
    batch_rows: int = 1 << 20
    device: str = "cuda"

    @property
    def schema(self) -> T.Schema:
        return T.Schema.from_arrow(self.table.schema)

    def describe(self):
        return f"InMemoryScan[{self.table.num_rows} rows]"


@dataclasses.dataclass
class Project(LogicalPlan):
    exprs: List[E.Expression]
    child: LogicalPlan

    def __post_init__(self):
        self.children = (self.child,)

    @property
    def schema(self) -> T.Schema:
        return EV.output_schema(EV.bind_projection(self.exprs,
                                                   self.child.schema))

    def describe(self):
        return f"Project{self.exprs}"


@dataclasses.dataclass
class Filter(LogicalPlan):
    condition: E.Expression
    child: LogicalPlan

    def __post_init__(self):
        self.children = (self.child,)

    @property
    def schema(self) -> T.Schema:
        return self.child.schema

    def describe(self):
        return f"Filter[{self.condition!r}]"


@dataclasses.dataclass
class Aggregate(LogicalPlan):
    group_exprs: List[E.Expression]
    agg_exprs: List[E.Expression]
    child: LogicalPlan

    def __post_init__(self):
        self.children = (self.child,)

    @property
    def schema(self) -> T.Schema:
        from spark_rapids_tpu_torch.exec.aggregate import _strip_alias

        fields = []
        for e in self.group_exprs:
            inner, name = _strip_alias(E.resolve(e, self.child.schema))
            fields.append(T.Field(name, inner.dtype, inner.nullable))
        for e in self.agg_exprs:
            func, name = _strip_alias(e)
            bound = E.resolve(func, self.child.schema)
            fields.append(T.Field(name, bound.dtype, bound.nullable))
        return T.Schema(fields)

    def describe(self):
        return f"Aggregate[keys={self.group_exprs}, aggs={self.agg_exprs}]"


@dataclasses.dataclass
class Sort(LogicalPlan):
    orders: List[SortOrder]
    child: LogicalPlan
    limit: Optional[int] = None

    def __post_init__(self):
        self.children = (self.child,)

    @property
    def schema(self) -> T.Schema:
        return self.child.schema

    def describe(self):
        return f"Sort{self.orders}"


@dataclasses.dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    left_keys: List[E.Expression]
    right_keys: List[E.Expression]
    join_type: str = "inner"

    def __post_init__(self):
        self.children = (self.left, self.right)

    @property
    def schema(self) -> T.Schema:
        return T.Schema(list(self.left.schema) + list(self.right.schema))

    def describe(self):
        return f"Join[{self.join_type}]"


@dataclasses.dataclass
class Limit(LogicalPlan):
    n: int
    child: LogicalPlan
    offset: int = 0

    def __post_init__(self):
        self.children = (self.child,)

    @property
    def schema(self) -> T.Schema:
        return self.child.schema

    def describe(self):
        return f"Limit[{self.n}]"
