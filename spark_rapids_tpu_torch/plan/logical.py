"""Logical plan nodes (counterpart of spark_rapids_tpu/plan/logical.py for
the nodes the port plans): ParquetScan, InMemoryScan, Project, Filter,
Aggregate, Window, Sort, Join (with an optional residual condition over
the pair of rows), Limit and Union. They hold structure and schemas only;
``overrides.py`` converts them into physical operators.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import window as W


class LogicalPlan:
    """A node's schema reads its children's. Above the leaves it is
    computed once and kept on the node (no node changes after it is
    built: a rewrite builds new nodes), so that a walk asking every node
    for its children's schemas (the planner, the plan memo's key) takes
    time linear in the plan's depth, not quadratic."""

    children: Tuple["LogicalPlan", ...] = ()

    @property
    def schema(self) -> T.Schema:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class ParquetScan(LogicalPlan):
    """Parquet files; the schema is the first file's, as the reference's
    (the other files are read and cast to it). ``predicate`` is pushed to
    the scan's row-group pruning only: a filter above applies it."""

    paths: List[str]
    columns: Optional[List[str]] = None
    predicate: Optional[E.Expression] = None
    device: str = "cuda"

    @property
    def schema(self) -> T.Schema:
        import pyarrow.parquet as pq

        s = pq.read_schema(self.paths[0])
        if self.columns is not None:
            s = pa.schema([s.field(c) for c in self.columns])
        return T.Schema.from_arrow(s)

    def describe(self):
        return f"ParquetScan[{len(self.paths)} files]"


@dataclasses.dataclass
class InMemoryScan(LogicalPlan):
    table: pa.Table
    batch_rows: int = 1 << 20
    device: str = "cuda"
    partitions: int = 1  # source splits (Spark: one task per input split)

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

    @functools.cached_property
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

    @functools.cached_property
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

    @functools.cached_property
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
class Window(LogicalPlan):
    """Append window columns to the child (Spark WindowExec shape: all
    expressions share one (partition, order) spec per node)."""

    window_exprs: List[E.Expression]  # Alias(WindowExpression) ...
    child: LogicalPlan

    def __post_init__(self):
        self.children = (self.child,)

    @functools.cached_property
    def schema(self) -> T.Schema:
        from spark_rapids_tpu_torch.exec.aggregate import _strip_alias

        cs = self.child.schema
        fields = list(cs)
        for e in self.window_exprs:
            func, name = _strip_alias(e)
            f = func.function
            if isinstance(f, E.AggregateExpression) and f.children:
                b = type(f)(E.resolve(f.children[0], cs))
                dt, nullable = b.dtype, b.nullable
            elif isinstance(f, W.Lead):  # and Lag: the value's type
                dt, nullable = E.resolve(f.child, cs).dtype, True
            else:
                dt, nullable = f.dtype, f.nullable
            fields.append(T.Field(name, dt, nullable))
        return T.Schema(fields)

    def describe(self):
        return f"Window{self.window_exprs}"


@dataclasses.dataclass
class Sort(LogicalPlan):
    orders: List[SortOrder]
    child: LogicalPlan
    limit: Optional[int] = None

    def __post_init__(self):
        self.children = (self.child,)

    @functools.cached_property
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
    # a residual predicate over the left and right columns of each
    # key-equal pair: a pair where it is not true is no match
    condition: Optional[E.Expression] = None

    def __post_init__(self):
        self.children = (self.left, self.right)

    @functools.cached_property
    def schema(self) -> T.Schema:
        from spark_rapids_tpu_torch.exec.join import join_schema

        return join_schema(self.left.schema, self.right.schema,
                           self.join_type)

    def describe(self):
        if self.condition is not None:
            return f"Join[{self.join_type}, {self.condition!r}]"
        return f"Join[{self.join_type}]"


@dataclasses.dataclass
class Limit(LogicalPlan):
    n: int
    child: LogicalPlan
    offset: int = 0

    def __post_init__(self):
        self.children = (self.child,)

    @functools.cached_property
    def schema(self) -> T.Schema:
        return self.child.schema

    def describe(self):
        return f"Limit[{self.n}]"


@dataclasses.dataclass
class Union(LogicalPlan):
    """UNION ALL of its inputs, matched by position. The schema takes the
    first input's names; each column's type widens over the inputs
    (Spark's WidenSetOperationTypes, ``union_widen``) and is nullable
    where any input's is."""

    inputs: List[LogicalPlan]

    def __post_init__(self):
        self.children = tuple(self.inputs)

    @functools.cached_property
    def schema(self) -> T.Schema:
        schemas = [c.schema for c in self.inputs]
        first = schemas[0]
        for s in schemas[1:]:
            if len(s) != len(first):
                raise ValueError(f"union inputs have {len(first)} and "
                                 f"{len(s)} columns")
        fields = []
        for i, f in enumerate(first):
            dt, nullable = f.dtype, f.nullable
            for s in schemas[1:]:
                dt = union_widen(dt, s[i].dtype)
                nullable = nullable or s[i].nullable
            fields.append(T.Field(f.name, dt, nullable))
        return T.Schema(fields)

    def describe(self):
        return f"Union[{len(self.inputs)}]"


def union_widen(a: T.DataType, b: T.DataType) -> T.DataType:
    """The common type of two union columns: two decimals widen to the
    larger integer digits plus the larger scale (capped at 38 digits),
    other numerics as binary arithmetic widens them."""
    if a == b:
        return a
    if isinstance(a, T.DecimalType) and isinstance(b, T.DecimalType):
        s = max(a.scale, b.scale)
        p = max(a.precision - a.scale, b.precision - b.scale) + s
        return T.DecimalType(min(p, T.DecimalType.MAX_PRECISION), s)
    return E.numeric_widen(a, b)
