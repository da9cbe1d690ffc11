"""Expression trees with Spark typing rules (host-only; counterpart of
spark_rapids_tpu/exprs/expr.py for the nodes TPC-H Q1/Q3/Q5/Q6 build):
column references, literals (DATE included), Alias, Add/Subtract/Multiply,
LessThan/GreaterThanOrEqual/EqualTo, And, and the aggregates Sum, Average
and Count.

Null semantics: every expression evaluates to (data, validity); arithmetic
and comparisons are null-intolerant, And follows three-valued logic.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, List, Optional, Tuple

from spark_rapids_tpu_torch import types as T


class Expression:
    children: Tuple["Expression", ...] = ()

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    def __repr__(self):
        name = type(self).__name__
        if self.children:
            return f"{name}({', '.join(map(repr, self.children))})"
        return name

    # builder sugar, as the reference's
    def __add__(self, other):
        return Add(self, _lit(other))

    def __sub__(self, other):
        return Subtract(self, _lit(other))

    def __mul__(self, other):
        return Multiply(self, _lit(other))

    def __and__(self, other):
        return And(self, _lit(other))

    def __lt__(self, other):
        return LessThan(self, _lit(other))

    def __ge__(self, other):
        return GreaterThanOrEqual(self, _lit(other))

    def eq(self, other):
        return EqualTo(self, _lit(other))

    def alias(self, name: str):
        return Alias(self, name)


def _lit(v) -> Expression:
    return v if isinstance(v, Expression) else Literal.of(v)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ColumnRef(Expression):
    """Reference to an input column by ordinal (bound) with known type."""

    index: int
    _dtype: T.DataType
    _nullable: bool = True
    name: str = ""

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def __repr__(self):
        return f"col#{self.index}:{self._dtype}"


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class UnresolvedColumn(Expression):
    """Column referenced by name; resolved against a schema at bind time."""

    name: str

    @property
    def dtype(self):
        raise TypeError(f"unresolved column {self.name!r} has no type yet")

    def __repr__(self):
        return f"col({self.name!r})"


def col(name: str) -> UnresolvedColumn:
    return UnresolvedColumn(name)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class Literal(Expression):
    value: Any
    _dtype: T.DataType

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    @staticmethod
    def of(v, dtype: Optional[T.DataType] = None) -> "Literal":
        if dtype is None:
            if isinstance(v, bool):
                dtype = T.BOOLEAN
            elif isinstance(v, int):
                dtype = T.INT if -(2**31) <= v < 2**31 else T.LONG
            elif isinstance(v, float):
                dtype = T.DOUBLE
            elif isinstance(v, str):
                dtype = T.STRING
            elif isinstance(v, datetime.date):
                dtype = T.DATE
            else:
                raise TypeError(f"cannot infer literal type for {v!r}")
        if dtype == T.DATE and isinstance(v, datetime.date):
            v = (v - datetime.date(1970, 1, 1)).days
        return Literal(v, dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


def lit(v, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal.of(v, dtype)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class Alias(Expression):
    child: Expression
    name: str

    @property
    def children(self):  # type: ignore[override]
        return (self.child,)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return self.child.nullable

    def __repr__(self):
        return f"{self.child!r} AS {self.name}"


class _Binary(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right
        self.children = (left, right)


def numeric_widen(a: T.DataType, b: T.DataType) -> T.DataType:
    """Spark's binary-arithmetic common type over the port's numerics."""
    order = [T.INT, T.LONG, T.DOUBLE]
    if a not in order or b not in order:
        raise TypeError(f"no common numeric type for {a}, {b}")
    return order[max(order.index(a), order.index(b))]


class BinaryArithmetic(_Binary):
    symbol = "?"

    @property
    def dtype(self):
        return numeric_widen(self.left.dtype, self.right.dtype)

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class Add(BinaryArithmetic):
    symbol = "+"


class Subtract(BinaryArithmetic):
    symbol = "-"


class Multiply(BinaryArithmetic):
    symbol = "*"


class BinaryComparison(_Binary):
    symbol = "?"

    @property
    def dtype(self):
        return T.BOOLEAN

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class EqualTo(BinaryComparison):
    symbol = "="


class LessThan(BinaryComparison):
    symbol = "<"


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="


class And(_Binary):
    @property
    def dtype(self):
        return T.BOOLEAN


# --- aggregate functions (consumed by exec/aggregate.py) ---
class AggregateExpression(Expression):
    """Marker base; aggregates appear only inside aggregation operators."""


class Sum(AggregateExpression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return T.LONG if self.child.dtype in T.INTEGRAL_TYPES else T.DOUBLE

    @property
    def nullable(self):
        return True


class Count(AggregateExpression):
    def __init__(self, child: Optional[Expression] = None):
        self.child = child
        self.children = (child,) if child is not None else ()

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False


class Average(AggregateExpression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return True


SUPPORTED = (ColumnRef, UnresolvedColumn, Literal, Alias, Add, Subtract,
             Multiply, EqualTo, LessThan, GreaterThanOrEqual, And, Sum,
             Count, Average)


def check_supported(expr: Expression) -> None:
    """Raise NotImplementedError naming the first node outside the port."""
    if type(expr) not in SUPPORTED:
        raise NotImplementedError(
            f"expression {type(expr).__name__} is not in the port yet")
    for c in expr.children:
        check_supported(c)


def resolve(expr: Expression, schema: T.Schema) -> Expression:
    """Replace UnresolvedColumn with a typed ColumnRef against a schema."""
    if isinstance(expr, UnresolvedColumn):
        i = schema.index_of(expr.name)
        f = schema[i]
        return ColumnRef(i, f.dtype, f.nullable, f.name)
    if isinstance(expr, (ColumnRef, Literal)):
        return expr
    kids: List[Expression] = [resolve(c, schema) for c in expr.children]
    if isinstance(expr, Alias):
        return Alias(kids[0], expr.name)
    if isinstance(expr, Count):
        return Count(kids[0] if kids else None)
    check_supported(expr)
    return type(expr)(*kids)
