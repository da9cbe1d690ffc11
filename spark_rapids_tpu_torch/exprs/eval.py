"""Expression evaluation over device batches (counterpart of
spark_rapids_tpu/exprs/eval.py for the port's expression nodes).

A value is ``ColVal(data, validity)`` for fixed-width results, or the
string column itself (dictionary or plain) for string references; string
equality against a literal compares the dictionary's entries once and
gathers the answer by code.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exprs import expr as E


class ColVal(NamedTuple):
    data: torch.Tensor
    validity: torch.Tensor


Val = Union[ColVal, DeviceColumn]


class EvalContext:
    def __init__(self, batch: ColumnarBatch):
        self.batch = batch
        self.num_rows = batch.num_rows
        self.device = batch.columns[0].device


def _broadcast_literal(lit: E.Literal, ctx: EvalContext) -> ColVal:
    n = ctx.num_rows
    dt = lit.dtype
    if dt == T.STRING:
        raise NotImplementedError("string literal outside an equality")
    if lit.value is None:
        return ColVal(torch.zeros(n, dtype=dt.torch_dtype, device=ctx.device),
                      torch.zeros(n, dtype=torch.bool, device=ctx.device))
    return ColVal(torch.full((n,), lit.value, dtype=dt.torch_dtype,
                             device=ctx.device),
                  torch.ones(n, dtype=torch.bool, device=ctx.device))


def _string_equals_literal(c: DeviceColumn, value: str) -> torch.Tensor:
    """Per-row byte equality of a string column with one literal."""
    if c.is_dict:
        return _string_equals_literal(c.dictionary, value)[c.data.long()]
    raw = value.encode("utf-8")
    lens = c.lengths()
    eq = lens == len(raw)
    starts = c.offsets[:-1].long()
    limit = max(c.data.numel() - 1, 0)
    for k, byte in enumerate(raw):
        if c.data.numel() == 0:
            return torch.zeros_like(eq)
        pos = torch.clamp(starts + k, max=limit)
        eq = eq & (c.data[pos] == byte)
    return eq


def _nan_aware_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spark ordering: NaN is greater than everything."""
    if a.is_floating_point():
        an, bn = torch.isnan(a), torch.isnan(b)
        return torch.where(an, torch.zeros_like(an),
                           torch.where(bn, ~an, a < b))
    return a < b


def _eval_compare(expr: E.BinaryComparison, ctx: EvalContext) -> ColVal:
    if expr.left.dtype == T.STRING or expr.right.dtype == T.STRING:
        if not isinstance(expr, E.EqualTo):
            raise NotImplementedError("string ordering comparison")
        col_side, lit_side = expr.left, expr.right
        if isinstance(col_side, E.Literal):
            col_side, lit_side = lit_side, col_side
        if not isinstance(lit_side, E.Literal):
            raise NotImplementedError("string equality of two columns")
        c = eval_expr(col_side, ctx)
        if lit_side.value is None:
            return ColVal(torch.zeros_like(c.validity),
                          torch.zeros_like(c.validity))
        return ColVal(_string_equals_literal(c, lit_side.value), c.validity)
    l = eval_expr(expr.left, ctx)
    r = eval_expr(expr.right, ctx)
    lt, rt = expr.left.dtype, expr.right.dtype
    a, b = l.data, r.data
    if lt != rt:
        ct = E.numeric_widen(lt, rt)
        a, b = a.to(ct.torch_dtype), b.to(ct.torch_dtype)
    valid = l.validity & r.validity
    if isinstance(expr, E.EqualTo):
        eq = a == b
        if a.is_floating_point():
            eq = eq | (torch.isnan(a) & torch.isnan(b))
        return ColVal(eq, valid)
    if isinstance(expr, E.LessThan):
        return ColVal(_nan_aware_lt(a, b), valid)
    if isinstance(expr, E.GreaterThanOrEqual):
        return ColVal(~_nan_aware_lt(a, b), valid)
    raise NotImplementedError(type(expr).__name__)


def _eval_arith(expr: E.BinaryArithmetic, ctx: EvalContext) -> ColVal:
    out_t = expr.dtype
    l = eval_expr(expr.left, ctx)
    r = eval_expr(expr.right, ctx)
    a = l.data.to(out_t.torch_dtype)
    b = r.data.to(out_t.torch_dtype)
    valid = l.validity & r.validity
    if isinstance(expr, E.Add):
        return ColVal(a + b, valid)
    if isinstance(expr, E.Subtract):
        return ColVal(a - b, valid)
    if isinstance(expr, E.Multiply):
        return ColVal(a * b, valid)
    raise NotImplementedError(type(expr).__name__)


def eval_expr(expr: E.Expression, ctx: EvalContext) -> Val:
    if isinstance(expr, E.Alias):
        return eval_expr(expr.child, ctx)
    if isinstance(expr, E.ColumnRef):
        c = ctx.batch.columns[expr.index]
        if c.dtype == T.STRING:
            return c
        return ColVal(c.data, c.validity)
    if isinstance(expr, E.Literal):
        return _broadcast_literal(expr, ctx)
    if isinstance(expr, E.BinaryArithmetic):
        return _eval_arith(expr, ctx)
    if isinstance(expr, E.BinaryComparison):
        return _eval_compare(expr, ctx)
    if isinstance(expr, E.And):
        l = eval_expr(expr.left, ctx)
        r = eval_expr(expr.right, ctx)
        # three-valued logic: valid when both are, or either is a valid False
        valid = ((l.validity & r.validity) | (l.validity & ~l.data)
                 | (r.validity & ~r.data))
        return ColVal(l.data & r.data & l.validity & r.validity, valid)
    raise NotImplementedError(
        f"expression {type(expr).__name__} is not in the port yet")


def val_to_column(v: Val, dt: T.DataType) -> DeviceColumn:
    if isinstance(v, DeviceColumn):
        return v
    data = v.data.to(dt.torch_dtype)
    return DeviceColumn(dt, torch.where(v.validity, data,
                                        torch.zeros_like(data)), v.validity)


def bind_projection(exprs: Sequence[E.Expression],
                    schema: T.Schema) -> List[E.Expression]:
    return [E.resolve(e, schema) for e in exprs]


def output_schema(exprs: Sequence[E.Expression]) -> T.Schema:
    fields = []
    for i, e in enumerate(exprs):
        name = e.name if isinstance(e, E.Alias) else f"c{i}"
        if isinstance(e, E.ColumnRef) and e.name:
            name = e.name
        fields.append(T.Field(name, e.dtype, e.nullable))
    return T.Schema(fields)


def project_batch(batch: ColumnarBatch,
                  bound: Sequence[E.Expression]) -> ColumnarBatch:
    """Evaluate a bound projection over a batch."""
    ctx = EvalContext(batch)
    cols = [val_to_column(eval_expr(e, ctx), e.dtype) for e in bound]
    return ColumnarBatch(cols, batch.num_rows)
