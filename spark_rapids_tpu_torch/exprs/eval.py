"""Expression evaluation over device batches (counterpart of
spark_rapids_tpu/exprs/eval.py for the port's expression nodes).

A value is ``ColVal(data, validity)`` for fixed-width results, or a
string column (dictionary or plain) for string results; string equality
against a literal, ``IN`` over string literals and LIKE compare or match
the dictionary's entries once and gather the answer by code. Equality of
two string columns compares codes when both share one dictionary, and
bytes otherwise (``kernels.strings_equal``). A projected string literal
is a column over a one-entry dictionary.

Substring works on bytes, as the reference's device path does (equal to
Spark's character semantics on ASCII text). Over a plain column it gathers
each row's window of bytes; over a dictionary column it cuts every entry
once and re-encodes the cut entries (``kernels.dictionary_unique``): equal
cuts of different entries share one code, and the new dictionary is
sorted, so grouping, joining and sorting on codes stay exact.

And, Or and Not follow Spark's three-valued logic; ``x IN (items)`` is the
OR of ``x = item`` under the same logic (null when x is null, or when
nothing matches and some item is null).

If, CaseWhen and Coalesce select per row with ``torch.where`` over their
branches' data and validity (``resolve`` has given every value branch the
conditional's type). A null predicate takes the else branch. String
branches that share one dictionary select codes and keep it; otherwise the
branches are decoded and each row's length and bytes are gathered from the
branch it takes.

Decimals are int64 unscaled values. Add/Subtract rescale both operands to
the result scale, Multiply multiplies the unscaled values (the result scale
is the sum of the operand scales); a decimal meeting a double is cast to
double first (unscaled / 10**scale in float64). Comparisons of decimals
with decimals or integers are exact at mixed scales: the finer side is
floor-divided down to the coarser scale and its remainder breaks ties, so
nothing is scaled up and nothing can overflow.

Casts follow the reference's non-ANSI numeric semantics (``Cast``): a
narrowing integer cast wraps, a double becomes an integer as Java's
``(int)``/``(long)`` (``double_to_integral``), a decimal keeps its whole
part. An int or decimal cast to a decimal that holds all its digits
(``T.is_exact_decimal_widening``, a union's widening) is a rescale; other
casts to decimal run on the CPU engine.
"""

from __future__ import annotations

import decimal
from typing import List, NamedTuple, Sequence, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import regex as RX


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
        return _string_value(lit, ctx)
    if lit.value is None:
        return ColVal(torch.zeros(n, dtype=dt.torch_dtype, device=ctx.device),
                      torch.zeros(n, dtype=torch.bool, device=ctx.device))
    value = lit.value
    if isinstance(dt, T.DecimalType):
        value = decimal_unscaled(value, dt.scale)
    return ColVal(torch.full((n,), value, dtype=dt.torch_dtype,
                             device=ctx.device),
                  torch.ones(n, dtype=torch.bool, device=ctx.device))


def decimal_unscaled(value, scale: int) -> int:
    """The unscaled integer of a decimal literal (value * 10**scale; exact,
    HALF_UP past the scale)."""
    with decimal.localcontext() as c:
        c.prec = 50
        return int(decimal.Decimal(str(value) if isinstance(value, float)
                                   else value).scaleb(scale).quantize(
            decimal.Decimal(1), rounding=decimal.ROUND_HALF_UP))


def _decimal_to_double(data: torch.Tensor, dt: T.DecimalType) -> torch.Tensor:
    return data.double() / (10.0 ** dt.scale)


def _scale_of(dt: T.DataType) -> int:
    """Scale of a decimal operand; an integral one is decimal(d, 0)."""
    return dt.scale if isinstance(dt, T.DecimalType) else 0


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


def _compare_result(expr: E.BinaryComparison, lt_m: torch.Tensor,
                    eq_m: torch.Tensor, valid: torch.Tensor) -> ColVal:
    """A comparison from its less-than and equal masks."""
    if isinstance(expr, E.EqualTo):
        return ColVal(eq_m, valid)
    if isinstance(expr, E.LessThan):
        return ColVal(lt_m, valid)
    if isinstance(expr, E.LessThanOrEqual):
        return ColVal(lt_m | eq_m, valid)
    if isinstance(expr, E.GreaterThan):
        return ColVal(~lt_m & ~eq_m, valid)
    if isinstance(expr, E.GreaterThanOrEqual):
        return ColVal(~lt_m, valid)
    raise NotImplementedError(type(expr).__name__)


def _decimal_compare(expr: E.BinaryComparison, l: ColVal, r: ColVal,
                     lt: T.DataType, rt: T.DataType) -> ColVal:
    """Exact comparison of decimal/integral operands at mixed scales."""
    da, sa = l.data.long(), _scale_of(lt)
    db, sb = r.data.long(), _scale_of(rt)
    if sa == sb:
        lt_m, eq_m = da < db, da == db
    elif sa > sb:
        q = torch.div(da, 10 ** (sa - sb), rounding_mode="floor")
        rm = da - q * 10 ** (sa - sb)
        lt_m, eq_m = q < db, (q == db) & (rm == 0)
    else:
        q = torch.div(db, 10 ** (sb - sa), rounding_mode="floor")
        rm = db - q * 10 ** (sb - sa)
        lt_m = (da < q) | ((da == q) & (rm > 0))
        eq_m = (da == q) & (rm == 0)
    return _compare_result(expr, lt_m, eq_m, l.validity & r.validity)


def _eval_compare(expr: E.BinaryComparison, ctx: EvalContext) -> ColVal:
    if expr.left.dtype == T.STRING or expr.right.dtype == T.STRING:
        if not isinstance(expr, E.EqualTo):
            raise NotImplementedError("string ordering comparison")
        col_side, lit_side = expr.left, expr.right
        if isinstance(col_side, E.Literal):
            col_side, lit_side = lit_side, col_side
        if not isinstance(lit_side, E.Literal):
            a, b = eval_expr(expr.left, ctx), eval_expr(expr.right, ctx)
            return ColVal(K.strings_equal(a, b), a.validity & b.validity)
        c = eval_expr(col_side, ctx)
        if lit_side.value is None:
            return ColVal(torch.zeros_like(c.validity),
                          torch.zeros_like(c.validity))
        return ColVal(_string_equals_literal(c, lit_side.value), c.validity)
    l = eval_expr(expr.left, ctx)
    r = eval_expr(expr.right, ctx)
    lt, rt = expr.left.dtype, expr.right.dtype
    valid = l.validity & r.validity
    if isinstance(lt, T.DecimalType) or isinstance(rt, T.DecimalType):
        if E.decimal_operands(lt, rt) is not None:
            return _decimal_compare(expr, l, r, lt, rt)
        # decimal against a double: both sides as double
        a = (_decimal_to_double(l.data, lt) if isinstance(lt, T.DecimalType)
             else l.data.double())
        b = (_decimal_to_double(r.data, rt) if isinstance(rt, T.DecimalType)
             else r.data.double())
        return _compare_result(expr, _nan_aware_lt(a, b), a == b, valid)
    a, b = l.data, r.data
    if lt != rt:
        ct = E.numeric_widen(lt, rt)
        a, b = a.to(ct.torch_dtype), b.to(ct.torch_dtype)
    eq = a == b
    if a.is_floating_point():
        eq = eq | (torch.isnan(a) & torch.isnan(b))
    # Spark orders NaN above every value and equal to itself
    return _compare_result(expr, _nan_aware_lt(a, b), eq, valid)


def _eval_arith(expr: E.BinaryArithmetic, ctx: EvalContext) -> ColVal:
    out_t = expr.dtype
    lt, rt = expr.left.dtype, expr.right.dtype
    l = eval_expr(expr.left, ctx)
    r = eval_expr(expr.right, ctx)
    valid = l.validity & r.validity
    if isinstance(out_t, T.DecimalType):
        a, b = l.data.long(), r.data.long()
        if isinstance(expr, E.Multiply):
            return ColVal(a * b, valid)  # result scale = sa + sb
        s = out_t.scale
        a = a * 10 ** (s - _scale_of(lt))
        b = b * 10 ** (s - _scale_of(rt))
        if isinstance(expr, E.Add):
            return ColVal(a + b, valid)
        if isinstance(expr, E.Subtract):
            return ColVal(a - b, valid)
        raise NotImplementedError(f"decimal {type(expr).__name__}")
    # decimal with a double: Spark casts the decimal side to double
    a = (_decimal_to_double(l.data, lt) if isinstance(lt, T.DecimalType)
         else l.data).to(out_t.torch_dtype)
    b = (_decimal_to_double(r.data, rt) if isinstance(rt, T.DecimalType)
         else r.data).to(out_t.torch_dtype)
    if isinstance(expr, E.Add):
        return ColVal(a + b, valid)
    if isinstance(expr, E.Subtract):
        return ColVal(a - b, valid)
    if isinstance(expr, E.Multiply):
        return ColVal(a * b, valid)
    raise NotImplementedError(type(expr).__name__)


def _eval_cast(expr: E.Cast, ctx: EvalContext) -> ColVal:
    src, dst = expr.child.dtype, expr.to
    v = eval_expr(expr.child, ctx)
    if src == dst:
        return v
    if isinstance(src, T.DecimalType) and dst == T.DOUBLE:
        return ColVal(_decimal_to_double(v.data, src), v.validity)
    if src in T.INTEGRAL_TYPES and dst in (T.LONG, T.DOUBLE):
        return ColVal(v.data.to(dst.torch_dtype), v.validity)
    if T.is_exact_decimal_widening(src, dst):  # a rescale, exact
        return ColVal(v.data.long() * 10 ** (dst.scale - _scale_of(src)),
                      v.validity)
    if dst in T.INTEGRAL_TYPES:
        if src == T.DOUBLE:
            return ColVal(double_to_integral(v.data, dst), v.validity)
        if isinstance(src, T.DecimalType):  # the whole part, then wrap
            return ColVal(torch.div(v.data, 10 ** src.scale,
                                    rounding_mode="trunc")
                          .to(dst.torch_dtype), v.validity)
        if src in T.INTEGRAL_TYPES:  # bigint -> int wraps, as Java's
            return ColVal(v.data.to(dst.torch_dtype), v.validity)
    raise NotImplementedError(f"cast {src} -> {dst} is not in the port yet")


def double_to_integral(d: torch.Tensor, dst: T.DataType) -> torch.Tensor:
    """Java's (int)/(long) of a double, Spark's non-ANSI cast: NaN is 0,
    values at or past the type's range saturate at its min/max (infinities
    included), the rest truncate toward zero. The bounds are exact powers
    of two: the type's max itself does not round-trip through a double."""
    info = torch.iinfo(dst.torch_dtype)
    hi = float(2 ** (info.bits - 1))
    over, under = d >= hi, d < -hi
    inside = torch.where(torch.isnan(d) | over | under,
                         torch.zeros_like(d), d)
    out = torch.trunc(inside).to(dst.torch_dtype)
    out = torch.where(over, torch.full_like(out, info.max), out)
    return torch.where(under, torch.full_like(out, info.min), out)


def _eval_in(expr: E.In, ctx: EvalContext) -> ColVal:
    value = expr.value
    if value.dtype == T.STRING:
        if not all(isinstance(i, E.Literal) for i in expr.items):
            raise NotImplementedError("string IN over non-literal items")
        c = eval_expr(value, ctx)
        target = c.dictionary if c.is_dict else c
        hit = torch.zeros(target.num_rows, dtype=torch.bool,
                          device=c.device)
        for item in expr.items:
            if item.value is not None:
                hit = hit | _string_equals_literal(target, item.value)
        if c.is_dict:
            hit = hit[c.data.long()]
        hit = hit & c.validity
        if any(i.value is None for i in expr.items):
            return ColVal(hit, hit)
        return ColVal(hit, c.validity)
    v = eval_expr(value, ctx)
    hit = torch.zeros_like(v.validity)
    all_valid = v.validity
    for item in expr.items:
        eq = _eval_compare(E.EqualTo(value, item), ctx)
        hit = hit | (eq.data & eq.validity)
        all_valid = all_valid & eq.validity
    return ColVal(hit, hit | all_valid)


def _substring(expr: E.Substring, ctx: EvalContext) -> DeviceColumn:
    c = eval_expr(expr.child, ctx)
    if not c.is_dict:
        return substring_bytes(c, expr.pos, expr.length)
    entries, remap = K.dictionary_unique(
        substring_bytes(c.dictionary, expr.pos, expr.length))
    return DeviceColumn(T.STRING, remap[c.data.long()], c.validity, None,
                        entries)


def substring_bytes(c: DeviceColumn, pos: int, length: int) -> DeviceColumn:
    """Spark's substringSQL over the bytes of a plain string column: the
    window [start, start + length) from pos (1-based; 0 acts as 1; a
    negative pos counts from the end) clamped into [0, len]. One host
    read: the output's byte count."""
    lens = c.lengths().long()
    if pos > 0:
        raw = torch.full_like(lens, pos - 1)
    elif pos == 0:
        raw = torch.zeros_like(lens)
    else:
        raw = lens + pos
    zero = torch.zeros_like(lens)
    start = torch.minimum(torch.maximum(raw, zero), lens)
    # a length past any row (up to Java's int range) clamps to the row
    end = torch.minimum(torch.maximum(raw + min(length, 1 << 40), zero),
                        lens)
    out_len = torch.clamp(end - start, min=0)
    n = c.num_rows
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=c.device)
    if n:
        offsets[1:] = torch.cumsum(out_len, 0)
    total = int(offsets[-1]) if n else 0
    rows = torch.repeat_interleave(torch.arange(n, device=c.device), out_len,
                                   output_size=total)
    rel = torch.arange(total, device=c.device) - offsets[:-1][rows]
    src = c.offsets[:-1].long()[rows] + start[rows] + rel
    return DeviceColumn(T.STRING, c.data[src], c.validity, offsets.int())


def _like(expr: E.Like, ctx: EvalContext) -> ColVal:
    c = eval_expr(expr.child, ctx)
    dfa = RX.like_to_dfa(expr.pattern, expr.escape)
    if c.is_dict:
        hit = RX.match_strings(dfa, c.dictionary)[c.data.long()]
    else:
        hit = RX.match_strings(dfa, c)
    return ColVal(hit & c.validity, c.validity)


def _string_value(expr: E.Expression, ctx: EvalContext,
                  like: DeviceColumn = None) -> DeviceColumn:
    """A string branch as a column; a literal becomes a column of ``n``
    rows (a null one shares ``like``'s dictionary when it has one)."""
    if not isinstance(expr, E.Literal):
        return eval_expr(expr, ctx)
    n, dev = ctx.num_rows, ctx.device
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    if expr.value is None:
        if like is not None and like.is_dict:
            return DeviceColumn(T.STRING, zeros, zeros.bool(), None,
                                like.dictionary)
        return K.null_column(T.STRING, n, dev)
    raw = torch.tensor(list(expr.value.encode("utf-8")), dtype=torch.uint8,
                       device=dev)
    entry = DeviceColumn(T.STRING, raw,
                         torch.ones(1, dtype=torch.bool, device=dev),
                         torch.tensor([0, raw.numel()], dtype=torch.int32,
                                      device=dev))
    return DeviceColumn(T.STRING, zeros, torch.ones(n, dtype=torch.bool,
                                                    device=dev), None, entry)


def _string_select(take: torch.Tensor, a: DeviceColumn,
                   b: DeviceColumn) -> DeviceColumn:
    """Per row, ``a`` where ``take`` else ``b``."""
    valid = torch.where(take, a.validity, b.validity)
    if a.is_dict and b.is_dict and a.dictionary is b.dictionary:
        return DeviceColumn(T.STRING, torch.where(take, a.data, b.data),
                            valid, None, a.dictionary)
    both = K.concat_device([
        ColumnarBatch([K.decode_dictionary(c) if c.is_dict else c],
                      c.num_rows) for c in (a, b)]).columns[0]
    rows = torch.arange(take.numel(), device=take.device)
    out = K.gather_string(both, torch.where(take, rows, rows + a.num_rows))
    return DeviceColumn(T.STRING, out.data, valid, out.offsets)


def _eval_conditional(expr: E.Expression, ctx: EvalContext) -> Val:
    """If, CaseWhen and Coalesce as a fold of two-way selections from the
    last value back to the first."""
    if isinstance(expr, E.If):
        p, t, f = expr.children
        arms = [(p, t)]
        last = f
    elif isinstance(expr, E.CaseWhen):
        arms = list(expr.branches)
        last = (expr.else_value if expr.else_value is not None
                else E.Literal(None, expr.dtype))
    else:  # Coalesce: each value is its own predicate (non-null)
        arms = [(None, v) for v in expr.children[:-1]]
        last = expr.children[-1]
    if expr.dtype == T.STRING:
        cols = {id(v): eval_expr(v, ctx) for v in [v for _, v in arms]
                + [last] if not isinstance(v, E.Literal)}
        like = next((c for c in cols.values() if c.is_dict), None)

        def value(e):
            got = cols.get(id(e))
            return got if got is not None else _string_value(e, ctx, like)
        select = _string_select
    else:
        def value(e):
            return eval_expr(e, ctx)

        def select(take, a, b):
            return ColVal(torch.where(take, a.data, b.data),
                          torch.where(take, a.validity, b.validity))
    out = value(last)
    for pred, v in reversed(arms):
        val = value(v)
        if pred is None:
            take = val.validity
        else:
            pv = eval_expr(pred, ctx)
            take = pv.data & pv.validity
        out = select(take, val, out)
    return out


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
    if isinstance(expr, E.Cast):
        return _eval_cast(expr, ctx)
    if isinstance(expr, E.And):
        l = eval_expr(expr.left, ctx)
        r = eval_expr(expr.right, ctx)
        # three-valued logic: valid when both are, or either is a valid False
        valid = ((l.validity & r.validity) | (l.validity & ~l.data)
                 | (r.validity & ~r.data))
        return ColVal(l.data & r.data & l.validity & r.validity, valid)
    if isinstance(expr, E.Or):
        l = eval_expr(expr.left, ctx)
        r = eval_expr(expr.right, ctx)
        # valid when both are, or either is a valid True
        valid = ((l.validity & r.validity) | (l.validity & l.data)
                 | (r.validity & r.data))
        return ColVal((l.data & l.validity) | (r.data & r.validity), valid)
    if isinstance(expr, E.Not):
        c = eval_expr(expr.child, ctx)
        return ColVal(~c.data & c.validity, c.validity)
    if isinstance(expr, (E.IsNull, E.IsNotNull)):
        valid = eval_expr(expr.child, ctx).validity
        return ColVal(~valid if isinstance(expr, E.IsNull) else valid,
                      torch.ones_like(valid))
    if isinstance(expr, E.In):
        return _eval_in(expr, ctx)
    if isinstance(expr, (E.If, E.CaseWhen, E.Coalesce)):
        return _eval_conditional(expr, ctx)
    if isinstance(expr, E.Substring):
        return _substring(expr, ctx)
    if isinstance(expr, E.Like):
        return _like(expr, ctx)
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
