"""Hash aggregation in mode ``complete`` (counterpart of
spark_rapids_tpu/exec/aggregate.py on its hash-grouping path).

Per input batch, a first pass pre-projects the group keys and aggregate
inputs, clusters rows with ``kernels.group_rows`` and reduces each group
with the sorted segment reducers into partial buffers. The partials of all
batches are then concatenated on the device and merged by one more grouped
reduction, and a final projection turns buffers into results.

Buffer layout per function (Spark result types):
  Sum -> [sum]    Count -> [count]    Average -> [sum, count]
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E


@dataclasses.dataclass
class _AggSpec:
    func: E.AggregateExpression
    name: str
    input_index: Optional[int]  # into the pre-projection; None = count(*)
    ops: List[str]
    buffer_types: List[T.DataType]


_MERGE_OP = {"sum": "sum", "count": "sum", "count_all": "sum"}


def _lower_agg(func: E.AggregateExpression, name: str,
               input_index: Optional[int]) -> _AggSpec:
    if isinstance(func, E.Count):
        op = "count" if func.children else "count_all"
        return _AggSpec(func, name, input_index, [op], [T.LONG])
    if isinstance(func, E.Sum):
        return _AggSpec(func, name, input_index, ["sum"], [func.dtype])
    if isinstance(func, E.Average):
        sum_t = (T.DOUBLE if func.child.dtype in T.FRACTIONAL_TYPES
                 else T.LONG)
        return _AggSpec(func, name, input_index, ["sum", "count"],
                        [sum_t, T.LONG])
    raise NotImplementedError(
        f"aggregate {type(func).__name__} is not in the port yet")


def _strip_alias(e: E.Expression) -> Tuple[E.Expression, str]:
    if isinstance(e, E.Alias):
        return e.child, e.name
    return e, (e.name if isinstance(e, (E.ColumnRef, E.UnresolvedColumn))
               else repr(e))


class HashAggregateExec(UnaryExec):
    def __init__(self, group_exprs: Sequence[E.Expression],
                 agg_exprs: Sequence[E.Expression], child: DeviceExec,
                 mode: str = "complete"):
        if mode != "complete":
            raise NotImplementedError(f"aggregate mode {mode} is not in the "
                                      f"port yet")
        super().__init__(child)
        self.mode = mode
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        in_schema = child.output_schema
        self._group_bound = [E.resolve(e, in_schema) for e in group_exprs]
        self._n_keys = len(self._group_bound)
        pre: List[E.Expression] = list(self._group_bound)
        self._specs: List[_AggSpec] = []
        for e in self.agg_exprs:
            func, name = _strip_alias(e)
            if not isinstance(func, E.AggregateExpression):
                raise NotImplementedError(f"not an aggregate: {e!r}")
            func = E.resolve(func, in_schema)
            idx = None
            if func.children:
                idx = len(pre)
                pre.append(func.children[0])
            self._specs.append(_lower_agg(func, name, idx))
        self._pre_bound = tuple(pre)
        self._register_metric("numAggBatches")

    def _buffer_schema(self) -> T.Schema:
        fields = []
        for e in self._group_bound:
            inner, name = _strip_alias(e)
            fields.append(T.Field(name, inner.dtype, inner.nullable))
        for s in self._specs:
            for bi, bt in enumerate(s.buffer_types):
                fields.append(T.Field(f"{s.name}#b{bi}", bt, True))
        return T.Schema(fields)

    @property
    def output_schema(self) -> T.Schema:
        fields = []
        for e in self._group_bound:
            inner, name = _strip_alias(e)
            fields.append(T.Field(name, inner.dtype, inner.nullable))
        for s in self._specs:
            fields.append(T.Field(s.name, s.func.dtype, s.func.nullable))
        return T.Schema(fields)

    def node_description(self) -> str:
        return (f"HashAggregate(mode={self.mode}) "
                f"keys=[{', '.join(map(repr, self.group_exprs))}] "
                f"aggs=[{', '.join(map(repr, self.agg_exprs))}]")

    # -- passes --------------------------------------------------------------
    def _grouping(self, pre: ColumnarBatch) -> K.GroupInfo:
        n = pre.num_rows
        dev = pre.columns[0].device
        if self._n_keys == 0:
            # global aggregation: one output row, even over no input
            return K.GroupInfo(torch.arange(n, device=dev),
                               torch.zeros(n, dtype=torch.int32, device=dev),
                               1, torch.zeros(1, dtype=torch.int64,
                                              device=dev))
        return K.group_rows(pre, list(range(self._n_keys)))

    def _first_pass(self, batch: ColumnarBatch) -> ColumnarBatch:
        ctx = EV.EvalContext(batch)
        pre_cols = []
        for e in self._pre_bound:
            inner, _ = _strip_alias(e)
            if isinstance(inner, E.ColumnRef):
                # as-is: dictionary keys group and gather on their codes
                pre_cols.append(batch.columns[inner.index])
            else:
                pre_cols.append(EV.val_to_column(EV.eval_expr(inner, ctx),
                                                  inner.dtype))
        if not pre_cols:
            # count(*) alone: a placeholder column carries the row count
            pre_cols.append(DeviceColumn(
                T.BOOLEAN, torch.zeros(batch.num_rows, dtype=torch.bool,
                                       device=ctx.device),
                torch.ones(batch.num_rows, dtype=torch.bool,
                           device=ctx.device)))
        pre = ColumnarBatch(pre_cols, batch.num_rows)
        return self._aggregate_grouped(pre, self._grouping(pre),
                                       [s.ops for s in self._specs])

    def _merge_pass(self, buffers: ColumnarBatch) -> ColumnarBatch:
        merge_ops = [[_MERGE_OP[op] for op in s.ops] for s in self._specs]
        return self._aggregate_grouped(buffers, self._grouping(buffers),
                                       merge_ops, buffers_input=True)

    def _aggregate_grouped(self, pre: ColumnarBatch, gi: K.GroupInfo,
                           ops_per_spec, buffers_input: bool = False
                           ) -> ColumnarBatch:
        perm = gi.perm
        out_cols: List[DeviceColumn] = []
        if self._n_keys:
            out_cols = K.gather_columns(pre.columns[: self._n_keys],
                                        perm[gi.group_starts])
        buf_idx = self._n_keys
        for s, ops in zip(self._specs, ops_per_spec):
            for op, bt in zip(ops, s.buffer_types):
                if buffers_input:
                    src_i = buf_idx
                    buf_idx += 1
                else:
                    src_i = s.input_index
                if src_i is None:  # count(*)
                    vals = None
                    valid = torch.ones(perm.numel(), dtype=torch.bool,
                                       device=perm.device)
                else:
                    src = pre.columns[src_i]
                    vals, valid = K.gather_lanes([src.data, src.validity],
                                                 perm)
                data, avalid = K.segment_agg(vals, valid, gi.segment_ids,
                                             gi.group_starts, op)
                data = data.to(bt.torch_dtype)
                out_cols.append(DeviceColumn(
                    bt, torch.where(avalid, data, torch.zeros_like(data)),
                    avalid))
        return ColumnarBatch(out_cols, gi.num_groups)

    def _final_project(self, buffers: ColumnarBatch) -> ColumnarBatch:
        out_cols: List[DeviceColumn] = list(buffers.columns[: self._n_keys])
        bi = self._n_keys
        for s in self._specs:
            bufs = buffers.columns[bi: bi + len(s.ops)]
            bi += len(s.ops)
            if isinstance(s.func, E.Average):
                ssum, cnt = bufs
                valid = ssum.validity & (cnt.data > 0)
                data = ssum.data.double() / torch.clamp(cnt.data,
                                                        min=1).double()
                out_cols.append(DeviceColumn(
                    T.DOUBLE, torch.where(valid, data,
                                          torch.zeros_like(data)), valid))
            else:
                out_cols.append(bufs[0])
        return ColumnarBatch(out_cols, buffers.num_rows)

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        partials = []
        for batch in self.child.execute(partition):
            partials.append(self._first_pass(batch))
            self.metrics["numAggBatches"].add(1)
        if not partials:
            if self._n_keys == 0:
                dev = _device_of(self)
                buf = empty_batch(self._buffer_schema().types(), dev)
                yield self._final_project(self._merge_pass(buf))
            return
        merged = (partials[0] if len(partials) == 1
                  else self._merge_pass(K.concat_device(partials)))
        yield self._final_project(merged)


def _device_of(node: DeviceExec) -> torch.device:
    """The device of a plan's source batches (for empty results)."""
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec

    while not isinstance(node, BatchSourceExec):
        node = node.children[0]
    if node.device is None:
        raise ValueError("the plan's source has no device: pass device= to "
                         "BatchSourceExec")
    return node.device
