"""Hash aggregation (counterpart of spark_rapids_tpu/exec/aggregate.py on
its hash-grouping path), in the reference's three modes:

- ``complete``: input rows -> results, in one stage;
- ``partial``: input rows -> (keys + buffers), one batch per partition;
- ``final``: (keys + buffers) -> results (``final_from_partial``), the
  reduce side of a shuffle: every buffer batch of its partition is merged
  once, as map tasks' buffers may hold the same key.

Per input batch, a first pass pre-projects the group keys and aggregate
inputs, clusters rows with ``kernels.group_rows`` and reduces each group
with the sorted segment reducers into partial buffers, each held as a
spillable handle (``mem/spill.py``). The partials of all batches are then
concatenated on the device, each pinned until the concat is made, and
merged by one more grouped reduction, and a final projection turns
buffers into results. When the partials' bytes are above
``spark.rapids.gpu.sql.agg.repartition.targetBytes`` (a quarter of the
pool's limit by default), or the pool cannot hold them all at once, they
are hash-repartitioned into spillable buckets instead, recursively, and
each bucket is merged alone (``_repartition_merge``); the operator then
emits a batch per bucket. A partial buffer column is named
``<aggregate>#b<i>``; a split into partial and final changes only the
order of float additions.

Buffer layout per function (Spark result types):
  Sum -> [sum]    Count -> [count]    Average -> [sum, count]
  Min/Max -> [min]/[max]    First/Last/AnyValue -> [value]
  BoolAnd/BoolOr -> [min]/[max] of the booleans    CountIf -> [count]
  VarianceSamp/Pop, StddevSamp/Pop -> [n, mean, M2]
  Skewness/Kurtosis -> [n, mean, M2, M3, M4]
  CovarSamp/CovarPop -> [n, mean x, mean y, Cxy]
  Corr -> [n, mean x, mean y, Cxy, M2x, M2y]
  MinBy/MaxBy -> [value, ordering]

The moment buffers are central moments (Spark's CentralMomentAgg,
Covariance and Corr), not the reference's raw power sums, which lose
every digit under a common offset: a group's rows (each a buffer of n = 1,
mean x and no spread) and a merge's partial buffers combine by one
formula (``_combine_moments``): the combined mean is taken about the
group's first live mean (so identical values give M2 = 0 exactly), then
each part's moments are shifted to it and summed. Variance, covariance and
correlation inputs are cast to DOUBLE (decimals too), and a covariance
takes only the pairs whose sides are both non-null.

First, Last and AnyValue keep the first (last) non-null value in input
order; MinBy/MaxBy the value at the first least (greatest) non-null
ordering (an integral, boolean, date or timestamp one on the device). A
string Min or Max is exact in byte order: a dictionary column reduces its
codes (its dictionary is sorted) and keeps the dictionary; a plain one
ranks its rows by a full sort of their bytes.

Decimal sums are exact sums of the unscaled values: int64 for a DECIMAL64
result, two int64 limbs exact mod 2^128 for a DECIMAL128 one (a
decimal(17,2) column sums into decimal(27,2); ``kernels.segment_agg``); a
sum whose magnitude reaches 10**precision of its result type is null
(Spark's non-ANSI overflow). A decimal average is sum / count rounded
HALF_UP at the result scale (the reference's rule, computed divide-first
so the scaled numerator cannot wrap): in int64 when the sum fits one, else
through ``int128.decimal_avg_128`` (a decimal(17,2) column averages into
decimal(21,6)). Min and Max of DECIMAL128 values reduce both limbs, and
DECIMAL128 group keys hash, sort and compare both.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec import int128 as I128
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.mem import retry, spill
from spark_rapids_tpu_torch.mem.pool import (
    RetryOOM, SplitAndRetryOOM, get_pool)


@dataclasses.dataclass
class _AggSpec:
    func: E.AggregateExpression
    name: str
    inputs: List[int]  # into the pre-projection; [] = count(*)
    ops: List[str]  # one label a buffer
    buffer_types: List[T.DataType]
    # "simple": each buffer reduced alone by its op (merged by _MERGE_OP);
    # "moments", "comoments", "minby", "pick" and "string" reduce their
    # buffers together, by one rule in the first pass and the merges
    kind: str = "simple"


_MERGE_OP = {"sum": "sum", "count": "sum", "count_all": "sum",
             "count_true": "sum", "min": "min", "max": "max"}
_COUNT_OPS = ("count", "count_all", "count_true")


def agg_inputs(func: E.AggregateExpression) -> List[E.Expression]:
    """The bound expressions an aggregate's first pass reads: its children,
    a variance's or covariance's cast to DOUBLE (Spark's input cast)."""
    if isinstance(func, (E._VarianceBase, E._CovarianceBase)):
        return [c if c.dtype == T.DOUBLE else E.Cast(c, T.DOUBLE)
                for c in func.children]
    return list(func.children)


def _lower_agg(func: E.AggregateExpression, name: str,
               inputs: List[int]) -> _AggSpec:
    def spec(ops, types, kind="simple"):
        return _AggSpec(func, name, inputs, ops, types, kind)

    if isinstance(func, E.Count):
        return spec(["count" if func.children else "count_all"], [T.LONG])
    if isinstance(func, E.Sum):
        return spec(["sum"], [func.dtype])
    if isinstance(func, (E.Min, E.Max)):
        op = "min" if isinstance(func, E.Min) else "max"
        return spec([op], [func.dtype],
                    "string" if func.child.dtype in (T.STRING, T.BINARY)
                    else "simple")
    if isinstance(func, (E.First, E.Last, E.AnyValue)):
        return spec(["last" if isinstance(func, E.Last) else "first"],
                    [func.dtype], "pick")
    if isinstance(func, E.Average):
        c = func.child.dtype
        if isinstance(c, T.DecimalType):
            sum_t = E.Sum(func.child).dtype
        else:
            sum_t = T.DOUBLE if c in T.FRACTIONAL_TYPES else T.LONG
        return spec(["sum", "count"], [sum_t, T.LONG])
    if isinstance(func, E._VarianceBase):
        order = 4 if isinstance(func, (E.Skewness, E.Kurtosis)) else 2
        return spec(["n", "mean"] + [f"m{p}" for p in range(2, order + 1)],
                    [T.LONG] + [T.DOUBLE] * order, "moments")
    if isinstance(func, E._CovarianceBase):
        ops = ["n", "mean_x", "mean_y", "c_xy"]
        if isinstance(func, E.Corr):
            ops += ["m2_x", "m2_y"]
        return spec(ops, [T.LONG] + [T.DOUBLE] * (len(ops) - 1),
                    "comoments")
    if isinstance(func, E.MinBy):
        op = "max" if isinstance(func, E.MaxBy) else "min"
        return spec([op + "by_value", op + "by_ordering"],
                    [func.value.dtype, func.ordering.dtype], "minby")
    if isinstance(func, E.BoolAnd):
        return spec(["max" if isinstance(func, E.BoolOr) else "min"],
                    [T.BOOLEAN])
    if isinstance(func, E.CountIf):
        return spec(["count_true"], [T.LONG])
    raise NotImplementedError(
        f"aggregate {type(func).__name__} is not on the device (the CPU "
        f"engine runs it)")


def _strip_alias(e: E.Expression) -> Tuple[E.Expression, str]:
    if isinstance(e, E.Alias):
        return e.child, e.name
    return e, (e.name if isinstance(e, (E.ColumnRef, E.UnresolvedColumn))
               else repr(e))


class HashAggregateExec(UnaryExec):
    def __init__(self, group_exprs: Sequence[E.Expression],
                 agg_exprs: Sequence[E.Expression], child: DeviceExec,
                 mode: str = "complete",
                 specs: Optional[List[_AggSpec]] = None):
        if mode not in ("complete", "partial", "final"):
            raise ValueError(f"aggregate mode {mode!r}")
        if (mode == "final") != (specs is not None):
            raise ValueError("a final aggregate takes its partial's specs "
                             "(final_from_partial), and only it does")
        super().__init__(child)
        self.mode = mode
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        in_schema = child.output_schema
        self._group_bound = [E.resolve(e, in_schema) for e in group_exprs]
        self._n_keys = len(self._group_bound)
        pre: List[E.Expression] = list(self._group_bound)
        self._specs: List[_AggSpec] = list(specs or [])
        for e in (self.agg_exprs if specs is None else ()):
            func, name = _strip_alias(e)
            if not isinstance(func, E.AggregateExpression):
                raise NotImplementedError(f"not an aggregate: {e!r}")
            func = E.resolve(func, in_schema)
            idx = []
            for x in agg_inputs(func):
                idx.append(len(pre))
                pre.append(x)
            self._specs.append(_lower_agg(func, name, idx))
        self._pre_bound = tuple(pre)
        for f in self.output_schema:
            T.check_device_type(f.dtype)
        cf = C.get_active()
        self._repart = (C.AGG_REPARTITION_ENABLED.get(cf) and self._n_keys > 0,
                        C.AGG_REPARTITION_TARGET_BYTES.get(cf),
                        C.AGG_REPARTITION_NUM_BUCKETS.get(cf),
                        C.AGG_REPARTITION_MAX_DEPTH.get(cf))
        self._register_metric("numAggBatches")
        self._register_metric("numRepartitions")
        self.max_repartition_depth = 0  # deepest level reached, 1-based

    @staticmethod
    def final_from_partial(partial: "HashAggregateExec",
                           child: DeviceExec) -> "HashAggregateExec":
        """The reduce-side aggregate of a partial's buffers (``child``
        yields the partial's buffer schema, e.g. through an exchange)."""
        keys = [E.col(f.name) for f in list(partial.output_schema)
                [: partial._n_keys]]
        return HashAggregateExec(keys, partial.agg_exprs, child,
                                 mode="final", specs=partial._specs)

    def _key_fields(self) -> List[T.Field]:
        fields = []
        for e in self._group_bound:
            inner, name = _strip_alias(e)
            fields.append(T.Field(name, inner.dtype, inner.nullable))
        return fields

    def buffer_schema(self) -> T.Schema:
        """Keys, then each aggregate's buffers (what a partial yields)."""
        return T.Schema(self._key_fields() + [
            T.Field(f"{s.name}#b{i}", bt, True) for s in self._specs
            for i, bt in enumerate(s.buffer_types)])

    @property
    def output_schema(self) -> T.Schema:
        if self.mode == "partial":
            return self.buffer_schema()
        return T.Schema(self._key_fields() + [
            T.Field(s.name, s.func.dtype, s.func.nullable)
            for s in self._specs])

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
        return self._aggregate_grouped(pre, self._grouping(pre))

    def _merge_pass(self, buffers: ColumnarBatch) -> ColumnarBatch:
        return self._aggregate_grouped(buffers, self._grouping(buffers),
                                       buffers_input=True)

    def _aggregate_grouped(self, pre: ColumnarBatch, gi: K.GroupInfo,
                           buffers_input: bool = False) -> ColumnarBatch:
        out_cols: List[DeviceColumn] = []
        if self._n_keys:
            out_cols = K.gather_columns(pre.columns[: self._n_keys],
                                        gi.perm[gi.group_starts])
        buf_idx = self._n_keys
        for s in self._specs:
            if buffers_input:
                cols = pre.columns[buf_idx: buf_idx + len(s.ops)]
                buf_idx += len(s.ops)
            else:
                cols = [pre.columns[i] for i in s.inputs]
            if s.kind == "simple":
                out_cols.extend(self._simple(s, cols, gi, buffers_input))
            else:
                out_cols.extend(_REDUCERS[s.kind](s, cols, gi,
                                                  buffers_input))
        return ColumnarBatch(out_cols, gi.num_groups)

    @staticmethod
    def _simple(s: _AggSpec, cols: List[DeviceColumn], gi: K.GroupInfo,
                buffers_input: bool) -> List[DeviceColumn]:
        """Each buffer reduced alone: in the first pass by its op over the
        spec's one input (none for count(*)), in a merge by its merge op
        over its own buffer column."""
        perm = gi.perm
        out = []
        for i, (first_op, bt) in enumerate(zip(s.ops, s.buffer_types)):
            op = _MERGE_OP[first_op] if buffers_input else first_op
            src = cols[i] if buffers_input else (cols[0] if cols else None)
            if src is None:  # count(*)
                vals = None
                valid = torch.ones(perm.numel(), dtype=torch.bool,
                                   device=perm.device)
            elif op in ("count", "count_all"):
                vals, valid = None, src.validity[perm.long()]
            else:
                vals, valid = K.gather_lanes([src.data, src.validity], perm)
                if op == "count_true":
                    valid = valid & vals
                    op = "count"
                if T.is_wide_decimal(bt) and vals.dim() == 1:
                    # a DECIMAL64 sum into a DECIMAL128 buffer
                    vals = I128.pack(*I128.from_i64(vals))
            data, avalid = K.segment_agg(vals, valid, gi.segment_ids,
                                         gi.group_starts, op)
            if buffers_input and first_op in _COUNT_OPS:
                # a merged count is a count: 0 for a group of no row
                # (the global group of a final aggregate over nothing)
                avalid = torch.ones_like(avalid)
            out.append(DeviceColumn(
                bt, K.where_valid(avalid, data.to(bt.torch_dtype)), avalid))
        return out

    def _final_project(self, buffers: ColumnarBatch) -> ColumnarBatch:
        out_cols: List[DeviceColumn] = list(buffers.columns[: self._n_keys])
        bi = self._n_keys
        for s in self._specs:
            bufs = buffers.columns[bi: bi + len(s.ops)]
            bi += len(s.ops)
            out_cols.append(_finish(s, bufs))
        return ColumnarBatch(out_cols, buffers.num_rows)

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        fw = spill.get_framework()
        handles: List[spill.SpillableBatch] = []
        try:
            if self.mode == "final":
                handles.extend(spill.spillable(
                    self.child.execute(partition), fw))
                if not handles and self._n_keys:
                    return
                if not handles:
                    # a global aggregate over no input is one row: counts
                    # 0, every other function null
                    handles.extend(spill.spillable([empty_batch(
                        self.child.output_schema.types(),
                        self.plan_device())], fw))
            else:
                handles.extend(spill.spillable(
                    self._first_passes(partition), fw))
                if not handles:
                    if self._n_keys == 0 and self.mode == "complete":
                        # a global aggregate over no input is one row, as
                        # over an empty batch: counts 0, every other
                        # function null
                        empty = empty_batch(self.child.output_schema.types(),
                                            self.plan_device())
                        yield self._final_project(self._first_pass(empty))
                    return
            for merged in self._merge_all(handles):
                yield merged if self.mode == "partial" else \
                    self._final_project(merged)
        finally:
            for h in handles:
                h.close()

    def _first_passes(self, partition: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute(partition):
            self.metrics["numAggBatches"].add(1)
            yield self._first_pass(batch)

    def _merge_to_one(self, partials: List[ColumnarBatch]) -> ColumnarBatch:
        """The partials merged into one batch of buffers: one concat and
        one merge pass (a lone first-pass output is grouped already; a
        final aggregate's input may hold a key from several map tasks)."""
        if len(partials) == 1 and self.mode != "final":
            return partials[0]
        return self._merge_pass(K.concat_device(partials))

    # -- the oversized-state fallback -----------------------------------------
    # The reference's GpuAggregateExec repartition: when the merge state is
    # above the target, hash-repartition the partials into buckets (the hash
    # re-seeded per level, to a bounded depth) and merge each bucket alone.
    # Buckets hold disjoint keys, so one merged batch per bucket is a
    # correct result, and the operator may emit several batches.

    def _repart_conf(self) -> Tuple[bool, int, int, int]:
        """(enabled, target bytes, buckets per level, deepest level): the
        conf read at planning; a target of 0 is a quarter of the pool's
        limit (the merge's working set is its input and its output)."""
        enabled, target, nbuckets, max_depth = self._repart
        if target <= 0:
            target = max(get_pool().limit // 4, 1)
        return enabled, target, nbuckets, max_depth

    def _merge_all(self, handles: List[spill.SpillableBatch]
                   ) -> Iterator[ColumnarBatch]:
        """The partials (spillable handles) merged into one batch, or,
        when their bytes are above the target or the pool cannot hold them
        all at once, into one batch per hash bucket by recursive
        repartitioning. A direct merge keeps every partial pinned, and so
        accounted, until the merged batch is made (the merge's own working
        set is not accounted, as the reference's is not)."""
        enabled, target, nbuckets, max_depth = self._repart_conf()
        state = sum(h.nbytes for h in handles)
        if not enabled or len(handles) == 1 or state <= target:
            pinned: List[spill.SpillableBatch] = []
            try:
                partials = []
                for h in handles:
                    partials.append(retry.get_with_retry(h))
                    pinned.append(h)
                merged = self._merge_to_one(partials)
            except (RetryOOM, SplitAndRetryOOM):
                if not enabled or len(handles) == 1:
                    raise
                # the pool refused the whole state: repartition from the
                # handles, as the reference does
                merged = None
            finally:
                for h in pinned:
                    h.unpin()
                partials = None
            if merged is not None:
                for h in handles:
                    h.close()
                yield merged
                return
        yield from self._repartition_merge(list(handles), 0, target,
                                           nbuckets, max_depth)

    def _bucket_ids(self, batch: ColumnarBatch, level: int,
                    nbuckets: int) -> torch.Tensor:
        """Each row's bucket at ``level``: the key hash re-seeded through
        splitmix64 with a per-level salt, so every level cuts the key
        space on an independent boundary; the unsigned remainder."""
        salt = K._s64(((level + 1) * 0x9E3779B97F4A7C15)
                      & 0xFFFFFFFFFFFFFFFF)
        h = K._splitmix64(K.hash_keys(batch, list(range(self._n_keys)))
                          ^ salt)
        return ((K._lsr(h, 1) % nbuckets) * 2 + (h & 1)) % nbuckets

    def _scatter_one(self, batch: ColumnarBatch, level: int, nbuckets: int,
                     buckets: List[List], fw) -> None:
        """Split one batch across the buckets' lists of spillable
        handles: one stable sort by bucket and one host read of the
        counts, then a gather per non-empty bucket."""
        ids = self._bucket_ids(batch, level, nbuckets)
        perm = torch.sort(ids, stable=True).indices
        counts = torch.bincount(ids, minlength=nbuckets).tolist()
        start = 0
        for b, n in enumerate(counts):
            if n:
                sub = K.gather_batch(batch, perm[start:start + n])
                buckets[b].extend(spill.spillable([sub], fw))
            start += n

    def _repartition_merge(self, inputs: List, level: int, target: int,
                           nbuckets: int, max_depth: int
                           ) -> Iterator[ColumnarBatch]:
        """Hash-repartition ``inputs`` (spillable handles, each closed once
        it is read) into spillable buckets and merge each bucket: a bucket
        above the target with more than one piece repartitions again,
        while levels remain; one the pool cannot hold whole merges piece
        by piece (``_merge_last_resort``)."""
        _note_repartition(level)
        self.metrics["numRepartitions"].add(1)
        self.max_repartition_depth = max(self.max_repartition_depth,
                                         level + 1)
        fw = spill.get_framework()
        buckets: List[List[spill.SpillableBatch]] = [
            [] for _ in range(nbuckets)]
        try:
            for item in inputs:
                batch = retry.get_with_retry(item)
                # read: the source's handle goes before its buckets come
                item.unpin()
                item.close()
                self._scatter_one(batch, level, nbuckets, buckets, fw)
                del batch
            del inputs
            for hs in buckets:
                if not hs:
                    continue
                bucket_bytes = sum(h.nbytes for h in hs)
                if (bucket_bytes > target and len(hs) > 1
                        and level + 1 < max_depth):
                    yield from self._repartition_merge(
                        hs, level + 1, target, nbuckets, max_depth)
                    continue
                pinned: List[spill.SpillableBatch] = []
                try:
                    batches = []
                    for h in hs:
                        batches.append(h.get())
                        pinned.append(h)
                    merged = self._merge_to_one(batches)
                except (RetryOOM, SplitAndRetryOOM):
                    batches = None
                    for h in pinned:
                        h.unpin()
                    if level + 1 < max_depth and len(hs) > 1:
                        yield from self._repartition_merge(
                            hs, level + 1, target, nbuckets, max_depth)
                    else:
                        yield self._merge_last_resort(hs, fw)
                    continue
                for h in hs:
                    h.unpin()
                    h.close()
                yield merged
        finally:
            for hs in buckets:
                for h in hs:
                    h.close()  # idempotent: frees survivors of an error

    def _merge_last_resort(self, handles: List,
                           fw) -> ColumnarBatch:
        """The deepest level and still too big: merge each piece under
        split-retry, then the merged pieces."""
        merged = list(retry.with_retry(handles, self._merge_pass,
                                       framework=fw))
        return self._merge_to_one(merged)


# ---------------------------------------------------------------------------
# the reducers of the kinds that reduce their buffers together, and the
# final projection of a spec's buffers
# ---------------------------------------------------------------------------


def _gather_picked(col: DeviceColumn, perm: torch.Tensor, at: torch.Tensor,
                   found: torch.Tensor) -> DeviceColumn:
    """The rows ``perm[at]`` of ``col`` (``at`` in group order), null where
    not ``found``; all null when ``col`` has no row (a global group over
    nothing)."""
    if col.num_rows == 0:
        return K.null_column(col.dtype, found.numel(), found.device,
                             col.dictionary)
    rows = perm.long()[at.clamp(0, perm.numel() - 1)]
    if col.offsets is not None:
        return K.gather_string(col, rows, found)
    got = K.gather_column(col, rows)
    valid = got.validity & found
    return DeviceColumn(col.dtype, K.where_valid(valid, got.data), valid,
                        None, got.dictionary)


def _pick(s: _AggSpec, cols, gi: K.GroupInfo, buffers_input: bool):
    """First/Last/AnyValue: the group's first (last) non-null row in
    input order (a merge's partials arrive in input order)."""
    col = cols[0]
    at, found = K.segment_pick(col.validity[gi.perm.long()], gi.segment_ids,
                               gi.group_starts, last=s.ops[0] == "last")
    return [_gather_picked(col, gi.perm, at, found)]


def _string_extreme(s: _AggSpec, cols, gi: K.GroupInfo,
                    buffers_input: bool):
    """String Min/Max, exact in byte order: a dictionary column's codes
    (its dictionary is sorted), else each row's rank in a full sort of the
    column's bytes."""
    col, op = cols[0], s.ops[0]
    perm = gi.perm.long()
    valid = col.validity[perm]
    if col.is_dict:
        data, avalid = K.segment_agg(col.data[perm], valid, gi.segment_ids,
                                     gi.group_starts, op)
        return [DeviceColumn(col.dtype, K.where_valid(
            avalid, data.to(torch.int32)), avalid, None, col.dictionary)]
    rank = K.string_order_ranks(col)[perm]
    at, found = K.segment_arg_extreme(rank, valid, gi.segment_ids,
                                      gi.group_starts, op)
    return [_gather_picked(col, gi.perm, at, found)]


def _minby(s: _AggSpec, cols, gi: K.GroupInfo, buffers_input: bool):
    """MinBy/MaxBy: the first row at the least (greatest) non-null
    ordering; its value (null or not) and its ordering, so a merge picks
    again among the partials."""
    vcol, ocol = cols
    perm = gi.perm.long()
    at, found = K.segment_arg_extreme(
        ocol.data[perm].long(), ocol.validity[perm], gi.segment_ids,
        gi.group_starts, "max" if s.ops[0] == "maxby_value" else "min")
    return [_gather_picked(vcol, gi.perm, at, found),
            _gather_picked(ocol, gi.perm, at, found)]


def _shifted_mean(n: torch.Tensor, mean: torch.Tensor, gi: K.GroupInfo):
    """(count, mean and live flag per group; each part's distance from its
    group's mean) of parts of ``n`` rows and mean ``mean`` each (in group
    order). The group's mean is taken about its first live part's mean, so
    parts of one value give exactly that value."""
    seg_sum = K._sorted_segment_reducers(gi.segment_ids, gi.group_starts)[0]
    live = n > 0
    total = seg_sum(n)
    sl = gi.segment_ids.long()
    if mean.numel() == 0:
        m0 = torch.zeros(gi.num_groups, dtype=torch.float64,
                         device=mean.device)
    else:
        at, _any = K.segment_pick(live, gi.segment_ids, gi.group_starts)
        m0 = mean[at.clamp(0, mean.numel() - 1)]
    zero = torch.zeros((), dtype=torch.float64, device=mean.device)
    nf = n.double()
    d0 = torch.where(live, mean - m0[sl], zero)
    m = m0 + seg_sum(nf * d0) / total.clamp(min=1).double()
    m = torch.where(total > 0, m, zero)
    return total, m, torch.where(live, mean - m[sl], zero), live


def _moment_parts(cols, gi: K.GroupInfo, buffers_input: bool, k: int):
    """(n, means, higher moments) of each part, in group order: a merge's
    buffers, or the first pass's rows (n 1 where the row's inputs are all
    non-null, its values as means, no spread). ``k`` means; the rest are
    the moments."""
    perm = gi.perm.long()
    if buffers_input:
        n = cols[0].data[perm].long()
        means = [c.data[perm].double() for c in cols[1: 1 + k]]
        rest = [c.data[perm].double() for c in cols[1 + k:]]
        return n, means, rest
    valid = cols[0].validity[perm]
    for c in cols[1:k]:
        valid = valid & c.validity[perm]
    means = [c.data[perm].double() for c in cols[:k]]
    return valid.long(), means, None


def _moments_out(total: torch.Tensor, moments) -> List[DeviceColumn]:
    ok = total > 0
    return [DeviceColumn(T.LONG, total, torch.ones_like(ok))] + [
        DeviceColumn(T.DOUBLE, K.where_valid(ok, m), ok) for m in moments]


def _moments(s: _AggSpec, cols, gi: K.GroupInfo, buffers_input: bool):
    """(n, mean, M2[, M3, M4]) per group: the parts' central moments
    shifted to the group's mean and summed (Pebay's combination)."""
    order = len(s.ops) - 1
    n, (mean,), rest = _moment_parts(cols, gi, buffers_input, 1)
    total, m, d, live = _shifted_mean(n, mean, gi)
    zero = torch.zeros((), dtype=torch.float64, device=d.device)
    if rest is None:
        rest = [torch.zeros_like(d)] * (order - 1)
    rest = [torch.where(live, r, zero) for r in rest]
    seg_sum = K._sorted_segment_reducers(gi.segment_ids, gi.group_starts)[0]
    nf = n.double()
    m2 = rest[0] + nf * d * d
    out = [m, seg_sum(m2)]
    if order == 4:
        p2, p3, p4 = rest
        out.append(seg_sum(p3 + 3 * d * p2 + nf * d ** 3))
        out.append(seg_sum(p4 + 4 * d * p3 + 6 * d * d * p2 + nf * d ** 4))
    return _moments_out(total, out)


def _comoments(s: _AggSpec, cols, gi: K.GroupInfo, buffers_input: bool):
    """(n, mean x, mean y, Cxy[, M2x, M2y]) per group over the pairs whose
    sides are both non-null."""
    n, (mx, my), rest = _moment_parts(cols, gi, buffers_input, 2)
    total, ax, dx, live = _shifted_mean(n, mx, gi)
    _t, ay, dy, _l = _shifted_mean(n, my, gi)
    zero = torch.zeros((), dtype=torch.float64, device=dx.device)
    k = len(s.ops) - 3
    if rest is None:
        rest = [torch.zeros_like(dx)] * k
    rest = [torch.where(live, r, zero) for r in rest]
    seg_sum = K._sorted_segment_reducers(gi.segment_ids, gi.group_starts)[0]
    nf = n.double()
    out = [ax, ay, seg_sum(rest[0] + nf * dx * dy)]
    if k == 3:
        out.append(seg_sum(rest[1] + nf * dx * dx))
        out.append(seg_sum(rest[2] + nf * dy * dy))
    return _moments_out(total, out)


_REDUCERS = {"pick": _pick, "string": _string_extreme, "minby": _minby,
             "moments": _moments, "comoments": _comoments}


def _finish_moments(f, bufs) -> DeviceColumn:
    n = bufs[0].data
    nf = n.double()
    m2 = bufs[2].data.clamp(min=0.0)  # NaN stays NaN
    nan = torch.full_like(m2, float("nan"))
    if isinstance(f, (E.Skewness, E.Kurtosis)):
        if isinstance(f, E.Skewness):
            data = nf.sqrt() * bufs[3].data / m2 ** 1.5
        else:
            data = nf * bufs[4].data / (m2 * m2) - 3.0
        data = torch.where(m2 == 0, nan, data)
        valid = n > 0
    else:
        samp = isinstance(f, (E.VarianceSamp, E.StddevSamp))
        data = m2 / ((nf - 1) if samp else nf).clamp(min=1.0)
        if isinstance(f, (E.StddevSamp, E.StddevPop)):
            data = data.sqrt()
        # modern Spark: the sample variance of one row is null
        valid = n > 1 if samp else n > 0
    return DeviceColumn(T.DOUBLE, K.where_valid(valid, data), valid)


def _finish_comoments(f, bufs) -> DeviceColumn:
    n = bufs[0].data
    nf = n.double()
    c = bufs[3].data
    if isinstance(f, E.CovarPop):
        data, valid = c / nf.clamp(min=1.0), n > 0
    elif isinstance(f, E.CovarSamp):
        data, valid = c / (nf - 1).clamp(min=1.0), n > 1
    else:
        den = (bufs[4].data.clamp(min=0.0) * bufs[5].data.clamp(min=0.0)
               ).sqrt()
        # null where either variance is 0 (or NaN), as the reference's
        data, valid = c / den, (n > 0) & (den > 0)
    return DeviceColumn(T.DOUBLE, K.where_valid(valid, data), valid)


def _finish(s: _AggSpec, bufs: Sequence[DeviceColumn]) -> DeviceColumn:
    """One spec's result column from its buffers."""
    f, rt = s.func, s.func.dtype
    if s.kind == "moments":
        return _finish_moments(f, bufs)
    if s.kind == "comoments":
        return _finish_comoments(f, bufs)
    if isinstance(f, E.Average):
        ssum, cnt = bufs
        valid = ssum.validity & (cnt.data > 0)
        if ssum.data.dim() == 2:
            return _wide_average(ssum, cnt, valid, s.buffer_types[0], rt,
                                 rt.scale - f.child.dtype.scale)
        if isinstance(rt, T.DecimalType):
            data = decimal_avg_half_up(ssum.data, cnt.data,
                                       rt.scale - f.child.dtype.scale)
        else:
            data = ssum.data.double() / torch.clamp(cnt.data, min=1).double()
        return DeviceColumn(rt, torch.where(valid, data,
                                            torch.zeros_like(data)), valid)
    if isinstance(f, E.Sum) and isinstance(rt, T.DecimalType):
        b = bufs[0]
        if b.data.dim() == 2:
            ovf = I128.overflow_mask(*I128.split(b.data), rt.precision)
        else:
            ovf = b.data.abs() >= 10 ** rt.precision
        valid = b.validity & ~ovf
        return DeviceColumn(rt, K.where_valid(valid, b.data), valid)
    return bufs[0]  # the value buffer (MinBy/MaxBy's first)


_repart_lock = threading.Lock()
_repart_stats = {"total": 0, "max_depth": 0}


def _note_repartition(level: int) -> None:
    with _repart_lock:
        _repart_stats["total"] += 1
        _repart_stats["max_depth"] = max(_repart_stats["max_depth"],
                                         level + 1)


def repartition_snapshot() -> Dict[str, int]:
    """The process's repartition counters, monotonic: repartition passes
    (``total``) and the deepest level reached (``max_depth``, 1-based)."""
    with _repart_lock:
        return dict(_repart_stats)


def _wide_average(ssum: DeviceColumn, cnt: DeviceColumn, valid, sum_t,
                  rt: T.DecimalType, shift_digits: int) -> DeviceColumn:
    """A decimal average from a DECIMAL128 sum (``decimal_avg_128``): null
    where the sum overflowed its own type or the result its precision; a
    DECIMAL64 result keeps the low limb where it fits."""
    h, l = I128.split(ssum.data)
    qh, ql, ovf = I128.decimal_avg_128(h, l, cnt.data, shift_digits,
                                       rt.precision)
    valid = valid & ~ovf & ~I128.overflow_mask(h, l, sum_t.precision)
    if rt.is_wide:
        return DeviceColumn(rt, K.where_valid(valid, I128.pack(qh, ql)),
                            valid)
    valid = valid & (qh == torch.where(ql < 0, -1, 0))
    return DeviceColumn(rt, K.where_valid(valid, ql), valid)


def decimal_avg_half_up(total: torch.Tensor, count: torch.Tensor,
                        shift_digits: int) -> torch.Tensor:
    """round_half_up(total * 10**shift_digits / count) over int64 (count
    of 0 is read as 1): divide first, then scale only the remainder."""
    k = 10 ** shift_digits
    den = torch.clamp(count.long(), min=1)
    mag = total.long().abs()
    q1 = torch.div(mag, den, rounding_mode="floor")
    frac = (mag - q1 * den) * k
    fq = torch.div(frac, den, rounding_mode="floor")
    fr = frac - fq * den
    q = q1 * k + fq + (2 * fr >= den).long()
    return torch.where(total < 0, -q, q)
