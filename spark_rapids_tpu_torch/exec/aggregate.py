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
  Min -> [min]    Max -> [max]

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
    input_index: Optional[int]  # into the pre-projection; None = count(*)
    ops: List[str]
    buffer_types: List[T.DataType]


_MERGE_OP = {"sum": "sum", "count": "sum", "count_all": "sum", "min": "min",
             "max": "max"}


def _lower_agg(func: E.AggregateExpression, name: str,
               input_index: Optional[int]) -> _AggSpec:
    if isinstance(func, E.Count):
        op = "count" if func.children else "count_all"
        return _AggSpec(func, name, input_index, [op], [T.LONG])
    if isinstance(func, E.Sum):
        return _AggSpec(func, name, input_index, ["sum"], [func.dtype])
    if isinstance(func, (E.Min, E.Max)):
        if func.child.dtype == T.STRING:
            raise NotImplementedError("string min/max is not in the port yet")
        op = "min" if isinstance(func, E.Min) else "max"
        return _AggSpec(func, name, input_index, [op], [func.dtype])
    if isinstance(func, E.Average):
        c = func.child.dtype
        if isinstance(c, T.DecimalType):
            sum_t = E.Sum(func.child).dtype
        else:
            sum_t = T.DOUBLE if c in T.FRACTIONAL_TYPES else T.LONG
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
            idx = None
            if func.children:
                idx = len(pre)
                pre.append(func.children[0])
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
            for op, first_op, bt in zip(ops, s.ops, s.buffer_types):
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
                    if T.is_wide_decimal(bt) and vals.dim() == 1:
                        # a DECIMAL64 sum into a DECIMAL128 buffer
                        vals = I128.pack(*I128.from_i64(vals))
                data, avalid = K.segment_agg(vals, valid, gi.segment_ids,
                                             gi.group_starts, op)
                if buffers_input and first_op in ("count", "count_all"):
                    # a merged count is a count: 0 for a group of no row
                    # (the global group of a final aggregate over nothing)
                    avalid = torch.ones_like(avalid)
                out_cols.append(DeviceColumn(
                    bt, K.where_valid(avalid, data.to(bt.torch_dtype)),
                    avalid))
        return ColumnarBatch(out_cols, gi.num_groups)

    def _final_project(self, buffers: ColumnarBatch) -> ColumnarBatch:
        out_cols: List[DeviceColumn] = list(buffers.columns[: self._n_keys])
        bi = self._n_keys
        for s in self._specs:
            bufs = buffers.columns[bi: bi + len(s.ops)]
            bi += len(s.ops)
            rt = s.func.dtype
            if isinstance(s.func, E.Average):
                ssum, cnt = bufs
                valid = ssum.validity & (cnt.data > 0)
                if ssum.data.dim() == 2:
                    out_cols.append(_wide_average(
                        ssum, cnt, valid, s.buffer_types[0], rt,
                        rt.scale - s.func.child.dtype.scale))
                    continue
                if isinstance(rt, T.DecimalType):
                    in_t = s.func.child.dtype
                    data = decimal_avg_half_up(ssum.data, cnt.data,
                                               rt.scale - in_t.scale)
                else:
                    data = ssum.data.double() / torch.clamp(
                        cnt.data, min=1).double()
                out_cols.append(DeviceColumn(
                    rt, torch.where(valid, data, torch.zeros_like(data)),
                    valid))
            elif isinstance(s.func, E.Sum) and isinstance(rt, T.DecimalType):
                b = bufs[0]
                if b.data.dim() == 2:
                    ovf = I128.overflow_mask(*I128.split(b.data),
                                             rt.precision)
                else:
                    ovf = b.data.abs() >= 10 ** rt.precision
                valid = b.validity & ~ovf
                out_cols.append(DeviceColumn(
                    rt, K.where_valid(valid, b.data), valid))
            else:
                out_cols.append(bufs[0])
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
