"""Window operator (counterpart of spark_rapids_tpu/exec/window.py).

The partition's batches are concatenated on the device (as ``SortExec``
does) and the window columns are computed over that one batch: one sort by
the (partition, order) keys (a plain-string key sorts on its byte words
and its length, as ORDER BY does), ``keys_equal`` flags for the segment
and peer boundaries, and four segmented ``max`` scans through the
segmented-scan kernel's wrapper that carry each row's segment start and
end and peer-run start and end. Every window column is a function of that
shared geometry (rows come out partition-sorted, as Spark's WindowExec
emits them):

- RowNumber, Rank, DenseRank, NTile, PercentRank and CumeDist from the
  segment and peer-run bounds;
- Lead and Lag: a gather at the row ``offset`` rows away, the default
  (cast to the input's type) where that row lies outside the partition;
  any column kind (numbers, DECIMAL64, DECIMAL128 rows, dictionary and
  plain strings);
- Sum, Count, Average, Min, Max, First and Last over a frame: each row's
  frame is a row range [lo, hi] inside its partition (``_frame_bounds``:
  ROWS offsets, a RANGE frame's peers, or a bounded RANGE frame's rows
  found by a bisection of the sorted integral/date order key with a fixed
  step count, so no host read). Sums and counts are differences of
  segmented add-scans (a frame that starts at the partition's first row
  reads the running sum at its last row, with no subtraction); a
  DECIMAL128 sum add-scans lo's two 32-bit halves and hi apart and joins
  them with carries (exact mod 2^128; null past the result's precision).
  Min and Max: a segment reduction (UNBOUNDED frames), a running min/max
  scan read at the frame's last row (frames from UNBOUNDED PRECEDING) or
  over the reversed rows read at its first row (frames to UNBOUNDED
  FOLLOWING), the prefix/suffix block scans of the reference's
  ``_bounded_minmax`` (bounded ROWS frames) or a sparse table (bounded
  RANGE frames); Spark's order for floats (NaN above
  every value, -0.0 equal to 0.0) comes from scanning canonical, NaN-free
  values beside a NaN count. First and Last (the first or last non-null
  value, as the reference's) read a min (max) scan of the non-null rows'
  positions, so they need no sparse table.

Every add, min and max scan goes through ``kernels.segmented_scan_kernel``.
Raising NotImplementedError, as in the reference: window Min/Max over
DECIMAL128 and Skewness/Kurtosis windows (on the device only: the CPU
engine runs them), window aggregates over strings but Count, and a
bounded RANGE frame over anything but one ascending integral, DATE or
TIMESTAMP order key.

VarianceSamp/Pop and StddevSamp/Pop run over every frame
(``_variance_window``): add-scans of the values (cast to DOUBLE) shifted
by their partition's first finite value, and of their squares, each
differenced over the frame. Bounded ROWS frames stream with their
context as the Sum does; a running variance reads its whole partition.

Streaming (``streaming=True``, the reference's GpuRunningWindowExec and
GpuBatchedBoundedWindowExec): the planner gives a group that
``plan_stream_mode`` classifies an out-of-core sort as its child, so the
batches arrive sorted by (partition, order) across batches, and the
operator computes them one at a time instead of reading its whole
partition. ``running`` (row_number, rank, dense_rank and ROWS UNBOUNDED
PRECEDING..CURRENT ROW Sum, Count, Min and Max, over fixed-width,
non-float, non-DECIMAL128 keys): each batch is computed alone and the rows
that continue the previous batch's last partition are fixed up from a
carry of that batch's last row (its keys, each function's value, its row
number, rank and dense rank), all on the device. ``bounded`` (lead/lag
and bounded ROWS frames reaching at most
``spark.rapids.gpu.sql.window.streaming.maxContextRows`` rows): each
batch is computed with the previous batch's last K rows before it and the
next batch's first K rows after it, and only its own rows are kept; the
stream is first re-cut so that every batch but the last holds K rows at
least. Any other group reads its whole partition as one batch. Behind the
planner's out-of-core sort, whose batch boundaries fall only where the
first sort key changes, a partitioned window gets each partition whole
in one batch, so the carry and the context continue across a batch edge
when the window has no PARTITION BY (one partition over every batch), or
when a caller feeds batches cut elsewhere.
"""

from __future__ import annotations

import math
from typing import (Iterator, List, NamedTuple, Optional, Sequence, Tuple)

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_column
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import int128 as I128
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.aggregate import (
    _strip_alias, decimal_avg_half_up)
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import window as W

_AGGS = (E.Sum, E.Count, E.Average, E.Min, E.Max, E.First,
         E.Last) + E.VARIANCE_FAMILY
_RANKING = (W.RowNumber, W.Rank, W.DenseRank, W.NTile, W.PercentRank,
            W.CumeDist)
# order key types a bounded RANGE frame bisects (the reference's gate); a
# TIMESTAMP key's offsets are microseconds
RANGE_KEY_TYPES = (T.BYTE, T.SHORT, T.INT, T.LONG, T.DATE, T.TIMESTAMP)


def bind_function(f: E.Expression, schema: T.Schema) -> E.Expression:
    """A window function with its inputs resolved against ``schema``: an
    aggregate's input, and Lead/Lag's input and default, the default
    brought to the input's type (a literal re-typed, else a Cast)."""
    if isinstance(f, W.Lead):
        child = E.resolve(f.child, schema)
        d = f.default
        if isinstance(d, E.Literal) and d.value is None:
            d = E.Literal(None, child.dtype)
        elif d is not None:
            d = E.value_as(E.resolve(d, schema), child.dtype)
        return type(f)(child, f.offset, d)
    if isinstance(f, E.AggregateExpression) and f.children:
        return type(f)(E.resolve(f.children[0], schema))
    return f


def check_window(f: E.Expression, frame: W.WindowFrame,
                 order_keys: Sequence[Tuple[E.Expression, bool]] = ()
                 ) -> None:
    """Raise NotImplementedError for a bound window function or frame
    outside the port (both engines share this surface). ``order_keys``:
    the spec's bound (order expression, ascending) pairs."""
    if not isinstance(f, _RANKING + (W.Lead,) + _AGGS):
        raise NotImplementedError(f"window function {type(f).__name__} is "
                                  f"not in the port yet")
    if isinstance(f, _AGGS) and f.children:
        in_t = f.children[0].dtype
        if in_t in (T.STRING, T.BINARY) and not isinstance(f, E.Count):
            raise NotImplementedError(
                f"window {type(f).__name__} over a string column is not in "
                f"the port (nor in the reference's window)")
    if isinstance(f, _AGGS) and frame.is_bounded_range:
        ok = (len(order_keys) == 1 and order_keys[0][1]
              and order_keys[0][0].dtype in RANGE_KEY_TYPES)
        if not ok:
            raise NotImplementedError(
                "bounded RANGE frame needs one ascending integral/date "
                "order key")


def plan_stream_mode(window_exprs, child_schema
                     ) -> Optional[Tuple[str, int]]:
    """How a window group streams across batches: ("running", 0) when
    every function is a carried running computation (row_number, rank,
    dense_rank; ROWS UNBOUNDED PRECEDING..CURRENT ROW Sum, Count, Min or
    Max) over fixed-width, non-float, non-DECIMAL128 partition and order
    keys (the carry compares them by value), with no float Min/Max and no
    DECIMAL128 input or result; ("bounded", K) when every function needs
    at most K neighbour rows (lead/lag, bounded ROWS frames) and K is
    within ``spark.rapids.gpu.sql.window.streaming.maxContextRows``;
    else None (one batch per partition). The reference's
    ``WindowExec.plan_stream_mode``."""
    spec = None
    run_ok, bnd_ok, k = True, True, 0
    for e in window_exprs:
        func = e.child if isinstance(e, E.Alias) else e
        if not isinstance(func, W.WindowExpression):
            return None
        spec = spec or func.spec
        f = func.function
        frame = func.spec.resolved_frame()
        if isinstance(f, (W.RowNumber, W.Rank, W.DenseRank)):
            bnd_ok = False
        elif isinstance(f, W.Lead):  # Lag is a Lead
            run_ok = False
            k = max(k, abs(f.offset))
        elif (isinstance(f, (E.Sum, E.Count, E.Min, E.Max))
              and frame.kind == "rows" and frame.is_running):
            bnd_ok = False
        elif (isinstance(f, E.AggregateExpression) and frame.is_bounded_rows):
            run_ok = False
            k = max(k, abs(frame.start), abs(frame.end))
        else:
            return None
    if spec is None:
        return None
    if run_ok:
        for p in list(spec.partition_by) + [o.child for o in spec.order_by]:
            dt = E.resolve(p, child_schema).dtype
            if (not dt.fixed_width or dt in T.FRACTIONAL_TYPES
                    or T.is_wide_decimal(dt)):
                return None
        for e in window_exprs:
            func = e.child if isinstance(e, E.Alias) else e
            f = func.function
            if isinstance(f, E.AggregateExpression) and f.children:
                ff = E.resolve(f, child_schema)
                fdt = ff.children[0].dtype
                if isinstance(f, (E.Min, E.Max)) and \
                        fdt in T.FRACTIONAL_TYPES:
                    return None
                if T.is_wide_decimal(ff.dtype) or T.is_wide_decimal(fdt):
                    return None
        return ("running", 0)
    from spark_rapids_tpu_torch.config import conf as C

    if bnd_ok and k <= C.WINDOW_MAX_BOUNDED_CONTEXT.get(C.get_active()):
        return ("bounded", max(k, 1))
    return None


class _Geometry(NamedTuple):
    """Per sorted row (int64): its position, its partition's first and
    last rows and its peer run's first and last rows."""
    idx: torch.Tensor
    seg_start: torch.Tensor
    seg_end: torch.Tensor
    run_start: torch.Tensor
    run_end: torch.Tensor

    @property
    def seg_flag(self) -> torch.Tensor:
        return self.idx == self.seg_start


class WindowExec(UnaryExec):
    """Appends window columns to the child's output; all expressions share
    one (partition, order) spec."""

    def __init__(self, window_exprs: Sequence[E.Expression],
                 child: DeviceExec, streaming: bool = False):
        super().__init__(child)
        self.window_exprs = list(window_exprs)
        # a planner contract: the child's batches are sorted by
        # (partition, order) across batches (an out-of-core sort)
        self.streaming = streaming
        self._prepare()
        self._mode = (plan_stream_mode(self.window_exprs,
                                       child.output_schema)
                      if streaming else None)
        for name in ("windowTimeNs", "streamedBatches"):
            self._register_metric(name)

    # -- binding -----------------------------------------------------------
    def _prepare(self) -> None:
        cs = self.child.output_schema
        wins: List[Tuple[W.WindowExpression, str]] = []
        spec: Optional[W.WindowSpec] = None
        for e in self.window_exprs:
            func, name = _strip_alias(e)
            if not isinstance(func, W.WindowExpression):
                raise ValueError(f"not a window expression: {e!r}")
            if spec is None:
                spec = func.spec
            elif (repr(spec.partition_by) != repr(func.spec.partition_by)
                  or repr(spec.order_by) != repr(func.spec.order_by)):
                raise ValueError("one WindowExec handles one (partition, "
                                 "order) spec")
            wins.append((func, name))
        self._spec = spec or W.WindowSpec()
        self._part_bound = tuple(E.resolve(p, cs)
                                 for p in self._spec.partition_by)
        self._order_bound = tuple((E.resolve(o.child, cs), o.ascending,
                                   o.nulls_first)
                                  for o in self._spec.order_by)
        order_keys = [(o, asc) for o, asc, _nf in self._order_bound]
        bound = []
        for func, name in wins:
            f = bind_function(func.function, cs)
            frame = func.spec.resolved_frame()
            check_window(f, frame, order_keys)
            if isinstance(f, (E.Min, E.Max)) and T.is_wide_decimal(f.dtype):
                # the CPU engine runs it; the reference's device does not
                raise NotImplementedError(
                    "window min/max over DECIMAL128 is not on the device")
            if isinstance(f, (E.Skewness, E.Kurtosis)):
                # the CPU engine runs them; the reference's device does not
                raise NotImplementedError(
                    "skewness/kurtosis window functions are not on the "
                    "device")
            T.check_device_type(f.dtype)
            bound.append((f, frame, name))
        self._bound_wins = bound

    @property
    def output_schema(self) -> T.Schema:
        fields = list(self.child.output_schema)
        for f, _frame, name in self._bound_wins:
            fields.append(T.Field(name, f.dtype, f.nullable))
        return T.Schema(fields)

    def node_description(self) -> str:
        stream = (f" streaming={self._mode[0]}" if self._mode is not None
                  else "")
        return (f"Window [{', '.join(n for _, _, n in self._bound_wins)}] "
                f"{self._spec!r}{stream}")

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        if self._mode is None:
            batches = list(self.child.execute(partition))
            if not batches:
                return
            with self.timer("windowTimeNs"):
                out = self._compute(K.concat_device(batches),
                                    presorted=self.streaming)
            yield out
            return
        stream = (b for b in self.child.execute(partition) if b.num_rows)
        if self._mode[0] == "running":
            yield from self._exec_running(stream)
        else:
            yield from self._exec_bounded(stream, self._mode[1])

    # -- streaming ---------------------------------------------------------
    def _exec_bounded(self, stream, k: int) -> Iterator[ColumnarBatch]:
        """Each batch computed between the previous batch's last ``k``
        rows and the next batch's first ``k``; its own rows kept."""
        def rechunked():
            # a batch of fewer than k rows could leave a frame short of
            # context, so batches are joined until each holds k rows
            pending, rows = [], 0
            for b in stream:
                pending.append(b)
                rows += b.num_rows
                if rows >= k:
                    yield K.concat_device(pending)
                    pending, rows = [], 0
            if pending:
                yield K.concat_device(pending)

        prev_tail = cur = None
        for nxt in rechunked():
            if cur is not None:
                yield self._emit_bounded(
                    prev_tail, cur,
                    K.slice_batch(nxt, 0, min(k, nxt.num_rows)))
                prev_tail = K.slice_batch(cur, max(cur.num_rows - k, 0),
                                          cur.num_rows)
            cur = nxt
        if cur is not None:
            yield self._emit_bounded(prev_tail, cur, None)

    def _emit_bounded(self, prev_tail, cur, next_head) -> ColumnarBatch:
        parts = [p for p in (prev_tail, cur, next_head) if p is not None]
        with self.timer("windowTimeNs"):
            out = self._compute(K.concat_device(parts), presorted=True)
            start = prev_tail.num_rows if prev_tail is not None else 0
            out = K.slice_batch(out, start, start + cur.num_rows)
        self.metrics["streamedBatches"].add(1)
        return out

    def _exec_running(self, stream) -> Iterator[ColumnarBatch]:
        """Each batch computed alone, then the rows continuing the
        previous batch's last partition fixed up from the carry."""
        carry = None
        for b in stream:
            with self.timer("windowTimeNs"):
                if carry is None:
                    carry = self._init_carry(b)
                out, carry = self._streaming_compute(b, carry)
            self.metrics["streamedBatches"].add(1)
            yield out

    def _init_carry(self, batch: ColumnarBatch):
        """A carry that continues nothing (``valid`` false): zero key,
        function, row number and rank slots on the batch's device."""
        dev = batch.columns[0].device

        def slot(dtype):
            return (torch.zeros(1, dtype=dtype, device=dev),
                    torch.zeros(1, dtype=torch.bool, device=dev))

        zero = torch.zeros(1, dtype=torch.int64, device=dev)
        return {"valid": slot(torch.bool)[1],
                "keys": [slot(p.dtype.torch_dtype) for p in self._part_bound],
                "orders": [slot(ob.dtype.torch_dtype)
                           for ob, _a, _nf in self._order_bound],
                "funcs": [slot(f.dtype.torch_dtype)
                          for f, _fr, _n in self._bound_wins],
                "rn": zero, "rank": zero, "dense": zero}

    def _streaming_compute(self, batch: ColumnarBatch, carry):
        """(the batch's windows with the carry applied, the new carry).
        The carry holds the last row's partition and order keys, each
        function's value and validity, and its row number, rank and dense
        rank, as one-element device tensors."""
        out = self._compute(batch, presorted=True)
        n = batch.num_rows
        dev = batch.columns[0].device
        ctx = EV.EvalContext(batch)

        def pairs(exprs):
            got = []
            for e in exprs:
                v = EV.eval_expr(e, ctx)
                got.append((v.data, v.validity))
            return got

        kvals = pairs(self._part_bound)
        ovals = pairs([ob for ob, _a, _nf in self._order_bound])
        idx = torch.arange(n, device=dev)
        prev = torch.cat([idx[:1], idx[:-1]])

        def neq_prev(ps):
            # a null's data is not compared (it may hold anything)
            ne = torch.zeros(n, dtype=torch.bool, device=dev)
            for d, va in ps:
                ne = ne | (va != va[prev]) | (va & (d != d[prev]))
            return ne

        seg_start_flag = (idx == 0) | neq_prev(kvals)
        run_start_flag = seg_start_flag | neq_prev(ovals)
        in_seg0 = torch.cumsum(seg_start_flag.int(), 0) == 1
        in_run0 = torch.cumsum(run_start_flag.int(), 0) == 1
        last = n - 1

        def key_match(ps, slots):
            ok = carry["valid"]
            for (d, va), (cd, cv) in zip(ps, slots):
                ok = ok & ((va[:1] & cv & (d[:1] == cd)) | (~va[:1] & ~cv))
            return ok

        cont_part = key_match(kvals, carry["keys"])
        cont_peer = cont_part & key_match(ovals, carry["orders"])
        cont_rows = in_seg0 & cont_part
        zero = torch.zeros(1, dtype=torch.int64, device=dev)

        def carried(name):
            return torch.where(cont_part, carry[name], zero)

        c_rn, c_rank, c_dense = carried("rn"), carried("rank"), \
            carried("dense")
        base = len(self.child.output_schema)
        cols = list(out.columns)
        funcs = []
        rank_col = dense_col = None
        for j, (f, _frame, _name) in enumerate(self._bound_wins):
            c = cols[base + j]
            d = c.data
            cval, cvalid = carry["funcs"][j]
            cv0 = cvalid & cont_part
            if isinstance(f, W.RowNumber):
                d = d + torch.where(cont_rows, c_rn, 0).to(d.dtype)
                valid = c.validity
            elif isinstance(f, W.Rank):
                d64 = d.long()
                d = torch.where(cont_rows, torch.where(
                    cont_peer & in_run0, c_rank, d64 + c_rn), d64).to(
                        d.dtype)
                valid = c.validity
                rank_col = d
            elif isinstance(f, W.DenseRank):
                adj = torch.where(cont_peer, c_dense - 1, c_dense)
                d = torch.where(cont_rows, d.long() + adj.clamp(min=0),
                                d.long()).to(d.dtype)
                valid = c.validity
                dense_col = d
            elif isinstance(f, E.Count):
                d = d + torch.where(cont_rows & cv0, cval, 0).to(d.dtype)
                valid = c.validity
            else:  # running Sum, Min or Max
                cvs = cval.to(d.dtype)
                both = cont_rows & c.validity & cv0
                only_carry = cont_rows & ~c.validity & cv0
                if isinstance(f, E.Sum):
                    comb = d + cvs
                else:
                    comb = (torch.minimum if isinstance(f, E.Min)
                            else torch.maximum)(d, cvs)
                d = torch.where(both, comb, torch.where(only_carry, cvs, d))
                valid = c.validity | (cont_rows & cv0)
                if isinstance(f, E.Sum) and isinstance(f.dtype,
                                                       T.DecimalType):
                    # Spark's non-ANSI decimal sum overflow: null
                    valid = valid & (d.abs() < 10 ** f.dtype.precision)
                d = K.where_valid(valid, d)
            cols[base + j] = DeviceColumn(c.dtype, d, valid, c.offsets,
                                          c.dictionary)
            funcs.append((d[last:], valid[last:]))
        # the row number of the last row, for the next batch
        seg_start = K.segmented_scan_kernel(
            torch.where(seg_start_flag, idx.int(), -1), seg_start_flag,
            "max")
        rn_last = (last - seg_start[last:].long() + 1
                   + torch.where(in_seg0[last:], c_rn, zero))
        new = {
            "valid": torch.ones(1, dtype=torch.bool, device=dev),
            "keys": [(d[last:], va[last:]) for d, va in kvals],
            "orders": [(d[last:], va[last:]) for d, va in ovals],
            "funcs": funcs,
            "rn": rn_last,
            "rank": (rank_col[last:].long() if rank_col is not None
                     else zero),
            "dense": (dense_col[last:].long() if dense_col is not None
                      else zero),
        }
        return ColumnarBatch(cols, n), new

    # -- computation -------------------------------------------------------
    def _compute(self, batch: ColumnarBatch,
                 presorted: bool = False) -> ColumnarBatch:
        """The window columns of one batch (rows sorted by partition and
        order keys first, unless ``presorted``)."""
        n = batch.num_rows
        dev = batch.columns[0].device
        if n == 0:
            return ColumnarBatch(
                list(batch.columns) + [empty_column(f.dtype, dev)
                                       for f, _fr, _n in self._bound_wins],
                0)
        ctx = EV.EvalContext(batch)
        key_cols: List[DeviceColumn] = []
        specs: List[K.SortSpec] = []
        for p in self._part_bound:
            key_cols.append(EV.val_to_column(EV.eval_expr(p, ctx), p.dtype))
            specs.append(K.SortSpec(len(key_cols) - 1, True, None))
        n_part = len(key_cols)
        for ob, asc, nf in self._order_bound:
            key_cols.append(EV.val_to_column(EV.eval_expr(ob, ctx),
                                             ob.dtype))
            specs.append(K.SortSpec(len(key_cols) - 1, asc, nf))
        if key_cols and presorted:
            sbatch = batch
            skeys = ColumnarBatch(key_cols, n)
        elif key_cols:
            key_batch = ColumnarBatch(key_cols, n)
            order = K.sort_indices(key_batch, specs)
            sbatch = K.gather_batch(batch, order)
            skeys = K.gather_batch(key_batch, order)
        else:
            sbatch = batch
            skeys = ColumnarBatch([], n)

        idx = torch.arange(n, dtype=torch.int32, device=dev)
        prev = torch.cat([idx[:1], idx[:-1]])
        part_cols = list(range(n_part))
        same_part = (K.keys_equal(skeys, idx, part_cols, skeys, prev,
                                  part_cols) if n_part
                     else torch.ones(n, dtype=torch.bool, device=dev))
        seg_start_flag = (idx == 0) | ~same_part
        order_cols = list(range(n_part, len(key_cols)))
        same_peer = (K.keys_equal(skeys, idx, order_cols, skeys, prev,
                                  order_cols) if order_cols
                     else torch.ones(n, dtype=torch.bool, device=dev))
        run_start_flag = seg_start_flag | ~same_peer

        # per-row geometry: each start row contributes its index, the others
        # -1, so a segmented max scan carries the latest start forward; the
        # ends come from the same scan over the reversed rows
        def carry(flags):
            return K.segmented_scan_kernel(torch.where(flags, idx, -1),
                                           flags, "max").long()

        rev_idx = idx.flip(0)

        def carry_rev(flags):
            rf = _rev_flags(flags)
            return K.segmented_scan_kernel(torch.where(rf, rev_idx, -1), rf,
                                           "max").flip(0).long()

        geo = _Geometry(idx.long(), carry(seg_start_flag),
                        carry_rev(seg_start_flag), carry(run_start_flag),
                        carry_rev(run_start_flag))
        sctx = EV.EvalContext(sbatch)
        out_cols = list(sbatch.columns)
        for f, frame, _name in self._bound_wins:
            out_cols.append(self._one_window(f, frame, sctx, geo))
        return ColumnarBatch(out_cols, n)

    def _one_window(self, f, frame: W.WindowFrame, sctx,
                    g: _Geometry) -> DeviceColumn:
        every = torch.ones_like(g.idx, dtype=torch.bool)
        if isinstance(f, W.RowNumber):
            return _win_out(T.INT, g.idx - g.seg_start + 1, every)
        if isinstance(f, W.Rank):
            return _win_out(T.INT, g.run_start - g.seg_start + 1, every)
        if isinstance(f, W.DenseRank):
            runs_before = torch.cumsum((g.idx == g.run_start).int(), 0,
                                       dtype=torch.int32)
            at_seg_start = runs_before[g.seg_start]
            return _win_out(T.INT, runs_before - at_seg_start + 1, every)
        if isinstance(f, W.PercentRank):
            rank0 = (g.run_start - g.seg_start).double()
            others = (g.seg_end - g.seg_start).double()
            return _win_out(T.DOUBLE, torch.where(
                others > 0, rank0 / others.clamp(min=1.0),
                torch.zeros_like(rank0)), every)
        if isinstance(f, W.CumeDist):
            return _win_out(T.DOUBLE, (g.run_end - g.seg_start + 1).double()
                            / (g.seg_end - g.seg_start + 1).double(), every)
        if isinstance(f, W.NTile):
            # Spark's tiles: the first (rows % n) tiles hold one row more
            count = g.seg_end - g.seg_start + 1
            r = g.idx - g.seg_start
            base, rem = count // f.n, count % f.n
            big = rem * (base + 1)
            tile = torch.where(r < big, r // (base + 1),
                               rem + (r - big) // base.clamp(min=1))
            return _win_out(T.INT, tile + 1, every)
        if isinstance(f, W.Lead):
            return self._offset_window(f, sctx, g)
        return self._agg_window(f, frame, sctx, g)

    @staticmethod
    def _offset_window(f: W.Lead, sctx, g: _Geometry) -> DeviceColumn:
        """Lead/Lag: the input at the row ``offset`` rows after (before)
        each row; where that row is outside the partition, the default (or
        null)."""
        off = -f.offset if isinstance(f, W.Lag) else f.offset
        col = EV.val_to_column(EV.eval_expr(f.child, sctx), f.child.dtype)
        src = g.idx + off
        ok = (src >= g.seg_start) & (src <= g.seg_end)
        src = src.clamp(0, g.idx.numel() - 1)
        if col.offsets is not None:
            out = K.gather_string(col, src, ok)
        else:
            got = K.gather_column(col, src)
            out = DeviceColumn(col.dtype, K.where_valid(ok, got.data),
                               got.validity & ok, None, got.dictionary)
        if f.default is None:
            return out
        if col.dtype == T.STRING:
            return EV._string_select(ok, out, EV._string_value(
                f.default, sctx, like=out))
        dv = EV.eval_expr(f.default, sctx)
        take = ok[:, None] if out.data.dim() == 2 else ok
        return DeviceColumn(col.dtype, torch.where(
            take, out.data, dv.data.to(out.data.dtype)),
            torch.where(ok, out.validity, dv.validity))

    def _frame_bounds(self, frame: W.WindowFrame, sctx, g: _Geometry
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per row, the first and last rows of its frame (int64; empty
        where last < first)."""
        if frame.is_unbounded_both:
            return g.seg_start, g.seg_end
        if frame.kind == "rows":
            lo = (g.seg_start if frame.start is W.UNBOUNDED
                  else torch.maximum(g.idx + frame.start, g.seg_start))
            hi = (g.seg_end if frame.end is W.UNBOUNDED
                  else torch.minimum(g.idx + frame.end, g.seg_end))
            return lo, hi
        if frame.is_running:
            return g.seg_start, g.run_end
        if frame.start == 0 and frame.end is W.UNBOUNDED:
            return g.run_start, g.seg_end
        # bounded RANGE: bisect the sorted order key inside each partition,
        # a fixed number of steps (no host read); one ascending integral or
        # date key (check_window)
        ob, _asc, nf = self._order_bound[0]
        v = EV.eval_expr(ob, sctx)
        key, null = v.data.long(), ~v.validity
        nulls_first = True if nf is None else nf
        n = g.idx.numel()
        steps = math.ceil(math.log2(max(n, 2))) + 1

        def first_at_or_after(target, strict: bool):
            """First row of the partition whose key is >= target (>
            target when ``strict``)."""
            lo, hi = g.seg_start, g.seg_end + 1
            for _ in range(steps):
                live = lo < hi
                mid = (lo + hi) // 2
                at = mid.clamp(0, n - 1)
                below = key[at] <= target if strict else key[at] < target
                kn = null[at]
                right = (kn | below) if nulls_first else (~kn & below)
                lo = torch.where(live & right, mid + 1, lo)
                hi = torch.where(live & ~right, mid, hi)
            return lo

        lo = (g.seg_start if frame.start is W.UNBOUNDED
              else first_at_or_after(key + frame.start, False))
        hi = (g.seg_end if frame.end is W.UNBOUNDED
              else first_at_or_after(key + frame.end, True) - 1)
        # a null key's frame is its peers (the partition's null keys)
        return (torch.where(null, g.run_start, lo),
                torch.where(null, g.run_end, hi))

    def _agg_window(self, f, frame: W.WindowFrame, sctx,
                    g: _Geometry) -> DeviceColumn:
        n = g.idx.numel()
        if isinstance(f, E._VarianceBase):
            x = f.children[0]
            v = EV.eval_expr(x if x.dtype == T.DOUBLE
                             else E.Cast(x, T.DOUBLE), sctx)
            lo, hi = self._frame_bounds(frame, sctx, g)
            return _variance_window(f, v.data, v.validity,
                                    _Frame(lo, hi, g.seg_start, g.seg_flag),
                                    g.seg_start)
        if f.children:
            v = EV.eval_expr(f.children[0], sctx)
            vals, valid = v.data, v.validity
        else:
            vals = torch.ones(n, dtype=torch.int64, device=g.idx.device)
            valid = torch.ones(n, dtype=torch.bool, device=g.idx.device)
        out_t = f.dtype
        count_all = isinstance(f, E.Count) and not f.children
        contributing = torch.ones_like(valid) if count_all else valid
        seg_flag = g.seg_flag
        lo, hi = self._frame_bounds(frame, sctx, g)
        fr = _Frame(lo, hi, g.seg_start, seg_flag)
        if isinstance(f, E.Count):
            return _finish_agg(f, out_t, None, fr.count(contributing))
        if isinstance(f, (E.First, E.Last)):
            return _first_last(f, out_t, vals, valid, fr)
        if isinstance(f, (E.Min, E.Max)):
            op = "min" if isinstance(f, E.Min) else "max"
            if frame.is_unbounded_both:
                seg_id = torch.cumsum(seg_flag.int(), 0, dtype=torch.int32) - 1
                starts = torch.nonzero(seg_flag).squeeze(1)
                red, rvalid = K.segment_agg(vals, valid, seg_id, starts, op)
                sid = seg_id.long()
                return _win_out(out_t, red[sid], rvalid[sid])
            # a frame that reaches its partition's first (last) row on
            # every row; a bounded RANGE frame's null keys frame their peers
            if not frame.is_bounded_range and (frame.start is W.UNBOUNDED
                                               or frame.end is W.UNBOUNDED):
                return _scan_minmax(f, vals, valid, fr, out_t,
                                    from_end=frame.start is not W.UNBOUNDED)
            if frame.is_bounded_rows:
                return _bounded_minmax(f, vals, valid, fr, g.idx, g.seg_end,
                                       frame.start, frame.end, out_t)
            return _rmq_minmax(f, vals, valid, fr, out_t,
                               max(n, 1).bit_length())
        if T.is_wide_decimal(out_t) or vals.dim() == 2:
            return _wide_agg_window(f, out_t, vals, contributing, fr)

        # sum family: differences of segmented running sums. A frame from
        # the partition's first row reads the running sum at its last row;
        # the reference takes global prefix differences, which for floats
        # lose a small frame's sum under a large prefix
        if vals.is_floating_point():
            d, is_nan = K._float_canonical(vals)
            clean = contributing & ~is_nan
            masked = torch.where(clean, d, torch.zeros_like(d))
        else:
            is_nan = None
            v64 = vals.long()
            masked = torch.where(contributing, v64, torch.zeros_like(v64))
        s = fr.sum(masked)
        if is_nan is not None:
            s = torch.where(fr.count(contributing & is_nan) > 0,
                            torch.full_like(s, float("nan")), s)
        return _finish_agg(f, out_t, s, fr.count(contributing))


class _Frame:
    """Each row's frame [lo, hi] inside its partition, and sums over it
    as differences of segmented add-scans (through the kernel's wrapper)."""

    def __init__(self, lo: torch.Tensor, hi: torch.Tensor,
                 seg_start: torch.Tensor, seg_flag: torch.Tensor):
        last = lo.numel() - 1
        self.empty = hi < lo
        self.lo, self.hi = lo.clamp(0, last), hi.clamp(0, last)
        self.seg_flag = seg_flag
        # rows whose frame starts after the partition's first row subtract
        # the running sum just before it
        self.inner = lo > seg_start
        self.before = (lo - 1).clamp(0, last)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        run = K.segmented_scan_kernel(x.contiguous(), self.seg_flag, "add")
        s = run[self.hi] - torch.where(self.inner, run[self.before],
                                       torch.zeros_like(run[self.hi]))
        return torch.where(self.empty, torch.zeros_like(s), s)

    def count(self, rows: torch.Tensor) -> torch.Tensor:
        return self.sum(rows.long())


def _minmax_input(f, vals: torch.Tensor, valid: torch.Tensor):
    """(scan values, identity, live rows, NaN rows or None) of a Min or
    Max input: floats canonical (-0.0 as 0.0) with NaN and null rows at the
    identity, since Spark orders NaN above every value (a NaN count is
    kept beside); narrow integers and booleans widened to int32."""
    is_min = isinstance(f, E.Min)
    if vals.is_floating_point():
        d, is_nan = K._float_canonical(vals)
        live = valid & ~is_nan
        ident = float("inf") if is_min else float("-inf")
        return (torch.where(live, d, torch.full_like(d, ident)), ident, live,
                valid & is_nan)
    work = vals.int() if vals.dtype in (torch.bool, torch.int8,
                                        torch.int16) else vals
    info = torch.iinfo(work.dtype)
    ident = info.max if is_min else info.min
    return (torch.where(valid, work, torch.full_like(work, ident)), ident,
            valid, None)


def _minmax_out(f, out_t, vals, red, has, nan_seen) -> DeviceColumn:
    """A Min/Max column from the reduction of the live values, whether
    any was live, and (floats) whether a NaN was seen: a max with a NaN is
    NaN, a min of NaNs only is NaN."""
    if nan_seen is None:
        return _win_out(out_t, red, has)
    nan = torch.full_like(red, float("nan"))
    dec = (torch.where(nan_seen, nan, red) if isinstance(f, E.Max)
           else torch.where(has, red, nan))
    return _win_out(out_t, dec.to(vals.dtype), has | nan_seen)


def _scan_minmax(f, vals, valid, fr: _Frame, out_t,
                 from_end: bool) -> DeviceColumn:
    """Min/Max over frames that reach one end of their partition: a
    running min/max scan read at the frame's last row (frames from
    UNBOUNDED PRECEDING), or (``from_end``: frames to UNBOUNDED FOLLOWING)
    the same scan over the reversed rows, read at the frame's first row."""
    op = "min" if isinstance(f, E.Min) else "max"
    m, _ident, live, nan_row = _minmax_input(f, vals, valid)
    if from_end:
        red = K.segmented_scan_kernel(m.flip(0), _rev_flags(fr.seg_flag),
                                      op).flip(0)[fr.lo]
    else:
        red = K.segmented_scan_kernel(m, fr.seg_flag, op)[fr.hi]
    has = fr.count(live) > 0  # false for an empty frame: its row is null
    nan_seen = None if nan_row is None else fr.count(nan_row) > 0
    return _minmax_out(f, out_t, vals, red, has, nan_seen)


def _bounded_minmax(f, vals, valid, fr: _Frame, idx, seg_end, a: int,
                    b: int, out_t) -> DeviceColumn:
    """Min/Max over ROWS a..b (the reference's ``_bounded_minmax``): a
    frame of width w = b - a + 1 spans at most two w-aligned blocks, so a
    prefix scan that restarts at block and partition starts and a suffix
    scan (over the reversed rows) that restarts at block and partition
    ends cover it: one scan's value where the frame lies in one block and
    starts (or ends) on that scan's restart, else both combined."""
    op = "min" if isinstance(f, E.Min) else "max"
    comb = torch.minimum if op == "min" else torch.maximum
    w = max(b - a + 1, 1)
    block = idx % w
    m, _ident, live, nan_row = _minmax_input(f, vals, valid)
    pre = K.segmented_scan_kernel(m, fr.seg_flag | (block == 0), op)
    suf_start = ((idx == seg_end) | (block == w - 1)).flip(0)
    suf = K.segmented_scan_kernel(m.flip(0), suf_start, op).flip(0)
    lo, hi = fr.lo, fr.hi
    block_start = (hi // w) * w
    one_block = block_start <= lo
    # pre[hi] covers max(block start, partition start)..hi: exact when that
    # is lo, i.e. lo is the block start or the partition start
    from_pre = (block_start == lo) | fr.seg_flag[lo]
    red = torch.where(one_block, torch.where(from_pre, pre[hi], suf[lo]),
                      comb(suf[lo], pre[hi]))
    has = fr.count(live) > 0  # false for an empty frame: its row is null
    nan_seen = None if nan_row is None else fr.count(nan_row) > 0
    return _minmax_out(f, out_t, vals, red, has, nan_seen)


def _rmq_minmax(f, vals, valid, fr: _Frame, out_t,
                levels: int) -> DeviceColumn:
    """Min/Max over frames with no scan shape (bounded RANGE frames,
    whose null keys frame their peers): a sparse-table range query per
    row."""
    comb = torch.minimum if isinstance(f, E.Min) else torch.maximum
    m, ident, live, nan_row = _minmax_input(f, vals, valid)
    red = K.sparse_query(K.sparse_table(m, comb, ident, levels), comb,
                         fr.lo, fr.hi)
    has = fr.count(live) > 0
    nan_seen = None if nan_row is None else fr.count(nan_row) > 0
    return _minmax_out(f, out_t, vals, red, has, nan_seen)


def _first_last(f, out_t, vals, valid, fr: _Frame) -> DeviceColumn:
    """First/Last over any frame: the first non-null row at or after the
    frame's first row (a min scan of the non-null rows' positions over the
    reversed rows, read at lo), found where it is not past the frame's last
    row; Last the mirror (a max scan read at hi, found where not before
    lo)."""
    n = valid.numel()
    pos = torch.arange(n, dtype=torch.int32, device=valid.device)
    if isinstance(f, E.First):
        at = K.segmented_scan_kernel(
            torch.where(valid, pos, n).flip(0), _rev_flags(fr.seg_flag),
            "min").flip(0)[fr.lo].long()
        found = ~fr.empty & (at <= fr.hi)
    else:
        at = K.segmented_scan_kernel(torch.where(valid, pos, -1),
                                     fr.seg_flag, "max")[fr.hi].long()
        found = ~fr.empty & (at >= fr.lo)
    return _win_out(out_t, vals[at.clamp(0, n - 1)], found)


def _variance_window(f, x: torch.Tensor, valid: torch.Tensor, fr: _Frame,
                     seg_start: torch.Tensor) -> DeviceColumn:
    """VarianceSamp/Pop and StddevSamp/Pop over any frame: add-scans of
    the values shifted by their partition's first finite value (variance
    does not change under a shift, and what cancels is then the spread
    within the partition, not its distance from zero: the reference scans
    the raw values and loses every digit under a common offset), and of
    their squares, differenced over the frame; M2 = S2 - S1^2 / n. A
    frame holding a NaN or an infinity is NaN, as Spark's update gives."""
    n = x.numel()
    finite = valid & torch.isfinite(x)
    pos = torch.arange(n, dtype=torch.int32, device=x.device)
    first = K.segmented_scan_kernel(
        torch.where(finite, pos, n).flip(0), _rev_flags(fr.seg_flag),
        "min").flip(0)[seg_start].long()
    zero = torch.zeros((), dtype=torch.float64, device=x.device)
    shift = torch.where(first < n, x[first.clamp(max=n - 1)], zero)
    y = torch.where(finite, x - shift, zero)
    s1, s2 = fr.sum(y), fr.sum(y * y)
    c = fr.count(finite).double()
    m2 = (s2 - s1 * s1 / c.clamp(min=1.0)).clamp(min=0.0)
    samp = isinstance(f, (E.VarianceSamp, E.StddevSamp))
    data = m2 / ((c - 1) if samp else c).clamp(min=1.0)
    if isinstance(f, (E.StddevSamp, E.StddevPop)):
        data = data.sqrt()
    bad = fr.count(valid & ~finite) > 0
    data = torch.where(bad, torch.full_like(data, float("nan")), data)
    rows = fr.count(valid)
    return _win_out(T.DOUBLE, data, rows > 1 if samp else rows > 0)


def _wide_agg_window(f, out_t: T.DecimalType, vals: torch.Tensor,
                     contributing: torch.Tensor, fr: _Frame) -> DeviceColumn:
    """A DECIMAL128 window Sum or Average: the frame's 128-bit sum from
    three add-scans of the segmented-scan kernel (lo's 32-bit halves and
    hi), each differenced over the frame and joined with carries."""
    if vals.dim() == 2:
        h, l = I128.split(vals)
    else:  # a DECIMAL64 input whose window sum is DECIMAL128
        h, l = I128.from_i64(vals)
    zero = torch.zeros((), dtype=torch.int64, device=vals.device)
    h = torch.where(contributing, h, zero)
    l = torch.where(contributing, l, zero)
    l0, l1 = I128.lo_halves(l)
    th, tl = I128.from_part_sums(fr.sum(l0), fr.sum(l1), fr.sum(h))
    c = fr.count(contributing)
    nz = c > 0
    if isinstance(f, E.Average):
        d = out_t.scale - f.children[0].dtype.scale
        qh, ql, ovf = I128.decimal_avg_128(th, tl, c, d, out_t.precision)
    else:
        qh, ql = th, tl
        ovf = I128.overflow_mask(th, tl, out_t.precision)
    ok = nz & ~ovf
    return DeviceColumn(out_t, K.where_valid(ok, I128.pack(qh, ql)), ok)


def _rev_flags(flags: torch.Tensor) -> torch.Tensor:
    """Segment-start flags in reversed coordinates: reversed position i
    starts a segment when original row n-1-i ends one (the next row starts
    a segment, or it is the last row)."""
    nxt = torch.cat([flags[1:], torch.ones(1, dtype=torch.bool,
                                            device=flags.device)])
    return nxt.flip(0)


def _win_out(out_t: T.DataType, data: torch.Tensor,
             valid: torch.Tensor) -> DeviceColumn:
    return DeviceColumn(out_t, K.where_valid(valid,
                                             data.to(out_t.torch_dtype)),
                        valid)


def _finish_agg(f, out_t: T.DataType, s: Optional[torch.Tensor],
                c: torch.Tensor) -> DeviceColumn:
    if isinstance(f, E.Count):
        return _win_out(T.LONG, c, torch.ones_like(c, dtype=torch.bool))
    nz = c > 0
    if isinstance(f, E.Average):
        if isinstance(out_t, T.DecimalType):
            in_t = f.children[0].dtype
            return _win_out(out_t, decimal_avg_half_up(
                s, c, out_t.scale - in_t.scale), nz)
        return _win_out(out_t, s.double() / torch.clamp(c, min=1).double(),
                        nz)
    if isinstance(out_t, T.DecimalType):
        # Spark's non-ANSI decimal sum overflow: null past the precision
        nz = nz & (s.abs() < 10 ** out_t.precision)
    return _win_out(out_t, s, nz)
