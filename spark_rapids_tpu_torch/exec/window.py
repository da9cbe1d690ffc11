"""Window operator (counterpart of spark_rapids_tpu/exec/window.py).

The partition's batches are concatenated on the device (as ``SortExec``
does) and the window columns are computed over that one batch: one sort by
the (partition, order) keys, ``keys_equal`` flags for the segment and peer
boundaries, and four segmented ``max`` scans through the segmented-scan
kernel's wrapper that carry each row's segment start and end and peer-run
start and end. Every window column is a function of that shared geometry
(rows come out partition-sorted, as Spark's WindowExec emits them).

Supported: RowNumber, Rank and DenseRank; Sum, Count, Average, Min and Max
over ROWS or RANGE frames UNBOUNDED PRECEDING..UNBOUNDED FOLLOWING and
UNBOUNDED PRECEDING..CURRENT ROW, over non-string inputs, DECIMAL64 and
DECIMAL128 (Sum, Count and Average; a decimal(17,2) sum windows into
decimal(27,2), its average into decimal(21,6)). A DECIMAL128 window sum
splits each value into three int64 lanes (lo's two 32-bit halves and hi),
add-scans each through the segmented-scan kernel (a half's sums stay below
2^63 for any partition under 2^31 rows; hi wraps mod 2^64, as its place
value allows) and joins them with carries: exact mod 2^128, null past the
result's precision. DECIMAL128 partition and order keys sort and compare
both limbs. Everything else raises NotImplementedError naming what is
missing: lead/lag, ntile, percent_rank, cume_dist, bounded frames,
first/last, the sparse-table frames, streaming windows and Min/Max over
DECIMAL128. A plain (non-dictionary) string partition or order key raises
too; it is never ordered by its hash.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

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

_AGGS = (E.Sum, E.Count, E.Average, E.Min, E.Max)


def _check_window_supported(f: E.Expression, frame: W.WindowFrame) -> None:
    """Raise NotImplementedError for a window function or frame outside the
    port."""
    if isinstance(f, (W.RowNumber, W.Rank, W.DenseRank)):
        return
    missing = {W.Lead: "lead/lag", W.NTile: "ntile",
               W.PercentRank: "percent_rank", W.CumeDist: "cume_dist"}
    for cls, what in missing.items():
        if isinstance(f, cls):
            raise NotImplementedError(f"window function {what} is not in "
                                      f"the port yet")
    if not isinstance(f, _AGGS):
        raise NotImplementedError(f"window function {type(f).__name__} "
                                  f"(first/last and others) is not in the "
                                  f"port yet")
    if not (frame.is_unbounded_both or frame.is_running):
        raise NotImplementedError(f"bounded window frame {frame!r} is not in "
                                  f"the port yet")


class WindowExec(UnaryExec):
    """Appends window columns to the child's output; all expressions share
    one (partition, order) spec."""

    def __init__(self, window_exprs: Sequence[E.Expression],
                 child: DeviceExec):
        super().__init__(child)
        self.window_exprs = list(window_exprs)
        self._prepare()
        self._register_metric("windowTimeNs")

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
        bound = []
        for func, name in wins:
            f = func.function
            frame = func.spec.resolved_frame()
            _check_window_supported(f, frame)
            if isinstance(f, _AGGS) and f.children:
                f = type(f)(E.resolve(f.children[0], cs))
                if f.children[0].dtype == T.STRING:
                    raise NotImplementedError(
                        "window aggregate over a string column is not in "
                        "the port yet")
                if isinstance(f, (E.Min, E.Max)) and T.is_wide_decimal(
                        f.dtype):
                    raise NotImplementedError(
                        "window min/max over DECIMAL128 is not in the port "
                        "yet")
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
        return (f"Window [{', '.join(n for _, _, n in self._bound_wins)}] "
                f"{self._spec!r}")

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute(partition))
        if not batches:
            return
        with self.timer("windowTimeNs"):
            out = self._compute(K.concat_device(batches))
        yield out

    # -- computation -------------------------------------------------------
    def _compute(self, batch: ColumnarBatch) -> ColumnarBatch:
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
        if any(c.offsets is not None for c in key_cols):
            raise NotImplementedError(
                "window partition/order key on a plain (non-dictionary) "
                "string column is not in the port yet")
        if key_cols:
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
                                           flags, "max")

        rev_idx = idx.flip(0)

        def carry_rev(flags):
            rf = _rev_flags(flags)
            return K.segmented_scan_kernel(torch.where(rf, rev_idx, -1), rf,
                                           "max").flip(0)

        seg_start = carry(seg_start_flag)
        run_start = carry(run_start_flag)
        seg_end = carry_rev(seg_start_flag)
        run_end = carry_rev(run_start_flag)

        sctx = EV.EvalContext(sbatch)
        out_cols = list(sbatch.columns)
        for f, frame, _name in self._bound_wins:
            out_cols.append(self._one_window(f, frame, sctx, idx, seg_start,
                                             seg_end, run_start, run_end))
        return ColumnarBatch(out_cols, n)

    def _one_window(self, f, frame: W.WindowFrame, sctx, idx, seg_start,
                    seg_end, run_start, run_end) -> DeviceColumn:
        every = torch.ones_like(idx, dtype=torch.bool)
        if isinstance(f, W.RowNumber):
            return _win_out(T.INT, idx - seg_start + 1, every)
        if isinstance(f, W.Rank):
            return _win_out(T.INT, run_start - seg_start + 1, every)
        if isinstance(f, W.DenseRank):
            runs_before = torch.cumsum((idx == run_start).int(), 0,
                                       dtype=torch.int32)
            at_seg_start = runs_before[seg_start.long()]
            return _win_out(T.INT, runs_before - at_seg_start + 1, every)
        return self._agg_window(f, frame, sctx, idx, seg_start, seg_end,
                                run_end)

    @staticmethod
    def _frame_end(frame: W.WindowFrame, idx, seg_end, run_end):
        """Per-row last frame row of the supported frames, which all start
        at the segment's first row."""
        if frame.is_unbounded_both:
            return seg_end
        if frame.kind == "rows":
            return idx
        return run_end  # RANGE: the current row's peers too

    def _agg_window(self, f, frame, sctx, idx, seg_start, seg_end,
                    run_end) -> DeviceColumn:
        n = idx.numel()
        if f.children:
            v = EV.eval_expr(f.children[0], sctx)
            vals, valid = v.data, v.validity
        else:
            vals = torch.ones(n, dtype=torch.int64, device=idx.device)
            valid = torch.ones(n, dtype=torch.bool, device=idx.device)
        out_t = f.dtype
        count_all = isinstance(f, E.Count) and not f.children
        contributing = torch.ones_like(valid) if count_all else valid
        seg_flag = idx == seg_start
        hi = self._frame_end(frame, idx, seg_end, run_end).long()
        if T.is_wide_decimal(out_t) and isinstance(f, (E.Sum, E.Average)):
            return _wide_agg_window(f, out_t, vals, contributing, seg_flag,
                                    hi)

        if isinstance(f, (E.Min, E.Max)):
            op = "min" if isinstance(f, E.Min) else "max"
            if frame.is_unbounded_both:
                seg_id = torch.cumsum(seg_flag.int(), 0, dtype=torch.int32) - 1
                starts = torch.nonzero(seg_flag).squeeze(1)
                red, rvalid = K.segment_agg(vals, valid, seg_id, starts, op)
                sid = seg_id.long()
                return _win_out(out_t, red[sid], rvalid[sid])
            c_run = K.segmented_scan_kernel(contributing.long(), seg_flag,
                                            "add")
            return self._scan_minmax(f, vals, valid, seg_flag, c_run, out_t,
                                     None if frame.kind == "rows" else hi)

        # sum family. Every supported frame starts at the segment's first
        # row, so a frame's sum is the segment's running sum at its last
        # row. The reference takes a global prefix difference
        # pre[hi] - pre[lo] + x[lo]: the same for integers (exact under
        # wraparound), but for floats it loses a small segment's sum under
        # a large prefix, which the segmented scan does not.
        if vals.is_floating_point():
            d, is_nan = K._float_canonical(vals)
            clean = contributing & ~is_nan
            nan_row = (contributing & is_nan).long()
            masked = torch.where(clean, d, torch.zeros_like(d))
        else:
            nan_row = None
            v64 = vals.long()
            masked = torch.where(contributing, v64, torch.zeros_like(v64))

        def win(x):
            return K.segmented_scan_kernel(x, seg_flag, "add")[hi]

        s = win(masked)
        c = win(contributing.long())
        if nan_row is not None:
            s = torch.where(win(nan_row) > 0,
                            torch.full_like(s, float("nan")), s)
        return _finish_agg(f, out_t, s, c)

    @staticmethod
    def _scan_minmax(f, vals, valid, seg_flag, cnt, out_t,
                     gather_at: Optional[torch.Tensor]) -> DeviceColumn:
        op = "min" if isinstance(f, E.Min) else "max"
        if vals.is_floating_point():
            # Spark orders NaN above every value: scan the clean values with
            # an infinite identity and NaN-seen / clean-seen flags beside
            d, is_nan = K._float_canonical(vals)
            live_clean = valid & ~is_nan
            ident = float("inf") if op == "min" else float("-inf")
            m = torch.where(live_clean, d, torch.full_like(d, ident))
            red = K.segmented_scan_kernel(m, seg_flag, op)
            nan_seen = K.segmented_scan_kernel((valid & is_nan).int(),
                                               seg_flag, "max") > 0
            clean_seen = K.segmented_scan_kernel(live_clean.int(), seg_flag,
                                                 "max") > 0
            if gather_at is not None:
                red, cnt = red[gather_at], cnt[gather_at]
                nan_seen, clean_seen = nan_seen[gather_at], clean_seen[
                    gather_at]
            nan = torch.full_like(red, float("nan"))
            dec = (torch.where(nan_seen, nan, red) if op == "max"
                   else torch.where(clean_seen, red, nan))
            return _win_out(out_t, dec.to(vals.dtype), cnt > 0)
        work = vals.int() if vals.dtype == torch.bool else vals
        info = torch.iinfo(work.dtype)
        ident = info.max if op == "min" else info.min
        m = torch.where(valid, work, torch.full_like(work, ident))
        red = K.segmented_scan_kernel(m, seg_flag, op)
        if gather_at is not None:
            red, cnt = red[gather_at], cnt[gather_at]
        return _win_out(out_t, red, cnt > 0)


def _wide_agg_window(f, out_t: T.DecimalType, vals: torch.Tensor,
                     contributing: torch.Tensor, seg_flag: torch.Tensor,
                     hi: torch.Tensor) -> DeviceColumn:
    """A DECIMAL128 window Sum or Average: the segment's running 128-bit
    sum at each row's last frame row, from three add-scans of the
    segmented-scan kernel (lo's 32-bit halves and hi), joined with
    carries."""
    if vals.dim() == 2:
        h, l = I128.split(vals)
    else:  # a DECIMAL64 input whose window sum is DECIMAL128
        h, l = I128.from_i64(vals)
    zero = torch.zeros((), dtype=torch.int64, device=vals.device)
    h = torch.where(contributing, h, zero)
    l = torch.where(contributing, l, zero)

    def win(x):
        return K.segmented_scan_kernel(x.contiguous(), seg_flag, "add")[hi]

    l0, l1 = I128.lo_halves(l)
    th, tl = I128.from_part_sums(win(l0), win(l1), win(h))
    c = win(contributing.long())
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


def _finish_agg(f, out_t: T.DataType, s: torch.Tensor,
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
