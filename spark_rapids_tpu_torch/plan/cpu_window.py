"""The CPU engine's window operator (counterpart of the reference's
CpuWindowExec in spark_rapids_tpu/plan/cpu_agg.py), for the device's window
surface (``exec.window.check_window``): RowNumber, Rank, DenseRank, NTile,
PercentRank, CumeDist, Lead and Lag, and Sum, Count, Average, Min, Max,
First, Last, the variance family and (here alone, as in the reference)
Skewness and Kurtosis over UNBOUNDED, running and bounded ROWS and RANGE
frames.

Like the device's ``WindowExec`` it reads every row of its child, orders
them by the (partition, order) keys (``cpu.sort_permutation``: Spark's
null and NaN order, strings by their characters, stable) and appends the
window columns, so its rows come out partition-sorted too. Each row's
frame is a row range inside its partition: ROWS offsets clipped to the
partition, the peers of a RANGE frame, or for a bounded RANGE frame a
``np.searchsorted`` of the order key within each partition (null keys
frame their peers). Counts are prefix-count differences; decimal and
integer sums are differences of exact Python-int prefix sums, float sums
of per-partition running sums (null past a decimal result's precision; a
decimal average is HALF_UP at the result scale, as on the device). Min
and Max read a per-partition running min/max where the frame starts at
the partition's first row and reduce each frame otherwise, in Spark's
order (NaN above every double). First and Last take the first (last)
non-null row of the frame; Lead and Lag the row ``offset`` rows away.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.aggregate import _strip_alias
from spark_rapids_tpu_torch.exec.base import DeviceExec
from spark_rapids_tpu_torch.exec.window import bind_function, check_window
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import window as W
from spark_rapids_tpu_torch.plan.cpu import (
    CpuExec, _canonical_float, _half_up_div, cpu_eval, exact_order_key,
    order_ranks, sort_permutation, values_to_arrow)


class CpuWindowExec(CpuExec):
    """Appends window columns to the child's rows on the host; every
    expression shares one (partition, order) spec, as on the device."""

    def __init__(self, window_exprs: Sequence[E.Expression],
                 child: DeviceExec, device):
        super().__init__(child, device=device)
        self.window_exprs = list(window_exprs)
        cs = child.output_schema
        wins = []
        spec = None
        for e in self.window_exprs:
            w, name = _strip_alias(e)
            if not isinstance(w, W.WindowExpression):
                raise ValueError(f"not a window expression: {e!r}")
            if spec is None:
                spec = w.spec
            elif (repr(spec.partition_by) != repr(w.spec.partition_by)
                  or repr(spec.order_by) != repr(w.spec.order_by)):
                raise ValueError("one window operator handles one "
                                 "(partition, order) spec")
            wins.append((w, name))
        self._spec = spec or W.WindowSpec()
        self._parts = [E.resolve(p, cs) for p in self._spec.partition_by]
        self._orders = [(E.resolve(o.child, cs), o.ascending, o.nulls_first)
                        for o in self._spec.order_by]
        order_keys = [(o, asc) for o, asc, _nf in self._orders]
        self._bound = []
        for w, name in wins:
            f, frame = bind_function(w.function, cs), w.spec.resolved_frame()
            check_window(f, frame, order_keys)
            self._bound.append((f, frame, name))

    @property
    def output_schema(self) -> T.Schema:
        return T.Schema(list(self.children[0].output_schema)
                        + [T.Field(name, f.dtype, f.nullable)
                           for f, _frame, name in self._bound])

    def num_partitions(self) -> int:
        return 1  # it reads every partition of its child (or children)

    def node_description(self) -> str:
        return (f"CpuWindow [{', '.join(n for _, _, n in self._bound)}] "
                f"{self._spec!r}")

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        t = self.all_child_rows(self.children[0])
        n = t.num_rows
        perm = sort_permutation(t, [(p, True, None) for p in self._parts]
                                + self._orders)
        t = t.take(pa.array(perm, pa.int64()))
        seg_start = _run_starts(t, self._parts, n)
        run_start = seg_start | _run_starts(
            t, [o for o, _a, _nf in self._orders], n)
        g = _geometry(seg_start, run_start, n)
        arrays = list(t.columns)
        for f, frame, _name in self._bound:
            vals, valid = _window_column(f, frame, t, g, self._orders)
            arrays.append(values_to_arrow(vals, valid, f.dtype))
        yield pa.Table.from_arrays(arrays,
                                   schema=self.output_schema.to_arrow())


class _Geo(NamedTuple):
    """Per sorted row: its position, its partition's first and last rows
    and its peer run's first and last rows; the partitions' bounds."""
    idx: np.ndarray
    seg_first: np.ndarray
    seg_last: np.ndarray
    peer_first: np.ndarray
    peer_last: np.ndarray
    starts: np.ndarray
    ends: np.ndarray


def _geometry(seg_start: np.ndarray, run_start: np.ndarray, n: int) -> _Geo:
    starts = np.flatnonzero(seg_start)
    ends = np.append(starts[1:], n)[:len(starts)].astype(np.int64)
    rstarts = np.flatnonzero(run_start)
    rends = np.append(rstarts[1:], n)[:len(rstarts)].astype(np.int64)
    return _Geo(np.arange(n), np.repeat(starts, ends - starts),
                np.repeat(ends - 1, ends - starts),
                np.repeat(rstarts, rends - rstarts),
                np.repeat(rends - 1, rends - rstarts), starts, ends)


def _run_starts(t: pa.Table, keys: Sequence[E.Expression],
                n: int) -> np.ndarray:
    """Per sorted row: does its key tuple differ from the previous row's
    (row 0 always starts a run)? Nulls equal nulls."""
    flags = np.zeros(n, np.bool_)
    if n:
        flags[0] = True
    for k in keys:
        vals, valid = cpu_eval(k, t)
        key = exact_order_key(vals, valid, k.dtype)
        if key is None:
            key = order_ranks(vals, valid, k.dtype)[0]
        flags[1:] |= (key[1:] != key[:-1]) | (valid[1:] != valid[:-1])
    return flags


def _window_column(f, frame: W.WindowFrame, t: pa.Table, g: _Geo, orders):
    """(values, valid) of one window function over the sorted rows."""
    n = len(g.idx)
    every = np.ones(n, np.bool_)
    if isinstance(f, W.RowNumber):
        return (g.idx - g.seg_first + 1).astype(np.int32), every
    if isinstance(f, W.Rank):
        return (g.peer_first - g.seg_first + 1).astype(np.int32), every
    if isinstance(f, W.DenseRank):
        runs = np.cumsum(g.peer_first == g.idx)
        return (runs - runs[g.seg_first] + 1).astype(np.int32), every
    if isinstance(f, W.PercentRank):
        others = g.seg_last - g.seg_first
        return np.where(others > 0, (g.peer_first - g.seg_first)
                        / np.maximum(others, 1), 0.0), every
    if isinstance(f, W.CumeDist):
        return ((g.peer_last - g.seg_first + 1)
                / (g.seg_last - g.seg_first + 1)), every
    if isinstance(f, W.NTile):
        size = g.seg_last - g.seg_first + 1
        r = g.idx - g.seg_first
        base, rem = size // f.n, size % f.n
        big = rem * (base + 1)  # rows in the (rem) tiles one row larger
        tile = np.where(r < big, r // (base + 1),
                        rem + (r - big) // np.maximum(base, 1))
        return (tile + 1).astype(np.int32), every
    if isinstance(f, W.Lead):
        return _offset(f, t, g)
    return _frame_agg(f, frame, t, g, orders)


def _offset(f: W.Lead, t: pa.Table, g: _Geo):
    vals, valid = cpu_eval(f.child, t)
    off = -f.offset if isinstance(f, W.Lag) else f.offset
    src = g.idx + off
    ok = (src >= g.seg_first) & (src <= g.seg_last)
    src = np.clip(src, 0, max(len(g.idx) - 1, 0))
    out, out_valid = vals[src], valid[src] & ok
    if f.default is not None:
        dv, dvalid = cpu_eval(f.default, t)
        out = np.where(ok, out, dv)
        out_valid = np.where(ok, out_valid, dvalid)
    return out, out_valid


def _frame_rows(frame: W.WindowFrame, t: pa.Table, g: _Geo, orders):
    """Per row, the first and last rows of its frame (empty where last <
    first)."""
    if frame.is_unbounded_both:
        return g.seg_first, g.seg_last
    if frame.kind == "rows":
        lo = (g.seg_first if frame.start is None
              else np.maximum(g.idx + frame.start, g.seg_first))
        hi = (g.seg_last if frame.end is None
              else np.minimum(g.idx + frame.end, g.seg_last))
        return lo, hi
    if frame.is_running:
        return g.seg_first, g.peer_last
    if frame.start == 0 and frame.end is None:
        return g.peer_first, g.seg_last
    # bounded RANGE: the rows whose key lies in [key + start, key + end],
    # searched among each partition's non-null keys (ascending, contiguous)
    vals, valid = cpu_eval(orders[0][0], t)
    key = np.asarray(vals, np.int64)
    lo, hi = g.peer_first.copy(), g.peer_last.copy()  # null keys: peers
    for s, e in zip(g.starts, g.ends):
        nn = s + np.flatnonzero(valid[s:e])
        if not len(nn):
            continue
        k = key[nn]
        if frame.start is not None:
            lo[nn] = nn[0] + np.searchsorted(k, k + frame.start, "left")
        else:
            lo[nn] = s
        if frame.end is not None:
            hi[nn] = nn[0] + np.searchsorted(k, k + frame.end, "right") - 1
        else:
            hi[nn] = e - 1
    return lo, hi


def _frame_agg(f, frame: W.WindowFrame, t: pa.Table, g: _Geo, orders):
    n = len(g.idx)
    lo, hi = _frame_rows(frame, t, g, orders)
    empty = hi < lo
    lo_c, hi_c = np.clip(lo, 0, max(n - 1, 0)), np.clip(hi, 0, max(n - 1, 0))
    if isinstance(f, E._VarianceBase):
        x = f.children[0]
        vals, valid = cpu_eval(x if x.dtype == T.DOUBLE
                               else E.Cast(x, T.DOUBLE), t)
        return _frame_moments(f, np.asarray(vals, np.float64), valid, lo,
                              empty, lo_c, hi_c, g)
    if f.children:
        vals, valid = cpu_eval(f.children[0], t)
        in_t = f.children[0].dtype
    else:  # count(*)
        vals, valid, in_t = np.zeros(n, np.int64), np.ones(n, np.bool_), \
            T.LONG

    def count(rows):
        pre = np.concatenate([[0], np.cumsum(rows)])
        return np.where(empty, 0, pre[hi_c + 1] - pre[lo_c])

    cnt = count(valid)
    ok = cnt > 0
    out_t = f.dtype
    if isinstance(f, E.Count):
        return cnt, np.ones(n, np.bool_)
    if isinstance(f, (E.First, E.Last)):
        rows = np.flatnonzero(valid)
        before = np.concatenate([[0], np.cumsum(valid)])
        k = before[lo_c] if isinstance(f, E.First) else before[hi_c + 1] - 1
        at = rows[np.clip(k, 0, max(len(rows) - 1, 0))] if len(rows) \
            else lo_c
        return vals[at], ok
    exact = (isinstance(in_t, T.DecimalType)
             or in_t in T.INTEGRAL_TYPES + (T.DATE, T.TIMESTAMP,
                                            T.BOOLEAN))
    if isinstance(f, (E.Min, E.Max)):
        from_first = bool((np.where(empty, g.seg_first, lo)
                           == g.seg_first).all())
        return _frame_extremum(f, vals, valid, exact, lo_c, hi_c, g,
                               from_first, count)
    if exact:  # exact prefix sums: any difference is the frame's sum
        pre = np.cumsum(np.concatenate(
            [[0], np.where(valid, vals, 0)]).astype(object))
        got = np.where(empty, 0, pre[hi_c + 1] - pre[lo_c])
        nan_in = None
    else:
        d = _canonical_float(np.asarray(vals, np.float64))
        is_nan = valid & np.isnan(d)
        run = np.zeros(n)
        clean = np.where(valid & ~is_nan, d, 0.0)
        for s, e in zip(g.starts, g.ends):
            run[s:e] = np.cumsum(clean[s:e])
        got = run[hi_c] - np.where(lo > g.seg_first, run[lo_c - 1], 0.0)
        got = np.where(empty, 0.0, got)
        nan_in = count(is_nan) > 0
    if isinstance(f, E.Average):
        if isinstance(out_t, T.DecimalType):
            k = 10 ** (out_t.scale - in_t.scale)
            out = np.array([_half_up_div(int(x) * k, int(c)) if c else 0
                            for x, c in zip(got, cnt)], dtype=object)
            return _fit(out, ok, out_t)
        got = got.astype(np.float64)
        if nan_in is not None:
            got = np.where(nan_in, np.nan, got)
        return got / np.maximum(cnt, 1), ok
    if isinstance(out_t, T.DecimalType):
        return _fit(got, ok, out_t)
    if exact:  # a long sum wraps, as Java's
        return np.array([(int(x) + (1 << 63)) % (1 << 64) - (1 << 63)
                         for x in got], np.int64), ok
    return np.where(nan_in, np.nan, got), ok


def _frame_moments(f, x: np.ndarray, valid: np.ndarray, lo, empty, lo_c,
                   hi_c, g: _Geo):
    """The variance family, Skewness and Kurtosis over each frame, as the
    device's ``_variance_window``: per-partition running sums of the
    values shifted by their partition's first finite value and of their
    powers, differenced over the frame, give the frame's central moments
    (NaN where the frame holds a NaN or an infinity)."""
    n = len(x)
    finite = valid & np.isfinite(x)
    shift = np.zeros(n)
    for s, e in zip(g.starts, g.ends):
        at = np.flatnonzero(finite[s:e])
        shift[s:e] = x[s + at[0]] if len(at) else 0.0
    y = np.where(finite, x - shift, 0.0)

    def frame_count(rows):
        pre = np.concatenate([[0], np.cumsum(rows)])
        return np.where(empty, 0, pre[hi_c + 1] - pre[lo_c])

    def frame_sum(v):
        run = np.zeros(n)
        for s, e in zip(g.starts, g.ends):
            run[s:e] = np.cumsum(v[s:e])
        got = run[hi_c] - np.where(lo > g.seg_first, run[lo_c - 1], 0.0)
        return np.where(empty, 0.0, got)

    c = frame_count(finite).astype(np.float64)
    cc = np.maximum(c, 1.0)
    s1, s2 = frame_sum(y), frame_sum(y * y)
    m2 = np.maximum(s2 - s1 * s1 / cc, 0.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        if isinstance(f, (E.Skewness, E.Kurtosis)):
            s3 = frame_sum(y ** 3)
            m3 = s3 - 3 * s1 * s2 / cc + 2 * s1 ** 3 / cc ** 2
            if isinstance(f, E.Skewness):
                out = np.sqrt(c) * m3 / m2 ** 1.5
            else:
                s4 = frame_sum(y ** 4)
                m4 = (s4 - 4 * s1 * s3 / cc + 6 * s1 * s1 * s2 / cc ** 2
                      - 3 * s1 ** 4 / cc ** 3)
                out = c * m4 / (m2 * m2) - 3.0
            out = np.where(m2 == 0, np.nan, out)
            samp = False
        else:
            samp = isinstance(f, (E.VarianceSamp, E.StddevSamp))
            out = m2 / np.maximum(c - 1 if samp else c, 1.0)
            if isinstance(f, (E.StddevSamp, E.StddevPop)):
                out = np.sqrt(out)
    if finite.all():  # no null, NaN or infinity: the counts are c
        bad, rows = np.zeros(n, np.bool_), c
    else:
        bad, rows = frame_count(valid & ~finite) > 0, frame_count(valid)
    return (np.where(bad, np.nan, out),
            rows > 1 if samp else rows > 0)


def _frame_extremum(f, vals, valid, exact: bool, lo_c, hi_c, g: _Geo,
                    from_first: bool, count):
    """Min or Max of each frame in Spark's order (NaN above every
    double): a running min/max per partition read at the frame's last row
    where every frame starts at its partition's first row (``from_first``),
    else one reduction per frame. ``count`` counts flagged rows per
    frame."""
    is_min = isinstance(f, E.Min)
    if exact:
        m = np.asarray(vals)
        m = m.astype(np.int64) if m.dtype == np.bool_ else m
        if m.dtype == object:  # DECIMAL128: Python ints, past any 38 digits
            ident = 10 ** 39 if is_min else -10 ** 39
        else:
            info = np.iinfo(m.dtype)
            ident = info.max if is_min else info.min
        m = np.where(valid, m, ident)
        nan_row = None
    else:
        d = _canonical_float(np.asarray(vals, np.float64))
        nan_row = valid & np.isnan(d)
        m = np.where(valid & ~nan_row, d, np.inf if is_min else -np.inf)
    fold = np.minimum if is_min else np.maximum
    if from_first:
        run = np.empty_like(m)
        for s, e in zip(g.starts, g.ends):
            run[s:e] = fold.accumulate(m[s:e])
        red = run[hi_c]
    else:
        bounds = np.stack([lo_c, hi_c + 1], 1).reshape(-1)
        red = fold.reduceat(np.append(m, m[:1]), bounds)[::2]
    has = count(valid & ~nan_row if nan_row is not None else valid) > 0
    if nan_row is None:
        return red.astype(np.asarray(vals).dtype), has
    nan_seen = count(nan_row) > 0
    out = (np.where(has, red, np.nan) if is_min
           else np.where(nan_seen, np.nan, red))
    return out, has | nan_seen


def _fit(vals: np.ndarray, ok: np.ndarray, dt: T.DecimalType):
    """Decimal results: null where none contributed or where the value
    reaches 10**precision (Spark's non-ANSI overflow)."""
    bound = 10 ** dt.precision
    ok = ok & np.array([abs(int(x)) < bound for x in vals], np.bool_)
    out = np.array([int(x) if k else 0 for x, k in zip(vals, ok)],
                   dtype=object)
    return (out if dt.is_wide else out.astype(np.int64)), ok
