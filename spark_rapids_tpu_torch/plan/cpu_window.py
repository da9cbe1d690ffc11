"""The CPU engine's window operator (counterpart of the reference's
CpuWindowExec in spark_rapids_tpu/plan/cpu.py), for the device's window
surface: RowNumber, Rank and DenseRank, and Sum, Count, Average, Min and
Max over ROWS or RANGE frames UNBOUNDED PRECEDING..UNBOUNDED FOLLOWING and
UNBOUNDED PRECEDING..CURRENT ROW.

Like the device's ``WindowExec`` it reads every row of its child, orders
them by the (partition, order) keys (``cpu.sort_permutation``: Spark's
null and NaN order, stable) and appends the window columns, so its rows
come out partition-sorted too. Each segment (a partition) is folded on
its own with numpy; decimals add as Python ints (exact at any precision,
null past the result's), and a decimal average is HALF_UP at the result
scale, as on the device. A frame that starts at the segment's first row
ends at the segment's last row (UNBOUNDED FOLLOWING), the current row
(ROWS) or the current row's last peer (RANGE), so every aggregate is a
running fold read at that row.
"""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.aggregate import _strip_alias
from spark_rapids_tpu_torch.exec.base import DeviceExec
from spark_rapids_tpu_torch.exec.window import (
    _AGGS, _check_window_supported)
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import window as W
from spark_rapids_tpu_torch.plan.cpu import (
    CpuExec, _canonical_float, _half_up_div, cpu_eval, order_ranks,
    sort_permutation, values_to_arrow)


class CpuWindowExec(CpuExec):
    """Appends window columns to the child's rows on the host; every
    expression shares one (partition, order) spec, as on the device."""

    def __init__(self, window_exprs: Sequence[E.Expression],
                 child: DeviceExec, device):
        super().__init__(child, device=device)
        self.window_exprs = list(window_exprs)
        cs = child.output_schema
        self._bound = []
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
            f, frame = w.function, w.spec.resolved_frame()
            _check_window_supported(f, frame)
            if isinstance(f, _AGGS) and f.children:
                f = type(f)(E.resolve(f.children[0], cs))
            self._bound.append((f, frame, name))
        self._spec = spec or W.WindowSpec()
        self._parts = [E.resolve(p, cs) for p in self._spec.partition_by]
        self._orders = [(E.resolve(o.child, cs), o.ascending, o.nulls_first)
                        for o in self._spec.order_by]

    @property
    def output_schema(self) -> T.Schema:
        return T.Schema(list(self.children[0].output_schema)
                        + [T.Field(name, f.dtype, f.nullable)
                           for f, _frame, name in self._bound])

    def node_description(self) -> str:
        return (f"CpuWindow [{', '.join(n for _, _, n in self._bound)}] "
                f"{self._spec!r}")

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        t = self.all_child_rows(self.children[0])
        n = t.num_rows
        perm = sort_permutation(t, [(p, True, None) for p in self._parts]
                                + self._orders)
        t = t.take(pa.array(perm, pa.int64()))
        seg_start = _run_starts(t, [p for p in self._parts], n)
        run_start = seg_start | _run_starts(
            t, [o for o, _a, _nf in self._orders], n)
        starts = np.flatnonzero(seg_start) if n else np.zeros(0, np.int64)
        ends = np.append(starts[1:], n)
        arrays = list(t.columns)
        for f, frame, _name in self._bound:
            vals, valid = _window_column(f, frame, t, starts, ends,
                                         run_start, n)
            arrays.append(values_to_arrow(vals, valid, f.dtype))
        yield pa.Table.from_arrays(arrays,
                                   schema=self.output_schema.to_arrow())


def _run_starts(t: pa.Table, keys: Sequence[E.Expression],
                n: int) -> np.ndarray:
    """Per sorted row: does its key tuple differ from the previous row's
    (row 0 always starts a run)? Nulls equal nulls."""
    flags = np.zeros(n, np.bool_)
    if n:
        flags[0] = True
    for k in keys:
        vals, valid = cpu_eval(k, t)
        ranks, _ = order_ranks(vals, valid, k.dtype)
        key = np.where(valid, ranks, -1)
        flags[1:] |= key[1:] != key[:-1]
    return flags


def _window_column(f, frame: W.WindowFrame, t: pa.Table, starts, ends,
                   run_start: np.ndarray, n: int):
    """(values, valid) of one window function over the sorted rows."""
    idx = np.arange(n)
    seg_first = np.repeat(starts, ends - starts)
    if isinstance(f, (W.RowNumber, W.Rank, W.DenseRank)):
        peer_first = np.maximum.accumulate(np.where(run_start, idx, 0)) \
            if n else idx
        if isinstance(f, W.RowNumber):
            out = idx - seg_first + 1
        elif isinstance(f, W.Rank):
            out = peer_first - seg_first + 1
        else:
            runs = np.cumsum(run_start)
            out = runs - runs[seg_first] + 1
        return out.astype(np.int32), np.ones(n, np.bool_)
    # the last row of each row's frame
    if frame.is_unbounded_both:
        last = np.repeat(ends - 1, ends - starts)
    elif frame.kind == "rows":
        last = idx
    else:  # RANGE: the current row's last peer
        nxt = np.append(np.flatnonzero(run_start)[1:], n) if n else idx
        run_id = np.cumsum(run_start) - 1
        last = nxt[run_id] - 1
    if f.children:
        vals, valid = cpu_eval(f.children[0], t)
        in_t = f.children[0].dtype
    else:  # count(*)
        vals, valid, in_t = np.zeros(n, np.int64), np.ones(n, np.bool_), \
            T.LONG
    out_t = f.dtype
    counts = np.zeros(n, np.int64)
    if isinstance(f, E.Count):
        for s, e in zip(starts, ends):
            counts[s:e] = np.cumsum(valid[s:e])
        return counts[last], np.ones(n, np.bool_)
    exact = (isinstance(in_t, T.DecimalType)
             or in_t in T.INTEGRAL_TYPES + (T.DATE, T.BOOLEAN))
    acc = np.zeros(n, dtype=object if exact else np.float64)
    for s, e in zip(starts, ends):
        v, m = vals[s:e], valid[s:e]
        counts[s:e] = np.cumsum(m)
        if isinstance(f, (E.Sum, E.Average)):
            if exact:
                acc[s:e] = np.cumsum(np.array(
                    [int(x) if ok else 0 for x, ok in zip(v, m)],
                    dtype=object))
            else:
                acc[s:e] = np.cumsum(np.where(m, v, 0.0))
        else:
            acc[s:e] = _running_extremum(v, m, isinstance(f, E.Min),
                                         exact)
    cnt = counts[last]
    got = acc[last]
    ok = cnt > 0
    if isinstance(f, E.Average):
        if isinstance(out_t, T.DecimalType):
            k = 10 ** (out_t.scale - in_t.scale)
            out = np.array([_half_up_div(int(x) * k, int(c)) if c else 0
                            for x, c in zip(got, cnt)], dtype=object)
            return _fit(out, ok, out_t)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(ok, got.astype(np.float64)
                            / np.maximum(cnt, 1), 0.0), ok
    if isinstance(out_t, T.DecimalType):
        return _fit(got, ok, out_t)
    if exact:  # a long sum wraps, as Java's
        return np.array([(int(x) + (1 << 63)) % (1 << 64) - (1 << 63)
                         for x in got], np.int64), ok
    return got.astype(np.float64), ok


def _running_extremum(v: np.ndarray, m: np.ndarray, is_min: bool,
                      exact: bool) -> np.ndarray:
    """Running min or max of the valid values of one segment (Spark's
    order: NaN above every double); rows before the first valid one hold
    an unused value."""
    out = np.empty(len(v), dtype=object if exact else np.float64)
    best = None
    for i, (x, ok) in enumerate(zip(v.tolist(), m.tolist())):
        if ok:
            if exact:
                x = int(x)
            if best is None:
                best = x
            elif exact:
                best = min(best, x) if is_min else max(best, x)
            else:
                best = _float_extremum(best, x, is_min)
        out[i] = 0 if best is None else best
    if not exact:
        out = _canonical_float(out.astype(np.float64))
    return out


def _float_extremum(a: float, b: float, is_min: bool) -> float:
    if np.isnan(a) or np.isnan(b):
        if is_min:
            return b if np.isnan(a) else a
        return a if np.isnan(a) else b
    return min(a, b) if is_min else max(a, b)


def _fit(vals: np.ndarray, ok: np.ndarray, dt: T.DecimalType):
    """Decimal results: null where none contributed or where the value
    reaches 10**precision (Spark's non-ANSI overflow)."""
    bound = 10 ** dt.precision
    ok = ok & np.array([abs(int(x)) < bound for x in vals], np.bool_)
    out = np.array([int(x) if k else 0 for x, k in zip(vals, ok)],
                   dtype=object)
    return (out if dt.is_wide else out.astype(np.int64)), ok

