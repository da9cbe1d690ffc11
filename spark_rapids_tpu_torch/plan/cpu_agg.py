"""The CPU engine's aggregate and join (counterpart of
spark_rapids_tpu/plan/cpu_agg.py), vectorised with numpy.

``CpuAggregateExec`` is the hash aggregate in mode ``complete``: group keys
are factorised by hash (a null key is a group of its own; doubles group
with -0.0 as 0.0 and NaN as one value), groups come out in order of first
appearance, the rows are ordered by group once for the whole node and
every function reduces over that order, each distinct input
(sub-)expression is evaluated once (``cpu_eval``'s cache), and Sum, Count,
Average, Min and Max reduce with Spark's
result types: integer sums wrap as a long does, decimal sums are exact and
null past their precision, decimal averages round HALF_UP at the result
scale in integer arithmetic; CountDistinct counts each group's distinct
non-null values; CollectList each group's non-null values in row order
and CollectSet their distinct values, sorted (the reference sorts them),
the CPU engine's alone as in the reference. A global aggregate over no rows is one row (counts 0,
everything else null).

The rest of the family follows the device's rules (``exec/aggregate.py``):
the variance family and the covariances take central moments over the
inputs cast to DOUBLE, about each group's first non-null value (so a
common offset costs no digit and identical values give M2 = 0 exactly);
First/Last/AnyValue the first (last) non-null value in row order;
MinBy/MaxBy the value at the first least (greatest) non-null ordering of
any type (Spark's order: NaN above every double); string Min/Max in byte
order; BoolAnd/BoolOr and CountIf over the non-null booleans. The
reference's CPU-only aggregates run here alone: BitAndAgg/BitOrAgg/
BitXorAgg over the non-null integers, Percentile/Median by Spark's linear
interpolation at rank p * (n - 1) of the sorted non-null values.

``CpuJoinExec`` is the equi-join of every type the device runs (inner,
left, right, full, left_semi, left_anti): both sides' keys are factorised
together and null keys never match. Pairs come out in left-row order, each
left row's matches in right-row order; then the unpaired left rows of a
left or full join (null right columns) and the unpaired right rows of a
right or full join (null left columns). Semi and anti joins emit the
matched or unmatched left rows once each, in order. A residual
``condition`` is evaluated over every key-equal pair (the columns it reads
taken at the pair's rows) before any row counts as matched: a pair where
it is false or null is dropped, for all six join types.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.aggregate import _strip_alias, agg_inputs
from spark_rapids_tpu_torch.exec.base import DeviceExec
from spark_rapids_tpu_torch.exec.join import (
    JOIN_TYPES, PairCondition, join_schema)
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.plan import cpu_nested as CN
from spark_rapids_tpu_torch.plan.cpu import (
    CpuExec, _canonical_float, _half_up_div, _is_float, comparable,
    cpu_eval, expr_key, order_ranks, values_to_arrow)


def _factorize(vals: np.ndarray, valid: np.ndarray,
               dt: T.DataType) -> Tuple[np.ndarray, int]:
    """Codes 0..k-1 of the valid values and k for null; returns (codes,
    k + 1). The codes are by hash, not in value order: grouping, joins and
    distinct counts only need equality (doubles: -0.0 equals 0.0, NaN
    equals NaN; strings by bytes)."""
    v = vals[valid]
    if _is_float(dt):
        v = _canonical_float(v)
    if T.is_nested(dt):  # dicts and lists by their text
        v = np.array([repr(x) for x in v], dtype=object)
    codes, uniq = pd.factorize(v, use_na_sentinel=False)
    k = len(uniq)
    out = np.full(len(vals), k, np.int64)
    out[valid] = codes
    return out, k + 1


def _combine(codes: Sequence[np.ndarray], n: int) -> np.ndarray:
    """One dense id per distinct tuple of per-key codes."""
    gid = np.zeros(n, np.int64)
    for c in codes:
        gid, _ = pd.factorize(gid * (int(c.max()) + 1 if len(c) else 1) + c)
        gid = gid.astype(np.int64)
    return gid


class _Groups:
    """The rows of an aggregate node ordered by group, computed once and
    shared by all its functions: ``order`` (None for a global aggregate,
    whose rows are already one group) and each group's first position in
    it (``starts``). Every group holds at least one row."""

    def __init__(self, gid: np.ndarray, ng: int, keyed: bool):
        self.gid, self.ng = gid, ng
        self.order = np.argsort(gid, kind="stable") if keyed else None
        if keyed and len(gid):
            g = gid[self.order]
            self.starts = np.flatnonzero(np.r_[True, g[1:] != g[:-1]])
        else:
            self.starts = np.zeros(min(len(gid), 1), np.int64)

        self._all_counts = None

    def counts(self, valid: np.ndarray) -> np.ndarray:
        if valid.all():  # the rows' own counts, kept for the next function
            if self._all_counts is None:
                self._all_counts = np.bincount(self.gid, minlength=self.ng)
            return self._all_counts
        return np.bincount(self.gid[valid], minlength=self.ng)


def _group_sum(vals: np.ndarray, valid: np.ndarray, groups: _Groups,
               wrap: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(sum, any valid) per group. Doubles add in row order; integers in
    int64 (wrapping as Spark's long does when ``wrap``), else exactly as
    Python ints where int64 could overflow. Null rows add nothing."""
    ng, gid = groups.ng, groups.gid
    has = groups.counts(valid) > 0
    if vals.dtype.kind == "f":
        if valid.all():
            return np.bincount(gid, weights=vals, minlength=ng), has
        return np.bincount(gid[valid], weights=vals[valid],
                           minlength=ng), has
    live = vals[valid]
    safe = live.dtype != object and (
        wrap or len(live) == 0
        or max(abs(int(live.max())), abs(int(live.min()))) * len(live)
        < (1 << 62))
    out = np.zeros(ng, np.int64 if safe else object)
    if len(live):
        v = np.where(valid, vals, 0)
        if groups.order is not None:
            v = v[groups.order]
        if safe:
            with np.errstate(over="ignore"):
                out[:] = np.add.reduceat(v.astype(np.int64), groups.starts)
        else:
            bounds = list(groups.starts) + [len(v)]
            out[:] = [sum(int(x) for x in v[a:b])
                      for a, b in zip(bounds[:-1], bounds[1:])]
    return out, has


def _count_distinct(codes: np.ndarray, k: int, valid: np.ndarray,
                    gid: np.ndarray, ng: int) -> np.ndarray:
    """Distinct valid codes (0..k-1) per group: a bitmap of (group, code)
    pairs where it is small, else the sorted unique pairs."""
    pair = gid[valid] * k + codes[valid]
    if ng * k <= max(1 << 24, 4 * len(pair)):
        seen = np.zeros(ng * k, np.bool_)
        seen[pair] = True
        pair = np.flatnonzero(seen)
    else:
        pair = np.unique(pair)
    return np.bincount(pair // k, minlength=ng)


def _group_extreme(vals: np.ndarray, valid: np.ndarray, ranks: np.ndarray,
                   dt: T.DataType, groups: "_Groups", want_max: bool):
    """(min or max, any valid) per group in Spark order (``ranks``:
    ``order_ranks``'s)."""
    at = _arg_extreme_rows(ranks, valid, groups, want_max)
    has = at >= 0
    out = np.zeros(groups.ng, vals.dtype)
    if vals.dtype == object and dt in (T.STRING, T.BINARY):
        out[:] = "" if dt == T.STRING else b""
    out[has] = vals[at[has]]
    return out, has


def _decimal_avg(total: np.ndarray, count: np.ndarray,
                 shift_digits: int) -> np.ndarray:
    """round_half_up(total * 10**shift_digits / count) per group (count 0
    read as 1): exact integer arithmetic."""
    den = np.maximum(count, 1)
    if total.dtype != object:
        # divide first, then scale only the remainder (no int64 overflow),
        # as the device's decimal_avg_half_up
        k = np.int64(10 ** shift_digits)
        mag = np.abs(total)
        q1 = mag // den
        frac = (mag - q1 * den) * k
        fq = frac // den
        fr = frac - fq * den
        q = q1 * k + fq + (2 * fr >= den)
        return np.where(total < 0, -q, q)
    out = np.empty(len(total), dtype=object)
    out[:] = [_half_up_div(int(t) * 10 ** shift_digits, int(c))
              for t, c in zip(total, den)]
    return out


def _host_pair(pair):
    """A (values, valid) pair with a nested value as Python objects."""
    return CN.host_objects(pair[0]), pair[1]


def _collect(func: E.CollectList, out_t: T.DataType, groups: "_Groups",
             evaluate) -> pa.Array:
    """collect_list: each group's non-null values in row order;
    collect_set: their distinct values, sorted."""
    vals, valid = evaluate(func.child)
    py = values_to_arrow(vals, valid, func.child.dtype).to_pylist()
    out: List[list] = [[] for _ in range(groups.ng)]
    for g, v, ok in zip(groups.gid.tolist(), py, valid.tolist()):
        if ok:
            out[g].append(v)
    if isinstance(func, E.CollectSet):
        out = [sorted(set(x)) for x in out]
    return pa.array(out, type=out_t.arrow_type())


class CpuAggregateExec(CpuExec):
    def __init__(self, group_exprs: Sequence[E.Expression],
                 agg_exprs: Sequence[E.Expression], child: DeviceExec,
                 device):
        super().__init__(child, device=device)
        self.group_exprs = list(group_exprs)
        self.agg_exprs = list(agg_exprs)
        cs = child.output_schema
        self._keys = [E.resolve(e, cs) for e in self.group_exprs]
        self._aggs = []
        for e in self.agg_exprs:
            func, name = _strip_alias(e)
            if not isinstance(func, E.AGGREGATES):
                raise NotImplementedError(
                    f"aggregate {type(func).__name__} is not in the CPU "
                    f"engine yet")
            self._aggs.append((E.resolve(func, cs), name))
        fields = []
        for b in self._keys:
            inner, name = _strip_alias(b)
            fields.append(T.Field(name, inner.dtype, inner.nullable))
        for func, name in self._aggs:
            fields.append(T.Field(name, func.dtype, func.nullable))
        self._schema = T.Schema(fields)

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return 1  # it reads every partition of its child (or children)

    def node_description(self) -> str:
        return (f"CpuAggregate keys=[{', '.join(map(repr, self.group_exprs))}"
                f"] aggs=[{', '.join(map(repr, self.agg_exprs))}]")

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        t = self.all_child_rows(self.children[0])
        n = t.num_rows
        key_vals = [_host_pair(cpu_eval(b, t)) for b in self._keys]
        if key_vals:
            gid = _combine([_factorize(v, m, b.dtype)[0]
                            for (v, m), b in zip(key_vals, self._keys)], n)
            _, first = np.unique(gid, return_index=True)
            # groups in order of first appearance
            by_first = np.argsort(first, kind="stable")
            rank = np.empty(len(first), np.int64)
            rank[by_first] = np.arange(len(first))
            gid = rank[gid]
            first = first[by_first]
        else:
            gid = np.zeros(n, np.int64)
            first = np.zeros(0, np.int64)
        ng = len(first) if key_vals else 1
        groups = _Groups(gid, ng, bool(key_vals))
        cache: dict = {}  # each distinct (sub-)expression, evaluated once

        def evaluate(e: E.Expression):
            return _host_pair(cpu_eval(e, t, cache))

        arrays: List[pa.Array] = []
        for (v, m), f in zip(key_vals, self._schema):
            arrays.append(values_to_arrow(v[first], m[first], f.dtype))
        for (func, _name), f in zip(self._aggs,
                                    list(self._schema)[len(key_vals):]):
            arrays.append(self._reduce(func, f.dtype, n, groups, evaluate,
                                       cache))
        yield pa.Table.from_arrays(arrays, schema=self._schema.to_arrow())

    @staticmethod
    def _reduce(func, out_t: T.DataType, n: int, groups: _Groups,
                evaluate, memo: dict) -> pa.Array:
        gid, ng = groups.gid, groups.ng
        if isinstance(func, E.Count):
            valid = (evaluate(func.children[0])[1] if func.children
                     else np.ones(n, np.bool_))
            return values_to_arrow(groups.counts(valid),
                                   np.ones(ng, np.bool_), out_t)
        if isinstance(func, E.CollectList):
            return _collect(func, out_t, groups, evaluate)
        if not isinstance(func, _BASIC):
            return _reduce_family(func, out_t, groups, evaluate, memo)
        in_t = func.children[0].dtype
        vals, valid = evaluate(func.children[0])
        if isinstance(func, E.CountDistinct):
            codes, k = _factorize(vals, valid, in_t)
            return values_to_arrow(_count_distinct(codes, k, valid, gid, ng),
                                   np.ones(ng, np.bool_), out_t)
        if in_t in T.FRACTIONAL_TYPES:
            vals = _canonical_float(vals)
        if isinstance(func, (E.Min, E.Max)):
            ranks = _memo_ranks(memo, func.children[0], vals, valid)
            out, has = _group_extreme(vals, valid, ranks, in_t, groups,
                                      isinstance(func, E.Max))
            return values_to_arrow(out, has, out_t)
        total, has = _group_sum(vals, valid, groups,
                                wrap=in_t in T.INTEGRAL_TYPES)
        if isinstance(func, E.Sum):
            if isinstance(out_t, T.DecimalType):
                bound = 10 ** out_t.precision
                ok = np.array([abs(int(x)) < bound for x in total], np.bool_)
                total = np.where(ok, total, 0)
                return values_to_arrow(total, has & ok, out_t)
            return values_to_arrow(total, has, out_t)
        count = groups.counts(valid)
        if isinstance(out_t, T.DecimalType):
            avg = _decimal_avg(total, count, out_t.scale - in_t.scale)
            return values_to_arrow(avg, has, out_t)
        avg = total.astype(np.float64) / np.maximum(count, 1)
        return values_to_arrow(np.where(has, avg, 0.0), has, out_t)


_BASIC = (E.Sum, E.Count, E.Average, E.Min, E.Max, E.CountDistinct)


def _memo_ranks(memo: dict, e: E.Expression, vals: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
    """``order_ranks`` of the bound expression ``e``'s values, once per
    node (a Min and a Max, or a MinBy and a MaxBy, share them)."""
    key = ("#ranks", expr_key(e))
    if key not in memo:
        memo[key] = order_ranks(vals, valid, e.dtype)[0]
    return memo[key]


def _first_sorted(v: np.ndarray, groups: _Groups,
                  last: bool = False) -> np.ndarray:
    """Each group's first (``last``: last) row where ``v`` (given in the
    groups' row order) holds, as a row index, -1 where none."""
    n = len(v)
    if n == 0:
        return np.full(groups.ng, -1, np.int64)
    pos = np.arange(n)
    if last:
        at = np.maximum.reduceat(np.where(v, pos, -1), groups.starts)
    else:
        at = np.minimum.reduceat(np.where(v, pos, n), groups.starts)
    found = (at >= 0) & (at < n)
    at = np.clip(at, 0, n - 1)
    rows = at if groups.order is None else groups.order[at]
    return np.where(found, rows, -1)


def _sorted(a: np.ndarray, groups: _Groups) -> np.ndarray:
    """``a`` in the groups' row order."""
    return a if groups.order is None else a[groups.order]


def _first_rows(valid: np.ndarray, groups: _Groups,
                last: bool = False) -> np.ndarray:
    """Each group's first (``last``: last) row where ``valid``, -1 where
    none."""
    return _first_sorted(_sorted(valid, groups), groups, last)


def _shifted_mean(x: np.ndarray, valid: np.ndarray, groups: _Groups):
    """(count, mean, each row's distance from its group's mean; 0 where
    not valid): the mean taken about the group's first valid value."""
    gid, ng = groups.gid, groups.ng
    first = _first_rows(valid, groups)
    x0 = np.where(first >= 0, x[np.maximum(first, 0)] if len(x) else 0.0,
                  0.0)
    n = np.bincount(gid[valid], minlength=ng)
    with np.errstate(invalid="ignore"):
        y = np.where(valid, x - x0[gid], 0.0)
        mean = x0 + np.bincount(gid, weights=y, minlength=ng) / np.maximum(
            n, 1)
        return n, mean, np.where(valid, x - mean[gid], 0.0)


def _central_moments(x: np.ndarray, valid: np.ndarray, groups: _Groups):
    """(count, M2, M3, M4) per group: the sums of the powers of each valid
    value's distance from its group's mean."""
    gid, ng = groups.gid, groups.ng
    n, _mean, d = _shifted_mean(np.asarray(x, np.float64), valid, groups)
    with np.errstate(invalid="ignore", over="ignore"):
        d2 = d * d
        return (n,) + tuple(np.bincount(gid, weights=v, minlength=ng)
                            for v in (d2, d2 * d, d2 * d2))


def _moments(func, moments):
    """A variance-family result from ``_central_moments``: (values,
    valid)."""
    n, m2, m3, m4 = moments
    nf = n.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        m2 = np.where(m2 < 0, 0.0, m2)  # NaN stays NaN
        if isinstance(func, (E.Skewness, E.Kurtosis)):
            if isinstance(func, E.Skewness):
                out = np.sqrt(nf) * m3 / m2 ** 1.5
            else:
                out = nf * m4 / (m2 * m2) - 3.0
            return np.where(m2 == 0, np.nan, out), n > 0
        samp = isinstance(func, (E.VarianceSamp, E.StddevSamp))
        out = m2 / np.maximum(nf - 1 if samp else nf, 1.0)
        if isinstance(func, (E.StddevSamp, E.StddevPop)):
            out = np.sqrt(out)
    return out, (n > 1) if samp else (n > 0)


def _comoments(func, cols, groups: _Groups):
    """A covariance or correlation over the pairs with both sides non-null:
    (values, valid)."""
    gid, ng = groups.gid, groups.ng
    (x, vx), (y, vy) = cols
    pair = vx & vy
    n, _mx, dx = _shifted_mean(np.asarray(x, np.float64), pair, groups)
    _n, _my, dy = _shifted_mean(np.asarray(y, np.float64), pair, groups)

    def total(v):
        return np.bincount(gid, weights=v, minlength=ng)

    nf = n.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        c = total(dx * dy)
        if isinstance(func, E.CovarPop):
            return c / np.maximum(nf, 1.0), n > 0
        if isinstance(func, E.CovarSamp):
            return c / np.maximum(nf - 1, 1.0), n > 1
        mx, my = total(dx * dx), total(dy * dy)
        den = np.sqrt(np.where(mx < 0, 0.0, mx) * np.where(my < 0, 0.0, my))
        # null where either variance is 0 (or NaN), as the reference's
        ok = (n > 0) & (den > 0)
        return np.where(ok, c / np.where(ok, den, 1.0), 0.0), ok


def _arg_extreme_rows(ranks: np.ndarray, ovalid, groups: _Groups,
                      want_max: bool) -> np.ndarray:
    """Each group's first row at its least (greatest) non-null ordering
    (``ranks``: ``order_ranks``'s, in Spark's order), -1 where none."""
    big = np.iinfo(np.int64).max
    k = _sorted(np.where(ovalid, -ranks if want_max else ranks, big), groups)
    if not len(k):
        return np.full(groups.ng, -1, np.int64)
    best = np.minimum.reduceat(k, groups.starts)
    seg = np.repeat(np.arange(len(groups.starts)),
                    np.diff(np.append(groups.starts, len(k))))
    return _first_sorted((k == best[seg]) & _sorted(ovalid, groups), groups)


def _bit_reduce(func, vals, valid, groups: _Groups):
    """bit_and/or/xor of each group's non-null values (null where none):
    one reduction over the rows in group order, null rows at the
    operation's identity."""
    ufunc = (np.bitwise_xor if isinstance(func, E.BitXorAgg) else
             np.bitwise_or if isinstance(func, E.BitOrAgg) else
             np.bitwise_and)
    v = np.asarray(vals)
    ident = -1 if ufunc is np.bitwise_and else 0
    has = groups.counts(valid) > 0
    if not len(v):
        return np.zeros(groups.ng, v.dtype), has
    out = ufunc.reduceat(_sorted(np.where(valid, v, v.dtype.type(ident)),
                                 groups), groups.starts)
    return np.where(has, out, 0).astype(v.dtype), has


def _percentile(func, x, valid, gid: np.ndarray, ng: int):
    """Spark's exact percentile: linear interpolation at rank p * (n - 1)
    of each group's sorted non-null values."""
    x = np.asarray(x, np.float64)
    rows = np.flatnonzero(valid)
    rows = rows[np.argsort(x[rows])]
    rows = rows[np.argsort(gid[rows], kind="stable")]
    xs = x[rows]
    n = np.bincount(gid[rows], minlength=ng)
    start = np.cumsum(n) - n
    has = n > 0
    r = func.percentage * np.maximum(n - 1, 0)
    lo, hi = np.floor(r).astype(np.int64), np.ceil(r).astype(np.int64)
    if not len(xs):
        return np.zeros(ng), has
    a = xs[np.clip(start + lo, 0, len(xs) - 1)]
    b = xs[np.clip(start + hi, 0, len(xs) - 1)]
    with np.errstate(invalid="ignore"):
        return np.where(has, a + (b - a) * (r - lo), 0.0), has


def _reduce_family(func, out_t: T.DataType, groups: _Groups, evaluate,
                   memo: dict) -> pa.Array:
    """The aggregates beyond Sum/Count/Average/Min/Max/CountDistinct
    (``memo`` keeps what several of them share)."""
    gid, ng = groups.gid, groups.ng
    inputs = agg_inputs(func)
    cols = [evaluate(e) for e in inputs]
    if isinstance(func, E._VarianceBase):
        # one set of central moments for every function of one input
        key = ("#moments", expr_key(inputs[0]))
        if key not in memo:
            memo[key] = _central_moments(*cols[0], groups)
        return values_to_arrow(*_moments(func, memo[key]), out_t)
    if isinstance(func, E._CovarianceBase):
        return values_to_arrow(*_comoments(func, cols, groups), out_t)
    if isinstance(func, E.MinBy):
        (vals, valid), (ovals, ovalid) = cols
        at = _arg_extreme_rows(_memo_ranks(memo, inputs[1], ovals, ovalid),
                               ovalid, groups, isinstance(func, E.MaxBy))
        safe = np.maximum(at, 0)
        return values_to_arrow(vals[safe] if len(vals) else
                               np.zeros(ng, vals.dtype),
                               (at >= 0) & (valid[safe] if len(valid)
                                            else False), out_t)
    (vals, valid), = cols
    if isinstance(func, (E.First, E.Last, E.AnyValue)):
        at = _first_rows(valid, groups, last=isinstance(func, E.Last))
        safe = np.maximum(at, 0)
        return values_to_arrow(vals[safe] if len(vals) else
                               np.zeros(ng, vals.dtype), at >= 0, out_t)
    if isinstance(func, E.CountIf):
        return values_to_arrow(groups.counts(valid & vals.astype(np.bool_)),
                               np.ones(ng, np.bool_), out_t)
    if isinstance(func, E.BoolAnd):
        has = groups.counts(valid) > 0
        if isinstance(func, E.BoolOr):
            out = groups.counts(valid & vals.astype(np.bool_)) > 0
        else:
            out = groups.counts(valid & ~vals.astype(np.bool_)) == 0
        return values_to_arrow(out & has, has, out_t)
    if isinstance(func, E.BitAndAgg):
        return values_to_arrow(*_bit_reduce(func, vals, valid, groups),
                               out_t)
    if isinstance(func, E.Percentile):
        x, xv = evaluate(E.Cast(func.child, T.DOUBLE)
                         if func.child.dtype != T.DOUBLE else func.child)
        return values_to_arrow(*_percentile(func, x, xv, gid, ng), out_t)
    raise NotImplementedError(
        f"aggregate {type(func).__name__} is not in the CPU engine yet")


class CpuJoinExec(CpuExec):
    """Equi-join of two children on the host, of any type in
    ``JOIN_TYPES``."""

    def __init__(self, left_keys: Sequence[E.Expression],
                 right_keys: Sequence[E.Expression], join_type: str,
                 left: DeviceExec, right: DeviceExec, device,
                 condition: Optional[E.Expression] = None):
        if join_type not in JOIN_TYPES:
            raise NotImplementedError(
                f"{join_type} join is not in the port yet")
        super().__init__(left, right, device=device)
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        ls, rs = left.output_schema, right.output_schema
        self._lk = [E.resolve(k, ls) for k in self.left_keys]
        self._rk = [E.resolve(k, rs) for k in self.right_keys]
        self._schema = join_schema(ls, rs, join_type)
        self.condition = condition
        self._cond = (PairCondition(condition, ls, rs)
                      if condition is not None else None)

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def num_partitions(self) -> int:
        return 1  # it reads every partition of its child (or children)

    def node_description(self) -> str:
        cond = (f" condition={self.condition!r}"
                if self.condition is not None else "")
        return (f"CpuJoin {self.join_type} "
                f"keys={list(zip(self.left_keys, self.right_keys))}{cond}")

    def _condition_holds(self, lt: pa.Table, li: np.ndarray, rt: pa.Table,
                         ri: np.ndarray) -> np.ndarray:
        """Per pair (left row ``li``, right row ``ri``): whether the
        condition is true (null is not)."""
        c = self._cond
        arrays = [lt.column(i).take(pa.array(li)) if i < c.n_left
                  else rt.column(i - c.n_left).take(pa.array(ri))
                  for i in c.columns]
        pair = pa.Table.from_arrays(arrays, names=[f"c{j}" for j in
                                                   range(len(arrays))])
        vals, valid = cpu_eval(c.bound, pair)
        return np.asarray(vals, np.bool_) & valid

    def execute_host(self, partition: int = 0) -> Iterator[pa.Table]:
        jt = self.join_type
        lt = self.all_child_rows(self.children[0])
        rt = self.all_child_rows(self.children[1])
        nl, nr = lt.num_rows, rt.num_rows
        lok, rok = np.ones(nl, np.bool_), np.ones(nr, np.bool_)
        codes = []
        for lb, rb in zip(self._lk, self._rk):
            lv, lm = cpu_eval(lb, lt)
            rv, rm = cpu_eval(rb, rt)
            a, b, is_float = comparable(lv, lb.dtype, rv, rb.dtype)
            code, _ = _factorize(np.concatenate([a, b]),
                                 np.concatenate([lm, rm]),
                                 T.DOUBLE if is_float else lb.dtype)
            codes.append(code)
            lok &= lm
            rok &= rm
        key = _combine(codes, nl + nr)  # dense ids 0..k-1
        lkey, rkey = key[:nl], key[nl:]
        rrows = np.flatnonzero(rok)
        rrows = rrows[np.argsort(rkey[rrows], kind="stable")]
        # the right rows of each id: a count and a start per id
        per_key = np.bincount(rkey[rrows], minlength=int(key.max(
            initial=-1)) + 1)
        lrows = np.flatnonzero(lok)
        cnt = per_key[lkey[lrows]]
        lo = (np.cumsum(per_key) - per_key)[lkey[lrows]]
        lmatched = np.zeros(nl, np.bool_)
        semi = jt in ("left_semi", "left_anti")
        if semi and self._cond is None:  # no pair is needed
            lmatched[lrows[cnt > 0]] = True
            keep = lmatched if jt == "left_semi" else ~lmatched
            yield lt.filter(pa.array(keep))
            return
        total = int(cnt.sum())
        li = np.repeat(lrows, cnt)
        offs = np.repeat(np.cumsum(cnt) - cnt, cnt)
        ri = rrows[np.arange(total) - offs + np.repeat(lo, cnt)]
        if self._cond is not None:
            holds = self._condition_holds(lt, li, rt, ri)
            li, ri = li[holds], ri[holds]
            total = len(li)
        lmatched[li] = True
        if semi:
            keep = lmatched if jt == "left_semi" else ~lmatched
            yield lt.filter(pa.array(keep))
            return
        lnull, rnull = np.zeros(total, np.bool_), np.zeros(total, np.bool_)
        if jt in ("left", "full"):
            lonly = np.flatnonzero(~lmatched)
            li = np.concatenate([li, lonly])
            ri = np.concatenate([ri, np.zeros(len(lonly), np.int64)])
            lnull = np.concatenate([lnull, np.zeros(len(lonly), np.bool_)])
            rnull = np.concatenate([rnull, np.ones(len(lonly), np.bool_)])
        if jt in ("right", "full"):
            rmatched = np.zeros(nr, np.bool_)
            rmatched[ri[~rnull]] = True
            ronly = np.flatnonzero(~rmatched)
            li = np.concatenate([li, np.zeros(len(ronly), np.int64)])
            ri = np.concatenate([ri, ronly])
            lnull = np.concatenate([lnull, np.ones(len(ronly), np.bool_)])
            rnull = np.concatenate([rnull, np.zeros(len(ronly), np.bool_)])
        # a null index takes a null row
        left = lt.take(pa.array(li, pa.int64(), mask=lnull))
        right = rt.take(pa.array(ri, pa.int64(), mask=rnull))
        yield pa.Table.from_arrays(list(left.columns) + list(right.columns),
                                   schema=self._schema.to_arrow())
