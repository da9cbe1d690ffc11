"""Plan rewrite: tag -> convert -> explain, with per-operator CPU fallback
(counterpart of spark_rapids_tpu/plan/overrides.py).

  LogicalPlan -> PlanMeta tree --tag--> device-or-CPU decision per node
             --convert--> device operators and CpuExec nodes (the
             transitions live in CpuExec) --> explain string

Tagging holds every bound expression to the device's declarations
(``check_expr``: the expression set, each class's ``type_support``, the
expressions with a DECIMAL128 implementation (``WIDE_OK``), the decimal
Divide's rescale range, and the device's own refusals such as string
ordering comparisons, MinBy/MaxBy over a float, string or decimal
ordering or a string or decimal value, float -> string, string -> decimal
and ANSI string casts, decimal floor/ceil/round and decimal IntegralDivide,
Remainder and Pmod, an RLIKE pattern outside the regex subset ("regex not
on device: ..."), each with the reference's reason; Rand and the
reference's CPU-only string classes (``device_supported`` False: Bin, the
digests, Crc32, Levenshtein, FormatNumber, StringSpace, RegexpExtract,
RegexpReplace, and Overlay without a FOR length) are outside the device's
set, as the reference's planner keeps them; an expression that touches a
STRUCT, MAP or ARRAY value outside ``NESTED_OK``, map_keys of a
variable-width or DECIMAL128 key, element_at over variable-width keys,
values or elements, array_contains beyond fixed-width elements, and
get_json_object of a path outside ``json_device.parse_path``'s grammar,
each with the reference's reason), and each node to its
operator's:
a DECIMAL128 group key, join key or window Min/Max, a nested group, sort
or join key, a struct with variable-width fields beside a join, and a
Skewness or Kurtosis window, stay on the CPU engine, as in the
reference. So do, beyond the reference (whose upload fails on them), a
column of arrays with a null element (its scan and every node that
reads it) and an array of variable-width elements (collect_list of a
string makes one). The
reference's CPU-only aggregates (BitAndAgg/BitOrAgg/BitXorAgg,
Percentile/Median) are outside the device's expression set. A node with
reasons runs on the CPU engine when
``spark.rapids.gpu.sql.fallback.enabled`` is true (the default) and raises
NotImplementedError naming them when it is false; with
``spark.rapids.gpu.sql.enabled`` false every node runs on the CPU engine.
Placement is decided here, at plan time, and nowhere else. A node that
neither side can run (a window the device refuses, a join type outside
inner/left/right/full/left_semi/left_anti, an expression outside the port)
raises NotImplementedError with the reasons.

Partitions are planned as the reference plans them, with its adaptive
execution (AQE), exchange and broadcast reuse, prefetch and dynamic
partition pruning, at its defaults; its fusion is not in the port. An
in-memory scan has ``min(partitions, batches)`` source splits, a Parquet
scan ``min(files, shuffle partitions)`` (``exec/scan.ParquetScanExec``;
the CPU engine's ``CpuParquetScanExec`` one); its paths are rewritten by
``spark.rapids.gpu.alluxio.pathsToReplace`` (``io/paths.py``) before any
footer is read. A query whose scan leaves all sit under the fast path's
row and byte bounds (a Parquet leaf: at most 16 files, its footers' rows
and its files' sizes on disk) plans one shuffle partition instead of
``shuffle_partitions``. Above a child with more than one partition the
planner places:

- an aggregate: partial, a hash exchange on the keys (a single-partition
  exchange when there is no key), final;
- a window: a hash exchange on its partition keys when they are columns,
  else a single-partition exchange; a group that streams
  (``exec/window.plan_stream_mode``, with
  ``spark.rapids.gpu.sql.window.streaming.enabled``) reads an out-of-core
  sort, every other one reads one batch per partition
  (``CoalesceBatchesExec``);
- a global sort: a range exchange on one numeric or date key sampled
  from the first batch of each child partition, else a single-partition
  exchange; a sort with a limit is a top-k per partition, gathered and
  merged (``take_ordered_and_project``) at any partition count;
- a join: a broadcast hash join (inner, left, semi, anti) when the right
  side's estimated rows (``cbo.estimate_rows``) are at most
  ``spark.rapids.gpu.sql.join.broadcastRowThreshold``, its build side a
  ``ReplayExec`` run once, else a shuffled hash join over two hash
  exchanges; a multi-partition right side under a one-partition left side
  takes a single-partition exchange. An inner, left-semi or right join
  whose left side is a Parquet scan (under filters and coalesces only)
  gives the scan a ``DynamicPruningFilter`` per key column of the scan
  (``spark.rapids.gpu.sql.dynamicPartitionPruning.enabled``): its build
  is the join's broadcast ``ReplayExec``, its raw right exchange, its
  single-partition exchange, or else a ``ReplayExec`` that the join then
  reads too.

With ``spark.rapids.gpu.sql.adaptive.enabled`` (the default) an AQE
reader (``shuffle/aqe.py``) reads each hash exchange of an aggregate and
a window and each range exchange, coalescing small reduce partitions, and
a shuffled join reads its two exchanges through a pair of skew-aware
readers. Every partition-count decision is made by ``_planned_parts``,
inside ``planning_scope``, so planning writes no exchange (the range
sample alone runs its child). After conversion, ``plan/reuse.apply_reuse``
aliases equal exchange and broadcast-build subtrees
(``spark.rapids.gpu.sql.exchange.reuse.enabled``), then, off the fast
path, ``exec/pipeline.insert_prefetch`` places the prefetch boundaries
(``spark.rapids.gpu.sql.prefetch.enabled``). The three keys false give
the plan without them.

A union has the partitions of all its children, and a limit one.
``explain`` shows, on each converted node's line, the exchanges, AQE
readers, reused exchanges and broadcasts, prefetch boundaries and the
join strategy placed between it and its children's conversions.

Before tagging, every union branch whose column types differ from the
union's (``L.union_widen``) gets a Project of Casts to them
(``widen_unions``, Spark's WidenSetOperationTypes), which is tagged like
any projection: on the device when the device has the cast, else on the
CPU engine, named by ``explain``. A join's residual condition is checked
like a filter's, over the pair schema (left columns, then right).

``apply`` is memoised (``plan/plan_cache.py``,
``spark.rapids.gpu.plan.cache.enabled``, on by default as the reference's
key): a repeat of a rename-equal plan under the same configuration is
lent the tree built the first time, and skips every step below (the
range exchange's sample too); ``execute_to_arrow`` gives it back after
the run.

Before tagging, with ``spark.rapids.gpu.sql.enabled`` true, an aggregate
with COUNT(DISTINCT x) is rewritten for the device (``rewrite_distinct``,
Spark's RewriteDistinctAggregates): the regular aggregate joined on its
keys with one Count over each (keys, x)-distinct sub-aggregate, on a
constant ``#one`` key when there are no keys. ``explain`` shows the
rewritten plan.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import weakref
from typing import List, Optional, Set

import numpy as np

from spark_rapids_tpu_torch import support
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ELEMENT_NULLS, array_element_nulls, batch_from_arrow,
    dictionary_encode_table)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.aggregate import (
    HashAggregateExec, _strip_alias)
from spark_rapids_tpu_torch.exec.base import BatchSourceExec, DeviceExec
from spark_rapids_tpu_torch.exec.dpp import DynamicPruningFilter, ReplayExec
from spark_rapids_tpu_torch.exec.join import JOIN_TYPES, HashJoinExec
from spark_rapids_tpu_torch.exec.join_bcast import BroadcastHashJoinExec
from spark_rapids_tpu_torch.exec.misc import (
    CoalesceBatchesExec, GlobalLimitExec, UnionExec,
    take_ordered_and_project)
from spark_rapids_tpu_torch.exec.pipeline import PrefetchExec, insert_prefetch
from spark_rapids_tpu_torch.exec.project import FilterExec, ProjectExec
from spark_rapids_tpu_torch.exec.reuse import (
    ReusedBroadcastExec, ReusedExchangeExec)
from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
from spark_rapids_tpu_torch.exec.sort import SortExec, SortOrder
from spark_rapids_tpu_torch.exec.window import (
    WindowExec, bind_function, check_window, plan_stream_mode)
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import json_device as JD
from spark_rapids_tpu_torch.exprs import regex as RX
from spark_rapids_tpu_torch.exprs import window as W
from spark_rapids_tpu_torch.plan import cbo as CBO
from spark_rapids_tpu_torch.plan import cpu as CPU
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache as PC
from spark_rapids_tpu_torch.plan.cpu_agg import CpuAggregateExec, CpuJoinExec
from spark_rapids_tpu_torch.plan.cpu_window import CpuWindowExec
from spark_rapids_tpu_torch.plan.reuse import apply_reuse
from spark_rapids_tpu_torch.shuffle.aqe import (
    AQEShuffleReadExec, pair_for_skew_join, planning_scope)
from spark_rapids_tpu_torch.shuffle.exchange_exec import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.partition import (
    HashPartitioner, RangePartitioner, SinglePartitioner)


# uploaded batches per (arrow table, batch_rows, device, partitions), so
# plans over one table reuse one upload; an entry drops when its table is
# collected
_SOURCE_CACHE: dict = {}
_SOURCE_LOCK = threading.Lock()


def source_batches(node: L.InMemoryScan):
    """Upload a table as device batches of ``batch_rows`` rows, split into
    ``min(partitions, batches)`` source partitions, batch ``i`` in split
    ``i % splits`` (the reference's split). Strings are dictionary-encoded
    once for the whole table, so every batch shares one device
    dictionary."""
    key = (id(node.table), node.batch_rows, node.device, node.partitions)
    with _SOURCE_LOCK:
        ent = _SOURCE_CACHE.get(key)
        if ent is not None and ent[0]() is node.table:
            return ent[1]
    t = dictionary_encode_table(node.table)
    cache: dict = {}
    batches = [batch_from_arrow(t.slice(i, node.batch_rows), node.device,
                                dict_cache=cache)
               for i in range(0, max(t.num_rows, 1), node.batch_rows)]
    n_parts = max(1, min(node.partitions, len(batches)))
    parts = [batches[p::n_parts] for p in range(n_parts)]
    ref = weakref.ref(node.table,
                      lambda _r, k=key: _SOURCE_CACHE.pop(k, None))
    with _SOURCE_LOCK:
        _SOURCE_CACHE[key] = (ref, parts)
    return parts


# ---------------------------------------------------------------------------
# device support
# ---------------------------------------------------------------------------

_ORDERING = (E.LessThan, E.LessThanOrEqual, E.GreaterThan,
             E.GreaterThanOrEqual)


# the expressions with a DECIMAL128 device implementation (the reference's
# ``_WIDE_OK``, limited to the port's expressions): any other expression
# that takes or gives a DECIMAL128 value runs on the CPU engine
WIDE_OK = (E.Alias, E.ColumnRef, E.UnresolvedColumn, E.Literal, E.Cast,
           E.Add, E.Subtract, E.Multiply, E.Divide, E.Abs, E.UnaryMinus,
           E.BinaryComparison, E.IsNull, E.IsNotNull, E.If, E.CaseWhen,
           E.Coalesce, E.Sum, E.Min, E.Max, E.Average, E.Count, E.First,
           E.Last, E.Greatest)

# the expressions with a device implementation over a STRUCT, MAP or ARRAY
# operand or result (the reference's ``_NESTED_OK``): any other expression
# that touches a nested value runs on the CPU engine
NESTED_OK = (E.Alias, E.ColumnRef, E.UnresolvedColumn, E.GetStructField,
             E.CreateNamedStruct, E.MapKeys, E.Size, E.ElementAt,
             E.ArrayContains, E.IsNull, E.IsNotNull)

_STRINGY = (T.STRING, T.BINARY)


def _struct_has_varwidth(dt: T.DataType) -> bool:
    return isinstance(dt, T.StructType) and any(
        not f.dtype.fixed_width or _struct_has_varwidth(f.dtype)
        for f in dt.fields)


def _varwidth_array(dt: T.DataType) -> bool:
    """Whether ``dt`` holds an ARRAY of variable-width elements, which has
    no device layout (``collect_list`` of a string makes one)."""
    if isinstance(dt, T.ArrayType):
        return not dt.element.fixed_width
    if isinstance(dt, T.StructType):
        return any(_varwidth_array(f.dtype) for f in dt.fields)
    if isinstance(dt, T.MapType):
        return _varwidth_array(dt.key) or _varwidth_array(dt.value)
    return False


def _nested_reasons(bound: E.Expression) -> List[str]:
    """The reference's nested gates: the expressions of ``NESTED_OK``
    only, map_keys of a fixed-width (not DECIMAL128) key, element_at of
    fixed-width keys and values or elements, array_contains of fixed-width
    elements and value, and a JSON path inside ``parse_path``'s grammar."""
    out: List[str] = []
    kids = [c.dtype for c in bound.children]
    if ((T.is_nested(bound.dtype) or any(T.is_nested(k) for k in kids))
            and not isinstance(bound, NESTED_OK)):
        out.append(f"{type(bound).__name__} not on device for nested types")
    if isinstance(bound, E.MapKeys):
        kdt = bound.child.dtype.key
        if not kdt.fixed_width or T.is_wide_decimal(kdt):
            out.append("map_keys key type not on device")
    if isinstance(bound, E.ElementAt):
        ct = bound.left.dtype
        if isinstance(ct, T.MapType):
            if (not ct.key.fixed_width or T.is_wide_decimal(ct.key)
                    or not ct.value.fixed_width):
                out.append("element_at key/value type not on device")
        elif not ct.element.fixed_width:
            out.append("element_at element type not on device")
    if isinstance(bound, E.ArrayContains):
        ct, vt = bound.left.dtype, bound.right.dtype
        if not (isinstance(ct, T.ArrayType) and ct.element.fixed_width
                and vt.fixed_width and not T.is_wide_decimal(ct.element)
                and not T.is_wide_decimal(vt)):
            out.append("array_contains type not on device")
    if isinstance(bound, E.GetJsonObject) and JD.parse_path(
            bound.path) is None:
        out.append(f"json path {bound.path!r} not on device")
    return out


# the window functions with a DECIMAL128 device implementation (Lead covers
# Lag)
_WIDE_WINDOW_OK = (E.Sum, E.Average, E.Count, E.First, E.Last, W.Lead)


def check_expr(expr: E.Expression, schema: T.Schema,
               conf: Optional[C.RapidsConf] = None) -> List[str]:
    """Reasons this expression cannot run on the device (empty: it can).
    ``conf`` (the active one by default) bounds an RLIKE's automaton."""
    reasons: List[str] = []
    max_states = C.REGEX_MAX_DFA_STATES.get(conf or C.get_active())

    def walk(e: E.Expression):
        if type(e) not in E.SUPPORTED or not getattr(
                e, "device_supported", True):
            reasons.append(f"expression {type(e).__name__} not on device")
            return
        bound = E.resolve(e, schema)
        name = type(bound).__name__
        decl = type(bound).type_support
        if not isinstance(bound, E.Alias):
            bad_in = [c.dtype for c in bound.children
                      if not decl.ok(c.dtype)]
            if bad_in:
                reasons.append(f"{name} does not support "
                               f"{support.classify(bad_in[0])} inputs")
            if not decl.ok(bound.dtype, output=True):
                reasons.append(f"{name} does not support "
                               f"{support.classify(bound.dtype)} outputs")
        if ((T.is_wide_decimal(bound.dtype) or any(
                T.is_wide_decimal(c.dtype) for c in bound.children))
                and not isinstance(bound, WIDE_OK)):
            reasons.append(f"{name} not on device for decimal128")
        if isinstance(bound, E.Cast) and not E.cast_supported(
                bound.child.dtype, bound.to):
            reasons.append(f"cast {bound.child.dtype} -> {bound.to} not "
                           f"on device")
        elif (isinstance(bound, E.Cast)
              and T.is_wide_decimal(bound.child.dtype)
              and isinstance(bound.to, T.DecimalType)
              and bound.child.dtype.scale - bound.to.scale > 18):
            reasons.append("decimal128 scale reduction > 18 not on device")
        if isinstance(bound, E.Cast):
            # the casts the reference's device does not format or parse
            cdt = bound.child.dtype
            if cdt in T.FRACTIONAL_TYPES and bound.to == T.STRING:
                reasons.append("float to string cast not on device")
            if cdt == T.STRING and isinstance(bound.to, T.DecimalType):
                reasons.append("string to decimal cast not on device")
            if cdt == T.STRING and bound.ansi:
                reasons.append("ANSI string cast not on device")
        if isinstance(bound, (E.Floor, E.Round)) and isinstance(
                bound.child.dtype, T.DecimalType):
            reasons.append("decimal floor/ceil/round not on device")
        if isinstance(bound, (E.IntegralDivide, E.Remainder)) and any(
                isinstance(c.dtype, T.DecimalType) for c in bound.children):
            reasons.append("decimal division not on device")
        if isinstance(bound, E.Divide) and isinstance(bound.dtype,
                                                      T.DecimalType):
            s1 = getattr(bound.left.dtype, "scale", 0)
            s2 = getattr(bound.right.dtype, "scale", 0)
            k = bound.dtype.scale - s1 + s2
            if not 0 <= k <= 76:
                reasons.append("decimal divide rescale outside device range")
        if isinstance(bound, E.BinaryComparison) and (
                bound.left.dtype in _STRINGY
                or bound.right.dtype in _STRINGY):
            if isinstance(bound, _ORDERING):
                reasons.append("string ordering comparison not on device")
        if (isinstance(bound, E.In) and bound.value.dtype in _STRINGY
                and not all(isinstance(i, E.Literal) for i in bound.items)):
            reasons.append("string IN over non-literal items not on device")
        if isinstance(bound, E.MinBy):
            # the device picks by an integral, boolean, date or timestamp
            # ordering and gathers a fixed-width value (the reference's
            # gate)
            odt, vdt = bound.ordering.dtype, bound.value.dtype
            if (odt in T.FRACTIONAL_TYPES or odt in _STRINGY
                    or vdt in _STRINGY
                    or isinstance(odt, T.DecimalType)
                    or isinstance(vdt, T.DecimalType)):
                reasons.append(
                    "min_by/max_by ordering/value type not on device")
        if isinstance(bound, (E.StartsWith, E.EndsWith, E.Contains)) and (
                not isinstance(bound.right, E.Literal)):
            reasons.append("string search of a column pattern not on device")
        reasons.extend(_nested_reasons(bound))
        # a pattern the regex subset rejects (the reference's transpiler
        # bail-outs) runs on the CPU engine
        if isinstance(bound, E.RLike):
            try:
                RX.compile_rlike(bound.pattern, max_states)
            except RX.RegexUnsupported as rex:
                reasons.append(f"regex not on device: {rex}")
        # the bound children: resolve may add Casts (conditional branches)
        for c in bound.children:
            walk(c)

    walk(expr)
    return reasons


def pair_schema(node: L.Join) -> T.Schema:
    """The schema a join's condition is bound against: the left columns,
    then the right (for semi and anti joins too)."""
    return T.Schema(list(node.left.schema) + list(node.right.schema))


def _node_exprs(node: L.LogicalPlan) -> List[E.Expression]:
    """The expressions a Project, Filter, Aggregate or Sort evaluates over
    its child's rows."""
    if isinstance(node, L.Project):
        return list(node.exprs)
    if isinstance(node, L.Filter):
        return [node.condition]
    if isinstance(node, L.Aggregate):
        return list(node.group_exprs) + list(node.agg_exprs)
    if isinstance(node, L.Sort):
        return [o.child for o in node.orders]
    return []


def _window_reasons(node: L.Window, device: bool = True) -> List[str]:
    """Why the device's WindowExec (``device``) or the CPU engine's
    window operator cannot run this node: both have the window surface of
    ``exec/window.py`` (``check_window``: the bounded-RANGE order-key rule
    among them), and the device no DECIMAL128 window Min/Max."""
    check = check_expr if device else CPU.cpu_unsupported
    schema = node.child.schema
    reasons: List[str] = []
    for e in node.window_exprs:
        inner = e.child if isinstance(e, E.Alias) else e
        if not isinstance(inner, W.WindowExpression):
            reasons.append(f"not a window expression: {e!r}")
            continue
        spec = inner.spec
        try:
            fn = bind_function(inner.function, schema)
        except NotImplementedError as ex:
            reasons.append(str(ex))
            continue
        # an aggregate is checked whole (its type support), First/Last and
        # the other window functions by their inputs
        whole = isinstance(fn, E.AggregateExpression) and not isinstance(
            fn, (E.First, E.Last))
        for x in (list(spec.partition_by) + [o.child for o in spec.order_by]
                  + ([fn] if whole else list(fn.children))):
            reasons.extend(check(x, schema))
        if device and (T.is_wide_decimal(fn.dtype) or any(
                T.is_wide_decimal(c.dtype) for c in fn.children)) and \
                not isinstance(fn, _WIDE_WINDOW_OK):
            reasons.append("decimal128 window function not on device")
        if device and isinstance(fn, (E.Skewness, E.Kurtosis)):
            reasons.append("skewness/kurtosis window functions not on "
                           "device")
        order_keys = [(E.resolve(o.child, schema), o.ascending)
                      for o in spec.order_by]
        try:
            check_window(fn, spec.resolved_frame(), order_keys)
        except NotImplementedError as ex:
            reasons.append(str(ex))
    return list(dict.fromkeys(reasons))


# ---------------------------------------------------------------------------
# meta tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanMeta:
    node: L.LogicalPlan
    children: List["PlanMeta"]
    reasons: List[str] = dataclasses.field(default_factory=list)
    # the exchanges and join strategy the conversion placed for this node
    physical: List[str] = dataclasses.field(default_factory=list)
    # the output columns holding arrays with null elements (no device
    # layout; ``Overrides._tag_element_nulls``)
    host_columns: Set[str] = dataclasses.field(default_factory=set)

    def will_not_work(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_run_on_device(self) -> bool:
        return not self.reasons


def explain(meta: PlanMeta, mode: str = "ALL") -> str:
    """The tag tree (spark.rapids.sql.explain): ``*`` on the device, ``!``
    on the CPU engine with its reasons; NOT_ON_GPU lists only the ``!``
    nodes."""
    lines: List[str] = []

    def walk(m: PlanMeta, depth: int):
        if mode == "ALL" or not m.can_run_on_device:
            line = (f"{'  ' * depth}{'*' if m.can_run_on_device else '!'} "
                    f"{m.node.describe()}")
            if m.reasons:
                line += "  cannot run on GPU because " + "; ".join(m.reasons)
            if m.physical:
                line += "  [" + "; ".join(m.physical) + "]"
            lines.append(line)
        for c in m.children:
            walk(c, depth + 1)

    walk(meta, 0)
    return "\n".join(lines) if lines else "(entire plan runs on GPU)"


def join_paths(node) -> List[str]:
    """The path each join of an executed physical plan took, in plan
    order: ``ht`` (the device hash table and its probe kernel), ``sorted``
    (the device sorted-hash path), ``empty`` (a device join whose build
    side had no row) or ``cpu`` (the CPU engine)."""
    out: List[str] = []

    def walk(n):
        if isinstance(n, HashJoinExec):
            out.append(n.join_path or "empty")
        elif isinstance(n, CpuJoinExec):
            out.append("cpu")
        for c in n.children:
            walk(c)

    walk(node)
    return out


# one planner at a time: apply sets the process-wide active conf
_APPLY_LOCK = threading.RLock()


class Overrides:
    def __init__(self, conf: Optional[C.RapidsConf] = None,
                 shuffle_partitions: int = 4):
        self.conf = conf or C.RapidsConf()
        self.shuffle_partitions = shuffle_partitions
        self._parts = shuffle_partitions  # this plan's, after the fast path
        self._converted: list = []  # (meta, converted node, its kids' ids)

    # -- tag ---------------------------------------------------------------
    def wrap_and_tag(self, plan: L.LogicalPlan) -> PlanMeta:
        meta = PlanMeta(plan, [self.wrap_and_tag(c) for c in plan.children])
        if not C.SQL_ENABLED.get(self.conf):
            meta.will_not_work(f"{C.SQL_ENABLED.key} is false")
        else:
            self._tag(meta)
            self._tag_element_nulls(meta)
        return meta

    @staticmethod
    def _tag_element_nulls(meta: PlanMeta) -> None:
        """A column holding an array with a null element has no device
        layout: its scan and every node that reads it run on the CPU
        engine (``host_columns``: the names carrying one out of a node).
        A Parquet scan's nested columns are read at planning to find
        them."""
        node = meta.node
        leaf = isinstance(node, (L.InMemoryScan, L.ParquetScan))
        if leaf:
            schema = node.schema
            nested = [f.name for f in schema if T.is_nested(f.dtype)]
            if isinstance(node, L.InMemoryScan):
                tables = [node.table]
            else:
                import pyarrow.parquet as pq

                tables = [pq.read_table(p, columns=nested)
                          for p in node.paths] if nested else []
            bad = {n for n in nested for t in tables
                   if array_element_nulls(t.column(n), schema[n].dtype)}
        else:
            bad = set().union(*[c.host_columns for c in meta.children])
        for name in sorted(bad):
            meta.will_not_work(f"column {name}: {ELEMENT_NULLS}")
        if bad and not leaf:
            bad &= set(node.schema.names())
        meta.host_columns = bad

    def _tag(self, meta: PlanMeta) -> None:
        node = meta.node
        child_schema = node.children[0].schema if node.children else None
        for e in _node_exprs(node):
            for r in check_expr(e, child_schema, self.conf):
                meta.will_not_work(r)
        for c in node.children:
            for f in c.schema:
                if _varwidth_array(f.dtype):
                    meta.will_not_work(f"column {f.name}: arrays of "
                                       f"variable-width elements are not "
                                       f"on the device")
        if isinstance(node, L.Sort):
            for o in node.orders:
                if not isinstance(o.child, (E.UnresolvedColumn,
                                            E.ColumnRef)):
                    meta.will_not_work(f"sort key {o.child!r} is not a "
                                       f"column reference")
                if T.is_nested(E.resolve(o.child, child_schema).dtype):
                    meta.will_not_work("nested sort key not on device")
        elif isinstance(node, L.Aggregate):
            for g in node.group_exprs:
                gdt = E.resolve(g, child_schema).dtype
                if T.is_wide_decimal(gdt):
                    meta.will_not_work("decimal128 group key not on device")
                if T.is_nested(gdt):
                    meta.will_not_work("nested group key not on device")
        elif isinstance(node, L.Join):
            if node.join_type not in JOIN_TYPES:
                meta.will_not_work(f"{node.join_type} join not on device")
            for k, s in ([(k, node.left.schema) for k in node.left_keys]
                         + [(k, node.right.schema)
                            for k in node.right_keys]):
                for r in check_expr(k, s, self.conf):
                    meta.will_not_work(r)
                kdt = E.resolve(k, s).dtype
                if T.is_wide_decimal(kdt):
                    meta.will_not_work("decimal128 join key not on device")
                if T.is_nested(kdt):
                    meta.will_not_work("nested join key not on device")
                if not isinstance(k, (E.UnresolvedColumn, E.ColumnRef)):
                    meta.will_not_work(f"join key {k!r} is not a column "
                                       f"reference")
            if node.condition is not None:
                for r in check_expr(node.condition, pair_schema(node),
                                    self.conf):
                    meta.will_not_work(f"join condition: {r}")
            # as the reference: a struct with variable-width fields has no
            # per-child byte bound in a join's gathers
            for s in (node.left.schema, node.right.schema):
                for f in s:
                    if _struct_has_varwidth(f.dtype):
                        meta.will_not_work(
                            f"struct column {f.name} with var-width fields "
                            "not on device in joins")
        elif isinstance(node, L.Window):
            for r in _window_reasons(node):
                meta.will_not_work(r)

    # -- rewrite -----------------------------------------------------------
    def prepare(self, plan: L.LogicalPlan) -> PlanMeta:
        """The tagged plan the planner converts: scan paths rewritten,
        unions widened, and rewritten for the device first when the device
        is enabled."""
        return self._prepare(apply_path_rules(plan, self.conf))

    def _prepare(self, plan: L.LogicalPlan) -> PlanMeta:
        plan = widen_unions(plan)
        if C.SQL_ENABLED.get(self.conf):
            plan = rewrite_distinct(plan)
        return self.wrap_and_tag(plan)

    # -- convert -----------------------------------------------------------
    def apply(self, plan: L.LogicalPlan) -> DeviceExec:
        with _APPLY_LOCK:
            C.set_active(self.conf)
            # the plan memo (plan/plan_cache.py): a repeat of a
            # rename-equal plan under the same conf is lent the tree built
            # the first time
            memo_key = None
            pinned: list = []
            if self.conf[C.PLAN_CACHE_ENABLED]:
                memo_key = PC.build_key(plan, self.conf,
                                        self.shuffle_partitions, pinned)
                hit = PC.lookup(memo_key) if memo_key is not None else None
                if hit is not None:
                    if C.EXPLAIN.get(self.conf) != "NONE":
                        print("[plan-cache hit]\n" + hit.explain)
                    return hit.ex
            plan = apply_path_rules(plan, self.conf)
            meta = self._prepare(plan)
            fastpath = self._fastpath_eligible(plan)
            self._parts = 1 if fastpath else self.shuffle_partitions
            self._converted = []
            node = self._convert(meta)
            node = apply_reuse(node, self.conf)
            if not fastpath:
                node = insert_prefetch(node, self.conf)
            # the fast path's drains skip the task semaphore
            node._fastpath = fastpath
            for m, ex, kid_ids in self._converted:
                m.physical = _placed(ex, kid_ids)
            mode = C.EXPLAIN.get(self.conf)
            if mode != "NONE":
                print(explain(meta, mode))
            if memo_key is not None:
                PC.store(memo_key, node, explain(meta, "ALL"), pinned,
                         self.conf)
            return node

    def _fastpath_eligible(self, plan: L.LogicalPlan) -> bool:
        """True when the scan leaves' rows and bytes, summed, sit at or
        under the fast path's bounds: the query then plans one shuffle
        partition. A Parquet leaf counts its footers' rows and its files'
        sizes on disk (not their decoded size, as the reference), and one
        of more than 16 files disqualifies the query."""
        if not C.FASTPATH_ENABLED.get(self.conf):
            return False
        rows = nbytes = 0
        stack = [plan]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children)
            elif isinstance(n, L.InMemoryScan):
                rows += n.table.num_rows
                nbytes += n.table.nbytes
            elif isinstance(n, L.ParquetScan):
                if len(n.paths) > 16:
                    return False  # the footer reads would eat the gain
                rows += int(CBO.scan_rows(list(n.paths)))
                nbytes += sum(os.path.getsize(p) for p in n.paths)
            else:
                return False
        return (rows <= C.FASTPATH_MAX_ROWS.get(self.conf)
                and nbytes <= C.FASTPATH_MAX_BYTES.get(self.conf))

    def _cpu_reasons(self, node: L.LogicalPlan) -> List[str]:
        """Why the CPU engine cannot run this node (empty: it can)."""
        if isinstance(node, L.Window):
            return _window_reasons(node, device=False)
        if isinstance(node, L.Join) and node.join_type not in JOIN_TYPES:
            return [f"{node.join_type} join is not in the port yet"]
        schema = node.children[0].schema if node.children else None
        out = [r for e in _node_exprs(node)
               for r in CPU.cpu_unsupported(e, schema)]
        if isinstance(node, L.Join) and node.condition is not None:
            out += CPU.cpu_unsupported(node.condition, pair_schema(node))
        return out

    def _convert(self, meta: PlanMeta) -> DeviceExec:
        kids_out: List[DeviceExec] = []
        ex = self._convert_node(meta, kids_out)
        # annotated once the reuse and prefetch passes have run
        self._converted.append((meta, ex, {id(k) for k in kids_out}))
        return ex

    def _convert_node(self, meta: PlanMeta,
                      kids_out: List[DeviceExec]) -> DeviceExec:
        node = meta.node
        on_dev = meta.can_run_on_device
        if not on_dev:
            if (C.SQL_ENABLED.get(self.conf)
                    and not C.CPU_FALLBACK_ENABLED.get(self.conf)):
                raise NotImplementedError(
                    f"{node.describe()} cannot run on the GPU and "
                    f"{C.CPU_FALLBACK_ENABLED.key} is false: "
                    f"{'; '.join(meta.reasons)}")
            cpu_reasons = self._cpu_reasons(node)
            if cpu_reasons:
                raise NotImplementedError(
                    f"{node.describe()} runs neither on the GPU nor on the "
                    f"CPU engine: {'; '.join(meta.reasons + cpu_reasons)}")
        kids = [self._convert(c) for c in meta.children]
        kids_out.extend(kids)
        dev = self._device(node)
        if isinstance(node, L.ParquetScan):
            if not on_dev:
                return CPU.CpuParquetScanExec(node.paths, node.columns,
                                              device=dev)
            return ParquetScanExec(
                node.paths, columns=node.columns, predicate=node.predicate,
                n_partitions=max(1, min(len(node.paths), self._parts)),
                device=dev, conf=self.conf)
        if isinstance(node, L.InMemoryScan):
            if not on_dev:
                return CPU.CpuInMemoryScanExec(node.table, dev)
            return BatchSourceExec(source_batches(node), node.schema, dev)
        if isinstance(node, L.Project):
            return (ProjectExec(node.exprs, kids[0]) if on_dev
                    else CPU.CpuProjectExec(node.exprs, kids[0], dev))
        if isinstance(node, L.Filter):
            return (FilterExec(node.condition, kids[0]) if on_dev
                    else CPU.CpuFilterExec(node.condition, kids[0], dev))
        if isinstance(node, L.Aggregate):
            if not on_dev:
                return CpuAggregateExec(node.group_exprs, node.agg_exprs,
                                        kids[0], dev)
            return self._convert_aggregate(node, kids[0])
        if isinstance(node, L.Window):
            if not on_dev:
                return CpuWindowExec(node.window_exprs, kids[0], dev)
            return self._convert_window(node, kids[0])
        if isinstance(node, L.Sort):
            if not on_dev:
                return CPU.CpuSortExec(node.orders, kids[0], dev,
                                       limit=node.limit)
            return self._convert_sort(node, kids[0])
        if isinstance(node, L.Join):
            if not on_dev:
                return CpuJoinExec(node.left_keys, node.right_keys,
                                   node.join_type, kids[0], kids[1], dev,
                                   condition=node.condition)
            return self._convert_join(node, kids[0], kids[1])
        if isinstance(node, L.Union):
            if not on_dev:
                return CPU.CpuUnionExec(node.schema, *kids, device=dev)
            return UnionExec(node.schema, *kids)
        if isinstance(node, L.Limit):
            return (GlobalLimitExec(node.n, kids[0], node.offset) if on_dev
                    else CPU.CpuLimitExec(node.n, kids[0], dev, node.offset))
        raise NotImplementedError(
            f"plan node {type(node).__name__} is not in the port yet")

    @staticmethod
    def _planned_parts(node: DeviceExec) -> int:
        """A node's partition count for a plan decision: an AQE reader
        below answers with its estimate, and nothing is written."""
        with planning_scope():
            return node.num_partitions()

    def _maybe_aqe_read(self, exchange: DeviceExec) -> DeviceExec:
        """An AQE reader over a hash or range exchange when AQE is on: the
        keys of a reduce partition stay together when adjacent partitions
        are coalesced, so an aggregate, a window or a range sort may read
        them coalesced."""
        if not C.AQE_ENABLED.get(self.conf):
            return exchange
        return AQEShuffleReadExec(exchange, self.conf)

    def _convert_aggregate(self, node: L.Aggregate,
                           child: DeviceExec) -> DeviceExec:
        if self._planned_parts(child) == 1:
            return HashAggregateExec(node.group_exprs, node.agg_exprs, child,
                                     mode="complete")
        partial = HashAggregateExec(node.group_exprs, node.agg_exprs, child,
                                    mode="partial")
        n_keys = len(node.group_exprs)
        if n_keys:
            exchange = self._maybe_aqe_read(ShuffleExchangeExec(
                HashPartitioner(range(n_keys), self._parts), partial))
        else:
            exchange = ShuffleExchangeExec(SinglePartitioner(), partial)
        return HashAggregateExec.final_from_partial(partial, exchange)

    def _convert_window(self, node: L.Window,
                        child: DeviceExec) -> DeviceExec:
        first = node.window_exprs[0]
        spec = (first.child if isinstance(first, E.Alias) else first).spec
        if self._planned_parts(child) > 1:
            # co-partition rows by the window's partition keys: a hash
            # exchange when they are all columns, else one partition
            cs = child.output_schema
            key_idx = []
            for p in spec.partition_by:
                b = E.resolve(p, cs)
                if not isinstance(b, E.ColumnRef):
                    key_idx = []
                    break
                key_idx.append(b.index)
            if key_idx:
                child = self._maybe_aqe_read(ShuffleExchangeExec(
                    HashPartitioner(key_idx, self._parts), child))
            else:
                child = ShuffleExchangeExec(SinglePartitioner(), child)
        # a group that streams (a running carry or a bounded context)
        # reads a stream sorted across batches by an out-of-core sort, so
        # a window partition never has to fit in one batch
        orders = ([SortOrder(p) for p in spec.partition_by]
                  + list(spec.order_by))
        cs = child.output_schema
        if (C.WINDOW_STREAMING_ENABLED.get(self.conf)
                and plan_stream_mode(node.window_exprs, cs) is not None
                and all(isinstance(E.resolve(o.child, cs), E.ColumnRef)
                        for o in orders)):
            return WindowExec(node.window_exprs, SortExec(
                orders, child, out_of_core=True,
                target_rows=C.SORT_OOC_TARGET_ROWS.get(self.conf)),
                streaming=True)
        return WindowExec(node.window_exprs,
                          CoalesceBatchesExec(child, require_single=True))

    def _convert_sort(self, node: L.Sort, child: DeviceExec) -> DeviceExec:
        if node.limit is not None:
            # the top-k reads its child's partition count
            with planning_scope():
                return take_ordered_and_project(node.orders, node.limit,
                                                child)
        if self._planned_parts(child) > 1:
            part = self._range_partitioner(node, child)
            child = ShuffleExchangeExec(part, child)
            if isinstance(part, RangePartitioner):
                # adjacent range partitions stay ordered when coalesced
                child = self._maybe_aqe_read(child)
        return SortExec(node.orders, child)

    def _range_partitioner(self, node: L.Sort, child: DeviceExec):
        """Range bounds of the first sort key, sampled from the first batch
        of each child partition (GpuRangePartitioner's sample); one
        partition for a string, DECIMAL128 or boolean key, or several
        keys. Samples are the device's values (a decimal's unscaled
        integers, a date's days), the units the partitioner compares."""
        first = node.orders[0]
        bound = E.resolve(first.child, child.output_schema)
        if (len(node.orders) > 1 or bound.dtype in (T.STRING, T.BINARY,
                                                     T.BOOLEAN)
                or T.is_wide_decimal(bound.dtype)):
            return SinglePartitioner()
        samples = []
        for p in range(child.num_partitions()):
            for b in child.execute(p):
                col = b.columns[bound.index]
                vals = col.data[col.validity].double().cpu().numpy()
                vals = vals[~np.isnan(vals)]
                if len(vals):
                    samples.append(np.random.default_rng(0).choice(
                        vals, min(len(vals), 256)))
                break  # the first batch of each partition only
        values = np.concatenate(samples) if samples else np.zeros(0)
        return RangePartitioner.from_sample(
            values, self._parts, bound.index, first.ascending,
            first.nulls_first)

    def _convert_join(self, node: L.Join, left: DeviceExec,
                      right: DeviceExec) -> DeviceExec:
        max_rows = C.JOIN_MAX_OUTPUT_ROWS.get(self.conf)
        probe = left  # the subtree below any exchange, where DPP looks
        if self._planned_parts(left) > 1:
            if (node.join_type in BroadcastHashJoinExec.BROADCAST_TYPES
                    and CBO.estimate_rows(node.right)
                    <= C.JOIN_BROADCAST_ROWS.get(self.conf)):
                cached = ReplayExec(right)
                self._try_dynamic_pruning(node, probe, cached)
                return BroadcastHashJoinExec(
                    node.left_keys, node.right_keys, node.join_type, left,
                    cached, max_rows, condition=node.condition)
            lk = [E.resolve(k, left.output_schema).index
                  for k in node.left_keys]
            rk = [E.resolve(k, right.output_schema).index
                  for k in node.right_keys]
            left = ShuffleExchangeExec(HashPartitioner(lk, self._parts), left)
            rex = ShuffleExchangeExec(HashPartitioner(rk, self._parts), right)
            right = rex
            if C.AQE_ENABLED.get(self.conf):
                left, right = pair_for_skew_join(left, rex, node.join_type,
                                                 self.conf)
            # the raw right exchange, not its AQE reader: the keys are
            # collected inside the left exchange's write, where the reader
            # would re-enter the skew planner
            self._try_dynamic_pruning(node, probe, rex)
        elif self._planned_parts(right) > 1:
            right = ShuffleExchangeExec(SinglePartitioner(), right)
            self._try_dynamic_pruning(node, probe, right)
        else:
            # no exchange to share: the build materialized once for the
            # filter and the join
            cached = ReplayExec(right)
            if self._try_dynamic_pruning(node, probe, cached):
                right = cached
        return HashJoinExec(node.left_keys, node.right_keys, node.join_type,
                            left, right, max_candidate_rows=max_rows,
                            condition=node.condition)

    def _try_dynamic_pruning(self, node: L.Join, probe: DeviceExec,
                             build: DeviceExec) -> bool:
        """Attach a runtime key filter from the join's ``build`` (its own
        materialization) to a Parquet scan under the probe side, where
        dropping unmatched probe rows cannot change the join's result (an
        inner, left-semi or right join); the walk goes through filters and
        coalesces only (a projection could rename or derive the key).
        Returns whether a filter was attached."""
        if not C.DPP_ENABLED.get(self.conf):
            return False
        if node.join_type not in ("inner", "left_semi", "right"):
            return False
        cur = probe
        while isinstance(cur, (FilterExec, CoalesceBatchesExec)):
            cur = cur.children[0]
        if not isinstance(cur, ParquetScanExec):
            return False
        scan_cols = {f.name for f in cur.output_schema}
        attached = False
        for lk, rk in zip(node.left_keys, node.right_keys):
            lb = E.resolve(lk, node.left.schema)
            rb = E.resolve(rk, node.right.schema)
            if not isinstance(lb, E.ColumnRef) or lb.name not in scan_cols:
                continue
            if not isinstance(rb, E.ColumnRef):
                continue
            cur.dynamic_filters.append(DynamicPruningFilter(
                build, rb.index, lb.name,
                max_values=C.DPP_MAX_KEYS.get(self.conf)))
            attached = True
        return attached

    @staticmethod
    def _device(node: L.LogicalPlan) -> str:
        """The device of a node's first scan: where its batches live, and
        where a CPU node uploads its output for a device parent."""
        while node.children:
            node = node.children[0]
        return node.device


def apply_path_rules(plan: L.LogicalPlan,
                     conf: C.RapidsConf) -> L.LogicalPlan:
    """The plan with every Parquet scan's paths rewritten by the conf's
    replacement rules (``io/paths.replace_paths``, the reference's
    AlluxioUtils analog); the plan itself when no rule applies."""
    from spark_rapids_tpu_torch.io.paths import replace_paths

    if isinstance(plan, L.ParquetScan):
        paths = replace_paths(plan.paths, conf)
        return (plan if paths == plan.paths
                else dataclasses.replace(plan, paths=paths))
    kids = [apply_path_rules(c, conf) for c in plan.children]
    if any(k is not c for k, c in zip(kids, plan.children)):
        plan = _with_children(plan, kids)
    return plan


def join_strategy(join: HashJoinExec) -> str:
    """``broadcast``, ``shuffled`` (both sides read from hash exchanges,
    through AQE readers or prefetch boundaries or not) or
    ``one_partition``."""
    if isinstance(join, BroadcastHashJoinExec):
        return "broadcast"
    side = join.left
    while isinstance(side, (PrefetchExec, AQEShuffleReadExec)):
        side = side.children[0]
    if (isinstance(side, (ShuffleExchangeExec, ReusedExchangeExec))
            and isinstance(side.partitioner, HashPartitioner)):
        return "shuffled"
    return "one_partition"


def _placed(node: DeviceExec, kid_ids: Set[int]) -> List[str]:
    """The exchanges, AQE readers, reused exchanges and broadcasts,
    prefetch boundaries and the join strategy in a converted node's
    subtree above its children's conversions (``explain``'s
    annotation)."""
    out: List[str] = []

    def walk(n):
        if id(n) in kid_ids:
            return
        if isinstance(n, ShuffleExchangeExec):
            reuse = (f" [reuse #{n.reuse_id}]" if n.reuse_id is not None
                     else "")
            out.append(f"Exchange {n.partitioner.describe()}{reuse}")
        elif isinstance(n, (AQEShuffleReadExec, ReusedExchangeExec,
                            ReusedBroadcastExec, PrefetchExec)):
            out.append(n.node_description())
        elif isinstance(n, ReplayExec) and n.reuse_id is not None:
            out.append(n.node_description())
        elif isinstance(n, HashJoinExec):
            out.append({"broadcast": "BroadcastHashJoin",
                        "shuffled": "ShuffledHashJoin",
                        "one_partition": "HashJoin"}[join_strategy(n)])
        for c in n.children:
            walk(c)

    walk(node)
    return out


# ---------------------------------------------------------------------------
# distinct-aggregate rewrite
# ---------------------------------------------------------------------------


def _with_children(node: L.LogicalPlan, kids) -> L.LogicalPlan:
    """A copy of ``node`` over new children."""
    if isinstance(node, L.Join):
        return dataclasses.replace(node, left=kids[0], right=kids[1])
    if isinstance(node, L.Union):
        return dataclasses.replace(node, inputs=list(kids))
    return dataclasses.replace(node, child=kids[0])


def widen_unions(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Give every union branch the union's column types: a branch that
    differs is wrapped in a Project that casts each differing column (by
    ordinal, keeping the branch's names)."""
    kids = [widen_unions(c) for c in plan.children]
    if any(k is not c for k, c in zip(kids, plan.children)):
        plan = _with_children(plan, kids)
    if not isinstance(plan, L.Union):
        return plan
    target = [f.dtype for f in plan.schema]
    inputs = []
    for child in plan.inputs:
        cs = child.schema
        if [f.dtype for f in cs] != target:
            exprs: List[E.Expression] = []
            for i, (f, dt) in enumerate(zip(cs, target)):
                ref = E.ColumnRef(i, f.dtype, f.nullable, f.name)
                exprs.append(ref if f.dtype == dt
                             else E.Alias(E.Cast(ref, dt), f.name))
            child = L.Project(exprs, child)
        inputs.append(child)
    return L.Union(inputs)


def rewrite_distinct(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Spark's distinct-aggregate rewrite (RewriteDistinctAggregates; the
    reference's ``Overrides._rewrite_distinct``).

    ``Aggregate(keys, [.., CountDistinct(x) AS n, ..])`` becomes the
    regular aggregate (distinct aggregates dropped) joined on the keys
    with, per distinct aggregate, ``Count(#dx) AS n`` over the
    ``(keys, x AS #dx)``-distinct sub-aggregate (a Count skips the null
    x). A global aggregate joins its one-row parts on a constant ``#one``
    key. An aggregate whose group keys are not non-nullable columns stays
    as it is (the join would drop null-key groups): tagging places it on
    the CPU engine, which counts distinct values natively. A Project
    restores the output columns' order. An aggregate whose only aggregate
    is one COUNT(DISTINCT x) needs no join, whatever its keys: it becomes
    ``Count(#dx0)`` per key over the ``(keys, x AS #dx0)``-distinct
    sub-aggregate."""
    kids = [rewrite_distinct(c) for c in plan.children]
    if any(k is not c for k, c in zip(kids, plan.children)):
        plan = _with_children(plan, kids)
    if not isinstance(plan, L.Aggregate):
        return plan
    dist = [i for i, e in enumerate(plan.agg_exprs)
            if isinstance(_strip_alias(e)[0], E.CountDistinct)]
    if not dist:
        return plan
    child_schema = plan.child.schema
    if len(dist) == len(plan.agg_exprs) == 1:
        # one distinct aggregate and nothing else (Spark's single-distinct
        # plan): count the (keys, x)-distinct rows per key, no join, so
        # nullable keys need nothing more
        func, name = _strip_alias(plan.agg_exprs[0])
        keys = [_strip_alias(E.resolve(e, child_schema))[1]
                for e in plan.group_exprs]
        sub = L.Aggregate(list(plan.group_exprs)
                          + [E.Alias(func.children[0], "#dx0")], [],
                          plan.child)
        return L.Aggregate([E.col(k) for k in keys],
                           [E.Alias(E.Count(E.col("#dx0")), name)], sub)
    key_names = []
    for e in plan.group_exprs:
        inner, name = _strip_alias(E.resolve(e, child_schema))
        if not isinstance(inner, E.ColumnRef) or inner.nullable:
            return plan
        key_names.append(name)
    regular = [e for i, e in enumerate(plan.agg_exprs) if i not in dist]
    if key_names:
        reg_plan: L.LogicalPlan = L.Aggregate(list(plan.group_exprs),
                                              regular, plan.child)
        join_keys = key_names
    else:
        agg = L.Aggregate([], regular, plan.child)
        reg_plan = L.Project([E.col(f.name) for f in agg.schema]
                             + [E.Alias(E.Literal(1, T.INT), "#one")], agg)
        join_keys = ["#one"]
    for n, i in enumerate(dist):
        func, name = _strip_alias(plan.agg_exprs[i])
        x = f"#dx{n}"
        sub = L.Aggregate(list(plan.group_exprs)
                          + [E.Alias(func.children[0], x)], [], plan.child)
        cnt: L.LogicalPlan = L.Aggregate(
            [E.col(k) for k in key_names],
            [E.Alias(E.Count(E.col(x)), name)], sub)
        if not key_names:
            cnt = L.Project([E.col(name),
                             E.Alias(E.Literal(1, T.INT), "#one")], cnt)
        reg_plan = L.Join(reg_plan, cnt, [E.col(k) for k in join_keys],
                          [E.col(k) for k in join_keys])
    return L.Project([E.col(_strip_alias(e)[1])
                      for e in plan.group_exprs + plan.agg_exprs], reg_plan)
