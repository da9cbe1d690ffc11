"""Plan-time computation reuse: subtree fingerprints and the rewrite
(counterpart of spark_rapids_tpu/plan/reuse.py; Spark's
ReuseExchangeAndSubquery).

``Overrides.apply`` runs ``apply_reuse`` on the converted plan, before
prefetch boundaries go in. Fingerprints are semantic: expressions are
resolved against their child's schema and stripped of names (a bound
column reference keeps its ordinal, an Alias only renames), so subtrees
equal up to renaming have equal fingerprints, while whatever changes the
values (literals, types, partitioner keys and bounds, join keys) stays in
them. A node without a key here (a window, a final aggregate, whose
expressions are over its partial's input, a CPU-engine node, the top-k
gather) gets a key of its own identity and merges with nothing: an
operator unknown to the rewrite costs a missed reuse, never a wrong one.
These are the reference's keys over the port's operators.

A Parquet scan's key holds its dynamic pruning filters' build
fingerprints (they change what it emits). After the aliasing,
``_dedupe_subqueries`` points each filter whose build was replaced at the
surviving build, and merges filters of equal (build, key, column, cap)
into one object, so a key set is collected once for every scan that
reads it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exprs import expr as E

# ---------------------------------------------------------------------------
# expression keys
# ---------------------------------------------------------------------------

# private attributes that change what an expression computes
_KEY_PRIVATE_ATTRS = ("_dtype", "_nullable")


def _holds_expression(v) -> bool:
    if isinstance(v, E.Expression):
        return True
    if isinstance(v, (tuple, list)):
        return any(_holds_expression(x) for x in v)
    return False


def _canon(v):
    if isinstance(v, (str, int, float, bool, bytes)) or v is None:
        return v
    if isinstance(v, (tuple, list)):
        return tuple(_canon(x) for x in v)
    return repr(v)  # a type, a Decimal, a date: their reprs are canonical


def expr_key(e: E.Expression) -> tuple:
    """(class, non-child attributes, children's keys) of a bound
    expression, without the names of column references and aliases (the
    reference's ``cache_key`` and ``_scrub``)."""
    scalars = []
    for k in sorted(vars(e)):
        if k == "children" or (k.startswith("_")
                               and k not in _KEY_PRIVATE_ATTRS):
            continue
        if k == "name" and isinstance(e, (E.ColumnRef, E.Alias)):
            continue
        v = vars(e)[k]
        if _holds_expression(v) or callable(v):
            continue  # the children's keys hold it
        scalars.append((k, _canon(v)))
    return (type(e).__name__, tuple(scalars),
            tuple(expr_key(c) for c in e.children))


def _expr_key(expr: E.Expression, schema: T.Schema) -> tuple:
    return expr_key(E.resolve(expr, schema))


def _exprs_key(exprs, schema: T.Schema) -> tuple:
    return tuple(_expr_key(e, schema) for e in exprs)


def _partitioner_key(p) -> tuple:
    from spark_rapids_tpu_torch.shuffle.partition import (
        HashPartitioner, RangePartitioner, RoundRobinPartitioner,
        SinglePartitioner)

    if isinstance(p, HashPartitioner):
        return ("hash", p.key_cols, p.num_partitions)
    if isinstance(p, RoundRobinPartitioner):
        return ("rr", p.num_partitions, p.start)
    if isinstance(p, SinglePartitioner):
        return ("single",)
    if isinstance(p, RangePartitioner):
        return ("range", p.key_col, p.ascending, p.nulls_first,
                p.bounds.tobytes())
    raise NotImplementedError(f"no reuse key for {type(p).__name__}")


# ---------------------------------------------------------------------------
# plan fingerprints
# ---------------------------------------------------------------------------


def plan_fingerprint(node, memo: Optional[Dict[int, tuple]] = None) -> tuple:
    """Hashable key of a physical subtree: equal keys compute the same
    rows (by position) from the same sources. ``memo`` is keyed by node
    identity, so a walk is linear."""
    if memo is None:
        memo = {}
    fp = memo.get(id(node))
    if fp is None:
        kids = tuple(plan_fingerprint(c, memo) for c in node.children)
        local = _local_key(node)
        fp = (("opaque", id(node)) if local is None
              else (type(node).__name__, local, kids))
        memo[id(node)] = fp
    return fp


def _local_key(node) -> Optional[tuple]:
    """The node's own part of its fingerprint; None for a node without
    one."""
    from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
    from spark_rapids_tpu_torch.exec.base import BatchSourceExec
    from spark_rapids_tpu_torch.exec.dpp import ReplayExec
    from spark_rapids_tpu_torch.exec.expand import ExpandExec
    from spark_rapids_tpu_torch.exec.join import HashJoinExec
    from spark_rapids_tpu_torch.exec.misc import (
        CoalesceBatchesExec, GlobalLimitExec, LocalLimitExec, UnionExec)
    from spark_rapids_tpu_torch.exec.project import FilterExec, ProjectExec
    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
    from spark_rapids_tpu_torch.exec.sort import SortExec
    from spark_rapids_tpu_torch.plan.cache import CachedRelation
    from spark_rapids_tpu_torch.shuffle.aqe import AQEShuffleReadExec
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)

    if isinstance(node, BatchSourceExec):
        # overrides.source_batches keeps one upload per table and slicing,
        # so two scans of one table hold the same batch objects
        return ("src", tuple(tuple(id(b) for b in p) for p in node._parts))
    if isinstance(node, CachedRelation):
        return ("cached", id(node._blobs))
    if isinstance(node, ParquetScanExec):
        # dynamic filters change what the scan emits: their builds'
        # fingerprints are part of its identity
        dyn = tuple((plan_fingerprint(f.build, {}), f.key_index, f.column,
                     f.max_values) for f in node.dynamic_filters)
        pred = None if node.predicate is None else expr_key(node.predicate)
        return ("parquet", tuple(node.paths),
                None if node.columns is None else tuple(node.columns),
                pred, node.n_partitions, dyn)
    if isinstance(node, ProjectExec):
        return ("project", _exprs_key(node.exprs, node.child.output_schema))
    if isinstance(node, FilterExec):
        return ("filter", _expr_key(node.condition,
                                    node.child.output_schema))
    if isinstance(node, ExpandExec):
        cs = node.child.output_schema
        return ("expand", tuple(_exprs_key(p, cs) for p in node.projections))
    if isinstance(node, HashAggregateExec):
        if node.mode == "final":
            return None
        cs = node.child.output_schema
        return ("agg", node.mode, _exprs_key(node.group_exprs, cs),
                _exprs_key(node.agg_exprs, cs))
    if isinstance(node, SortExec):
        cs = node.child.output_schema
        orders = tuple((_expr_key(o.child, cs), o.ascending, o.nulls_first)
                       for o in node.orders)
        return ("sort", orders, node.limit)
    if isinstance(node, LocalLimitExec):
        return ("llimit", node.limit)
    if isinstance(node, GlobalLimitExec):
        return ("glimit", node.limit, node.offset)
    if isinstance(node, CoalesceBatchesExec):
        return ("coalesce", node.target_rows, node.require_single)
    if isinstance(node, UnionExec):
        return ("union",)
    if isinstance(node, HashJoinExec):  # a broadcast join too
        ls = node.left.output_schema
        rs = node.right.output_schema
        cond = (None if node.condition is None
                else _expr_key(node.condition,
                               T.Schema(list(ls) + list(rs))))
        return ("join", node.join_type, _exprs_key(node.left_keys, ls),
                _exprs_key(node.right_keys, rs), cond,
                node.max_candidate_rows)
    if isinstance(node, ShuffleExchangeExec):
        return ("exchange", _partitioner_key(node.partitioner),
                node.target_batch_rows, id(node.manager))
    if isinstance(node, AQEShuffleReadExec):  # a skew-aware reader too
        return ("aqeread",)
    if isinstance(node, ReplayExec):
        return ("replay",)
    return None


# ---------------------------------------------------------------------------
# duplicates
# ---------------------------------------------------------------------------


def _walk_slots(root) -> List[Tuple[object, int, object]]:
    """(parent, child index, node) of every node, depth first, parents
    first; the root's is (None, -1, root)."""
    out: List[Tuple[object, int, object]] = []

    def walk(node, parent, idx):
        out.append((parent, idx, node))
        for i, c in enumerate(node.children):
            walk(c, node, i)

    walk(root, None, -1)
    return out


def _reusable_roots(root, memo) -> Dict[tuple, List[Tuple]]:
    """Fingerprint groups of the subtrees reuse may alias: shuffle
    exchanges and broadcast builds (``ReplayExec``)."""
    from spark_rapids_tpu_torch.exec.dpp import ReplayExec
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)

    groups: Dict[tuple, List[Tuple]] = {}
    for parent, idx, node in _walk_slots(root):
        if parent is not None and isinstance(
                node, (ShuffleExchangeExec, ReplayExec)):
            groups.setdefault(plan_fingerprint(node, memo), []).append(
                (parent, idx, node))
    return groups


def duplicate_groups(root) -> List[dict]:
    """The repeated reusable subtrees of a plan, one dict per fingerprint
    that occurs more than once."""
    out = []
    for occs in _reusable_roots(root, {}).values():
        distinct = {id(n): n for _, _, n in occs}
        if len(distinct) < 2:
            continue
        first = next(iter(distinct.values()))
        out.append({"root": first.node_description(),
                    "occurrences": len(distinct),
                    "subtree_nodes": _subtree_size(first)})
    return out


def _subtree_size(node) -> int:
    return 1 + sum(_subtree_size(c) for c in node.children)


# ---------------------------------------------------------------------------
# the rewrite
# ---------------------------------------------------------------------------

_next_reuse_id = [0]


def apply_reuse(root, conf: C.RapidsConf):
    """Alias the repeated exchange and broadcast-build subtrees of a
    converted plan to one survivor each, and give broadcast joins with
    equal builds one ``SharedBroadcast``; nothing with
    ``spark.rapids.gpu.sql.exchange.reuse.enabled`` false. Returns the
    root (changed in place)."""
    if not C.REUSE_ENABLED.get(conf):
        return root

    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.shuffle.aqe import AQEShuffleReadExec
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)

    memo: Dict[int, tuple] = {}
    groups = _reusable_roots(root, memo)
    dead: set = set()
    survivors: Dict[tuple, object] = {}

    def mark_dead(node):
        dead.add(id(node))
        # a range sample at planning may have run part of a replaced
        # subtree, which no cleanup walk reaches now: stop its AQE
        # readers' read-ahead, then free the exchanges it wrote
        if isinstance(node, AQEShuffleReadExec):
            node.cleanup()
        for c in node.children:
            mark_dead(c)
        if isinstance(node, ShuffleExchangeExec) and node._written:
            node.cleanup()

    # largest subtrees first: aliasing an outer repeat subsumes its inner
    # ones, and the dead set keeps inner groups from reviving them
    ordered = sorted(groups.values(),
                     key=lambda occs: -_subtree_size(occs[0][2]))
    for occs in ordered:
        seen: set = set()
        live = []
        for parent, idx, node in occs:
            if id(node) in dead or id(node) in seen:
                continue
            seen.add(id(node))
            live.append((parent, idx, node))
        if len(live) < 2:
            continue
        survivor = live[0][2]
        survivors[plan_fingerprint(survivor, memo)] = survivor
        _next_reuse_id[0] += 1
        rid = _next_reuse_id[0]
        survivor.reuse_id = rid
        if isinstance(survivor, ShuffleExchangeExec):
            entry = R.SharedExchangeEntry(conf)
            entry.retain(len(live))
            survivor._shared = entry
            for parent, idx, node in live[1:]:
                reused = R.ReusedExchangeExec(survivor, node.output_schema,
                                              rid, entry)
                parent.children[idx] = reused
                R.note("reuse_exchanges_total")
                if node._written:
                    # written by a range sample: its consumer now reads the
                    # survivor, so the write it made is the one saved
                    R.note("reuse_bytes_saved_total", sum(
                        node.manager.partition_sizes(node._reg)))
                    reused._counted_write_skip = True
                mark_dead(node)
        else:  # a broadcast build (ReplayExec)
            for parent, idx, node in live[1:]:
                parent.children[idx] = R.ReusedBroadcastExec(
                    survivor, node.output_schema, rid)
                R.note("reuse_broadcasts_total")
                mark_dead(node)
    _dedupe_subqueries(root, memo, dead, survivors)
    _attach_shared_broadcasts(root, memo)
    return root


def _dedupe_subqueries(root, memo, dead, survivors) -> None:
    """Point each dynamic pruning filter whose build the rewrite replaced
    at the surviving build, and merge filters of equal (build, key,
    column, cap) into one object."""
    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.exec.scan import ParquetScanExec

    canon: Dict[tuple, object] = {}
    for _, _, node in _walk_slots(root):
        if not isinstance(node, ParquetScanExec) or not node.dynamic_filters:
            continue
        for j, f in enumerate(list(node.dynamic_filters)):
            bfp = plan_fingerprint(f.build, memo)
            key = (bfp, f.key_index, f.column, f.max_values)
            prior = canon.get(key)
            if prior is not None:
                if prior is not f:
                    node.dynamic_filters[j] = prior
                    R.note("reuse_subqueries_total")
                continue
            if id(f.build) in dead:
                surv = survivors.get(bfp)
                if surv is not None:
                    f.build = surv
                    R.note("reuse_subqueries_total")
            canon[key] = f


def _attach_shared_broadcasts(root, memo) -> None:
    """Broadcast joins whose builds have equal fingerprints and build-key
    ordinals share one ``SharedBroadcast``."""
    from spark_rapids_tpu_torch.exec import reuse as R
    from spark_rapids_tpu_torch.exec.join_bcast import BroadcastHashJoinExec

    by_key: Dict[tuple, List[object]] = {}
    for _, _, node in _walk_slots(root):
        if not isinstance(node, BroadcastHashJoinExec):
            continue
        build = node.right
        target = (build.target if isinstance(build, R.ReusedBroadcastExec)
                  else build)
        key = (plan_fingerprint(target, memo), tuple(node._rkeys))
        by_key.setdefault(key, []).append(node)
    for joins in by_key.values():
        if len(joins) > 1:
            holder = R.SharedBroadcast()
            for j in joins:
                j._shared_broadcast = holder
