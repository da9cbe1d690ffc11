"""Memoised plan rewrite (counterpart of spark_rapids_tpu/plan/plan_cache.py).

``Overrides.apply`` is pure in (logical plan, configuration, shuffle
partitions, shuffle manager): the same inputs build the same physical
tree, and a physical tree can run again (its exchanges are written again,
its reuse entries count their consumers again). So a repeat of an equal
query is served the tree built the first time, and skips planning: the
path rules, the tagging, the conversion, the range exchange's sample, the
reuse rewrite and the prefetch boundaries.

Keys are semantic, as ``plan/reuse.py``'s fingerprints: expressions are
resolved against their child's schema and stripped of the names of column
references and aliases, so an intermediate rename hits and a literal
change misses. The key also holds the final output names, every
registered configuration key and every explicit one, the shuffle
partitions, the identity of the shuffle manager the exchanges bind to, a
manual epoch (``bump_epoch``), and each scan's device. An in-memory
scan's table is pinned by identity. A Parquet scan keys its paths,
columns and predicate, as the reference's, and also each file's size and
modification time: its tree holds the schema read at planning and its
broadcast builds' batches, so a file rewritten under the same path must
miss (the reference keys the paths only and serves such a tree).

Unlike the reference, which assumes one query at a time, a tree runs
once at a time. An entry is lent (to the caller that planned it, or by
``lookup``), running, or idle. ``lookup`` lends only an idle entry's
tree: a second thread asking for a lent or running entry's key plans its
own tree and counts a miss. ``acquire`` (at the start of
``execute_to_arrow``) marks the entry running, and waits while another
run holds it: a caller that keeps a tree and runs it again after its
first run gave it back shares it with ``lookup``'s borrowers, one run
after another. ``release`` (once the run has cleaned up its shuffles)
makes it idle. While lent or running, the entry holds its tree weakly, so
a tree planned and dropped unrun is collected with what it holds (a range
sort's sampled shuffle) and its entry dies. Going idle, the tree drops
what its run built (``drop_run_state``: broadcast builds and their hash
tables, replayed build sides, dynamic pruning's keys), so the next run
builds them again. Between runs a memoised tree holds no device batch,
no shuffle file, no pool registration, no spill handle and no thread,
only what planning built. An entry whose pinned table is collected is
dropped (through ``mem/cleaner``'s deferred releases), so it does not
keep that table's device batches alive.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.reuse import _expr_key, _exprs_key, expr_key

_LOCK = threading.RLock()
_IDLE = threading.Condition(_LOCK)  # notified when a run gives a tree back
_CACHE: "OrderedDict[tuple, _Entry]" = OrderedDict()
_EPOCH = 0
_HITS = 0
_MISSES = 0
_EVICTIONS = 0
_UNCACHEABLE = 0


class Unfingerprintable(Exception):
    """Raised while fingerprinting a plan the memo must not hold."""


class Hit(NamedTuple):
    """A tree lent by ``lookup`` and the explain text stored with it."""

    ex: object
    explain: str


class _Entry:
    """One memoised physical tree and the objects its key pins by
    identity, each held by a weak reference: a collected or replaced
    object invalidates the entry (an id reused after collection must
    never alias)."""

    __slots__ = ("_tree", "_strong", "explain", "state", "runner",
                 "_guard_ids", "_guards", "__weakref__")

    def __init__(self, key: tuple, ex, explain_text: str, pinned):
        drop = _dropper(key, self)
        self._tree = weakref.ref(ex, drop)
        self._strong = None  # the tree, while no run holds it
        self.explain = explain_text
        self.state = "lent"  # to the caller that planned it
        self.runner = None  # the thread running it
        self._guard_ids = [id(o) for o in pinned]
        self._guards = [weakref.ref(o, drop) for o in pinned]

    def tree(self):
        return self._tree()

    def valid(self) -> bool:
        if self._tree() is None:
            return False
        for i, ref in zip(self._guard_ids, self._guards):
            o = ref()
            if o is None or id(o) != i:
                return False
        return True


def _dropper(key: tuple, entry: _Entry):
    """A weak-reference callback that drops ``entry`` once one of its
    objects is collected. It only queues the drop: a callback may run
    inside any allocation, under any lock."""
    eref = weakref.ref(entry)

    def dropped(_ref):
        cleaner.defer(_drop, key, eref)
    return dropped


def _drop(key: tuple, eref) -> None:
    with _LOCK:
        e = eref()
        if e is not None and _CACHE.get(key) is e:
            del _CACHE[key]


# ---------------------------------------------------------------------------
# logical-plan fingerprints
# ---------------------------------------------------------------------------


def _order_key(order, schema: T.Schema) -> tuple:
    return (_expr_key(order.child, schema), order.ascending,
            order.nulls_first)


def _file_stamps(paths) -> tuple:
    out = []
    for p in paths:
        st = os.stat(p)
        out.append((st.st_size, st.st_mtime_ns))
    return tuple(out)


def _local_key(plan: L.LogicalPlan, pinned: List) -> tuple:
    if isinstance(plan, L.ParquetScan):
        pred = (expr_key(plan.predicate)
                if plan.predicate is not None else None)
        cols = tuple(plan.columns) if plan.columns is not None else None
        return ("parquet", tuple(plan.paths), cols, pred, plan.device,
                _file_stamps(plan.paths))
    if isinstance(plan, L.InMemoryScan):
        pinned.append(plan.table)
        return ("inmem", id(plan.table), plan.batch_rows, plan.partitions,
                plan.device)
    if isinstance(plan, L.Project):
        return ("project", _exprs_key(plan.exprs, plan.child.schema))
    if isinstance(plan, L.Filter):
        return ("filter", _expr_key(plan.condition, plan.child.schema))
    if isinstance(plan, L.Aggregate):
        cs = plan.child.schema
        return ("agg", _exprs_key(plan.group_exprs, cs),
                _exprs_key(plan.agg_exprs, cs))
    if isinstance(plan, L.Window):
        # unresolved, so its column names stay: a rename below a window
        # misses (a missed memo, never a wrong plan)
        return ("window", tuple(expr_key(e) for e in plan.window_exprs))
    if isinstance(plan, L.Sort):
        cs = plan.child.schema
        return ("sort", tuple(_order_key(o, cs) for o in plan.orders),
                plan.limit)
    if isinstance(plan, L.Join):
        joint = T.Schema(list(plan.left.schema) + list(plan.right.schema))
        cond = (_expr_key(plan.condition, joint)
                if plan.condition is not None else None)
        return ("join", plan.join_type,
                _exprs_key(plan.left_keys, plan.left.schema),
                _exprs_key(plan.right_keys, plan.right.schema), cond)
    if isinstance(plan, L.Limit):
        return ("limit", plan.n, plan.offset)
    if isinstance(plan, L.Union):
        return ("union", len(plan.inputs))
    raise Unfingerprintable(type(plan).__name__)


def logical_fingerprint(plan: L.LogicalPlan, pinned: List) -> tuple:
    """Semantic key of a logical subtree (names stripped, literals kept),
    appending every object pinned by identity to ``pinned``. Raises
    Unfingerprintable where a node or expression resists keying."""
    try:
        local = _local_key(plan, pinned)
    except Unfingerprintable:
        raise
    except Exception as e:
        raise Unfingerprintable(f"{type(plan).__name__}: {e}") from e
    kids = tuple(logical_fingerprint(c, pinned) for c in plan.children)
    return (type(plan).__name__, local, kids)


def _conf_key(conf: C.RapidsConf) -> tuple:
    items = []
    for k in sorted(set(C._REGISTRY) | set(conf._values)):
        v = conf.get(k)
        if not isinstance(v, (str, int, float, bool, type(None))):
            v = repr(v)
        items.append((k, v))
    return tuple(items)


# ---------------------------------------------------------------------------
# the memo
# ---------------------------------------------------------------------------


def build_key(plan: L.LogicalPlan, conf: C.RapidsConf,
              shuffle_partitions: int, pinned: List) -> Optional[tuple]:
    """The full memo key, or None when the plan must not be memoised."""
    global _UNCACHEABLE
    from spark_rapids_tpu_torch.shuffle.manager import get_manager

    try:
        fp = logical_fingerprint(plan, pinned)
        out_names = tuple(f.name for f in plan.schema)
    except Exception:
        # Unfingerprintable, or the schema itself failing at key time (a
        # Parquet path that only exists after the path rewrite): never
        # memoised, never an error here
        with _LOCK:
            _UNCACHEABLE += 1
        return None
    mgr = get_manager(conf)
    pinned.append(mgr)
    return (fp, out_names, shuffle_partitions, _conf_key(conf), id(mgr),
            _EPOCH)


def lookup(key: tuple) -> Optional[Hit]:
    """Lend the idle tree memoised under ``key`` (refreshing its place in
    the LRU order and counting a hit), or None: no entry, a dead one
    (dropped) or one another run holds. Misses are counted by ``store``."""
    global _HITS
    with _LOCK:
        entry = _CACHE.get(key)
        if entry is None:
            return None
        ex = entry.tree()
        if ex is None or not entry.valid():
            del _CACHE[key]
            return None
        if entry.state != "idle":
            return None
        entry.state = "lent"
        entry._strong = None  # the borrower holds it now
        _CACHE.move_to_end(key)
        _HITS += 1
        return Hit(ex, entry.explain)


def store(key: tuple, ex, explain_text: str, pinned,
          conf: C.RapidsConf) -> None:
    """Memoise ``ex`` under ``key``, lent to its planner until it is
    released."""
    global _MISSES, _EVICTIONS
    cap = conf[C.PLAN_CACHE_MAX_ENTRIES]
    ex._plan_memo_key = key
    with _LOCK:
        _MISSES += 1
        _CACHE[key] = _Entry(key, ex, explain_text, pinned)
        _CACHE.move_to_end(key)
        while len(_CACHE) > cap:
            _CACHE.popitem(last=False)
            _EVICTIONS += 1


def _entry_of(ex) -> Optional[_Entry]:
    key = getattr(ex, "_plan_memo_key", None)
    if key is None:
        return None
    entry = _CACHE.get(key)
    if entry is None or entry.tree() is not ex:
        return None  # replaced or evicted: the caller's own tree
    return entry


def acquire(ex) -> None:
    """The start of a run of ``ex``: a memoised tree becomes running,
    once no other run holds it."""
    me = threading.get_ident()
    with _IDLE:
        while True:
            entry = _entry_of(ex)
            if entry is None:
                return
            if entry.state != "running":
                break
            if entry.runner == me:
                raise RuntimeError("a plan cannot run inside its own run")
            _IDLE.wait()
        entry.state = "running"
        entry.runner = me
        entry._strong = None  # the run holds it now


def _drop_run_state(ex) -> None:
    stack = [ex]
    while stack:
        n = stack.pop()
        drop = getattr(n, "drop_run_state", None)
        if drop is not None:
            drop()
        stack.extend(n.children)


def release(ex, ok: bool = True) -> None:
    """The end of a run of ``ex``: a memoised tree drops what its run
    built and becomes idle (held strongly, ready for the next hit); one
    whose run raised is dropped."""
    with _IDLE:
        # a waiter re-checks its entry, which may be gone meanwhile
        _IDLE.notify_all()
        entry = _entry_of(ex)
        if entry is None:
            return
        if ok:
            _drop_run_state(ex)
            entry.state = "idle"
            entry.runner = None
            entry._strong = ex
        else:
            del _CACHE[ex._plan_memo_key]


def bump_epoch() -> None:
    """Invalidate every memoised plan (the configuration is in the key
    already; this is the manual hammer for everything else)."""
    global _EPOCH
    with _LOCK:
        _EPOCH += 1
        _CACHE.clear()


def clear() -> None:
    with _LOCK:
        _CACHE.clear()


def counters() -> Dict[str, int]:
    with _LOCK:
        return {"plan_cache_hit_total": _HITS,
                "plan_cache_miss_total": _MISSES,
                "plan_cache_evict_total": _EVICTIONS,
                "plan_cache_uncacheable_total": _UNCACHEABLE,
                "plan_cache_size": len(_CACHE)}


def reset_stats() -> None:
    global _HITS, _MISSES, _EVICTIONS, _UNCACHEABLE
    with _LOCK:
        _HITS = _MISSES = _EVICTIONS = _UNCACHEABLE = 0
