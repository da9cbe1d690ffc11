"""Logical -> physical conversion (the converter part of
spark_rapids_tpu/plan/overrides.py).

Every plan becomes a single-partition physical tree with no exchange. A
node or expression outside the port raises NotImplementedError naming it;
there is no CPU fallback engine yet.
"""

from __future__ import annotations

import threading
import weakref
from typing import List, Optional

from spark_rapids_tpu_torch.columnar.batch import (
    batch_from_arrow, dictionary_encode_table)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec
from spark_rapids_tpu_torch.exec.base import BatchSourceExec, DeviceExec
from spark_rapids_tpu_torch.exec.join import HashJoinExec
from spark_rapids_tpu_torch.exec.project import FilterExec, ProjectExec
from spark_rapids_tpu_torch.exec.sort import LimitExec, SortExec
from spark_rapids_tpu_torch.exec.window import WindowExec
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.exprs import window as W
from spark_rapids_tpu_torch.plan import logical as L


# uploaded batches per (arrow table, batch_rows, device), so plans over one
# table reuse one upload; an entry drops when its table is collected
_SOURCE_CACHE: dict = {}
_SOURCE_LOCK = threading.Lock()


def source_batches(node: L.InMemoryScan):
    """Upload a table as device batches of ``batch_rows`` rows. Strings are
    dictionary-encoded once for the whole table, so every batch shares one
    device dictionary."""
    key = (id(node.table), node.batch_rows, node.device)
    with _SOURCE_LOCK:
        ent = _SOURCE_CACHE.get(key)
        if ent is not None and ent[0]() is node.table:
            return ent[1]
    t = dictionary_encode_table(node.table)
    cache: dict = {}
    batches = [batch_from_arrow(t.slice(i, node.batch_rows), node.device,
                                dict_cache=cache)
               for i in range(0, max(t.num_rows, 1), node.batch_rows)]
    ref = weakref.ref(node.table,
                      lambda _r, k=key: _SOURCE_CACHE.pop(k, None))
    with _SOURCE_LOCK:
        _SOURCE_CACHE[key] = (ref, batches)
    return batches


def _check_exprs(exprs) -> None:
    for e in exprs:
        E.check_supported(e)


class Overrides:
    def __init__(self, conf: Optional[C.RapidsConf] = None):
        self.conf = conf or C.RapidsConf()

    def apply(self, plan: L.LogicalPlan) -> DeviceExec:
        C.set_active(self.conf)
        return self._convert(plan)

    def _convert(self, node: L.LogicalPlan) -> DeviceExec:
        kids: List[DeviceExec] = [self._convert(c) for c in node.children]
        if isinstance(node, L.InMemoryScan):
            return BatchSourceExec([source_batches(node)], node.schema,
                                   node.device)
        if isinstance(node, L.Project):
            _check_exprs(node.exprs)
            return ProjectExec(node.exprs, kids[0])
        if isinstance(node, L.Filter):
            _check_exprs([node.condition])
            return FilterExec(node.condition, kids[0])
        if isinstance(node, L.Aggregate):
            _check_exprs(node.group_exprs + node.agg_exprs)
            return HashAggregateExec(node.group_exprs, node.agg_exprs,
                                     kids[0], mode="complete")
        if isinstance(node, L.Window):
            # one partition, so no exchange; the window's functions and
            # frames are checked by WindowExec itself
            for e in node.window_exprs:
                inner = e.child if isinstance(e, E.Alias) else e
                if not isinstance(inner, W.WindowExpression):
                    raise NotImplementedError(f"not a window expression: "
                                              f"{e!r}")
                spec = inner.spec
                _check_exprs(list(spec.partition_by)
                             + [o.child for o in spec.order_by]
                             + list(inner.function.children))
            return WindowExec(node.window_exprs, kids[0])
        if isinstance(node, L.Sort):
            _check_exprs([o.child for o in node.orders])
            return SortExec(node.orders, kids[0], limit=node.limit)
        if isinstance(node, L.Join):
            _check_exprs(node.left_keys + node.right_keys)
            return HashJoinExec(node.left_keys, node.right_keys,
                                node.join_type, kids[0], kids[1],
                                max_candidate_rows=C.JOIN_MAX_OUTPUT_ROWS.get(
                                    self.conf))
        if isinstance(node, L.Limit):
            return LimitExec(node.n, kids[0], node.offset)
        raise NotImplementedError(
            f"plan node {type(node).__name__} is not in the port yet")
