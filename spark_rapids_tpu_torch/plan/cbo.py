"""Row estimates of logical plans (counterpart of ``estimate_rows`` in
spark_rapids_tpu/plan/cbo.py). The planner reads them to choose a
broadcast build side. Static factors only: the reference's autotune store
has no sample for a fresh plan, so its ratio is None there too.
"""

from __future__ import annotations

from typing import Dict, Optional

from spark_rapids_tpu_torch.plan import logical as L

_FILTER_SELECTIVITY = 0.5
_AGG_REDUCTION = 0.25


def estimate_rows(node: L.LogicalPlan,
                  _cache: Optional[Dict[int, float]] = None) -> float:
    """Estimated output rows of a logical plan node (memoized per node)."""
    if _cache is None:
        _cache = {}
    if id(node) in _cache:
        return _cache[id(node)]
    if isinstance(node, L.InMemoryScan):
        est = float(node.table.num_rows)
    else:
        kids = [estimate_rows(c, _cache) for c in node.children]
        if isinstance(node, L.Filter):
            est = kids[0] * _FILTER_SELECTIVITY
        elif isinstance(node, L.Aggregate):
            est = max(1.0, kids[0] * _AGG_REDUCTION)
        elif isinstance(node, L.Join):
            est = max(kids) if kids else 1.0
        elif isinstance(node, L.Limit):
            est = min(kids[0], float(node.n))
        elif isinstance(node, L.Union):
            est = sum(kids)
        else:
            est = kids[0] if kids else 1.0
    _cache[id(node)] = est
    return est
