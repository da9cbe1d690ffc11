"""Row estimates of logical plans (counterpart of ``estimate_rows`` in
spark_rapids_tpu/plan/cbo.py). The planner reads them to choose a
broadcast build side. Static factors only: the reference's autotune store
has no sample for a fresh plan, so its ratio is None there too. A Parquet
scan's rows are its files' footer row counts, read once per file version
(path, size, mtime) for the process, through a pool of
``spark.rapids.gpu.sql.scan.metadataThreads``.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.plan import logical as L

# footer row counts by (path, size, mtime): a rewritten file is read anew
_FOOTER_ROWS: Dict[Tuple[str, int, int], int] = {}
_FOOTER_LOCK = threading.Lock()


def _footer_key(path: str) -> Tuple[str, int, int]:
    st = os.stat(path)
    return (path, st.st_size, st.st_mtime_ns)


def _read_footer_rows(path: str) -> int:
    import pyarrow.parquet as pq

    return int(pq.ParquetFile(path).metadata.num_rows)


def scan_rows(paths: List[str]) -> float:
    """The summed footer row counts of Parquet files, each read on first
    sight only."""
    keys = [_footer_key(p) for p in paths]
    with _FOOTER_LOCK:
        missing = [(p, k) for p, k in zip(paths, keys)
                   if k not in _FOOTER_ROWS]
    if missing:
        n_threads = min(C.SCAN_METADATA_THREADS.get(C.get_active()),
                        len(missing))
        if n_threads > 1:
            with ThreadPoolExecutor(max_workers=n_threads,
                                    thread_name_prefix="srgpu-cbo-meta") as ex:
                rows = list(ex.map(_read_footer_rows,
                                   [p for p, _ in missing]))
        else:
            rows = [_read_footer_rows(p) for p, _ in missing]
        with _FOOTER_LOCK:
            for (_, k), r in zip(missing, rows):
                _FOOTER_ROWS[k] = r
    with _FOOTER_LOCK:
        return float(sum(_FOOTER_ROWS[k] for k in keys))

_FILTER_SELECTIVITY = 0.5
_AGG_REDUCTION = 0.25


def estimate_rows(node: L.LogicalPlan,
                  _cache: Optional[Dict[int, float]] = None) -> float:
    """Estimated output rows of a logical plan node (memoized per node)."""
    if _cache is None:
        _cache = {}
    if id(node) in _cache:
        return _cache[id(node)]
    if isinstance(node, L.ParquetScan):
        est = scan_rows(list(node.paths))
    elif isinstance(node, L.InMemoryScan):
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
