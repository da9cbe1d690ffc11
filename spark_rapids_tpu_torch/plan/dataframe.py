"""DataFrame front end (counterpart of spark_rapids_tpu/plan/dataframe.py):
builders over the logical plan, planned with ``shuffle_partitions`` reduce
partitions (4 by default, as the reference's) and executed on the batches'
device.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    batch_to_arrow, resolve_device)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.mem.semaphore import get_task_semaphore
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan import plan_cache


def _cols(ks) -> List[E.Expression]:
    ks = ks if isinstance(ks, (list, tuple)) else [ks]
    return [E.col(k) if isinstance(k, str) else k for k in ks]


class DataFrame:
    def __init__(self, plan: L.LogicalPlan,
                 conf: Optional[C.RapidsConf] = None,
                 shuffle_partitions: int = 4):
        self.plan = plan
        self.conf = conf
        self.shuffle_partitions = shuffle_partitions

    def _with(self, plan: L.LogicalPlan) -> "DataFrame":
        return DataFrame(plan, self.conf, self.shuffle_partitions)

    def select(self, *exprs) -> "DataFrame":
        return self._with(L.Project(_cols(list(exprs)), self.plan))

    def with_column(self, name: str, expr: E.Expression) -> "DataFrame":
        """Append a named column, or replace the column of that name in
        place, keeping all others (Spark's ``withColumn``)."""
        exprs: List[E.Expression] = []
        replaced = False
        for f in self.plan.schema:
            if f.name == name:
                exprs.append(E.Alias(expr, name))
                replaced = True
            else:
                exprs.append(E.col(f.name))
        if not replaced:
            exprs.append(E.Alias(expr, name))
        return self._with(L.Project(exprs, self.plan))

    def filter(self, condition: E.Expression) -> "DataFrame":
        return self._with(L.Filter(condition, self.plan))

    where = filter

    def group_by(self, *keys) -> "GroupedDataFrame":
        return GroupedDataFrame(self, _cols(list(keys)))

    def agg(self, *aggs) -> "DataFrame":
        return GroupedDataFrame(self, []).agg(*aggs)

    def sort(self, *orders, limit: Optional[int] = None) -> "DataFrame":
        os_: List[SortOrder] = []
        for o in orders:
            if isinstance(o, str):
                os_.append(SortOrder(E.col(o)))
            elif isinstance(o, SortOrder):
                os_.append(o)
            else:
                os_.append(SortOrder(o))
        return self._with(L.Sort(os_, self.plan, limit=limit))

    order_by = sort

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             left_on=None, right_on=None,
             condition: Optional[E.Expression] = None) -> "DataFrame":
        """Equi-join with ``other``; ``how`` is inner, left, right, full,
        left_semi or left_anti. ``on`` names key columns that both sides
        share (one name or a list); else ``left_on``/``right_on`` give
        each side's keys (names or expressions). ``condition`` is a
        residual predicate over both sides' columns (a name resolves to
        the left side's column first): a key-equal pair where it is not
        true does not match, for every join type."""
        if on is not None:
            names = [on] if isinstance(on, str) else list(on)
            left_on = right_on = [E.col(c) for c in names]
        return self._with(L.Join(self.plan, other.plan, _cols(left_on),
                                 _cols(right_on), how, condition))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL by position (``L.Union``)."""
        return self._with(L.Union([self.plan, other.plan]))

    def with_window(self, *window_exprs) -> "DataFrame":
        """Append window columns (all expressions must share one
        (partition, order) spec — Spark WindowExec shape)."""
        return self._with(L.Window(list(window_exprs), self.plan))

    def limit(self, n: int, offset: int = 0) -> "DataFrame":
        return self._with(L.Limit(n, self.plan, offset))

    @property
    def schema(self) -> T.Schema:
        return self.plan.schema

    def physical_plan(self):
        from spark_rapids_tpu_torch.plan.overrides import Overrides

        return Overrides(self.conf, self.shuffle_partitions).apply(self.plan)

    def explain(self, mode: str = "ALL") -> str:
        """The planner's tag tree: ``*`` for a node on the device, ``!`` for
        a node on the CPU engine with the reasons (``mode`` NOT_ON_GPU lists
        only those)."""
        from spark_rapids_tpu_torch.plan.overrides import Overrides, explain

        return explain(Overrides(self.conf, self.shuffle_partitions)
                       .prepare(self.plan), mode)

    def to_arrow(self) -> pa.Table:
        return execute_to_arrow(self.physical_plan())

    def collect(self) -> List[dict]:
        return self.to_arrow().to_pylist()


def execute_to_arrow(node) -> pa.Table:
    """Run a physical plan (``DataFrame.physical_plan``) and gather its
    rows, partition by partition, each partition's drain holding a permit
    of the task semaphore (``mem/semaphore.py``; not on the small-query
    fast path); then stop its AQE readers' read-ahead, and release its
    shuffles' blocks and its reused exchanges' holds on their shared
    entries. The caller keeps
    the plan, so it can read the operators' metrics after the run, or run
    it again: its exchanges are written again, and its AQE readers read
    them through the specs they planned the first time. A tree the plan
    memo holds runs once at a time (``plan/plan_cache.acquire`` waits for
    another run of it to end), and goes back to the memo once its
    shuffles are released (``plan/plan_cache.release``), or is dropped
    from it if the run raised."""
    from spark_rapids_tpu_torch.plan.cpu import CpuExec

    schema = node.output_schema
    plan_cache.acquire(node)
    ok = False
    try:
        if isinstance(node, CpuExec):  # a CPU root: rows stay on the host
            tables = []
            for p in range(node.num_partitions()):
                rows = node.execute_host(p)
                try:
                    tables.extend(rows)
                finally:
                    # a run that raises closes its operators now (their
                    # registrations in the pool end with them), not
                    # whenever the traceback that holds them is collected
                    rows.close()
        else:
            sem = (None if getattr(node, "_fastpath", False)
                   else get_task_semaphore())
            tables = []
            for p in range(node.num_partitions()):
                # a task is one partition of one run: two threads draining
                # partition 0 are two holders, not one re-entrant one
                task = (threading.get_ident(), id(node), p)
                if sem is not None:
                    sem.acquire(task)
                batches = node.execute(p)
                try:
                    tables.extend(batch_to_arrow(b, schema) for b in batches)
                finally:
                    batches.close()
                    if sem is not None:
                        sem.release(task)
        ok = True
    finally:
        finish_run(node, ok)
    if not tables:
        return schema.to_arrow().empty_table()
    return pa.concat_tables(tables)


def finish_run(node, ok: bool) -> None:
    """The end of a run of a physical plan, also one that raised (its
    shuffles' files and blocks would otherwise live as long as the
    process-wide manager): release its shuffles, run the deferred
    releases, and give a tree lent by the plan memo back to it."""
    _cleanup_shuffles(node)
    cleaner.run_deferred()
    plan_cache.release(node, ok)


def _cleanup_shuffles(node) -> None:
    """Stop a plan's AQE readers' read-ahead, then release its shuffles'
    blocks and its reused exchanges' holds on their shared entries."""
    from spark_rapids_tpu_torch.exec.reuse import ReusedExchangeExec
    from spark_rapids_tpu_torch.shuffle.aqe import AQEShuffleReadExec
    from spark_rapids_tpu_torch.shuffle.exchange_exec import (
        ShuffleExchangeExec)

    nodes, stack = [], [node]
    while stack:
        n = stack.pop()
        nodes.append(n)
        stack.extend(n.children)
    # every reader stops before any exchange deletes blocks: a reader may
    # read a reused exchange's blocks from another subtree
    for kinds in ((AQEShuffleReadExec,),
                  (ShuffleExchangeExec, ReusedExchangeExec)):
        for n in nodes:
            if isinstance(n, kinds):
                n.cleanup()


class GroupedDataFrame:
    def __init__(self, df: DataFrame, keys: List[E.Expression]):
        self.df = df
        self.keys = keys

    def agg(self, *aggs) -> DataFrame:
        """Aggregate each group; with no aggregate, the distinct keys."""
        return self.df._with(L.Aggregate(self.keys, list(aggs), self.df.plan))


def from_arrow(table: pa.Table, conf: Optional[C.RapidsConf] = None,
               batch_rows: int = 1 << 20, device=None,
               partitions: int = 1) -> DataFrame:
    """A DataFrame over an Arrow table, uploaded in ``batch_rows`` batches
    to ``device`` (``cuda`` by default; raises when no card is present)
    and read as ``min(partitions, batches)`` source splits, batch ``i``
    in split ``i % splits``."""
    dev = resolve_device(device)
    return DataFrame(L.InMemoryScan(table, batch_rows, str(dev), partitions),
                     conf)


def read_parquet(paths, columns=None, predicate=None,
                 conf: Optional[C.RapidsConf] = None,
                 device=None) -> DataFrame:
    """A DataFrame over Parquet files (one path or a list), scanned to
    ``device`` (``cuda`` by default; raises when no card is present) in
    ``min(files, shuffle partitions)`` partitions; ``columns`` selects
    columns, ``predicate`` prunes row groups by their statistics (a filter
    above it still applies it to rows)."""
    if isinstance(paths, str):
        paths = [paths]
    dev = resolve_device(device)
    return DataFrame(L.ParquetScan(list(paths),
                                   None if columns is None else list(columns),
                                   predicate, str(dev)), conf)
