"""File scans into device batches (counterpart of
spark_rapids_tpu/exec/scan.py; GpuParquetScan.scala's three reader types:
MULTITHREADED, where a thread pool reads and decodes while the task
computes, and PERFILE and COALESCING, which read a partition's items one
after another on the task's thread; the reference's COALESCING branch is
that same read, and every type re-cuts its tables into
``target_batch_rows`` batches).

Arrow C++ decodes on the host; the device is touched only by the upload of
each re-chunked table (``target_batch_rows`` rows), the analog of the
reference taking the GPU semaphore only once host buffers are ready. Each
uploaded chunk's strings are dictionary-encoded with a sorted dictionary of
their own (``dictionary_encode_table``), so two chunks of one scan do not
share codes: consumers compare, hash and concatenate strings by value
across batches, as they do over a shuffle read's chunks.

With ``spark.rapids.gpu.sql.prefetch.enabled`` (read from the scan's conf)
the encode and upload of chunk N+1 run on a staging worker
(``exec/pipeline.PrefetchIterator``) on the consumer's CUDA stream while
the consumer computes on chunk N; the decode pool feeds the stager.
Closing a scan mid-way awaits the reads in flight (``windowed_map``) and
joins the pool and the stager.

``ParquetScanExec`` plans row-group tasks per partition from the files'
footers (a pool of ``spark.rapids.gpu.sql.scan.metadataThreads``), pruning
row groups whose min/max statistics prove that the pushed predicate
(``_stats_may_match``) or a dynamic pruning filter (``exec/dpp.py``) can
match no row. Files go to partitions round-robin (file ``i`` to partition
``i % n_partitions``).

Metrics: ``scanTimeNs`` (host read and decode), ``uploadTimeNs`` (encode
and host-to-device copy, host clock), ``numRowGroups``,
``numPrunedRowGroups``, ``numDynPrunedRowGroups``.
"""

from __future__ import annotations

import bisect
import concurrent.futures as cf
import dataclasses
import datetime
from collections import deque
from typing import Iterator, List, Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, batch_from_arrow, dictionary_encode_table, resolve_device)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.base import DeviceExec
from spark_rapids_tpu_torch.exprs import expr as E


def windowed_map(pool, fn, items, window: int):
    """``pool.map`` with a bounded in-flight window: reads overlap
    consumption without every decoded table held at once.

    On close, queued futures are cancelled and the running calls are
    awaited (never abandoned mid-decode), so no read outlives its
    consumer."""
    items = iter(items)
    inflight = deque()
    try:
        for it in items:
            inflight.append(pool.submit(fn, it))
            if len(inflight) >= window:
                yield inflight.popleft().result()
        while inflight:
            yield inflight.popleft().result()
    finally:
        for f in inflight:
            f.cancel()
        cf.wait([f for f in inflight if not f.cancelled()])


class FileScanBase(DeviceExec):
    """Base of the single-format file scans: subclasses provide
    ``_read_path(path) -> pa.Table`` and ``_read_schema() -> pa.Schema``;
    a finer work split than the file (parquet row groups) overrides
    ``_partition_items``/``_read_item``. ``device`` is where the batches
    go (``cuda`` unless named; without a card it raises)."""

    def __init__(self, paths: Sequence[str],
                 columns: Optional[Sequence[str]] = None,
                 reader_type: str = "MULTITHREADED",
                 reader_threads: int = 8,
                 target_batch_rows: int = 1 << 20,
                 n_partitions: int = 1,
                 device=None,
                 conf: Optional[C.RapidsConf] = None):
        super().__init__()
        assert reader_type in C.PARQUET_READER_TYPES, reader_type
        self.paths = list(paths)
        self.columns = list(columns) if columns is not None else None
        self.reader_type = reader_type
        self.reader_threads = reader_threads
        self.target_batch_rows = target_batch_rows
        self.n_partitions = n_partitions
        self.device = resolve_device(device)
        self.conf = conf if conf is not None else C.get_active()
        self._schema: Optional[T.Schema] = None
        self._first_cache = None  # (item, table) kept by schema inference
        self._register_metric("scanTimeNs")
        self._register_metric("uploadTimeNs")

    # subclass surface -----------------------------------------------------
    def _read_schema(self) -> pa.Schema:
        raise NotImplementedError

    def _read_path(self, path: str) -> pa.Table:
        raise NotImplementedError

    # ----------------------------------------------------------------------
    @property
    def output_schema(self) -> T.Schema:
        if self._schema is None:
            arrow_schema = self._read_schema()
            if self.columns is not None:
                arrow_schema = pa.schema(
                    [arrow_schema.field(c) for c in self.columns])
            self._schema = T.Schema.from_arrow(arrow_schema)
        return self._schema

    def num_partitions(self) -> int:
        return self.n_partitions

    def plan_device(self):
        return self.device

    def node_description(self) -> str:
        cols = f" columns={self.columns}" if self.columns else ""
        return (f"{type(self).__name__} [{len(self.paths)} files,"
                f" {self.reader_type}]{cols}")

    def _files_for_partition(self, partition: int) -> List[str]:
        return [p for i, p in enumerate(self.paths)
                if i % self.n_partitions == partition]

    def _project(self, t: pa.Table) -> pa.Table:
        schema = self.output_schema.to_arrow()
        # select first: a cast cannot reorder fields (JSON files whose keys
        # come in other orders)
        return t.select(schema.names).cast(schema)

    _MAX_INFER_CACHE_BYTES = 256 << 20

    def _cache_inferred(self, item, table) -> None:
        """A schema-inferring subclass keeps the decoded first file here so
        execution does not decode it twice (not when it is large: a
        planning-only process would hold it for the node's life)."""
        if table.nbytes <= self._MAX_INFER_CACHE_BYTES:
            self._first_cache = (item, table)

    def _take_cached(self, item):
        if self._first_cache is not None and self._first_cache[0] == item:
            t = self._first_cache[1]
            self._first_cache = None
            return t
        return None

    # work-splitting hooks: one item per file by default
    def _partition_items(self, partition: int) -> List:
        return self._files_for_partition(partition)

    def _read_item(self, item) -> pa.Table:
        return self._read_path(item)

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        items = self._partition_items(partition)
        if not items:
            return
        # the schema once, on the caller's thread: schema-inferring
        # subclasses would otherwise parse the first file in every worker
        _ = self.output_schema

        def read(it):
            with self.timer("scanTimeNs"):
                t = self._take_cached(it)
                if t is None:
                    t = self._read_item(it)
                return self._project(t)

        if self.reader_type == "MULTITHREADED":
            pool = cf.ThreadPoolExecutor(self.reader_threads,
                                         thread_name_prefix="srgpu-scan")
            window = max(self.reader_threads,
                         C.SCAN_COMBINE_WINDOW.get(self.conf))
            try:
                yield from self.upload_batched(
                    windowed_map(pool, read, items, window))
            finally:
                # queued reads dropped, running decodes finished
                pool.shutdown(wait=True, cancel_futures=True)
        else:  # PERFILE, COALESCING
            yield from self.upload_batched(map(read, items))

    def _rechunk(self, tables) -> Iterator[pa.Table]:
        """Decoded tables re-cut on the host into ``target_batch_rows``
        windows."""
        pending: List[pa.Table] = []
        pending_rows = 0
        for t in tables:
            pending.append(t)
            pending_rows += t.num_rows
            while pending_rows >= self.target_batch_rows:
                whole = pa.concat_tables(pending)
                yield whole.slice(0, self.target_batch_rows)
                rest = whole.slice(self.target_batch_rows)
                pending = [rest] if rest.num_rows else []
                pending_rows = rest.num_rows
        if pending_rows > 0:
            yield pa.concat_tables(pending)

    def _stage_upload(self, t: pa.Table) -> ColumnarBatch:
        """Dictionary-encode and upload one chunk (the stager's unit of
        work), its strings under a dictionary of its own."""
        with self.timer("uploadTimeNs"):
            return batch_from_arrow(dictionary_encode_table(t), self.device,
                                    dict_cache={})

    def upload_batched(self, tables) -> Iterator[ColumnarBatch]:
        """Re-chunk host tables to ``target_batch_rows`` and upload each
        once; with prefetch on, through a staging worker on the consumer's
        stream (see the module docstring)."""
        from spark_rapids_tpu_torch.exec.pipeline import (
            PrefetchIterator, prefetch_settings)

        enabled, depth = prefetch_settings(self.conf)
        chunks = self._rechunk(tables)
        if not enabled:
            try:
                for t in chunks:
                    yield self._stage_upload(t)
            finally:
                chunks.close()
            return
        stager = PrefetchIterator(map(self._stage_upload, chunks),
                                  depth=depth, label="scan-stage",
                                  device=self.device)
        try:
            yield from stager
        finally:
            stager.close()
            # the stager is joined, so nothing runs the chunk generator
            # now: closing it unwinds windowed_map
            chunks.close()


@dataclasses.dataclass
class RowGroupTask:
    path: str
    row_groups: List[int]


def values_may_overlap(vals: List, mn, mx) -> bool:
    """Could any of the sorted values fall inside ``[mn, mx]``? True on
    unknown bounds and on values that do not compare with them (a
    ``TypeError``, as the reference's ``may_match``)."""
    if mn is None or mx is None:
        return True
    try:
        i = bisect.bisect_left(vals, mn)
        return i < len(vals) and vals[i] <= mx
    except TypeError:
        return True


def _stats_may_match(expr: E.Expression, stats_by_col) -> bool:
    """Conservative row-group pruning: False only when the statistics
    prove no row can match. And/Or and ``col <op> literal``; a literal that
    does not compare with the statistics (a ``TypeError``) may match."""
    if isinstance(expr, E.And):
        return (_stats_may_match(expr.left, stats_by_col)
                and _stats_may_match(expr.right, stats_by_col))
    if isinstance(expr, E.Or):
        return (_stats_may_match(expr.left, stats_by_col)
                or _stats_may_match(expr.right, stats_by_col))
    if isinstance(expr, E.BinaryComparison):
        col, litv, flipped = _col_lit(expr)
        if col is None or col not in stats_by_col:
            return True
        mn, mx = stats_by_col[col]
        if mn is None or mx is None:
            return True
        op = type(expr).__name__
        if flipped:
            flip = {"LessThan": "GreaterThan", "GreaterThan": "LessThan",
                    "LessThanOrEqual": "GreaterThanOrEqual",
                    "GreaterThanOrEqual": "LessThanOrEqual"}
            op = flip.get(op, op)
        try:
            if op == "EqualTo":
                return mn <= litv <= mx
            if op == "LessThan":
                return mn < litv
            if op == "LessThanOrEqual":
                return mn <= litv
            if op == "GreaterThan":
                return mx > litv
            if op == "GreaterThanOrEqual":
                return mx >= litv
        except TypeError:
            return True
    return True


_EPOCH = datetime.date(1970, 1, 1)
_EPOCH_TS = datetime.datetime(1970, 1, 1)


def stats_value(lit: E.Literal):
    """A literal's value as the Python value parquet statistics hold and
    the reference's literal carries: the port keeps a DATE as its days and
    a TIMESTAMP as its microseconds, the reference the ``date`` and the
    (naive) ``datetime`` it was given."""
    v = lit.value
    if v is None:
        return None
    if lit.dtype == T.DATE and isinstance(v, int):
        return _EPOCH + datetime.timedelta(days=v)
    if lit.dtype == T.TIMESTAMP and isinstance(v, int):
        return _EPOCH_TS + datetime.timedelta(microseconds=v)
    return v


def _col_lit(expr: E.BinaryComparison):
    left, right = expr.left, expr.right
    cols = (E.UnresolvedColumn, E.ColumnRef)
    if isinstance(left, cols) and isinstance(right, E.Literal):
        return left.name, stats_value(right), False
    if isinstance(right, cols) and isinstance(left, E.Literal):
        return right.name, stats_value(left), True
    return None, None, False


class ParquetScanExec(FileScanBase):
    """Parquet files into device batches: files split across
    ``n_partitions``, row groups pruned at planning, the reader type
    deciding the host-side strategy within a partition."""

    def __init__(self, paths: Sequence[str],
                 columns: Optional[Sequence[str]] = None,
                 predicate: Optional[E.Expression] = None,
                 **kw):
        super().__init__(paths, columns, **kw)
        self.predicate = predicate
        # runtime filters the planner attaches for dynamic partition
        # pruning (exec/dpp.py); read at the first task planning
        self.dynamic_filters: List = []
        self._register_metric("numRowGroups")
        self._register_metric("numPrunedRowGroups")
        self._register_metric("numDynPrunedRowGroups")

    def _read_schema(self) -> pa.Schema:
        return pq.read_schema(self.paths[0])

    def node_description(self) -> str:
        cols = f" columns={self.columns}" if self.columns else ""
        dyn = "".join(f" {f.describe()}" for f in self.dynamic_filters)
        return (f"ParquetScan [{len(self.paths)} files,"
                f" {self.reader_type}]{cols}{dyn}")

    def drop_run_state(self) -> None:
        for f in self.dynamic_filters:
            f.reset()

    # -- planning ----------------------------------------------------------
    def _plan_file(self, path: str):
        """Footer and row-group statistics of one file (a pool worker):
        (kept row groups, total, pruned, dynamically pruned). The caller
        adds the metrics, on its own thread."""
        md = pq.ParquetFile(path).metadata
        keep, pruned, dyn_pruned = [], 0, 0
        prune = (self.predicate is not None
                 and C.SCAN_ROW_GROUP_PRUNING.get(self.conf))
        for rg in range(md.num_row_groups):
            if prune and self._prune(md, rg):
                pruned += 1
                continue
            if self.dynamic_filters and self._dyn_prune(md, rg):
                dyn_pruned += 1
                continue
            keep.append(rg)
        return keep, md.num_row_groups, pruned, dyn_pruned

    def _tasks_for_partition(self, partition: int) -> List[RowGroupTask]:
        files = self._files_for_partition(partition)
        if not files:
            return []
        # footers are small random reads: a bounded pool overlaps them
        n_threads = min(C.SCAN_METADATA_THREADS.get(self.conf), len(files))
        if n_threads > 1:
            with cf.ThreadPoolExecutor(
                    max_workers=n_threads,
                    thread_name_prefix="srgpu-pq-meta") as ex:
                planned = list(ex.map(self._plan_file, files))
        else:
            planned = [self._plan_file(p) for p in files]
        tasks = []
        for path, (keep, total, pruned, dyn_pruned) in zip(files, planned):
            self.metrics["numRowGroups"].add(total)
            self.metrics["numPrunedRowGroups"].add(pruned)
            self.metrics["numDynPrunedRowGroups"].add(dyn_pruned)
            if keep:
                tasks.append(RowGroupTask(path, keep))
        return tasks

    def _prune(self, md, rg_index: int) -> bool:
        return not _stats_may_match(self.predicate,
                                    self._rg_stats(md, rg_index))

    def _dyn_prune(self, md, rg_index: int) -> bool:
        """The row group is disjoint from some runtime filter's keys."""
        stats_by_col = self._rg_stats(md, rg_index)
        for f in self.dynamic_filters:
            st = stats_by_col.get(f.column)
            if st is not None and not f.may_match(st[0], st[1]):
                return True
        return False

    @staticmethod
    def _rg_stats(md, rg_index: int):
        rg = md.row_group(rg_index)
        stats_by_col = {}
        for ci in range(rg.num_columns):
            col = rg.column(ci)
            st = col.statistics
            if st is not None and st.has_min_max:
                stats_by_col[col.path_in_schema] = (st.min, st.max)
        return stats_by_col

    # -- reading: the base's dispatch over row-group tasks -----------------
    def _partition_items(self, partition: int) -> List[RowGroupTask]:
        return self._tasks_for_partition(partition)

    def _read_item(self, task: RowGroupTask) -> pa.Table:
        f = pq.ParquetFile(task.path)
        return f.read_row_groups(task.row_groups, columns=self.columns,
                                 use_threads=False)
