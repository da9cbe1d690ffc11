"""Sort of one partition, with an optional limit, in core or out of core
(counterpart of spark_rapids_tpu/exec/sort.py). The planner's sort with a
limit is ``misc.take_ordered_and_project``.

In core, the partition's batches are concatenated on the device, one
stable lexicographic argsort orders the rows (Spark null and NaN order),
and one gather emits them, cut to ``limit`` rows when given. A
plain-string key sorts on all the bytes of its longest row (one host read
per such key), then its length, so ORDER BY on strings is exact at any
length.

Out of core (``out_of_core=True``, the reference's
GpuOutOfCoreSortIterator; the planner puts it under a streaming window),
no step needs the whole partition on the device: each input batch is
sorted into a run held as a spillable handle (``mem/spill.py``); past
``spark.rapids.gpu.sql.sort.outOfCore.maxMergeRuns`` runs, the oldest
are pre-merged into combined spillable runs; then each output batch takes
a boundary, the least over the runs of the key at ``targetRows / runs``
rows past each run's cursor, and every remaining row at or below it from
every run, and merges that bounded set. The boundary compares a coarse
key, the most significant words of the first sort key (a plain string's
null flag and first eight bytes), which orders the rows as the full key
does; rows equal on it, ties included, all go into one output batch, so
the batches come out in global order (and a window partitioned by the
first key never spans two of them). A merge set is a stable sort of its
pieces' concatenation in run order, so ties keep their input order and
the output equals the in-core sort's, row for row. Every handle a
pre-merge reads stays pinned, and so accounted on the pool, until the
combined run is made, as the reference's do.
(``...outOfCore.mergePath``, the reference's binary-search merge for a
one-word key, is accepted and has no effect: the stable sort gives the
same rows.)
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.mem import retry, spill


@dataclasses.dataclass(frozen=True)
class SortOrder:
    child: E.Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = Spark default for direction

    def __repr__(self):
        return f"{self.child!r} {'ASC' if self.ascending else 'DESC'}"


class SortExec(UnaryExec):
    def __init__(self, orders: Sequence[SortOrder], child: DeviceExec,
                 limit: Optional[int] = None, out_of_core: bool = False,
                 target_rows: Optional[int] = None):
        super().__init__(child)
        self.orders = list(orders)
        self.limit = limit
        self.out_of_core = out_of_core
        schema = child.output_schema
        self._specs = []
        for o in self.orders:
            bound = E.resolve(o.child, schema)
            if not isinstance(bound, E.ColumnRef):
                raise NotImplementedError("sort keys must be column refs")
            self._specs.append(K.SortSpec(bound.index, o.ascending,
                                          o.nulls_first))
        if out_of_core and limit is not None:
            raise ValueError("an out-of-core sort takes no limit")
        cf = C.get_active()
        self.target_rows = (target_rows if target_rows is not None
                            else C.SORT_OOC_TARGET_ROWS.get(cf))
        self.max_merge_runs = C.SORT_OOC_MAX_MERGE_RUNS.get(cf)
        for name in ("sortTimeNs", "sortRuns", "sortPremerges",
                     "sortMergeBatches"):
            self._register_metric(name)

    def node_description(self) -> str:
        lim = f" limit={self.limit}" if self.limit is not None else ""
        ooc = " out_of_core" if self.out_of_core else ""
        return f"Sort [{', '.join(map(repr, self.orders))}]{lim}{ooc}"

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        if self.out_of_core:
            yield from OutOfCoreSortIterator(
                self.child.execute(partition), self._specs,
                self.target_rows, self.max_merge_runs, node=self)
            return
        batches = list(self.child.execute(partition))
        if not batches:
            return
        with self.timer("sortTimeNs"):
            batch = K.concat_device(batches)
            idx = K.sort_indices(batch, self._specs)
            if self.limit is not None:
                idx = idx[: self.limit]
            out = K.gather_batch(batch, idx)
        yield out


# ---------------------------------------------------------------------------
# the out-of-core sort
# ---------------------------------------------------------------------------


def _boundary_keys(col, spec: K.SortSpec) -> List[torch.Tensor]:
    """The coarse key of the first sort spec, most significant first (at
    most three words, in torch's signed order): a prefix of the full key's
    words, or a plain string's null flag and first eight bytes."""
    nulls_first = spec.ascending if spec.nulls_first is None \
        else spec.nulls_first
    if col.is_dict:
        # codes of different dictionaries do not compare: use the bytes
        col = K.decode_dictionary(col)
    if col.offsets is not None:
        v = col.validity
        w = K.string_full_keys(col, 1)[0]
        if not spec.ascending:
            w = ~w
        null_key = v.int() if nulls_first else 1 - v.int()
        return [null_key, torch.where(v, w, torch.zeros_like(w))]
    keys = K.sortable_keys(col, spec.ascending, spec.nulls_first)
    return list(reversed(keys))[:3]


def _count_le(keys: List[torch.Tensor], offset: int,
              bounds: List[torch.Tensor]) -> torch.Tensor:
    """Rows at or past ``offset`` whose coarse key is at or below
    ``bounds``, as a device scalar."""
    le = torch.zeros(keys[0].numel() - offset, dtype=torch.bool,
                     device=keys[0].device)
    eq = torch.ones_like(le)
    for k, b in zip(keys, bounds):
        kk = k[offset:]
        le = le | (eq & (kk < b))
        eq = eq & (kk == b)
    return (le | eq).sum()


class _SortRun:
    """One sorted run: its segments (a handle each, in order, contiguous
    in the run's order: a registration split under pool pressure cuts a
    run into several), their coarse keys, and how many rows were
    emitted."""

    def __init__(self, segments: List[Tuple[spill.SpillableBatch,
                                            List[torch.Tensor]]]):
        self.segments = segments
        self.offset = 0  # rows of the first segment already emitted

    def _at(self, j: int):
        """(segment index, row in it) of the run's row ``j``."""
        for i, (h, _k) in enumerate(self.segments):
            if j < h.num_rows:
                return i, j
            j -= h.num_rows
        raise IndexError(j)

    def boundary_key(self, t: int) -> List[torch.Tensor]:
        """The coarse key of the ``t``-th remaining row (the last when
        fewer remain)."""
        total = sum(h.num_rows for h, _k in self.segments)
        i, r = self._at(min(self.offset + t - 1, total - 1))
        return [k[r] for k in self.segments[i][1]]

    def count_le(self, bounds) -> torch.Tensor:
        """Rows of the first segment's remainder at or below ``bounds``
        (a device scalar; ``take_le`` reads it)."""
        h, keys = self.segments[0]
        return _count_le(keys, self.offset, bounds)

    def take_le(self, bounds, first: int) -> List[ColumnarBatch]:
        """The remaining rows at or below ``bounds`` (``first`` of them in
        the first segment), one piece per segment they span; closes the
        segments they exhaust. A piece is a view of its handle's batch,
        unpinned once sliced as the reference's copy is: the merge set it
        joins is bounded by ``targetRows``."""
        pieces = []
        c = first
        while self.segments:
            h, keys = self.segments[0]
            start = self.offset
            if c:
                pieces.append(K.slice_batch(retry.get_with_retry(h), start,
                                            start + c))
                h.unpin()
            if start + c < h.num_rows:
                self.offset = start + c
                break
            h.close()
            self.segments.pop(0)
            self.offset = 0
            if self.segments:
                c = int(self.count_le(bounds))
        return pieces

    def take_all(self, held: List[spill.SpillableBatch]
                 ) -> List[ColumnarBatch]:
        """Every segment's batch, each handle pinned and put into
        ``held`` for ``_release``; the run is left empty."""
        out = []
        while self.segments:
            h, _k = self.segments.pop(0)
            try:
                out.append(retry.get_with_retry(h))
            except BaseException:
                h.close()
                raise
            held.append(h)
        return out

    def close(self) -> None:
        for h, _k in self.segments:
            h.close()
        self.segments = []


def _release(held: List[spill.SpillableBatch]) -> None:
    """Unpin and close the handles a pre-merge read."""
    for h in held:
        h.unpin()
        h.close()
    held.clear()


class OutOfCoreSortIterator:
    """The out-of-core sort of one partition (see the module docstring);
    ``node``, the ``SortExec``, takes its timer and metrics."""

    def __init__(self, source, specs: Sequence[K.SortSpec],
                 target_rows: int, max_merge_runs: int,
                 node: Optional[SortExec] = None):
        self.source = source
        self.specs = list(specs)
        self.target_rows = max(int(target_rows), 1)
        self.max_runs = max(int(max_merge_runs), 2)
        self.node = node

    def _timer(self):
        return self.node.timer("sortTimeNs") if self.node is not None \
            else _NullTimer()

    def _metric(self, name: str) -> None:
        if self.node is not None:
            self.node.metrics[name].add(1)

    def _run_of(self, batch: ColumnarBatch, fw) -> _SortRun:
        """``batch`` (sorted) as a spillable run with its coarse keys."""
        segments = []
        for h in spill.spillable([batch], fw):
            b = retry.get_with_retry(h)
            keys = _boundary_keys(b.columns[self.specs[0].column],
                                  self.specs[0])
            h.unpin()
            segments.append((h, keys))
        return _SortRun(segments)

    def _combine(self, pieces: List[ColumnarBatch]) -> ColumnarBatch:
        """One sorted batch of presorted pieces (in run order)."""
        if len(pieces) == 1:
            return pieces[0]
        merged = K.concat_device(pieces)
        return K.gather_batch(merged, K.sort_indices(merged, self.specs))

    def __iter__(self) -> Iterator[ColumnarBatch]:
        fw = spill.get_framework()
        runs: List[_SortRun] = []
        held: List[spill.SpillableBatch] = []
        try:
            for b in self.source:
                if b.num_rows == 0:
                    continue
                with self._timer():
                    sb = K.gather_batch(b, K.sort_indices(b, self.specs))
                runs.append(self._run_of(sb, fw))
                self._metric("sortRuns")
                del b, sb
            # a bounded merge set: the oldest runs past the cap are
            # pre-merged into one combined run, first in run order
            while len(runs) > self.max_runs:
                group, runs[:] = runs[:self.max_runs], runs[self.max_runs:]
                try:
                    with self._timer():
                        comb = self._combine([b for r in group
                                              for b in r.take_all(held)])
                finally:
                    _release(held)
                    for r in group:
                        r.close()
                runs.insert(0, self._run_of(comb, fw))
                del comb
                self._metric("sortPremerges")
            yield from self._emit(runs)
        finally:
            _release(held)
            for r in runs:
                r.close()

    def _emit(self, runs: List[_SortRun]) -> Iterator[ColumnarBatch]:
        t = max(self.target_rows // max(len(runs), 1), 1)
        while runs:
            with self._timer():
                # one host read per key word for the candidates, one for
                # the counts
                keys = [r.boundary_key(t) for r in runs]
                words = [torch.stack([k[i] for k in keys]).tolist()
                         for i in range(len(keys[0]))]
                host = list(zip(*words))
                bounds = keys[min(range(len(runs)), key=host.__getitem__)]
                counts = torch.stack([r.count_le(bounds)
                                      for r in runs]).tolist()
                pieces = []
                for r, c in zip(runs, counts):
                    pieces.extend(r.take_le(bounds, c))
                runs[:] = [r for r in runs if r.segments]
                out = self._combine(pieces)
                del pieces
            self._metric("sortMergeBatches")
            yield out


class _NullTimer:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
