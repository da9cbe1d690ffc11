"""Hash equi-join (counterpart of the ``ht`` and ``sorted`` paths of
spark_rapids_tpu/exec/join.py): inner, left, right and full outer, left
semi and left anti.

The build (right) side is collected as spillable handles
(``mem/spill.py``) and concatenated once, every handle pinned until the
concat is made; the output chunks of a probe batch wait as spillable
handles until each is yielded. On the hash-table path (the default) the
build's key hash pair is inserted into a ``kernels.HashTable``; each
probe batch hashes its keys, finds each row's slot through the probe
kernel's wrapper and reads the slot's candidate range of build rows. On
the sorted-hash path (``spark.rapids.gpu.sql.join.hashTable.enabled``
false, or every seeded table build overflowed its probe bound, as the
reference's ``_choose_path``) the build's key hashes are sorted once
(``kernels.prepare_join_side``) and each probe row's candidate range is
found by binary search (``kernels.join_candidate_counts``). Both paths then
share everything else: they expand the candidate pairs and keep the pairs
whose real keys are equal, so a hash collision only costs a discarded
candidate, and they emit the same rows. Payload columns of every type,
DECIMAL128 limbs included, are gathered as rows; a DECIMAL128 key raises,
as the reference's does (the planner keeps such a join on the CPU
engine). The metrics ``hashTableJoins``,
``sortedHashJoins`` and ``sortedHashFallbacks`` record the path each
execution took; ``join_path`` reads it from them.

Outer, semi and anti joins keep the reference's matched flags, all on the
device:

- ``pmatch`` (per probe batch): the probe rows with at least one verified
  pair, ORed over the batch's chunks. Left and full joins emit the rows
  without one after the pairs of the batch's last chunk, in the same
  output batch, with null build columns; semi and anti joins emit the
  rows with one, or without one, once each and no pairs.
- ``build_matched`` (across probe batches): the build rows that were
  paired. Right and full joins emit the others once, after the last probe
  batch, with null probe columns.

A residual ``condition`` (over the left columns, then the right, as the
reference binds it) is evaluated over every key-verified pair of a chunk,
on the columns it reads gathered at the pair's rows (``PairCondition``),
and ANDed into the verified mask before the compaction and the matched
flags, in the one ``_join_batch`` both paths share. A pair where it is
false or null is no match: it pairs nothing, and it counts for neither
``pmatch`` nor ``build_matched``, so an outer join keeps such rows
unmatched and an anti join keeps their probe rows.

A null key never matches: such a probe row is kept by left, full and anti
joins and dropped by semi joins; such a build row is never probed and is
emitted by right and full joins. An empty build side still emits every
probe row of a left, full or anti join, and an empty probe side every
build row of a right or full join.

Host reads per probe batch: the candidate total (sizes the expansion and
feeds the explosion guard), the verified pair count of each output chunk
(joins that emit pairs), and one count of the rows that a left, full, semi
or anti join emits unpaired; one more after the last batch for right and
full joins. Chunks stay on the device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, empty_batch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import BinaryExec, DeviceExec
from spark_rapids_tpu_torch.exprs import eval as EV
from spark_rapids_tpu_torch.exprs import expr as E
from spark_rapids_tpu_torch.mem import retry, spill

JOIN_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti")


def join_schema(ls: T.Schema, rs: T.Schema, join_type: str) -> T.Schema:
    """A join's output: the left side alone for semi and anti joins, else
    both sides, nullable on a side whose rows can be missing."""
    if join_type in ("left_semi", "left_anti"):
        return T.Schema(list(ls))
    lf = [T.Field(f.name, f.dtype,
                  f.nullable or join_type in ("right", "full")) for f in ls]
    rf = [T.Field(f.name, f.dtype,
                  f.nullable or join_type in ("left", "full")) for f in rs]
    return T.Schema(lf + rf)


def _null_columns(schema: T.Schema, n: int, device,
                  like: Optional[ColumnarBatch]) -> List[DeviceColumn]:
    """Null columns of a side's schema; a dictionary column of ``like``
    lends its dictionary, so the chunks concatenate by code."""
    out = []
    for i, f in enumerate(schema):
        d = (like.columns[i].dictionary if like is not None
             and like.columns[i].is_dict else None)
        out.append(K.null_column(f.dtype, n, device, d))
    return out


def condition_columns(condition: E.Expression,
                      pair: T.Schema) -> List[int]:
    """The pair-schema ordinals a (name-based) join condition reads."""
    if isinstance(condition, E.ColumnRef):
        raise NotImplementedError("a join condition names its columns; it "
                                  "takes no bound column reference")
    if isinstance(condition, E.UnresolvedColumn):
        return [pair.index_of(condition.name)]
    return sorted({i for c in condition.children
                   for i in condition_columns(c, pair)})


class PairCondition:
    """A join's residual condition bound over just the pair-schema
    columns it reads (``columns``; the left side's ``n_left`` columns come
    first)."""

    def __init__(self, condition: E.Expression, ls: T.Schema,
                 rs: T.Schema):
        pair = T.Schema(list(ls) + list(rs))
        self.columns = condition_columns(condition, pair) or [0]
        self.n_left = len(ls)
        self.bound = E.resolve(condition, T.Schema(
            [pair[i] for i in self.columns]))

    def holds(self, probe: ColumnarBatch, pc: torch.Tensor,
              build: ColumnarBatch, build_row: torch.Tensor) -> torch.Tensor:
        """Per pair (probe row ``pc``, build row ``build_row``): whether
        the condition is true (null is not)."""
        nl = self.n_left
        cols = [K.gather_column(probe.columns[i], pc) if i < nl
                else K.gather_column(build.columns[i - nl], build_row)
                for i in self.columns]
        v = EV.eval_expr(self.bound, EV.EvalContext(
            ColumnarBatch(cols, pc.numel())))
        return v.data & v.validity


class HashJoinExec(BinaryExec):
    def __init__(self, left_keys: Sequence[E.Expression],
                 right_keys: Sequence[E.Expression], join_type: str,
                 left: DeviceExec, right: DeviceExec,
                 max_candidate_rows: Optional[int] = None,
                 condition: Optional[E.Expression] = None):
        super().__init__(left, right)
        if join_type not in JOIN_TYPES:
            raise NotImplementedError(
                f"{join_type} join is not in the port yet")
        cf = C.get_active()
        self.join_type = join_type
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.max_candidate_rows = (max_candidate_rows
                                   if max_candidate_rows is not None
                                   else C.JOIN_MAX_OUTPUT_ROWS.get(cf))
        self.chunk_target_rows = C.JOIN_CHUNK_TARGET_ROWS.get(cf)
        self.hashtbl_enabled = C.JOIN_HASHTBL_ENABLED.get(cf)
        ls, rs = left.output_schema, right.output_schema
        self._lkeys = [self._key_index(k, ls) for k in self.left_keys]
        self._rkeys = [self._key_index(k, rs) for k in self.right_keys]
        self._schema = join_schema(ls, rs, join_type)
        self.condition = condition
        self._cond = (PairCondition(condition, ls, rs)
                      if condition is not None else None)
        for name in ("buildTimeNs", "joinTimeNs", "numCandidatePairs",
                     "numProbeBatches", "numChunks", "hashTableJoins",
                     "sortedHashJoins", "sortedHashFallbacks"):
            self._register_metric(name)

    @staticmethod
    def _key_index(k: E.Expression, schema: T.Schema) -> int:
        b = E.resolve(k, schema)
        if not isinstance(b, E.ColumnRef):
            raise NotImplementedError("join keys must be column references")
        if T.is_wide_decimal(b.dtype):
            # as the reference: its hash and key paths are single-word
            raise NotImplementedError(
                f"join key {b.name or b!r} is {b.dtype.name}: a DECIMAL128 "
                f"join key is not on the device")
        return b.index

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    @property
    def join_path(self) -> Optional[str]:
        """The path the build side took, from the metrics: ``ht`` (the hash
        table and its probe kernel), ``sorted`` (the sorted hashes), or
        None before a build side with rows."""
        if self.metrics["hashTableJoins"].value:
            return "ht"
        if self.metrics["sortedHashJoins"].value:
            return "sorted"
        return None

    def node_description(self) -> str:
        cond = (f" condition={self.condition!r}"
                if self.condition is not None else "")
        return (f"HashJoin {self.join_type} "
                f"keys={list(zip(self.left_keys, self.right_keys))}{cond}")

    def _prepare_build(self, build: ColumnarBatch):
        """The build side's probe structure, as the reference's
        ``_choose_path``: the hash table when it is enabled and a seeded
        build fits its probe bound, else the sorted hashes, counted in the
        metrics. Returns (path, order, structure): ("ht", order, (table,
        capacity, seed)) or ("sorted", order, the sorted join hashes)."""
        keys = tuple(self._rkeys)
        if self.hashtbl_enabled:
            ht = K.build_batch_hash_table(build, keys, K.HASHTBL_MAX_PROBES,
                                          K.HASHTBL_MAX_REHASH)
            if ht is not None:
                self.metrics["hashTableJoins"].add(1)
                return ("ht", ht[0].order, ht)
            self.metrics["sortedHashFallbacks"].add(1)
        jh = K.prepare_join_side(build, keys)
        self.metrics["sortedHashJoins"].add(1)
        return ("sorted", jh.order, jh)

    def _candidates(self, prep, probe: ColumnarBatch):
        """Each probe row's candidate range ``[lo, lo + cnt)`` of
        positions in the prepared build's order."""
        path, _order, structure = prep
        if path == "sorted":
            return K.join_candidate_counts(probe, self._lkeys, structure)
        tbl, capacity, seed = structure
        ph1, ph2, pvalid = _ht_probe_hashes(probe, self._lkeys)
        slot, hit = K.probe_hash_table_kernel(tbl, ph1, ph2, capacity, seed,
                                              K.HASHTBL_MAX_PROBES)
        return K.hashtbl_candidate_ranges(tbl, slot, hit & pvalid)

    def _build_side(self, partition: int):
        """(build batch, its probe structure or None when it has no row)
        of one partition: the right side's partition of the same number,
        so both sides must have one partition count (the planner
        co-partitions them by exchanges, or keeps both at one)."""
        nl, nr = self.left.num_partitions(), self.right.num_partitions()
        if nl != nr:
            raise ValueError(
                f"{self.node_description()}: the left side has {nl} "
                f"partitions and the right side {nr}; a partitioned hash "
                f"join needs co-partitioned sides")
        with self.timer("buildTimeNs"):
            return self._build(self.right.execute(partition))

    def _build(self, batches):
        """(the build batches concatenated, their probe structure or None
        when they have no row). The batches are collected as spillable
        handles, so that earlier ones can shed to the host while later
        ones are produced; every handle is read back and stays pinned,
        and so accounted on the pool, until the concat is made, as in the
        reference."""
        handles = []
        pinned = []
        try:
            handles.extend(spill.spillable(batches))
            parts = []
            for h in handles:
                parts.append(retry.get_with_retry(h))
                pinned.append(h)
            build = (K.concat_device(parts) if parts else empty_batch(
                self.right.output_schema.types(), self.plan_device()))
        finally:
            for h in pinned:
                h.unpin()
            for h in handles:
                h.close()
        return build, (self._prepare_build(build) if build.num_rows
                       else None)

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        jt = self.join_type
        build, prep = self._build_side(partition)
        # inner and semi joins with an empty build side emit nothing
        if prep is None and jt in ("inner", "left_semi"):
            return
        build_matched = (torch.zeros(build.num_rows, dtype=torch.bool,
                                     device=self.plan_device())
                         if jt in ("right", "full") else None)
        last_probe = None
        for probe in self.left.execute(partition):
            if probe.num_rows == 0:
                continue
            last_probe = probe
            with self.timer("joinTimeNs"):
                if prep is None:
                    outs = self._join_batch_empty_build(probe, build)
                else:
                    outs, build_matched = self._join_batch(
                        probe, build, prep, build_matched)
            # the chunks wait as spillable handles until each is taken
            waiting = []
            try:
                waiting.extend(spill.spillable(outs))
                del outs
                for h in waiting:
                    out = retry.get_with_retry(h)
                    h.unpin()
                    h.close()
                    yield out
            finally:
                for h in waiting:
                    h.close()
        if build_matched is not None and build.num_rows:
            with self.timer("joinTimeNs"):
                out = self._unmatched_build(build, build_matched, last_probe)
            if out is not None:
                yield out

    def _join_batch_empty_build(self, probe: ColumnarBatch,
                                build: ColumnarBatch) -> List[ColumnarBatch]:
        """No build row: a left or full join pads every probe row with
        nulls, an anti join keeps every probe row, a right join emits
        nothing."""
        if self.join_type == "left_anti":
            return [probe]
        if self.join_type in ("left", "full"):
            return [ColumnarBatch(list(probe.columns) + _null_columns(
                self.right.output_schema, probe.num_rows,
                probe.columns[0].device, build), probe.num_rows)]
        return []

    def _join_batch(self, probe: ColumnarBatch, build: ColumnarBatch, prep,
                    build_matched: Optional[torch.Tensor]):
        """One probe batch on either path: ``prep`` is the prepared build
        (``_prepare_build``), whose ``order`` maps candidate positions to
        build rows."""
        jt = self.join_type
        order = prep[1]
        self.metrics["numProbeBatches"].add(1)
        lo, cnt = self._candidates(prep, probe)
        ends = torch.cumsum(cnt.long(), 0)
        total = int(ends[-1])  # the one candidate-total read of this batch
        self.metrics["numCandidatePairs"].add(total)
        if total > self.max_candidate_rows:
            # a semi-cartesian key explosion: degrade loudly, not by OOM
            raise RuntimeError(
                f"join candidate explosion: one probe batch produced "
                f"{total} candidate pairs (> "
                f"{C.JOIN_MAX_OUTPUT_ROWS.key}={self.max_candidate_rows}); "
                f"check the join keys ({self.node_description()})")
        pairs_out = jt in ("inner", "left", "right", "full")
        pmatch = (torch.zeros(probe.num_rows, dtype=torch.bool,
                              device=lo.device)
                  if jt in ("left", "full", "left_semi", "left_anti")
                  else None)
        chunks = []  # (probe rows, build rows) of each chunk with pairs
        for r0, r1, ctot in _chunk_ranges(ends, total,
                                          self.chunk_target_rows):
            if ctot == 0:
                continue
            self.metrics["numChunks"].add(1)
            pc, build_row, ver = _candidate_pairs(
                probe, build, order, lo, cnt, r0, r1, ctot, self._lkeys,
                self._rkeys)
            if self._cond is not None:
                ver = ver & self._cond.holds(probe, pc, build, build_row)
            if not pairs_out:  # semi/anti: flags only, no pair count read
                pmatch = K.mark_rows(pmatch, pc, ver)
                continue
            keep = K.filter_indices(ver)
            if keep.numel() == 0:
                continue
            pi, bi = pc[keep], build_row[keep]
            if pmatch is not None:
                pmatch = K.mark_rows(pmatch, pi)
            if build_matched is not None:
                build_matched = K.mark_rows(build_matched, bi)
            chunks.append((pi, bi))
        if jt in ("left_semi", "left_anti"):
            idx = K.filter_indices(pmatch if jt == "left_semi" else ~pmatch)
            return ([K.gather_batch(probe, idx)] if idx.numel() else []), \
                build_matched
        if jt in ("left", "full"):
            # unmatched probe rows (null keys included) ride with the last
            # chunk's pairs, their build rows -1: null build columns
            ui = K.filter_indices(~pmatch)
            if ui.numel():
                pi, bi = chunks.pop() if chunks else (ui[:0], ui[:0])
                chunks.append((torch.cat([pi, ui]), torch.cat(
                    [bi, torch.full_like(ui, -1)])))
        out = []
        for pi, bi in chunks:
            bcols = ([K.gather_column_or_null(c, bi) for c in build.columns]
                     if jt in ("left", "full") else
                     K.gather_columns(build.columns, bi))
            out.append(ColumnarBatch(K.gather_columns(probe.columns, pi)
                                     + bcols, pi.numel()))
        return out, build_matched

    def _unmatched_build(self, build: ColumnarBatch, matched: torch.Tensor,
                         like: Optional[ColumnarBatch]
                         ) -> Optional[ColumnarBatch]:
        """The build rows no probe row paired with (null keys included),
        once, with null probe columns."""
        idx = K.filter_indices(~matched)
        n = idx.numel()
        if n == 0:
            return None
        return ColumnarBatch(_null_columns(self.left.output_schema, n,
                                           idx.device, like)
                             + K.gather_columns(build.columns, idx), n)


def _ht_probe_hashes(probe: ColumnarBatch, lkeys: Sequence[int]):
    """Probe-side 128-bit hash pair and the no-null-key mask."""
    ph1 = K.hash_keys(probe, list(lkeys))
    ph2 = K.hash_keys(probe, list(lkeys), variant=1)
    pvalid = torch.ones(probe.num_rows, dtype=torch.bool, device=ph1.device)
    for i in lkeys:
        pvalid = pvalid & probe.columns[i].validity
    return ph1, ph2, pvalid


def _chunk_ranges(ends: torch.Tensor, total: int,
                  chunk_target: int) -> List[Tuple[int, int, int]]:
    """Cut the probe rows into ranges of at most ``chunk_target``
    candidates (a single row past the target gets its own range)."""
    n = ends.numel()
    if total <= chunk_target:
        return [(0, n, total)]
    ends_h = ends.cpu()
    ranges = []
    r0, done = 0, 0
    while r0 < n and done < total:
        r1 = int(torch.searchsorted(ends_h, done + chunk_target, right=True))
        r1 = min(max(r1, r0 + 1), n)
        ctot = int(ends_h[r1 - 1]) - done
        ranges.append((r0, r1, ctot))
        done += ctot
        r0 = r1
    return ranges


def _candidate_pairs(probe: ColumnarBatch, build: ColumnarBatch,
                     order: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                     r0: int, r1: int, ctot: int, lkeys: Sequence[int],
                     rkeys: Sequence[int]):
    """Expand the candidates of probe rows [r0, r1) and test their keys:
    (probe rows, build rows, keys exactly equal), nothing read back."""
    pc, bpos = K.expand_candidates(lo, cnt, r0, r1, ctot)
    build_row = order.long()[bpos]
    ver = K.keys_equal(probe, pc, list(lkeys), build, build_row, list(rkeys))
    return pc, build_row, ver

