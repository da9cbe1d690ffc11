"""Adaptive query execution over written shuffles (counterpart of
spark_rapids_tpu/shuffle/aqe.py; GpuCustomShuffleReaderExec, Spark's
ShufflePartitionsUtil and OptimizeSkewedJoin).

A shuffle exchange is a stage boundary. Its first reader writes it; the
read above it is then planned from the real serialized size of each
reduce partition:

- coalescing: adjacent reduce partitions whose sizes fit the advisory size
  (``spark.rapids.gpu.sql.adaptive.advisoryPartitionSizeBytes``) are read
  by one task (``CoalescedPartitionSpec``);
- skew splitting: a shuffled join's reduce partition larger than both
  ``skewedPartitionFactor`` times the median and
  ``skewedPartitionThresholdBytes`` is read in map-output ranges of about
  the advisory size (``PartialReducerPartitionSpec``), the other side's
  partition replicated against each range.

Both are ``AQEShuffleReadExec`` over the exchange; a shuffled join's two
readers share one ``SkewJoinPlanner`` so that their spec lists line up.
Splitting is sound only where a side's rows may be divided: the left side
of inner, left, left_semi and left_anti joins, the right side of inner and
right joins; a full join is never split.

With ``spark.rapids.gpu.sql.prefetch.enabled`` a reader reads spec i + 1
ahead (fetch and host merge, ``exec/pipeline.ReadAhead``) while spec i is
consumed, as a direct read of an exchange reads its next partition;
``cleanup`` stops it, before the plan's exchanges delete their blocks.

Specs are planned at the first ``specs()`` call outside ``planning_scope``
and kept: a plan run again writes its exchanges again and reads them
through the same specs (the same input gives the same sizes). Within
``planning_scope`` (the planner's partition-count decisions)
``num_partitions`` answers with the exchange's partition count and writes
nothing.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

from spark_rapids_tpu_torch.columnar.batch import (
    ColumnarBatch, batch_from_arrow, dictionary_encode_table)
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec.base import DeviceExec, UnaryExec
from spark_rapids_tpu_torch.exec.pipeline import ReadAhead
from spark_rapids_tpu_torch.shuffle.manager import ReadCounts


# ---------------------------------------------------------------------------
# partition specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CoalescedPartitionSpec:
    """Read reduce partitions [start, end) from every map output."""

    start: int
    end: int

    def describe(self) -> str:
        return (f"[{self.start}]" if self.end == self.start + 1
                else f"[{self.start},{self.end})")


@dataclasses.dataclass(frozen=True)
class PartialReducerPartitionSpec:
    """Read reduce partition ``reducer`` from map outputs [map_start,
    map_end) only: one chunk of a skew-split partition."""

    reducer: int
    map_start: int
    map_end: int

    def describe(self) -> str:
        return f"[{self.reducer}:maps {self.map_start}-{self.map_end})"


# ---------------------------------------------------------------------------
# planning scope: partition counts that must not write a stage
# ---------------------------------------------------------------------------

_PLANNING = threading.local()


class planning_scope:
    """Within this scope an AQE reader's ``num_partitions`` is its
    exchange's partition count (or its specs' count once planned), and
    nothing is written: the planner's decisions never run a stage."""

    def __enter__(self):
        self._old = getattr(_PLANNING, "on", False)
        _PLANNING.on = True
        return self

    def __exit__(self, *exc):
        _PLANNING.on = self._old
        return False


def in_planning_scope() -> bool:
    return getattr(_PLANNING, "on", False)


# ---------------------------------------------------------------------------
# planning helpers
# ---------------------------------------------------------------------------


def pack_ranges(sizes: Sequence[int], target_bytes: int,
                offset: int = 0) -> List[Tuple[int, int]]:
    """The greedy packing rule of every AQE planner: contiguous [start,
    end) ranges over ``sizes``, each closed before the one that would take
    it past ``target_bytes`` (a range holds at least one index);
    ``offset`` shifts the indices."""
    ranges: List[Tuple[int, int]] = []
    start, acc = 0, 0
    for i, sz in enumerate(sizes):
        if i > start and acc + sz > target_bytes:
            ranges.append((offset + start, offset + i))
            start, acc = i, 0
        acc += sz
    ranges.append((offset + start, offset + len(sizes)))
    return ranges


def coalesce_specs(sizes: Sequence[int],
                   target_bytes: int) -> List[CoalescedPartitionSpec]:
    """Adjacent reduce partitions packed up to the advisory size."""
    return [CoalescedPartitionSpec(s, e)
            for s, e in pack_ranges(sizes, target_bytes)]


def split_map_ranges(sizes_by_map: Sequence[int],
                     target_bytes: int) -> List[Tuple[int, int]]:
    """One reduce partition's map outputs cut into contiguous ranges of
    about the advisory size."""
    return pack_ranges(sizes_by_map, target_bytes)


def _median(xs: Sequence[int]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return float(s[mid]) if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def skew_threshold(sizes: Sequence[int], factor: float,
                   min_bytes: int) -> float:
    """A partition is skewed above max(factor * median, min_bytes)."""
    return max(factor * _median(sizes), float(min_bytes))


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


class AQEShuffleReadExec(UnaryExec):
    """Reads a written exchange (or a ``ReusedExchangeExec`` of one)
    through a list of partition specs, planned from the exchange's sizes
    at the first ``specs()`` call, or set by a ``SkewJoinPlanner``. Each
    spec's blocks are merged on the host and uploaded in chunks of the
    exchange's ``target_batch_rows``, as the exchange uploads a partition.

    The plan's conf is read when the reader is built (the active conf is
    process-wide). Metrics: ``readTimeNs`` (fetch, merge and upload on the
    consumer's thread; a read-ahead's fetch and merge are its own
    thread's, and ``readAheadWaitNs`` is what the consumer waited for
    it), ``shuffleBytesRead``, ``shuffleBlocksRead``."""

    def __init__(self, exchange: DeviceExec,
                 conf: Optional[C.RapidsConf] = None):
        super().__init__(exchange)
        conf = conf or C.get_active()
        self.target_bytes = C.AQE_TARGET_PARTITION_BYTES.get(conf)
        self.read_ahead = C.PREFETCH_ENABLED.get(conf)
        self._ahead = ReadAhead("aqer")  # of (table, counts)
        self._specs: Optional[list] = None
        self._plan_lock = threading.Lock()
        for name in ("readTimeNs", "readAheadWaitNs", "shuffleBytesRead",
                     "shuffleBlocksRead"):
            self._register_metric(name)

    @property
    def exchange(self) -> DeviceExec:
        return self.children[0]

    # -- planning ----------------------------------------------------------
    def _set_specs(self, specs: list) -> None:
        with self._plan_lock:
            self._specs = list(specs)

    def specs(self) -> list:
        with self._plan_lock:
            if self._specs is None:
                self._specs = self._plan()
            return self._specs

    def planned_specs(self) -> Optional[list]:
        """The specs if they are planned, else None (writes nothing)."""
        with self._plan_lock:
            return None if self._specs is None else list(self._specs)

    def _plan(self) -> list:
        ex = self.exchange
        reg = ex._ensure_written()
        return list(coalesce_specs(ex.manager.partition_sizes(reg),
                                   self.target_bytes))

    # -- operator ----------------------------------------------------------
    def num_partitions(self) -> int:
        if in_planning_scope():
            with self._plan_lock:
                if self._specs is not None:
                    return len(self._specs)
            return self.exchange.num_partitions()
        return len(self.specs())

    def node_description(self) -> str:
        specs = self.planned_specs()
        if specs is None:
            return f"{type(self).__name__} (unplanned)"
        n_co = sum(isinstance(s, CoalescedPartitionSpec) for s in specs)
        return (f"{type(self).__name__} {len(specs)} specs ({n_co} "
                f"coalesced, {len(specs) - n_co} skew-split)")

    def _read_spec(self, reg, spec):
        """One spec's blocks fetched and merged on the host: (table,
        counts)."""
        counts = ReadCounts()
        manager = self.exchange.manager
        if isinstance(spec, CoalescedPartitionSpec):
            table = manager.read_spec(reg, range(spec.start, spec.end),
                                      counts=counts)
        else:
            table = manager.read_spec(reg, [spec.reducer], spec.map_start,
                                      spec.map_end, counts=counts)
        return table, counts

    def cleanup(self) -> None:
        """Stop the read-ahead and drop what it read (after the query's
        output is gathered); the specs stay."""
        self._ahead.shutdown()

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        specs = self.specs()
        ex = self.exchange
        # the specs outlive a cleanup, the blocks do not: a plan run again
        # writes the exchange again before reading it
        reg = ex._ensure_written()
        fut = self._ahead.take(partition)
        with self.timer("readTimeNs"):
            if fut is not None:
                with self.timer("readAheadWaitNs"):
                    table, counts = fut.result()
            else:
                table, counts = self._read_spec(reg, specs[partition])
            self.metrics["shuffleBytesRead"].add(counts.bytes)
            self.metrics["shuffleBlocksRead"].add(counts.blocks)
        nxt = partition + 1
        if self.read_ahead and nxt < len(specs):
            self._ahead.schedule(nxt, self._read_spec, reg, specs[nxt])
        if table is None or table.num_rows == 0:
            return
        device = self.plan_device()
        rows = ex.target_batch_rows
        for start in range(0, table.num_rows, rows):
            with self.timer("readTimeNs"):
                chunk = dictionary_encode_table(table.slice(start, rows))
                batch = batch_from_arrow(chunk, device, dict_cache={})
            yield batch


# ---------------------------------------------------------------------------
# skew joins
# ---------------------------------------------------------------------------


class SkewJoinPlanner:
    """Plans the paired spec lists of a shuffled join's two readers.

    For reduce partition r with sides (L, R):
      - L skewed, R not: L cut into map ranges, R's partition read whole
        against each;
      - the same for R;
      - both skewed (an inner join): every pair of chunks, whose joins
        together are the partition's join;
      - neither: runs of such partitions coalesced jointly, by the larger
        side's size, so both sides read the same ranges.
    """

    def __init__(self, left: AQEShuffleReadExec, right: AQEShuffleReadExec,
                 join_type: str, conf: Optional[C.RapidsConf] = None):
        self.left = left
        self.right = right
        self.join_type = join_type
        conf = conf or C.get_active()
        self.target_bytes = C.AQE_TARGET_PARTITION_BYTES.get(conf)
        self.skew_enabled = C.AQE_SKEW_ENABLED.get(conf)
        self.skew_factor = C.AQE_SKEW_FACTOR.get(conf)
        self.skew_min_bytes = C.AQE_SKEW_THRESHOLD_BYTES.get(conf)
        self._planned = False
        self._lock = threading.Lock()
        # (left sizes, right sizes) per reduce partition, once planned
        self.sizes: Optional[Tuple[List[int], List[int]]] = None

    def ensure_planned(self) -> None:
        with self._lock:
            if not self._planned:
                self._plan()
                self._planned = True

    def _plan(self) -> None:
        lex, rex = self.left.exchange, self.right.exchange
        lreg = lex._ensure_written()
        rreg = rex._ensure_written()
        lsizes = lex.manager.partition_sizes(lreg)
        rsizes = rex.manager.partition_sizes(rreg)
        if len(lsizes) != len(rsizes):
            raise ValueError(f"a shuffled join's sides have {len(lsizes)} "
                             f"and {len(rsizes)} partitions")
        self.sizes = (lsizes, rsizes)
        target = self.target_bytes
        lthr = skew_threshold(lsizes, self.skew_factor, self.skew_min_bytes)
        rthr = skew_threshold(rsizes, self.skew_factor, self.skew_min_bytes)
        # a side may be cut only where its rows can be divided: the rows a
        # join keeps whole (a left join's unmatched left rows are decided
        # against the whole right partition) pin the other side
        can_split_l = self.skew_enabled and self.join_type in (
            "inner", "left", "left_semi", "left_anti")
        can_split_r = self.skew_enabled and self.join_type in (
            "inner", "right")
        l_skews = [can_split_l and s > lthr for s in lsizes]
        r_skews = [can_split_r and s > rthr for s in rsizes]

        lspecs: list = []
        rspecs: list = []

        def pack_run(start: int, end: int) -> None:
            joint = [max(lsizes[i], rsizes[i]) for i in range(start, end)]
            for s, e in pack_ranges(joint, target, offset=start):
                lspecs.append(CoalescedPartitionSpec(s, e))
                rspecs.append(CoalescedPartitionSpec(s, e))

        run_start = -1
        for r in range(len(lsizes)):
            if l_skews[r] or r_skews[r]:
                if run_start >= 0:
                    pack_run(run_start, r)
                    run_start = -1
                lranges = (split_map_ranges(
                    lex.manager.partition_sizes_by_map(lreg, r), target)
                    if l_skews[r]
                    else [(0, lex.manager.num_map_outputs(lreg))])
                rranges = (split_map_ranges(
                    rex.manager.partition_sizes_by_map(rreg, r), target)
                    if r_skews[r]
                    else [(0, rex.manager.num_map_outputs(rreg))])
                for lm in lranges:
                    for rm in rranges:
                        lspecs.append(
                            PartialReducerPartitionSpec(r, lm[0], lm[1]))
                        rspecs.append(
                            PartialReducerPartitionSpec(r, rm[0], rm[1]))
            elif run_start < 0:
                run_start = r
        if run_start >= 0:
            pack_run(run_start, len(lsizes))
        self.left._set_specs(lspecs)
        self.right._set_specs(rspecs)


class SkewAwareShuffleReadExec(AQEShuffleReadExec):
    """An AQE reader whose specs come from its join's ``SkewJoinPlanner``."""

    def __init__(self, exchange: DeviceExec,
                 conf: Optional[C.RapidsConf] = None):
        super().__init__(exchange, conf)
        self.planner: Optional[SkewJoinPlanner] = None

    def specs(self) -> list:
        if self.planner is not None:
            self.planner.ensure_planned()
        return super().specs()


def pair_for_skew_join(left_exchange: DeviceExec, right_exchange: DeviceExec,
                       join_type: str, conf: Optional[C.RapidsConf] = None
                       ) -> Tuple[SkewAwareShuffleReadExec,
                                  SkewAwareShuffleReadExec]:
    """The paired readers of a shuffled join's two sides."""
    lread = SkewAwareShuffleReadExec(left_exchange, conf)
    rread = SkewAwareShuffleReadExec(right_exchange, conf)
    planner = SkewJoinPlanner(lread, rread, join_type, conf)
    lread.planner = planner
    rread.planner = planner
    return lread, rread
