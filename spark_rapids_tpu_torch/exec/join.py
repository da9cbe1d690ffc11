"""Inner hash equi-join on the open-addressing table (counterpart of the
``ht`` path of spark_rapids_tpu/exec/join.py).

The build (right) side is concatenated once and its key hash pair inserted
into a ``kernels.HashTable``. Each probe batch hashes its keys, finds each
row's slot through the probe kernel's wrapper, reads the slot's candidate
range of build rows, expands the candidate pairs and keeps the pairs whose
real keys are equal, so a hash collision only costs a discarded candidate.

Host reads per probe batch: the candidate total (sizes the expansion and
feeds the explosion guard) and the verified pair count of each output
chunk. Chunks stay on the device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exec.base import BinaryExec, DeviceExec
from spark_rapids_tpu_torch.exprs import expr as E


class HashJoinExec(BinaryExec):
    def __init__(self, left_keys: Sequence[E.Expression],
                 right_keys: Sequence[E.Expression], join_type: str,
                 left: DeviceExec, right: DeviceExec,
                 max_candidate_rows: Optional[int] = None):
        super().__init__(left, right)
        if join_type != "inner":
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
        ls, rs = left.output_schema, right.output_schema
        self._lkeys = [self._key_index(k, ls) for k in self.left_keys]
        self._rkeys = [self._key_index(k, rs) for k in self.right_keys]
        self._schema = T.Schema(list(ls) + list(rs))
        for name in ("buildTimeNs", "joinTimeNs", "numCandidatePairs",
                     "numProbeBatches", "numChunks"):
            self._register_metric(name)

    @staticmethod
    def _key_index(k: E.Expression, schema: T.Schema) -> int:
        b = E.resolve(k, schema)
        if not isinstance(b, E.ColumnRef):
            raise NotImplementedError("join keys must be column references")
        return b.index

    @property
    def output_schema(self) -> T.Schema:
        return self._schema

    def node_description(self) -> str:
        return (f"HashJoin {self.join_type} "
                f"keys={list(zip(self.left_keys, self.right_keys))}")

    def do_execute(self, partition: int) -> Iterator[ColumnarBatch]:
        with self.timer("buildTimeNs"):
            parts = list(self.right.execute(partition))
            build = (K.concat_device(parts) if parts else None)
            if build is None or build.num_rows == 0:
                ht = None
            else:
                ht = K.build_batch_hash_table(build, tuple(self._rkeys),
                                              K.HASHTBL_MAX_PROBES,
                                              K.HASHTBL_MAX_REHASH)
                if ht is None:
                    raise RuntimeError(
                        f"hash-table build overflowed its probe bound under "
                        f"every seed ({self.node_description()})")
        if ht is None:
            return  # an inner join with an empty build side emits nothing
        for probe in self.left.execute(partition):
            if probe.num_rows == 0:
                continue
            with self.timer("joinTimeNs"):
                outs = self._join_batch_ht(probe, build, ht)
            yield from outs

    def _join_batch_ht(self, probe: ColumnarBatch, build: ColumnarBatch,
                       ht) -> List[ColumnarBatch]:
        tbl, capacity, seed = ht
        self.metrics["numProbeBatches"].add(1)
        ph1, ph2, pvalid = _ht_probe_hashes(probe, self._lkeys)
        slot, hit = K.probe_hash_table_kernel(tbl, ph1, ph2, capacity, seed,
                                              K.HASHTBL_MAX_PROBES)
        lo, cnt, ends = _ht_candidate_stats(tbl, slot, hit & pvalid)
        total = int(ends[-1])  # the one candidate-total read of this batch
        self.metrics["numCandidatePairs"].add(total)
        if total > self.max_candidate_rows:
            # a semi-cartesian key explosion: degrade loudly, not by OOM
            raise RuntimeError(
                f"join candidate explosion: one probe batch produced "
                f"{total} candidate pairs (> "
                f"{C.JOIN_MAX_OUTPUT_ROWS.key}={self.max_candidate_rows}); "
                f"check the join keys ({self.node_description()})")
        out = []
        for r0, r1, ctot in _chunk_ranges(ends, total,
                                          self.chunk_target_rows):
            self.metrics["numChunks"].add(1)
            pi, bi = _verified_pairs(probe, build, tbl.order, lo, cnt, r0, r1,
                                     ctot, self._lkeys, self._rkeys)
            if pi.numel() == 0:
                continue
            out.append(ColumnarBatch(K.gather_columns(probe.columns, pi)
                                     + K.gather_columns(build.columns, bi),
                                     pi.numel()))
        return out


def _ht_probe_hashes(probe: ColumnarBatch, lkeys: Sequence[int]):
    """Probe-side 128-bit hash pair and the no-null-key mask."""
    ph1 = K.hash_keys(probe, list(lkeys))
    ph2 = K.hash_keys(probe, list(lkeys), variant=1)
    pvalid = torch.ones(probe.num_rows, dtype=torch.bool, device=ph1.device)
    for i in lkeys:
        pvalid = pvalid & probe.columns[i].validity
    return ph1, ph2, pvalid


def _ht_candidate_stats(tbl: K.HashTable, slot: torch.Tensor,
                        ok: torch.Tensor):
    """Candidate ranges and their inclusive prefix sum (``ends``)."""
    lo, cnt = K.hashtbl_candidate_ranges(tbl, slot, ok)
    return lo, cnt, torch.cumsum(cnt.long(), 0)


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


def _verified_pairs(probe: ColumnarBatch, build: ColumnarBatch,
                    order: torch.Tensor, lo: torch.Tensor, cnt: torch.Tensor,
                    r0: int, r1: int, ctot: int, lkeys: Sequence[int],
                    rkeys: Sequence[int]):
    """Expand the candidates of probe rows [r0, r1) and keep the pairs with
    exactly equal keys. Returns (probe rows, build rows), int64."""
    pc, bpos = K.expand_candidates(lo, cnt, r0, r1, ctot)
    build_row = order.long()[bpos]
    ver = K.keys_equal(probe, pc, list(lkeys), build, build_row, list(rkeys))
    keep = K.filter_indices(ver)
    return pc[keep], build_row[keep]
