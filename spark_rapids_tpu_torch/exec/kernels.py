"""Device kernels of the main path as torch operations (counterpart of
spark_rapids_tpu/exec/kernels.py).

Every function takes tensors on one device and keeps them there. Batches
hold live rows only, so the reference's capacity padding, active masks and
``mode="drop"`` sentinels disappear, except where an algorithm needs them
(the hash-table build keeps one sentinel slot past ``capacity`` for the
claims of rows that did not win).

64-bit hashes are carried as int64: ``*``, ``+`` and ``^`` wrap exactly like
the reference's uint64, a logical right shift is an arithmetic shift masked
to the low bits, and constants at or above 2**63 are written as their signed
value. Every hash and table field comes out bit-equal to the reference's.

The hash-table probe has a hand-written CUDA kernel
(``csrc/hashtbl_probe.cu``); ``probe_hash_table_kernel`` launches it for CUDA
tensors and runs the plain ``probe_hash_table`` for CPU tensors.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

_MASK64 = (1 << 64) - 1
_INT64_MIN = -(1 << 63)


def _s64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    c &= _MASK64
    return c - (1 << 64) if c >= (1 << 63) else c


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


# ---------------------------------------------------------------------------
# Gather and filter
# ---------------------------------------------------------------------------


def gather_string(col: DeviceColumn, idx: torch.Tensor,
                  row_valid: Optional[torch.Tensor] = None) -> DeviceColumn:
    """Gather rows of a plain string column. Rows where ``row_valid`` is
    False come out null and empty. One host read: the output byte count."""
    idx = idx.long()
    lens = col.lengths()[idx]
    validity = col.validity[idx]
    if row_valid is not None:
        validity = validity & row_valid
        lens = torch.where(row_valid, lens, torch.zeros_like(lens))
    m = idx.numel()
    out_off = torch.zeros(m + 1, dtype=torch.int32, device=idx.device)
    if m:
        out_off[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    total = int(out_off[-1]) if m else 0
    rows = torch.repeat_interleave(
        torch.arange(m, device=idx.device), lens.long(), output_size=total)
    rel = torch.arange(total, device=idx.device) - out_off[:-1].long()[rows]
    src = col.offsets[:-1].long()[idx][rows] + rel
    return DeviceColumn(col.dtype, col.data[src], validity, out_off)


def decode_dictionary(col: DeviceColumn) -> DeviceColumn:
    """Dictionary column -> plain string column (null rows come out empty)."""
    return gather_string(col.dictionary, col.data, col.validity)


def gather_column(col: DeviceColumn, idx: torch.Tensor) -> DeviceColumn:
    if col.offsets is not None:
        return gather_string(col, idx)
    idx = idx.long()
    return DeviceColumn(col.dtype, col.data[idx], col.validity[idx], None,
                        col.dictionary)


def gather_lanes(lanes: Sequence[torch.Tensor],
                 idx: torch.Tensor) -> List[torch.Tensor]:
    """Gather many same-length 1-D tensors by one index vector."""
    idx = idx.long()
    return [lane[idx] for lane in lanes]


def gather_columns(cols: Sequence[DeviceColumn],
                   idx: torch.Tensor) -> List[DeviceColumn]:
    return [gather_column(c, idx) for c in cols]


def gather_batch(batch: ColumnarBatch, idx: torch.Tensor) -> ColumnarBatch:
    return ColumnarBatch(gather_columns(batch.columns, idx), idx.numel())


def filter_indices(keep: torch.Tensor) -> torch.Tensor:
    """Order-preserving indices of the kept rows (stream compaction). The
    kept count is ``len`` of the result; reading it is one host sync."""
    return torch.nonzero(keep).squeeze(1)


# ---------------------------------------------------------------------------
# Key words (Spark float canonicalisation, order-preserving integer words)
# ---------------------------------------------------------------------------


def _float_canonical(data: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(canonical value, is_nan): NaNs collapse to 0.0 plus a flag and -0.0
    becomes +0.0, as Spark's ordering and equality of floats require."""
    d = data.double()
    is_nan = torch.isnan(d)
    zero = torch.zeros_like(d)
    d = torch.where(is_nan, zero, d)
    d = torch.where(d == 0.0, zero, d)
    return d, is_nan


def _float_hash_key(data: torch.Tensor) -> torch.Tensor:
    """64-bit key of a float column: the float32 words (hi = value rounded
    to float32, lo = the residual) of the canonical value, as the reference
    builds them; NaN has a fixed key."""
    d, is_nan = _float_canonical(data)
    hi = d.float()
    lo = (d - hi.double()).float()
    words = torch.stack([lo.view(torch.int32), hi.view(torch.int32)], 1)
    u = words.contiguous().view(torch.int64).reshape(-1)
    return torch.where(is_nan, torch.full_like(u, 0x7FF8DEAD7F4A7C15), u)


def _int_sortable(data: torch.Tensor) -> torch.Tensor:
    """The reference's uint64 sortable word (value ^ sign bit) as int64."""
    return data.long() ^ _INT64_MIN


def _u64_order(x: torch.Tensor) -> torch.Tensor:
    """int64 whose signed order is the unsigned order of ``x``'s bits."""
    return x ^ _INT64_MIN


# ---------------------------------------------------------------------------
# Sorting
# ---------------------------------------------------------------------------


class SortSpec(NamedTuple):
    column: int
    ascending: bool = True
    nulls_first: Optional[bool] = None


def sortable_keys(col: DeviceColumn, ascending: bool = True,
                  nulls_first: Optional[bool] = None) -> List[torch.Tensor]:
    """Per-column sort keys, least significant first, each in torch's signed
    order. Spark defaults: nulls first ascending, last descending; NaN
    greater than every other value."""
    if nulls_first is None:
        nulls_first = ascending
    v = col.validity
    if col.is_dict:
        # sorted dictionary: code order is byte order; nulls fold into the
        # same word at the int32 extremes
        k = col.data.int()
        if not ascending:
            k = -k
        null_v = torch.iinfo(torch.int32).min if nulls_first else \
            torch.iinfo(torch.int32).max
        return [torch.where(v, k, torch.full_like(k, null_v))]
    if col.offsets is not None:
        raise NotImplementedError(
            "ORDER BY on a plain (non-dictionary) string column")
    dt = col.dtype
    if dt == T.BOOLEAN:
        k = col.data.int()
        if not ascending:
            k = 1 - k
        return [torch.where(v, k, torch.full_like(k, -1 if nulls_first
                                                  else 2))]
    if dt in T.FRACTIONAL_TYPES:
        d, is_nan = _float_canonical(col.data)
        ex = torch.where(is_nan, 2, 1).int()
        if not ascending:
            d = -d
            ex = 3 - ex
        ex = torch.where(v, ex, torch.full_like(ex, 0 if nulls_first else 3))
        d = torch.where(v & ~is_nan, d, torch.zeros_like(d))
        return [d, ex]
    k = col.data.int() if dt in (T.INT, T.DATE) else col.data.long()
    if not ascending:
        k = ~k
    k = torch.where(v, k, torch.zeros_like(k))
    null_key = v.int() if nulls_first else 1 - v.int()
    return [k, null_key]


def lexsort_chain(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort, last key primary (``np.lexsort``
    semantics): a chain of stable single-key sorts, least significant
    first."""
    assert keys, "lexsort_chain needs at least one key"
    perm = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def sort_indices(batch: ColumnarBatch,
                 specs: Sequence[SortSpec]) -> torch.Tensor:
    """Stable ORDER BY permutation of the batch's rows (int64)."""
    keys: List[torch.Tensor] = []
    for spec in reversed(list(specs)):
        keys.extend(sortable_keys(batch.columns[spec.column], spec.ascending,
                                  spec.nulls_first))
    if not keys:
        return torch.arange(batch.num_rows,
                            device=batch.columns[0].device)
    return lexsort_chain(keys)


# ---------------------------------------------------------------------------
# Hashing (splitmix64 mixing; polynomial hash of string bytes)
# ---------------------------------------------------------------------------


def _splitmix64(x: torch.Tensor) -> torch.Tensor:
    x = x + _s64(0x9E3779B97F4A7C15)
    x = (x ^ _lsr(x, 30)) * _s64(0xBF58476D1CE4E5B9)
    x = (x ^ _lsr(x, 27)) * _s64(0x94D049BB133111EB)
    return x ^ _lsr(x, 31)


# per-variant constants: variant 1 is an independent second hash of the raw
# bytes, so the pair behaves as a 128-bit identifier
_STR_P = (0x100000001B3, 0x9E3779B97F4A7C15)
_LEN_MIX = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F)
_INT_SALT = (0, 0xA5A5A5A5A5A5A5A5)
_COMBINE_MULT = (31, 0x100000001B3)
_NULL_HASH = 0xDEADBEEFCAFEBABE


@lru_cache(maxsize=32)
def _pow_table_np(p: int, n: int) -> np.ndarray:
    """powers[k] = p**k mod 2**64 (uint64), by doubling."""
    vals = np.ones(1, np.uint64)
    stride = p & _MASK64
    while vals.shape[0] < n:
        vals = np.concatenate([vals, vals * np.uint64(stride)])
        stride = (stride * stride) & _MASK64
    return vals[:n]


def _string_hash(col: DeviceColumn, variant: int = 0) -> torch.Tensor:
    """Polynomial hash of each row's bytes mod 2**64, length-mixed and
    finalised by splitmix64 (bit-equal to the reference)."""
    n = col.num_rows
    dev = col.device
    lens = col.lengths()
    nbytes = col.data.numel()
    if nbytes == 0:
        h = torch.zeros(n, dtype=torch.int64, device=dev)
    else:
        rows = torch.repeat_interleave(torch.arange(n, device=dev),
                                       lens.long(), output_size=nbytes)
        rel = torch.arange(nbytes, device=dev) - col.offsets[:-1].long()[rows]
        powers = torch.from_numpy(
            _pow_table_np(_STR_P[variant], nbytes).view(np.int64)).to(dev)
        contrib = (col.data.long() + 1) * powers[rel]
        h = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
            0, rows, contrib)
    return _splitmix64(h ^ (lens.long() * _s64(_LEN_MIX[variant])))


def hash_keys(batch: ColumnarBatch, key_cols: Sequence[int],
              variant: int = 0) -> torch.Tensor:
    """64-bit combined hash of the key columns per row (int64 bits).
    Candidate generation only: exactness comes from ``keys_equal``."""
    salt = _s64(_INT_SALT[variant])
    h = torch.zeros(batch.num_rows, dtype=torch.int64,
                    device=batch.columns[key_cols[0]].device)
    for i in key_cols:
        col = batch.columns[i]
        if col.is_dict:
            # hash the dictionary entries, gather by code: the same value
            # hash as the plain string layout
            ch = _string_hash(col.dictionary, variant)[col.data.long()]
        elif col.offsets is not None:
            ch = _string_hash(col, variant)
        elif col.dtype in T.FRACTIONAL_TYPES:
            ch = _splitmix64(_float_hash_key(col.data) ^ salt)
        else:
            ch = _splitmix64(_int_sortable(col.data) ^ salt)
        ch = torch.where(col.validity, ch,
                         torch.full_like(ch, _s64(_NULL_HASH)))
        h = _splitmix64(h * _s64(_COMBINE_MULT[variant]) + ch)
    return h


# ---------------------------------------------------------------------------
# Key equality
# ---------------------------------------------------------------------------


def _string_rows_at(c: DeviceColumn, idx: torch.Tensor):
    """(bytes, row start, row length) of string rows at ``idx``; dictionary
    rows resolve into the dictionary's bytes."""
    if c.is_dict:
        d = c.dictionary
        codes = c.data.long()[idx]
        return d.data, d.offsets[:-1].long()[codes], d.lengths().long()[codes]
    return c.data, c.offsets[:-1].long()[idx], c.lengths().long()[idx]


def _string_eq_at(ca: DeviceColumn, a_idx: torch.Tensor, cb: DeviceColumn,
                  b_idx: torch.Tensor) -> torch.Tensor:
    """Exact byte equality of string rows at row pairs."""
    da, sa, la = _string_rows_at(ca, a_idx)
    db, sb, lb = _string_rows_at(cb, b_idx)
    eq = la == lb
    width = int(torch.where(eq, la, torch.zeros_like(la)).max()) \
        if la.numel() else 0
    for k in range(width):
        live = eq & (la > k)
        ba = da[torch.where(live, sa + k, torch.zeros_like(sa))]
        bb = db[torch.where(live, sb + k, torch.zeros_like(sb))]
        eq = eq & (~live | (ba == bb))
    return eq


def keys_equal(a: ColumnarBatch, a_idx: torch.Tensor, a_cols: Sequence[int],
               b: ColumnarBatch, b_idx: torch.Tensor,
               b_cols: Sequence[int]) -> torch.Tensor:
    """Exact null-safe equality of key tuples at row pairs (null equals
    null; Spark float equality: NaN equals NaN, -0.0 equals 0.0)."""
    a_idx, b_idx = a_idx.long(), b_idx.long()
    eq = torch.ones(a_idx.numel(), dtype=torch.bool, device=a_idx.device)
    for ai, bi in zip(a_cols, b_cols):
        ca, cb = a.columns[ai], b.columns[bi]
        va, vb = ca.validity[a_idx], cb.validity[b_idx]
        if ca.is_dict and cb.is_dict and ca.dictionary is cb.dictionary:
            ceq = ca.data[a_idx] == cb.data[b_idx]
        elif (ca.is_dict or ca.offsets is not None or cb.is_dict
              or cb.offsets is not None):
            ceq = _string_eq_at(ca, a_idx, cb, b_idx)
        elif ca.dtype in T.FRACTIONAL_TYPES:
            da, na = _float_canonical(ca.data)
            db, nb = _float_canonical(cb.data)
            ceq = (((da[a_idx] == db[b_idx]) & ~na[a_idx] & ~nb[b_idx])
                   | (na[a_idx] & nb[b_idx]))
        else:
            ceq = ca.data.long()[a_idx] == cb.data.long()[b_idx]
        eq = eq & ((ceq & va & vb) | (~va & ~vb))
    return eq


# ---------------------------------------------------------------------------
# Group-by: hash sort, exact neighbour split, sorted segment reducers
# ---------------------------------------------------------------------------


class GroupInfo(NamedTuple):
    """Rows in group order: ``perm`` (gather map into the input),
    ``segment_ids`` per permuted row, ``num_groups`` (host int) and
    ``group_starts`` (permuted index of each group's first row)."""

    perm: torch.Tensor
    segment_ids: torch.Tensor
    num_groups: int
    group_starts: torch.Tensor


def _neighbor_key_neq(batch: ColumnarBatch, key_cols: Sequence[int],
                      perm: torch.Tensor,
                      extra: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """Per permuted row: does its key differ from the previous row's?
    Null keys compare equal whatever data lies under them."""
    lanes: List[torch.Tensor] = list(extra)
    for i in key_cols:
        c = batch.columns[i]
        v = c.validity
        lanes.append(v)

        def m(lane, v=v):
            return torch.where(v, lane, torch.zeros_like(lane))

        if c.offsets is not None:
            lanes.append(m(c.lengths()))
        elif c.dtype in T.FRACTIONAL_TYPES:
            d, is_nan = _float_canonical(c.data)
            lanes.append(m(d))
            lanes.append(m(is_nan))
        else:
            lanes.append(m(c.data))
    neq = torch.zeros(perm.numel(), dtype=torch.bool, device=perm.device)
    for lane in gather_lanes(lanes, perm):
        prev = torch.cat([lane[:1], lane[:-1]])
        neq = neq | (lane != prev)
    return neq


def _group_from_boundaries(perm: torch.Tensor,
                           neq: torch.Tensor) -> GroupInfo:
    n = perm.numel()
    idx = torch.arange(n, device=perm.device)
    boundary = (idx == 0) | neq
    seg = (torch.cumsum(boundary.int(), 0, dtype=torch.int32) - 1).clamp_(
        min=0)
    starts = torch.nonzero(boundary).squeeze(1)
    return GroupInfo(perm, seg, starts.numel(), starts)


def group_rows(batch: ColumnarBatch, key_cols: Sequence[int]) -> GroupInfo:
    """Cluster rows by key equality: stable sort by the 64-bit key hash,
    then split segments wherever the exact keys of neighbours differ, so a
    hash collision only splits a group, never merges two. (The reference
    also sorts its padding rows last; a port batch has none.)

    Plain string keys sort on the independent 128-bit hash pair and split
    on hash, null and length differences (the reference's treat-as-exact
    string bar)."""
    if any(batch.columns[i].offsets is not None for i in key_cols):
        h1 = hash_keys(batch, key_cols)
        h2 = hash_keys(batch, key_cols, variant=1)
        perm = lexsort_chain([_u64_order(h2), _u64_order(h1)])
        neq = _neighbor_key_neq(batch, key_cols, perm, extra=(h1, h2))
        return _group_from_boundaries(perm, neq)
    h = hash_keys(batch, key_cols)
    perm = lexsort_chain([_u64_order(h)])
    return _group_from_boundaries(perm,
                                  _neighbor_key_neq(batch, key_cols, perm))


def segment_ends(group_starts: torch.Tensor, n: int) -> torch.Tensor:
    """Last permuted row of each sorted segment."""
    nxt = torch.cat([group_starts[1:],
                     torch.full((1,), n, dtype=group_starts.dtype,
                                device=group_starts.device)])
    return nxt - 1


def _sorted_segment_reducers(seg: torch.Tensor, starts: torch.Tensor):
    """(sum, min, max) reducers over sorted segment ids.

    Integer sums: one prefix sum and two boundary gathers per segment
    (cs[end] - cs[start] + v[start]), exact under wraparound, and free of
    the atomic contention a scatter-add suffers when a few groups take all
    the rows. Float sums add per segment through ``bincount`` (the
    reference's cumsum trick is not float-safe: a large group would absorb
    a small one's values); on the card bincount accumulates few segments in
    shared memory before one global add per block."""
    seg = seg.long()
    g = starts.numel()
    n = seg.numel()
    starts = starts.long()
    ends = segment_ends(starts, n)

    def seg_sum(v: torch.Tensor) -> torch.Tensor:
        if n == 0:
            return torch.zeros(g, dtype=v.dtype, device=v.device)
        if v.is_floating_point():
            return torch.bincount(seg, weights=v.double(),
                                  minlength=g).to(v.dtype)
        cs = torch.cumsum(v, 0)
        return cs[ends] - cs[starts] + v[starts]

    def seg_min(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(g, dtype=v.dtype, device=v.device).scatter_reduce_(
            0, seg, v, "amin", include_self=False)

    def seg_max(v: torch.Tensor) -> torch.Tensor:
        return torch.zeros(g, dtype=v.dtype, device=v.device).scatter_reduce_(
            0, seg, v, "amax", include_self=False)

    return seg_sum, seg_min, seg_max


def segment_agg(values: Optional[torch.Tensor], validity: torch.Tensor,
                seg: torch.Tensor, starts: torch.Tensor, op: str):
    """One segmented aggregation over sorted segment ids; ``starts`` holds
    each segment's first row (``GroupInfo.group_starts``).

    Returns (values, validity) with one entry per segment. ``op`` is one of
    sum, count (non-null values), count_all (rows; ``values`` unused), min
    and max. Sums of integers are int64, of floats float64; a segment with
    no non-null value is null (counts never are)."""
    seg_sum, seg_min, seg_max = _sorted_segment_reducers(seg, starts)
    if op in ("count_all", "count"):
        data = seg_sum((validity if op == "count" else
                        torch.ones_like(validity)).long())
        return data, torch.ones_like(data, dtype=torch.bool)
    any_valid = seg_sum(validity.long()) > 0
    if op == "sum":
        v = values.double() if values.is_floating_point() else values.long()
        return seg_sum(torch.where(validity, v, torch.zeros_like(v))), \
            any_valid
    if op in ("min", "max"):
        if values.is_floating_point():
            # Spark: NaN is greater than every other value
            d, is_nan = _float_canonical(values)
            clean = validity & ~is_nan
            ident = float("-inf") if op == "max" else float("inf")
            v = torch.where(clean, d, torch.full_like(d, ident))
            red = (seg_max if op == "max" else seg_min)(v)
            nan_any = seg_sum((validity & is_nan).long()) > 0
            clean_any = seg_sum(clean.long()) > 0
            nan = torch.full_like(red, float("nan"))
            red = (torch.where(nan_any, nan, red) if op == "max"
                   else torch.where(clean_any, red, nan))
            return red.to(values.dtype), any_valid
        v = values.long() if values.dtype == torch.bool else values
        info = torch.iinfo(v.dtype)
        ident = info.min if op == "max" else info.max
        v = torch.where(validity, v, torch.full_like(v, ident))
        red = (seg_max if op == "max" else seg_min)(v)
        return red.to(values.dtype), any_valid
    raise NotImplementedError(f"segment op {op}")


# ---------------------------------------------------------------------------
# Device concatenation
# ---------------------------------------------------------------------------


def _concat_strings(cols: Sequence[DeviceColumn]) -> DeviceColumn:
    offs = []
    base = 0
    for i, c in enumerate(cols):
        o = c.offsets if i == 0 else c.offsets[1:]
        offs.append(o + base)
        base += c.data.numel()  # a column's bytes end at offsets[-1]
    return DeviceColumn(cols[0].dtype, torch.cat([c.data for c in cols]),
                        torch.cat([c.validity for c in cols]),
                        torch.cat(offs).int())


def concat_device(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate batches on device. Dictionary columns concatenate their
    codes when every input shares one dictionary, else decode first."""
    if len(batches) == 1:
        return batches[0]
    out: List[DeviceColumn] = []
    for ci in range(len(batches[0].columns)):
        cols = [b.columns[ci] for b in batches]
        first = cols[0]
        if all(c.is_dict and c.dictionary is first.dictionary for c in cols):
            out.append(DeviceColumn(first.dtype,
                                    torch.cat([c.data for c in cols]),
                                    torch.cat([c.validity for c in cols]),
                                    None, first.dictionary))
        elif any(c.is_dict or c.offsets is not None for c in cols):
            out.append(_concat_strings([decode_dictionary(c) if c.is_dict
                                        else c for c in cols]))
        else:
            out.append(DeviceColumn(first.dtype,
                                    torch.cat([c.data for c in cols]),
                                    torch.cat([c.validity for c in cols])))
    return ColumnarBatch(out, sum(b.num_rows for b in batches))


# ---------------------------------------------------------------------------
# Open-addressing hash table over the 128-bit hash pair
# ---------------------------------------------------------------------------
#
# The table stores each distinct key's (h1, h2) pair in a power-of-two slot
# array; duplicate build rows attach to their key's slot, and the rows
# stably sorted by slot (``order``/``sorted_slots``) turn each slot into a
# candidate range. Linear probing is bounded by ``max_probes``; a build
# that overflows the bound is rebuilt with the next seed at twice the
# capacity.

HASHTBL_MAX_PROBES = 16  # reference default of the probe bound
HASHTBL_MAX_REHASH = 4   # reference default of the seeded rebuilds


class HashTable(NamedTuple):
    slot_h1: torch.Tensor       # (capacity,) int64 bits of the uint64 hash
    slot_h2: torch.Tensor       # (capacity,) int64
    slot_used: torch.Tensor     # (capacity,) bool
    row_slot: torch.Tensor      # (n,) int32, -1: invalid key
    order: torch.Tensor         # (n,) int32 build rows stably sorted by slot
    sorted_slots: torch.Tensor  # (n,) int32 row_slot[order]; invalid: capacity


def hashtbl_capacity(n_rows: int) -> int:
    """Slot count for an n-row build: the next power of two >= 2 * rows."""
    cap = 16
    while cap < 2 * max(n_rows, 1):
        cap *= 2
    return cap


def _seed_mix(seed: int) -> int:
    """The seed's re-mix word (uint64), so a rehash moves every cluster."""
    return (seed * 0x9E3779B97F4A7C15 + 0xC2B2AE3D27D4EB4F) & _MASK64


def _hashtbl_base(h1: torch.Tensor, capacity: int, seed: int) -> torch.Tensor:
    """Home slot per row (int32)."""
    return (_splitmix64(h1 ^ _s64(_seed_mix(seed))) & (capacity - 1)).int()


def _hashtbl_insert_rounds(h1, h2, valid, capacity: int, seed: int,
                           max_probes: int):
    """Round-synchronous build: returns (slot_h1, slot_h2, slot_used,
    row_slot).

    Round p: every unplaced row looks at base + p. Empty slots are claimed
    by a scatter-min of row ids; after the claims land, every unplaced row
    re-checks its slot and attaches when the stored pair is its own, so
    equal keys (winners and their duplicates) never split across slots.
    Slot ``capacity`` is a sentinel that absorbs the writes of rows that
    did not win. One host read per round: whether any row is unplaced."""
    n = h1.numel()
    dev = h1.device
    row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    base = _hashtbl_base(h1, capacity, seed).long()
    slot_h1 = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    slot_h2 = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    slot_used = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
    row_slot = torch.full((n,), -1, dtype=torch.int32, device=dev)
    for p in range(max_probes):
        unplaced = valid & (row_slot < 0)
        if not bool(unplaced.any()):
            break
        pos = (base + p) & (capacity - 1)
        want = unplaced & ~slot_used[pos]
        tgt = torch.where(want, pos, capacity)
        claim = torch.full((capacity + 1,), n, dtype=torch.int32,
                           device=dev).scatter_reduce_(
            0, tgt, row_ids, "amin", include_self=True)
        won = want & (claim[pos] == row_ids)
        wpos = torch.where(won, pos, capacity)
        slot_h1[wpos] = h1
        slot_h2[wpos] = h2
        slot_used[wpos] = True
        match = (unplaced & slot_used[pos] & (slot_h1[pos] == h1)
                 & (slot_h2[pos] == h2))
        row_slot = torch.where(match, pos.int(), row_slot)
    return (slot_h1[:capacity], slot_h2[:capacity], slot_used[:capacity],
            row_slot)


def build_hash_table(h1: torch.Tensor, h2: torch.Tensor, valid: torch.Tensor,
                     capacity: int, seed: int, max_probes: int):
    """Build the table and its duplicate layout. Returns (HashTable,
    overflow); ``overflow`` (host bool) means some valid row found no slot
    within the probe bound under this seed."""
    slot_h1, slot_h2, slot_used, row_slot = _hashtbl_insert_rounds(
        h1, h2, valid, capacity, seed, max_probes)
    placed = valid & (row_slot >= 0)
    overflow = bool((valid & ~placed).any())
    srt = torch.where(placed, row_slot, capacity)
    order = torch.sort(srt, stable=True).indices.int()
    return HashTable(slot_h1, slot_h2, slot_used, row_slot, order,
                     srt[order.long()]), overflow


def build_batch_hash_table(batch: ColumnarBatch, key_cols: Tuple[int, ...],
                           max_probes: int = HASHTBL_MAX_PROBES,
                           max_rehash: int = HASHTBL_MAX_REHASH):
    """Hash the key columns and build with seeded rehash.

    Returns (HashTable, capacity, seed), or None when every seed
    overflowed. The capacity follows the batch's live rows (the reference
    sizes it from its padded capacity, so slot numbers agree only when both
    are handed the same capacity)."""
    h1 = hash_keys(batch, list(key_cols))
    h2 = hash_keys(batch, list(key_cols), variant=1)
    valid = torch.ones(batch.num_rows, dtype=torch.bool, device=h1.device)
    for i in key_cols:
        valid = valid & batch.columns[i].validity
    capacity = hashtbl_capacity(batch.num_rows)
    for seed in range(max_rehash):
        tbl, overflow = build_hash_table(h1, h2, valid, capacity, seed,
                                         max_probes)
        if not overflow:
            return tbl, capacity, seed
        capacity *= 2  # grow and reseed: clusters cannot re-form in place
    return None


def probe_hash_table(tbl: HashTable, h1: torch.Tensor, h2: torch.Tensor,
                     capacity: int, seed: int, max_probes: int):
    """Plain version of the probe: each row walks at most ``max_probes``
    slots from its home slot and stops at its match (slot) or at the first
    empty slot (-1). Returns (slot int32, hit)."""
    n = h1.numel()
    base = _hashtbl_base(h1, capacity, seed).long()
    slot = torch.full((n,), -1, dtype=torch.int32, device=h1.device)
    done = torch.zeros(n, dtype=torch.bool, device=h1.device)
    for p in range(max_probes):
        if bool(done.all()):
            break
        pos = (base + p) & (capacity - 1)
        occ = tbl.slot_used[pos]
        match = occ & (tbl.slot_h1[pos] == h1) & (tbl.slot_h2[pos] == h2)
        slot = torch.where(~done & match, pos.int(), slot)
        done = done | match | ~occ
    return slot, slot >= 0


# launches of each hand-written kernel, counted where the kernel launches
KERNEL_LAUNCHES = {"hashtbl_probe": 0}
_launch_lock = threading.Lock()


def reset_kernel_launches() -> None:
    with _launch_lock:
        for k in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[k] = 0


def _check_probe_args(tbl: HashTable, h1: torch.Tensor, h2: torch.Tensor,
                      capacity: int, max_probes: int) -> None:
    dev = h1.device
    for name, t, dt, shape in (
            ("slot_h1", tbl.slot_h1, torch.int64, (capacity,)),
            ("slot_h2", tbl.slot_h2, torch.int64, (capacity,)),
            ("slot_used", tbl.slot_used, torch.bool, (capacity,)),
            ("h1", h1, torch.int64, None), ("h2", h2, torch.int64, None)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h1 on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if h1.dim() != 1 or h1.shape != h2.shape:
        raise ValueError("h1 and h2 must be 1-D of one length")
    if capacity <= 0 or capacity & (capacity - 1) or capacity > (1 << 31):
        raise ValueError(f"capacity {capacity} must be a power of two "
                         f"<= 2**31")
    if not 1 <= max_probes <= capacity:
        raise ValueError(f"max_probes {max_probes} out of range")
    if h1.numel() >= (1 << 31):
        raise ValueError("probe batch too large for int32 slots")


def probe_hash_table_kernel(tbl: HashTable, h1: torch.Tensor,
                            h2: torch.Tensor, capacity: int, seed: int,
                            max_probes: int):
    """Probe wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. Same contract as ``probe_hash_table``."""
    _check_probe_args(tbl, h1, h2, capacity, max_probes)
    if h1.device.type == "cpu":
        return probe_hash_table(tbl, h1, h2, capacity, seed, max_probes)
    if h1.device.type != "cuda":
        raise ValueError(f"no probe kernel for device {h1.device}")
    from spark_rapids_tpu_torch import native

    n = h1.numel()
    slot = torch.empty(n, dtype=torch.int32, device=h1.device)
    if n:
        lib = native.load()
        with torch.cuda.device(h1.device):  # launch in the tensors' context
            rc = lib.srt_hashtbl_probe(
                tbl.slot_used.data_ptr(), tbl.slot_h1.data_ptr(),
                tbl.slot_h2.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                slot.data_ptr(), n, capacity,
                ctypes.c_uint64(_seed_mix(seed)), max_probes,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"hashtbl_probe launch failed: CUDA error "
                               f"{rc} ({native.error_string(rc)})")
        with _launch_lock:
            KERNEL_LAUNCHES["hashtbl_probe"] += 1
    return slot, slot >= 0


def hashtbl_candidate_ranges(tbl: HashTable, slot: torch.Tensor,
                             hit: torch.Tensor):
    """(lo, cnt) candidate ranges in ``tbl.order`` for probed slots."""
    lo = torch.searchsorted(tbl.sorted_slots, slot).int()
    hi = torch.searchsorted(tbl.sorted_slots, slot, right=True).int()
    cnt = torch.where(hit, hi - lo, torch.zeros_like(lo))
    return torch.minimum(lo, hi), cnt


def expand_candidates(lo: torch.Tensor, cnt: torch.Tensor, r0: int, r1: int,
                      total: int):
    """Flat (probe row, build position) pairs for probe rows [r0, r1),
    whose candidate counts sum to ``total`` (known on the host)."""
    dev = lo.device
    c = cnt[r0:r1].long()
    probe = torch.repeat_interleave(torch.arange(r0, r1, device=dev), c,
                                    output_size=total)
    start = torch.cumsum(c, 0) - c
    j = torch.arange(total, device=dev)
    build_pos = lo.long()[probe] + (j - start[probe - r0])
    return probe, build_pos
