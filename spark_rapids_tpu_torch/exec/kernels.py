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

Decimal columns (DECIMAL64) are int64 unscaled values and take the integer
paths of ``sortable_keys``, ``hash_keys`` and ``keys_equal``, as in the
reference, and so do TINYINT, SMALLINT (sign-extended to the same 64-bit
word) and TIMESTAMP (its microseconds). A FLOAT key takes the double
path: its value widened exactly to float64, so -0.0 and NaN follow
Spark's rules (NaN largest) and its hash is the reference's. A
DECIMAL128 column's ``(n, 2)`` ``[lo, hi]`` limbs sort on (hi, lo read
unsigned), hash both limbs and compare both; their segment
sums are exact mod 2^128 and their min/max reduce hi, then lo among the
rows that tie on hi (``segment_agg``).

BINARY is a plain string column and sorts, hashes and compares as one.
The gathers, slices and concatenations carry the nested layouts: an
ARRAY's elements move as a string's bytes, a STRUCT's children by the
same rows, a MAP's key and value children by its gathered entry ranges
(``_range_gather``). No nested column is a key.

Two functions have hand-written CUDA kernels, each behind a wrapper that
launches the kernel for CUDA tensors and runs the plain torch version for
CPU tensors: the hash-table probe (``csrc/hashtbl_probe.cu``,
``probe_hash_table_kernel`` over ``probe_hash_table``) and the segmented
scan (``csrc/segscan.cu``, ``segmented_scan_kernel`` over
``segmented_scan``).
"""

from __future__ import annotations

import ctypes
import math
import threading
from functools import lru_cache
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import int128 as I128

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


def where_valid(valid: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``data`` with its null rows zeroed (a DECIMAL128 row's two limbs
    alike)."""
    v = valid[:, None] if data.dim() == 2 else valid
    return torch.where(v, data, torch.zeros((), dtype=data.dtype,
                                            device=data.device))


def _range_gather(offsets: torch.Tensor, idx: torch.Tensor,
                  row_valid: Optional[torch.Tensor] = None):
    """(output offsets, source positions) gathering the ranges that
    ``offsets`` gives rows ``idx`` (a string's bytes, an array's elements,
    a map's entries); a row where ``row_valid`` is False comes out empty.
    One host read: the output's length."""
    lens = (offsets[1:] - offsets[:-1])[idx]
    if row_valid is not None:
        lens = torch.where(row_valid, lens, torch.zeros_like(lens))
    m = idx.numel()
    out_off = torch.zeros(m + 1, dtype=torch.int32, device=idx.device)
    if m:
        out_off[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    total = int(out_off[-1]) if m else 0
    rows = torch.repeat_interleave(
        torch.arange(m, device=idx.device), lens.long(), output_size=total)
    rel = torch.arange(total, device=idx.device) - out_off[:-1].long()[rows]
    return out_off, offsets[:-1].long()[idx][rows] + rel


def gather_string(col: DeviceColumn, idx: torch.Tensor,
                  row_valid: Optional[torch.Tensor] = None) -> DeviceColumn:
    """Gather rows of a plain string (or ARRAY) column. Rows where
    ``row_valid`` is False come out null and empty. One host read: the
    output byte count."""
    idx = idx.long()
    validity = col.validity[idx]
    if row_valid is not None:
        validity = validity & row_valid
    out_off, src = _range_gather(col.offsets, idx, row_valid)
    return DeviceColumn(col.dtype, col.data[src], validity, out_off)


def _gather_nested(col: DeviceColumn, idx: torch.Tensor,
                   row_valid: Optional[torch.Tensor]) -> DeviceColumn:
    """Rows ``idx`` of a STRUCT (every child by the same rows) or a MAP
    (both entry children by the gathered entry ranges)."""
    validity = col.validity[idx]
    if row_valid is not None:
        validity = validity & row_valid
    if col.is_struct:
        kids = tuple(gather_column_or_null(c, idx) if row_valid is not None
                     else gather_column(c, idx) for c in col.children)
        return DeviceColumn(col.dtype, col.data, validity, None,
                            children=kids)
    out_off, src = _range_gather(col.offsets, idx, row_valid)
    return DeviceColumn(col.dtype, col.data, validity, out_off,
                        children=tuple(gather_column(c, src)
                                       for c in col.children))


def decode_dictionary(col: DeviceColumn) -> DeviceColumn:
    """Dictionary column -> plain string column (null rows come out empty)."""
    return gather_string(col.dictionary, col.data, col.validity)


def null_column(dt: T.DataType, n: int, device,
                dictionary: Optional[DeviceColumn] = None) -> DeviceColumn:
    """``n`` null rows of type ``dt`` (zeroed data, empty strings). A
    string column with ``dictionary`` is a dictionary column over it, so
    it concatenates with that dictionary's columns by code."""
    valid = torch.zeros(n, dtype=torch.bool, device=device)
    if dictionary is not None:
        return DeviceColumn(dt, torch.zeros(n, dtype=torch.int32,
                                            device=device), valid, None,
                            dictionary)
    if isinstance(dt, T.StructType):
        return DeviceColumn(dt, torch.zeros(0, dtype=torch.int32,
                                            device=device), valid,
                            children=tuple(null_column(f.dtype, n, device)
                                           for f in dt.fields))
    if isinstance(dt, (T.MapType, T.ArrayType)):
        from spark_rapids_tpu_torch.columnar.batch import empty_column

        e = empty_column(dt, device)
        return DeviceColumn(dt, e.data, valid, torch.zeros(
            n + 1, dtype=torch.int32, device=device), children=e.children)
    if dt.fixed_width:
        return DeviceColumn(dt, torch.zeros(T.device_shape(dt, n),
                                            dtype=dt.torch_dtype,
                                            device=device), valid)
    return DeviceColumn(dt, torch.zeros(0, dtype=torch.uint8, device=device),
                        valid, torch.zeros(n + 1, dtype=torch.int32,
                                           device=device))


def mark_rows(flags: torch.Tensor, rows: torch.Tensor,
              hits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The matched-flag scatter: ``flags`` with every row in ``rows`` set
    (where ``hits`` is true, when given). Repeated rows are fine and
    nothing is read back to the host."""
    rows = rows.long()
    if hits is None:
        return flags.index_fill(0, rows, True)
    marks = torch.zeros(flags.numel(), dtype=torch.int32,
                        device=flags.device).index_add_(0, rows, hits.int())
    return flags | (marks > 0)


def gather_column(col: DeviceColumn, idx: torch.Tensor) -> DeviceColumn:
    if col.children is not None:
        return _gather_nested(col, idx.long(), None)
    if col.offsets is not None:
        return gather_string(col, idx)
    idx = idx.long()
    return DeviceColumn(col.dtype, col.data[idx], col.validity[idx], None,
                        col.dictionary)


def gather_column_or_null(col: DeviceColumn,
                          idx: torch.Tensor) -> DeviceColumn:
    """Rows of ``col`` at ``idx``; a negative index gives a null row (an
    outer join's missing side). ``col`` must hold a row."""
    idx = idx.long()
    ok = idx >= 0
    safe = torch.where(ok, idx, torch.zeros_like(idx))
    if col.children is not None:
        if col.is_struct:  # the children's own nulls follow idx too
            return _gather_nested(col, idx, ok)
        return _gather_nested(col, safe, ok)
    if col.offsets is not None:
        return gather_string(col, safe, ok)
    return DeviceColumn(col.dtype, where_valid(ok, col.data[safe]),
                        col.validity[safe] & ok, None, col.dictionary)


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


def slice_batch(batch: ColumnarBatch, start: int, stop: int
                ) -> ColumnarBatch:
    """Rows [start, stop) of a batch without a gather: fixed-width and
    dictionary columns as views; a plain string column's bytes cut and
    its offsets rebased (one host read of the two byte offsets)."""
    return ColumnarBatch([slice_column(c, start, stop)
                          for c in batch.columns], stop - start)


def slice_column(c: DeviceColumn, start: int, stop: int) -> DeviceColumn:
    """Rows [start, stop) of one column (see ``slice_batch``); a STRUCT's
    children sliced alike, a MAP's entry children by its offsets."""
    if c.is_struct:
        return DeviceColumn(c.dtype, c.data, c.validity[start:stop],
                            children=tuple(slice_column(k, start, stop)
                                           for k in c.children))
    if c.offsets is None:
        return DeviceColumn(c.dtype, c.data[start:stop],
                            c.validity[start:stop], None, c.dictionary)
    lo, hi = c.offsets[[start, stop]].tolist()
    if c.is_map:
        return DeviceColumn(c.dtype, c.data, c.validity[start:stop],
                            c.offsets[start:stop + 1] - lo,
                            children=tuple(slice_column(k, lo, hi)
                                           for k in c.children))
    return DeviceColumn(c.dtype, c.data[lo:hi], c.validity[start:stop],
                        c.offsets[start:stop + 1] - lo)


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


def string_full_keys(col: DeviceColumn, words: int) -> List[torch.Tensor]:
    """``words`` int64 keys of a plain string column, most significant
    first: the first ``8 * words`` bytes of each row, big-endian, zero past
    the row's end, with the top bit flipped so that torch's signed order
    of a word is the unsigned order of its bytes. Ties past a row's end
    (``"ab"`` and ``"ab\\0"``) are broken by the length key that
    ``sortable_keys`` adds."""
    n = col.num_rows
    dev = col.device
    nbytes = col.data.numel()
    lens = col.lengths().long()
    starts = col.offsets[:-1].long()
    byte_pos = torch.arange(8, device=dev)
    keys = []
    for w in range(words):
        rel = byte_pos + 8 * w
        if nbytes == 0:
            b = torch.zeros(n, 8, dtype=torch.uint8, device=dev)
        else:
            pos = torch.clamp(starts[:, None] + rel, max=nbytes - 1)
            b = torch.where(rel < lens[:, None], col.data[pos],
                            torch.zeros((), dtype=torch.uint8, device=dev))
        word = b.flip(1).contiguous().view(torch.int64).reshape(n)
        keys.append(word ^ _INT64_MIN)
    return keys


def sortable_keys(col: DeviceColumn, ascending: bool = True,
                  nulls_first: Optional[bool] = None) -> List[torch.Tensor]:
    """Per-column sort keys, least significant first, each in torch's signed
    order. Spark defaults: nulls first ascending, last descending; NaN
    greater than every other value. A plain string sorts on the big-endian
    words of its bytes, as many as its longest row needs (one host read),
    and then its length, so a proper prefix sorts before its extensions
    (``"a" < "ab" < "ab\\0"``)."""
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
        longest = int(col.lengths().max()) if col.num_rows else 0
        words = string_full_keys(col, (longest + 7) // 8)
        data_keys = [col.lengths().long()] + words[::-1]
        if not ascending:
            data_keys = [~k for k in data_keys]
        data_keys = [torch.where(v, k, torch.zeros_like(k))
                     for k in data_keys]
        null_key = v.int() if nulls_first else 1 - v.int()
        return data_keys + [null_key]
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
    null_key = v.int() if nulls_first else 1 - v.int()
    if col.data.dim() == 2:  # DECIMAL128: (hi, lo read unsigned)
        kh, kl = I128.sortable_keys(*I128.split(col.data))
        if not ascending:
            kh, kl = ~kh, ~kl
        return [where_valid(v, kl), where_valid(v, kh), null_key]
    k = (col.data.int() if dt in (T.BYTE, T.SHORT, T.INT, T.DATE)
         else col.data.long())
    if not ascending:
        k = ~k
    k = torch.where(v, k, torch.zeros_like(k))
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


# powers of each variant's string multiplier, one int64 tensor per
# (variant, device), kept on its device and grown by doubling on it, so a
# warm hash copies nothing from the host; it covers the longest row hashed
# so far (rounded up to a power of two), not a column's total bytes
_POW_TABLES: dict = {}
_POW_LOCK = threading.Lock()


def _pow_table(variant: int, n: int, device) -> torch.Tensor:
    """powers[k] = p**k mod 2**64 (int64 bits) for k < n, on ``device``."""
    key = (variant, torch.device(device))
    with _POW_LOCK:
        t = _POW_TABLES.get(key)
        if t is None:
            t = torch.ones(1, dtype=torch.int64, device=device)
        while t.numel() < n:
            step = pow(_STR_P[variant], t.numel(), 1 << 64)
            t = torch.cat([t, t * _s64(step)])
        _POW_TABLES[key] = t
    return t[:n]


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
        powers = _pow_table(variant, int(lens.max()), dev)
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
        elif col.data.dim() == 2:  # DECIMAL128: both limbs
            hi, lo = I128.split(col.data)
            ch = _splitmix64(_splitmix64(_int_sortable(lo) ^ salt) + hi)
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
        elif ca.data.dim() == 2 or cb.data.dim() == 2:  # DECIMAL128 limbs
            ceq = (_limbs(ca)[a_idx] == _limbs(cb)[b_idx]).all(dim=1)
        else:
            ceq = ca.data.long()[a_idx] == cb.data.long()[b_idx]
        eq = eq & ((ceq & va & vb) | (~va & ~vb))
    return eq


def _limbs(c: DeviceColumn) -> torch.Tensor:
    """A decimal column's (n, 2) ``[lo, hi]`` limbs (a DECIMAL64 column's
    sign-extended)."""
    if c.data.dim() == 2:
        return c.data
    return I128.pack(*I128.from_i64(c.data))


def strings_equal(a: DeviceColumn, b: DeviceColumn) -> torch.Tensor:
    """Row-wise byte equality of two string columns of one length: codes
    when both share one dictionary, else the bytes (``_string_eq_at``).
    Validity is the caller's."""
    if a.is_dict and b.is_dict and a.dictionary is b.dictionary:
        return a.data == b.data
    rows = torch.arange(a.num_rows, device=a.device)
    return _string_eq_at(a, rows, b, rows)


def dictionary_unique(entries: DeviceColumn
                      ) -> Tuple[DeviceColumn, torch.Tensor]:
    """Re-encode a plain string column as a dictionary: (its distinct
    values sorted bytewise, each row's code among them). Entries that
    are equal share one code, and code order is byte order."""
    n = entries.num_rows
    if n == 0:
        return entries, torch.zeros(0, dtype=torch.int32,
                                    device=entries.device)
    perm = lexsort_chain(sortable_keys(entries))
    boundary = torch.ones(n, dtype=torch.bool, device=entries.device)
    boundary[1:] = ~_string_eq_at(entries, perm[1:], entries, perm[:-1])
    rank = torch.cumsum(boundary.int(), 0, dtype=torch.int32) - 1
    codes = torch.empty(n, dtype=torch.int32, device=entries.device)
    codes[perm] = rank
    return gather_string(entries, perm[boundary]), codes


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
        elif c.data.dim() == 2:  # DECIMAL128: each limb a lane
            lanes.append(m(c.data[:, 0]))
            lanes.append(m(c.data[:, 1]))
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


def sparse_table(m: torch.Tensor, op, ident, levels: int) -> torch.Tensor:
    """Doubling sparse table of ``op`` (torch.minimum or torch.maximum):
    level k holds, at each row, ``op`` over the 2^k rows from it (rows past
    the end read ``ident``); ``levels`` rows, so ranges up to
    2^levels - 1 rows wide. The reference's ``_sparse_table``."""
    out = [m]
    k = 1
    for _ in range(1, levels):
        prev = out[-1]
        pad = prev.new_full((min(k, prev.numel()),), ident)
        out.append(op(prev, torch.cat([prev[k:], pad])))
        k *= 2
    return torch.stack(out)


def sparse_query(tbl: torch.Tensor, op, lo: torch.Tensor,
                 hi: torch.Tensor) -> torch.Tensor:
    """``op`` over rows lo..hi (inclusive, in range) of the table's input,
    per row: two overlapping power-of-two blocks of the level that fits
    the range (the reference's ``_sparse_query``)."""
    n = tbl.shape[1]
    width = (hi - lo + 1).clamp(min=1)
    kk = (torch.frexp(width.double()).exponent.long() - 1).clamp(
        max=tbl.shape[0] - 1)
    second = (hi - (torch.ones_like(kk) << kk) + 1).clamp(min=0)
    flat = tbl.reshape(-1)
    return op(flat[kk * n + lo], flat[kk * n + second])


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


def segment_sum_int128(h: torch.Tensor, l: torch.Tensor, seg: torch.Tensor,
                       starts: torch.Tensor):
    """(hi, lo) per-segment sums of 128-bit values over sorted segment
    ids, exact mod 2^128: lo's two 32-bit halves and hi are summed apart
    (each half's sums stay below 2^63 for fewer than 2^31 rows, hi wraps
    mod 2^64 as its place value allows), then joined with carries."""
    seg_sum = _sorted_segment_reducers(seg, starts)[0]
    l0, l1 = I128.lo_halves(l)
    return I128.from_part_sums(seg_sum(l0), seg_sum(l1), seg_sum(h))


def segment_minmax_int128(h: torch.Tensor, l: torch.Tensor,
                          valid: torch.Tensor, seg: torch.Tensor,
                          starts: torch.Tensor, op: str):
    """(hi, lo) per-segment min or max of 128-bit values over their valid
    rows: reduce the signed hi word, then lo read unsigned among the rows
    that tie on it (a segment with no valid row gives 0)."""
    _, seg_min, seg_max = _sorted_segment_reducers(seg, starts)
    red = seg_min if op == "min" else seg_max
    ident = (1 << 63) - 1 if op == "min" else -(1 << 63)
    kh, kl = I128.sortable_keys(h, l)
    segl = seg.long()
    hm = torch.where(valid, kh, ident)
    rh = red(hm)
    tie = valid & (hm == rh[segl])
    rl = red(torch.where(tie, kl, ident))
    any_valid = seg_max(valid.long()) > 0
    zero = torch.zeros_like(rh)
    return (torch.where(any_valid, rh, zero),
            torch.where(any_valid, rl ^ _INT64_MIN, zero))


def segment_agg(values: Optional[torch.Tensor], validity: torch.Tensor,
                seg: torch.Tensor, starts: torch.Tensor, op: str):
    """One segmented aggregation over sorted segment ids; ``starts`` holds
    each segment's first row (``GroupInfo.group_starts``).

    Returns (values, validity) with one entry per segment. ``op`` is one of
    sum, count (non-null values), count_all (rows; ``values`` unused), min
    and max. Sums of integers are int64, of floats float64, of DECIMAL128
    (n, 2) limbs exact mod 2^128; a segment with no non-null value is null
    (counts never are)."""
    seg_sum, seg_min, seg_max = _sorted_segment_reducers(seg, starts)
    if op in ("count_all", "count"):
        data = seg_sum((validity if op == "count" else
                        torch.ones_like(validity)).long())
        return data, torch.ones_like(data, dtype=torch.bool)
    any_valid = seg_sum(validity.long()) > 0
    if values.dim() == 2:  # DECIMAL128 limbs
        h, l = I128.split(where_valid(validity, values))
        if op == "sum":
            return I128.pack(*segment_sum_int128(h, l, seg, starts)), \
                any_valid
        if op in ("min", "max"):
            return I128.pack(*segment_minmax_int128(
                h, l, validity, seg, starts, op)), any_valid
        raise NotImplementedError(f"decimal128 segment op {op}")
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


def segment_pick(valid: torch.Tensor, seg: torch.Tensor,
                 starts: torch.Tensor, last: bool = False):
    """Per sorted segment: the position of its first (``last``: its last)
    row where ``valid``, and whether it has one (positions in the
    segments' row order; a segment without one gives a position inside
    no row of it)."""
    seg_sum, seg_min, seg_max = _sorted_segment_reducers(seg, starts)
    n = valid.numel()
    pos = torch.arange(n, device=valid.device)
    if last:
        at = seg_max(torch.where(valid, pos, torch.full_like(pos, -1)))
    else:
        at = seg_min(torch.where(valid, pos, torch.full_like(pos, n)))
    return at, seg_sum(valid.long()) > 0


def segment_arg_extreme(key: torch.Tensor, valid: torch.Tensor,
                        seg: torch.Tensor, starts: torch.Tensor, op: str):
    """Per sorted segment: the first position holding the least (``op``
    "min") or greatest ("max") int64 ``key`` among the valid rows, and
    whether any row is valid (min_by/max_by's pick, the reference's
    ``_minmax_by_agg``)."""
    _seg_sum, seg_min, seg_max = _sorted_segment_reducers(seg, starts)
    info = torch.iinfo(torch.int64)
    ident = info.max if op == "min" else info.min
    k = torch.where(valid, key.long(), torch.full_like(key, ident,
                                                       dtype=torch.int64))
    best = (seg_min if op == "min" else seg_max)(k)
    tie = valid & (k == best[seg.long()])
    return segment_pick(tie, seg, starts)


def string_order_ranks(col: DeviceColumn) -> torch.Tensor:
    """Each row's position in the byte order of a plain string column (a
    proper prefix first; nulls first, their ranks unused): int64."""
    order = sort_indices(ColumnarBatch([col], col.num_rows),
                         [SortSpec(0, True, True)])
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=order.device)
    return rank


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
    out = [concat_columns([b.columns[ci] for b in batches])
           for ci in range(len(batches[0].columns))]
    return ColumnarBatch(out, sum(b.num_rows for b in batches))


def concat_columns(cols: Sequence[DeviceColumn]) -> DeviceColumn:
    """One column of the rows of ``cols`` in order; a nested column's
    children concatenated alike (a MAP's offsets rebased as a string's)."""
    first = cols[0]
    if first.children is not None:
        kids = tuple(concat_columns([c.children[k] for c in cols])
                     for k in range(len(first.children)))
        offsets = None
        if first.is_map:
            offs, base = [], 0
            for i, c in enumerate(cols):
                offs.append((c.offsets if i == 0 else c.offsets[1:]) + base)
                base += c.children[0].num_rows
            offsets = torch.cat(offs).int()
        return DeviceColumn(first.dtype, first.data,
                            torch.cat([c.validity for c in cols]), offsets,
                            children=kids)
    if all(c.is_dict and c.dictionary is first.dictionary for c in cols):
        return DeviceColumn(first.dtype, torch.cat([c.data for c in cols]),
                            torch.cat([c.validity for c in cols]), None,
                            first.dictionary)
    if any(c.is_dict or c.offsets is not None for c in cols):
        return _concat_strings([decode_dictionary(c) if c.is_dict else c
                                for c in cols])
    return DeviceColumn(first.dtype, torch.cat([c.data for c in cols]),
                        torch.cat([c.validity for c in cols]))


# ---------------------------------------------------------------------------
# Open-addressing hash table over the 128-bit hash pair
# ---------------------------------------------------------------------------
#
# The table stores each distinct key's (h1, h2) pair in a power-of-two slot
# array; duplicate build rows attach to their key's slot, and the rows
# stably sorted by slot (``order``/``sorted_slots``) turn each slot into a
# candidate range. Linear probing is bounded by ``max_probes``; a build
# that overflows the bound is rebuilt with the next seed at twice the
# capacity. A slot's two hash words sit side by side, one 16-byte record a
# slot (``slot_keys``, whose columns are ``slot_h1`` and ``slot_h2``), so
# the probe kernel compares a slot with one load; and each slot
# has a tag byte (0 when empty, else 0x80 | (h2 & 0x7f) of its key;
# ``slot_used`` is tag != 0), which the probe kernel reads first, so that
# it loads a slot's record only when the tag is the probe row's.

HASHTBL_MAX_PROBES = 16  # reference default of the probe bound
HASHTBL_MAX_REHASH = 4   # reference default of the seeded rebuilds


class HashTable(NamedTuple):
    slot_keys: torch.Tensor     # (capacity, 2) int64 bits of (h1, h2)
    row_slot: torch.Tensor      # (n,) int32, -1: invalid key
    order: torch.Tensor         # (n,) int32 build rows stably sorted by slot
    sorted_slots: torch.Tensor  # (n,) int32 row_slot[order]; invalid: capacity
    slot_tag: torch.Tensor      # (capacity,) uint8 (hashtbl_tags)

    @property
    def slot_used(self) -> torch.Tensor:
        """(capacity,) bool: whether each slot holds a key (tag != 0)."""
        return self.slot_tag != 0

    @property
    def slot_h1(self) -> torch.Tensor:
        """(capacity,) int64: each slot's h1 (a view of ``slot_keys``)."""
        return self.slot_keys[:, 0]

    @property
    def slot_h2(self) -> torch.Tensor:
        """(capacity,) int64: each slot's h2 (a view of ``slot_keys``)."""
        return self.slot_keys[:, 1]


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


def hashtbl_tags(slot_used: torch.Tensor,
                 slot_h2: torch.Tensor) -> torch.Tensor:
    """Tag byte of each slot: 0 when empty, else 0x80 | (h2 & 0x7f)."""
    return torch.where(slot_used, (slot_h2 & 0x7F) | 0x80,
                       0).to(torch.uint8)


def _hashtbl_insert_rounds(h1, h2, valid, capacity: int, seed: int,
                           max_probes: int):
    """Round-synchronous build: returns (slot_keys, slot_used, row_slot).

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
    keys = torch.zeros(capacity + 1, 2, dtype=torch.int64, device=dev)
    slot_h1, slot_h2 = keys[:, 0], keys[:, 1]
    pair = torch.stack([h1, h2], 1)
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
        keys[wpos] = pair
        slot_used[wpos] = True
        match = (unplaced & slot_used[pos] & (slot_h1[pos] == h1)
                 & (slot_h2[pos] == h2))
        row_slot = torch.where(match, pos.int(), row_slot)
    return keys[:capacity], slot_used[:capacity], row_slot


def build_hash_table(h1: torch.Tensor, h2: torch.Tensor, valid: torch.Tensor,
                     capacity: int, seed: int, max_probes: int):
    """Build the table and its duplicate layout. Returns (HashTable,
    overflow); ``overflow`` (host bool) means some valid row found no slot
    within the probe bound under this seed."""
    slot_keys, slot_used, row_slot = _hashtbl_insert_rounds(
        h1, h2, valid, capacity, seed, max_probes)
    placed = valid & (row_slot >= 0)
    overflow = bool((valid & ~placed).any())
    srt = torch.where(placed, row_slot, capacity)
    order = torch.sort(srt, stable=True).indices.int()
    return HashTable(slot_keys, row_slot, order, srt[order.long()],
                     hashtbl_tags(slot_used, slot_keys[:, 1])), overflow


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
    used = tbl.slot_used
    for p in range(max_probes):
        if bool(done.all()):
            break
        pos = (base + p) & (capacity - 1)
        occ = used[pos]
        match = occ & (tbl.slot_h1[pos] == h1) & (tbl.slot_h2[pos] == h2)
        slot = torch.where(~done & match, pos.int(), slot)
        done = done | match | ~occ
    return slot, slot >= 0


# launches of each hand-written kernel, counted where the kernel launches
KERNEL_LAUNCHES = {"hashtbl_probe": 0, "segscan": 0}
_launch_lock = threading.Lock()


def reset_kernel_launches() -> None:
    with _launch_lock:
        for k in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[k] = 0


_bound_fns = {}  # (kernel source, C function) -> (library, bound function)
# guards the module's caches (bound functions, the scan's scratch): a
# shuffle's writer threads may reach them concurrently
_cache_lock = threading.Lock()


def _kernel_fn(source: str, name: str):
    """(library, bound C function) of one kernel source, built and loaded
    on first use and cached."""
    with _cache_lock:
        got = _bound_fns.get((source, name))
        if got is None:
            from spark_rapids_tpu_torch import native

            lib = native.load(source)
            got = _bound_fns[(source, name)] = (lib, getattr(lib, name))
    return got


def _device_stream(device: torch.device) -> Tuple[int, int]:
    """(index, current stream handle) of a CUDA device. The handle comes
    from torch's raw-stream call, which builds no Stream object."""
    idx = device.index
    if idx is None:
        raise ValueError(f"{device} names no CUDA device index")
    return idx, torch._C._cuda_getCurrentRawStream(idx)


def _launch(kernel: str, lib, fn, idx: int, stream: int, *args) -> None:
    """Call one kernel's C launch function ``fn`` of library ``lib`` on
    device ``idx``'s ``stream``, switching the current device only when it
    is another; raise on a launch error, else count the launch."""
    if idx == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(idx):  # launch in the tensors' context
            rc = fn(*args, stream)
    if rc != 0:
        from spark_rapids_tpu_torch import native

        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({native.error_string(lib, rc)})")
    with _launch_lock:
        KERNEL_LAUNCHES[kernel] += 1


def _check_probe_args(tbl: HashTable, h1: torch.Tensor, h2: torch.Tensor,
                      capacity: int, max_probes: int) -> None:
    dev = h1.device
    keys, tag = tbl.slot_keys, tbl.slot_tag
    for name, t, dt, shape in (
            ("slot_keys", keys, torch.int64, (capacity, 2)),
            ("slot_tag", tag, torch.uint8, (capacity,)),
            ("h1", h1, torch.int64, None), ("h2", h2, torch.int64, None)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h1 on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if shape is not None and t.shape != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    if not (keys.is_contiguous() and tag.is_contiguous()
            and h1.is_contiguous() and h2.is_contiguous()):
        raise ValueError("slot_keys, slot_tag, h1 and h2 must be "
                         "contiguous")
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
    for CPU tensors. Same contract as ``probe_hash_table``. The kernel
    reads ``slot_tag`` and ``slot_keys``, from which the plain version's
    ``slot_used``, ``slot_h1`` and ``slot_h2`` are derived."""
    _check_probe_args(tbl, h1, h2, capacity, max_probes)
    dev = h1.device
    if dev.type == "cpu":
        return probe_hash_table(tbl, h1, h2, capacity, seed, max_probes)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    n = h1.numel()
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _launch("hashtbl_probe",
                *_kernel_fn("hashtbl_probe.cu", "srt_hashtbl_probe"),
                *_device_stream(dev), tbl.slot_tag.data_ptr(),
                tbl.slot_keys.data_ptr(),
                h1.data_ptr(), h2.data_ptr(), slot.data_ptr(),
                hit.data_ptr(), n, capacity, _seed_mix(seed), max_probes)
    return slot, hit


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


# ---------------------------------------------------------------------------
# Sorted-hash join structures (the hash-table path's fallback)
# ---------------------------------------------------------------------------
# The build side's rows with no null key, sorted by their 64-bit key hash
# (``hash_keys``, variant 0); a probe row's candidates are the build rows of
# its hash, found by two binary searches. The reference sorts and searches
# the hash as uint64; torch has no unsigned 64-bit sort or searchsorted, so
# the hash is sorted and searched as ``_u64_order`` of its bits (top bit
# flipped), whose signed order is the unsigned order. Rows with a null key
# never match: the reference pushes them past every real hash and clamps
# the search to the valid count, the port leaves them out of the sorted
# arrays, which gives the same ranges.


class JoinHashes(NamedTuple):
    sorted_hash: torch.Tensor  # (n_valid,) int64 _u64_order of the hash
    order: torch.Tensor        # (n_valid,) int32 build row of each position


def prepare_join_side(batch: ColumnarBatch,
                      key_cols: Sequence[int]) -> JoinHashes:
    """Sort a build side's non-null-key rows by key hash (stable, so equal
    hashes keep row order)."""
    valid = torch.ones(batch.num_rows, dtype=torch.bool,
                       device=batch.columns[key_cols[0]].device)
    for i in key_cols:
        valid = valid & batch.columns[i].validity
    rows = filter_indices(valid)
    h = _u64_order(hash_keys(batch, list(key_cols))[rows])
    srt = torch.sort(h, stable=True)
    return JoinHashes(srt.values, rows[srt.indices].int())


def join_candidate_counts(probe: ColumnarBatch, probe_keys: Sequence[int],
                          build: JoinHashes):
    """Per probe row, its candidate range ``[lo, lo + cnt)`` in
    ``build.order`` (0 candidates for a null key). Returns (lo, cnt)."""
    ph = _u64_order(hash_keys(probe, list(probe_keys)))
    pvalid = torch.ones(probe.num_rows, dtype=torch.bool, device=ph.device)
    for i in probe_keys:
        pvalid = pvalid & probe.columns[i].validity
    lo = torch.searchsorted(build.sorted_hash, ph).int()
    hi = torch.searchsorted(build.sorted_hash, ph, right=True).int()
    return lo, torch.where(pvalid, hi - lo, torch.zeros_like(lo))


# ---------------------------------------------------------------------------
# Segmented scan (window segment/peer geometry, running frames)
# ---------------------------------------------------------------------------

_SEGSCAN_OPS = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}
_SEGSCAN_OP_CODES = {"add": 0, "min": 1, "max": 2}
_SEGSCAN_DTYPE_CODES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                        torch.float64: 3}
_SEGSCAN_TILE_ROWS = 4096  # rows a tile of csrc/segscan.cu (its kTile)
# adds a value can meet inside one tile of csrc/segscan.cu (its kThreads x
# kItems rows in runs of kRun; segscan_add_tolerance)
_SEGSCAN_TILE_DEPTH = 20


def segmented_scan(values: torch.Tensor, is_start: torch.Tensor,
                   op_name: str = "add") -> torch.Tensor:
    """Plain version of the inclusive segmented scan: ``out[i]`` folds
    ``op`` over the rows from the last ``is_start`` row at or before ``i``
    (row 0 when there is none) up to ``i``.

    A log-step (Hillis-Steele) scan of the reference's (seen-a-head, value)
    combine ``(fa, va) . (fb, vb) = (fa | fb, vb if fb else va op vb)``.
    Integer add wraps; min and max propagate NaN (torch.minimum/maximum).
    Not a prefix sum minus the prefix at the segment start: for floats that
    subtraction would lose a small segment's sum under a large prefix."""
    op = _SEGSCAN_OPS[op_name]
    n = values.numel()
    v = values.clone()
    f = is_start.to(torch.bool).clone()
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        nf = f[d:] | f[:-d]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d *= 2
    return v


def segscan_add_tolerance(abs_running: torch.Tensor, n: int,
                          dtype: torch.dtype,
                          grouping: str = "kernel") -> torch.Tensor:
    """Stated tolerance of a float ``add`` scan against the plain version,
    per row: a first-order rounding bound of (ceil(log2 n) + depth) * eps *
    (running sum of |values| in the row's segment), where ceil(log2 n)
    bounds the adds a value passes through in the plain version's log-step
    scan (one a step) and ``depth`` those of the other grouping:
    - ``"kernel"``, the CUDA kernel: 20 + ceil(n / 4096). Its 4096-row
      tile is 8 warps, each lane holding 4 runs of 4 rows. On its way to
      the tile's aggregate a value meets at most 3 sequential adds in its
      run, 5 shuffle-scan steps over the lanes, 3 adds chaining the
      warp's runs and 3 shuffle-scan steps over the 8 warp totals (14);
      from there (or from the tile's prefix) into a row, at most 6 folds:
      the warp's prefix, the 3 runs before, the lanes before and the row
      (20 in all, the most any value inside the tile meets). The decoupled
      look-back carries it across the tiles before the row's, at most one
      add a tile crossed (a look-back over d tiles reduces them in a tree
      of depth <= log2 d, chains windows of 32, and adds the inclusive
      prefix it publishes: at most d adds): ceil(n / 4096);
    - ``"reference"``, the JAX package's scans: the larger of its odd-even
      associative scan (<= 2 adds a level, 2 ceil(log2 n)) and its Pallas
      kernel's 128-lane rows and row carries (<= 15 + 2 ceil(log2(n / 128
      + 1)))."""
    eps = torch.finfo(dtype).eps
    lg = math.ceil(math.log2(max(n, 2)))
    if grouping == "kernel":
        depth = _SEGSCAN_TILE_DEPTH + -(-max(n, 1) // _SEGSCAN_TILE_ROWS)
    elif grouping == "reference":
        depth = max(2 * lg, 15 + 2 * math.ceil(math.log2(n / 128 + 1)))
    else:
        raise ValueError(f"grouping {grouping!r} is not kernel or reference")
    return (lg + depth) * eps * abs_running


def _check_segscan_args(values: torch.Tensor, is_start: torch.Tensor,
                        op_name: str) -> None:
    if op_name not in _SEGSCAN_OPS:
        raise ValueError(f"segmented scan op {op_name!r} is not one of "
                         f"{sorted(_SEGSCAN_OPS)}")
    if values.dim() != 1 or is_start.shape != values.shape:
        raise ValueError("values and is_start must be 1-D of one length")
    if is_start.dtype != torch.bool:
        raise TypeError(f"is_start must be bool, got {is_start.dtype}")
    if is_start.device != values.device:
        raise ValueError(f"is_start is on {is_start.device}, values on "
                         f"{values.device}")


@lru_cache(maxsize=None)
def _segscan_layout(lib) -> Tuple[int, int, int]:
    """(rows a tile, header bytes, bytes a tile) of the kernel's scratch."""
    out = [ctypes.c_int64() for _ in range(3)]
    lib.srt_segscan_scratch_layout(*[ctypes.byref(o) for o in out])
    if out[0].value != _SEGSCAN_TILE_ROWS:  # segscan_add_tolerance uses it
        raise RuntimeError(f"segscan.cu tiles {out[0].value} rows, "
                           f"_SEGSCAN_TILE_ROWS says {_SEGSCAN_TILE_ROWS}")
    return out[0].value, out[1].value, out[2].value


# (device index, stream) -> the scan's scratch there: zeroed once and left
# zeroed by every launch; launches on one stream run one at a time
_segscan_scratch = {}


def _segscan_scratch_for(lib, n: int, idx: int, stream: int):
    """The stream's zeroed scratch, grown to fit an n-row scan."""
    tile, header, per_tile = _segscan_layout(lib)
    nbytes = header + per_tile * -(-n // tile)
    with _cache_lock:
        buf = _segscan_scratch.get((idx, stream))
        if buf is None or buf.numel() < nbytes:
            # zeroed on the device's current stream, the one the scan runs
            # on
            grown = 2 * buf.numel() if buf is not None else 0
            buf = torch.zeros(max(nbytes, grown), dtype=torch.uint8,
                              device=idx)
            _segscan_scratch[(idx, stream)] = buf
    return buf


def segmented_scan_kernel(values: torch.Tensor, is_start: torch.Tensor,
                          op_name: str = "add") -> torch.Tensor:
    """Segmented-scan wrapper: the CUDA kernel for CUDA tensors, the plain
    ``segmented_scan`` for CPU tensors. Same contract as the plain version;
    on the card, values must be contiguous int8, int16, int32, int64,
    float32 or float64 (any storage offset). The kernel has int32, int64,
    float32 and float64 instantiations: int8 and int16 values are scanned
    widened to int32 and narrowed back, which is exact for min and max and,
    since addition modulo 2^8 (2^16) commutes with narrowing, for the
    wrapping add too."""
    _check_segscan_args(values, is_start, op_name)
    dev = values.device
    if dev.type == "cpu":
        return segmented_scan(values, is_start, op_name)
    if dev.type != "cuda":
        raise ValueError(f"no segmented-scan kernel for device {dev}")
    if values.dtype in (torch.int8, torch.int16):
        return segmented_scan_kernel(values.int(), is_start,
                                     op_name).to(values.dtype)
    code = _SEGSCAN_DTYPE_CODES.get(values.dtype)
    if code is None:
        raise TypeError(f"the segmented-scan kernel takes int8, int16, "
                        f"int32, int64, float32 or float64 values, got "
                        f"{values.dtype}")
    if not (values.is_contiguous() and is_start.is_contiguous()):
        raise ValueError("values and is_start must be contiguous")
    n = values.numel()
    out = torch.empty_like(values)
    if n == 0:
        return out
    lib, fn = _kernel_fn("segscan.cu", "srt_segscan")
    idx, stream = _device_stream(dev)
    scratch = _segscan_scratch_for(lib, n, idx, stream)
    _launch("segscan", lib, fn, idx, stream,
            values.data_ptr(), is_start.data_ptr(), out.data_ptr(), n, code,
            _SEGSCAN_OP_CODES[op_name], scratch.data_ptr(), scratch.numel())
    return out
