"""Z-order and Hilbert clustering indexes on the device (counterpart of
spark_rapids_tpu/exec/zorder.py; the reference plugin's GpuInterleaveBits
and GpuHilbertLongIndex, which Delta's OPTIMIZE ZORDER BY uses).

Each key column is ranked (its full sort-key stack, nulls first, ties in
row order) and the ranks are scaled to fill 32 bits, so the curve's top
bits discriminate whatever the values' distribution; then the bits are
interleaved (the Z curve) or walked through the Hilbert state machine.
The 64-bit index is carried as an int64 bit pattern (torch has no uint64
shifts on the CPU), and sorted as unsigned by flipping its sign bit.

The batch holds live rows only, so a column is ranked over its rows, and
the scale comes from the row count. The reference ranks over its padded
capacity: its padding rows rank among the nulls, ahead of every value,
and its scale comes from the capacity, so its index depends on the
power-of-two bucket and equals the port's only where the rows fill it.
Both run where their batch lives.
"""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import kernels as K

_SIGN = K._s64(1 << 63)


def _normalize_u32(col: DeviceColumn) -> torch.Tensor:
    """Order-preserving 32-bit normalisation of a column (int64 holding
    the unsigned value): each row's rank among the rows, shifted up so the
    largest rank fills the top bit."""
    keys = K.sortable_keys(col, ascending=True, nulls_first=True)
    # every key of the column's stack: one alone would drop a float's
    # value or most of a string
    order = K.lexsort_chain(keys)
    n = col.num_rows
    ranks = torch.empty(n, dtype=torch.int64, device=order.device)
    ranks[order] = torch.arange(n, dtype=torch.int64, device=order.device)
    shift = 32 - max((n - 1).bit_length(), 1)
    return ranks << shift


def interleave_bits(batch: ColumnarBatch,
                    key_cols: Sequence[int]) -> torch.Tensor:
    """The Z-curve index: with k columns, the top min(64 // k, 32) bits
    of each normalised key, interleaved most significant first (int64
    bits of the uint64)."""
    k = len(key_cols)
    bits_per = min(64 // k, 32)
    cols = [_normalize_u32(batch.columns[i]) for i in key_cols]
    out = torch.zeros(batch.num_rows, dtype=torch.int64,
                      device=cols[0].device)
    zero = torch.zeros((), dtype=torch.int64, device=out.device)
    for b in range(bits_per):
        for ci, c in enumerate(cols):
            bit = ((c >> (31 - b)) & 1).bool()
            pos = 63 - (b * k + ci)
            out |= torch.where(bit, K._s64(1 << pos), zero)
    return out


def hilbert_index(batch: ColumnarBatch, key_cols: Sequence[int],
                  order: int = 16) -> torch.Tensor:
    """The 2-D Hilbert index of two key columns at ``order`` bits a
    coordinate (below 2^32 at order 16)."""
    if len(key_cols) != 2:
        raise ValueError("hilbert_index is 2-D")
    x = _normalize_u32(batch.columns[key_cols[0]]) >> (32 - order)
    y = _normalize_u32(batch.columns[key_cols[1]]) >> (32 - order)
    d = torch.zeros_like(x)
    s = 1 << (order - 1)
    while s > 0:
        rx = ((x & s) > 0).long()
        ry = ((y & s) > 0).long()
        d += s * s * ((3 * rx) ^ ry)
        # rotate the quadrant; the reference's uint32 wraps, masked here
        swap = ry == 0
        flip = swap & (rx == 1)
        x_flip = torch.where(flip, (s - 1 - x) & 0xFFFFFFFF, x)
        y_flip = torch.where(flip, (s - 1 - y) & 0xFFFFFFFF, y)
        x = torch.where(swap, y_flip, x_flip)
        y = torch.where(swap, x_flip, y_flip)
        s //= 2
    return d


def zorder_sort_indices(batch: ColumnarBatch, key_cols: Sequence[int],
                        curve: str = "z") -> torch.Tensor:
    """The row order that clusters by the curve (``"z"``, else Hilbert):
    the sort OPTIMIZE ZORDER BY makes. Stable, ties in row order."""
    idx = (interleave_bits(batch, key_cols) if curve == "z"
           else hilbert_index(batch, key_cols))
    return torch.sort(idx ^ _SIGN, stable=True).indices
