"""Byte helpers of the device's string values (counterpart of the offsets
and byte-gather helpers of spark_rapids_tpu/exprs/strings.py), over the
port's plain string columns (``columnar/column.py``: uint8 bytes, int32
offsets, validity; a dictionary column's entries are one).

The casts to and from strings build on them (``exprs/cast_strings.py``):
``row_ids`` names the row of each byte, ``make_offsets`` turns row lengths
into offsets (``DeviceColumn.lengths`` reads them back), and ``emit`` cuts
each row's window out of a byte matrix into a plain column (the output's
byte count is its one host read).
"""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


def make_offsets(lens: torch.Tensor) -> torch.Tensor:
    """int32 offsets (n + 1,) of rows with byte lengths ``lens``."""
    out = torch.zeros(lens.numel() + 1, dtype=torch.int32,
                      device=lens.device)
    if lens.numel():
        out[1:] = torch.cumsum(lens, 0, dtype=torch.int32)
    return out


def row_ids(offsets: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The row (int64) of each of the first ``nbytes`` bytes of a column
    with ``offsets``."""
    n = offsets.numel() - 1
    lens = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=offsets.device),
                                   lens, output_size=nbytes)


def emit(mat: torch.Tensor, lens: torch.Tensor, start: torch.Tensor,
         validity: torch.Tensor) -> DeviceColumn:
    """A plain string column whose row i is ``mat[i, start[i]:start[i] +
    lens[i]]`` (empty where the row is null)."""
    lens = torch.where(validity, lens.int(), torch.zeros_like(lens.int()))
    offsets = make_offsets(lens)
    total = int(offsets[-1]) if lens.numel() else 0
    rows = row_ids(offsets, total)
    rel = torch.arange(total, device=mat.device) - offsets[:-1].long()[rows]
    data = mat[rows, start.long()[rows] + rel]
    return DeviceColumn(T.STRING, data.to(torch.uint8).contiguous(),
                        validity, offsets)
