"""Device-resident columns (counterpart of spark_rapids_tpu/columnar/column.py).

A column holds exactly its live rows, so there is no capacity padding:

- fixed width: ``data`` (n,) of the type's torch dtype, ``validity`` (n,) bool;
  DECIMAL128: ``data`` (n, 2) int64, each row ``[lo, hi]`` (two's complement
  limbs, Arrow's 16-byte decimal128 layout), so a row gather ``data[idx]``
  and ``torch.cat`` along rows carry it as they carry any column;
- plain string: ``data`` uint8 bytes, ``offsets`` int32 (n+1,), ``validity``;
- dictionary string: ``data`` int32 codes into ``dictionary``, a plain string
  column of distinct values sorted bytewise, so code order is byte order;
- ARRAY: ``data`` the flat element buffer (no element nulls), ``offsets``
  int32 (n+1,) into it, ``validity``: a plain string's layout with
  elements for bytes, so the string gathers, slices and concatenations
  carry it;
- STRUCT: ``children`` one column of n rows a field, ``validity`` the
  struct's own, ``data`` an empty placeholder (struct-of-columns);
- MAP: ``offsets`` int32 (n+1,) over ``children`` ``(keys, values)``, two
  flat entry columns, ``data`` an empty placeholder.

Null rows carry zeroed data (empty strings), so hashing and gathers never
read undefined values. A plain string column's ``data`` holds exactly
``offsets[-1]`` bytes, so its byte count is known without a device read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T


@dataclasses.dataclass
class DeviceColumn:
    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor
    offsets: Optional[torch.Tensor] = None
    dictionary: Optional["DeviceColumn"] = None
    children: Optional[Tuple["DeviceColumn", ...]] = None

    @property
    def is_dict(self) -> bool:
        return self.dictionary is not None

    @property
    def is_struct(self) -> bool:
        return self.children is not None and self.offsets is None

    @property
    def is_map(self) -> bool:
        return self.children is not None and self.offsets is not None

    @property
    def num_rows(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def lengths(self) -> torch.Tensor:
        """Byte length per row of a plain string column (int32)."""
        return self.offsets[1:] - self.offsets[:-1]
