"""Device-resident columns (counterpart of spark_rapids_tpu/columnar/column.py).

A column holds exactly its live rows, so there is no capacity padding:

- fixed width: ``data`` (n,) of the type's torch dtype, ``validity`` (n,) bool;
- plain string: ``data`` uint8 bytes, ``offsets`` int32 (n+1,), ``validity``;
- dictionary string: ``data`` int32 codes into ``dictionary``, a plain string
  column of distinct values sorted bytewise, so code order is byte order.

Null rows carry zeroed data (empty strings), so hashing and gathers never
read undefined values. A plain string column's ``data`` holds exactly
``offsets[-1]`` bytes, so its byte count is known without a device read.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from spark_rapids_tpu_torch import types as T


@dataclasses.dataclass
class DeviceColumn:
    dtype: T.DataType
    data: torch.Tensor
    validity: torch.Tensor
    offsets: Optional[torch.Tensor] = None
    dictionary: Optional["DeviceColumn"] = None

    @property
    def is_dict(self) -> bool:
        return self.dictionary is not None

    @property
    def num_rows(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    def lengths(self) -> torch.Tensor:
        """Byte length per row of a plain string column (int32)."""
        return self.offsets[1:] - self.offsets[:-1]
