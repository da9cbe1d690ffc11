"""Build the port's device structures from numpy state.

The reference package's batches and hash tables cross over as numpy arrays
(its uint64 words viewed as int64, its bools as uint8 or bool), so tests
can feed a table the reference built straight into the port's probe. This
module imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.kernels import HashTable


def _t(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.require(a, requirements=["C", "W"])
    if dtype == torch.bool:
        a = a.astype(np.bool_)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).to(dtype).to(device)


def batch_from_numpy(columns: Sequence[Dict[str, np.ndarray]],
                     schema: T.Schema, device) -> ColumnarBatch:
    """Columns as dicts: ``data`` and ``validity``; plain strings add
    ``offsets``; dictionary strings give int32 codes in ``data`` plus
    ``dict_data`` and ``dict_offsets``. Every column has the same length;
    byte buffers may run past their last offset (the reference pads them)
    and are cut there, as the port's layout requires."""
    cols = []
    for c, f in zip(columns, schema):
        valid = _t(c["validity"], torch.bool, device)
        if "dict_offsets" in c:
            off = np.asarray(c["dict_offsets"])
            d = DeviceColumn(T.STRING,
                             _t(c["dict_data"][: int(off[-1])], torch.uint8,
                                device),
                             torch.ones(len(off) - 1, dtype=torch.bool,
                                        device=device),
                             _t(off - off[0], torch.int32, device))
            cols.append(DeviceColumn(T.STRING,
                                     _t(c["data"], torch.int32, device),
                                     valid, None, d))
        elif "offsets" in c:
            off = np.asarray(c["offsets"])
            cols.append(DeviceColumn(T.STRING,
                                     _t(c["data"][: int(off[-1])],
                                        torch.uint8, device),
                                     valid, _t(off, torch.int32, device)))
        else:
            cols.append(DeviceColumn(f.dtype, _t(c["data"], f.dtype.torch_dtype,
                                                 device), valid))
    n = cols[0].num_rows if cols else 0
    return ColumnarBatch(cols, n)


def hash_table_from_numpy(fields: Dict[str, np.ndarray], device) -> HashTable:
    """A HashTable from the reference's fields: ``slot_h1``/``slot_h2``
    (uint64 or int64 bits), ``slot_used`` (bool or uint8), and the int32
    ``row_slot``, ``order`` and ``sorted_slots``."""
    return HashTable(
        _t(fields["slot_h1"], torch.int64, device),
        _t(fields["slot_h2"], torch.int64, device),
        _t(fields["slot_used"], torch.bool, device),
        _t(fields["row_slot"], torch.int32, device),
        _t(fields["order"], torch.int32, device),
        _t(fields["sorted_slots"], torch.int32, device))
