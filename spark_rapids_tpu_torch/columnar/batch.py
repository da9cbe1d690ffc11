"""Columnar batches and Arrow interop (counterpart of
spark_rapids_tpu/columnar/batch.py).

A batch holds live rows only: ``num_rows`` is a host int equal to every
column's length, so there is no padding mask and no capacity bucket.
Strings that ``dictionary_encode_table`` encodes arrive as int32 codes into a
bytewise-sorted dictionary shared by every batch sliced from one table
(``dict_cache``), so codes compare and order consistently across batches.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


@dataclasses.dataclass
class ColumnarBatch:
    columns: List[DeviceColumn]
    num_rows: int


def resolve_device(device=None) -> torch.device:
    """The device a user-facing entry point runs on: ``cuda`` unless the
    caller names one. Without a card and without an explicit device this
    raises; the port never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU")
    return torch.device("cuda")


def empty_column(dt: T.DataType, device) -> DeviceColumn:
    valid = torch.zeros(0, dtype=torch.bool, device=device)
    if dt.fixed_width:
        return DeviceColumn(dt, torch.zeros(0, dtype=dt.torch_dtype,
                                            device=device), valid)
    return DeviceColumn(dt, torch.zeros(0, dtype=torch.uint8, device=device),
                        valid, torch.zeros(1, dtype=torch.int32,
                                           device=device))


def empty_batch(dtypes: Sequence[T.DataType], device) -> ColumnarBatch:
    return ColumnarBatch([empty_column(dt, device) for dt in dtypes], 0)


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(
        device)


def _arrow_fixed_to_numpy(arr: pa.Array, dt: T.DataType):
    """(values, valid) numpy arrays; null slots read as zero."""
    valid = (None if arr.null_count == 0
             else np.asarray(arr.is_valid(), dtype=np.bool_))
    if dt == T.DATE:
        values = np.asarray(arr.fill_null(0).cast(pa.int32()))
    elif dt == T.BOOLEAN:
        values = np.asarray(arr.fill_null(False).cast(pa.int8())).astype(
            np.bool_)
    else:
        np_dtype = torch.empty(0, dtype=dt.torch_dtype).numpy().dtype
        values = np.asarray(arr.fill_null(0)).astype(np_dtype, copy=False)
    if valid is not None:
        values = np.where(valid, values, np.zeros((), values.dtype))
    return values, valid


def _sort_remap_dictionary(enc: pa.DictionaryArray) -> pa.DictionaryArray:
    """Sort a DictionaryArray's dictionary bytewise and remap its codes, so
    code order is byte order (no-op when already sorted)."""
    dvals = enc.dictionary
    order = pc.sort_indices(dvals)
    rank = np.empty(len(dvals), np.int32)
    rank[np.asarray(order)] = np.arange(len(dvals), dtype=np.int32)
    codes = np.asarray(enc.indices.fill_null(0)).astype(np.int32)
    new_codes = pa.array(rank[codes], pa.int32(),
                         mask=~np.asarray(enc.is_valid()))
    return pa.DictionaryArray.from_arrays(new_codes, dvals.take(order))


def _dict_bytes_encodable(dvals, n_rows: int) -> bool:
    """Worst-case decode (rows x longest entry) must fit int32 offsets."""
    if len(dvals) == 0:
        return False
    lens = np.diff(np.frombuffer(dvals.buffers()[1], np.int32,
                                 count=len(dvals) + 1,
                                 offset=dvals.offset * 4))
    dmax = int(lens.max()) if len(lens) else 0
    return max(n_rows, 1024) * max(dmax, 1) < (1 << 31)


def dictionary_encode_table(table: pa.Table,
                            columns: Optional[Sequence[str]] = None,
                            max_size: int = 1 << 16) -> pa.Table:
    """Dictionary-encode eligible string columns with a sorted dictionary.

    Same eligibility rule as the reference: a column stays plain when its
    distinct count exceeds ``max_size`` or half its rows (16 at least)."""
    out = table
    for i, name in enumerate(table.column_names):
        if columns is not None and name not in columns:
            continue
        col = table.column(i).combine_chunks()
        if pa.types.is_dictionary(col.type):
            if not pa.types.is_string(col.type.value_type):
                continue
            enc = col
        elif pa.types.is_string(col.type):
            enc = col.dictionary_encode()
            if isinstance(enc, pa.ChunkedArray):
                enc = enc.combine_chunks()
        else:
            continue
        dvals = enc.dictionary.cast(pa.string())
        if len(dvals) == 0 or not _dict_bytes_encodable(dvals, len(col)):
            continue
        if not pa.types.is_dictionary(col.type) and (
                len(dvals) > max_size or len(dvals) > max(16, len(col) // 2)):
            continue
        out = out.set_column(i, name, _sort_remap_dictionary(enc))
    return out


def _plain_string_column(sarr: pa.Array, device) -> DeviceColumn:
    sarr = sarr.cast(pa.string())
    n = len(sarr)
    valid = np.asarray(sarr.is_valid(), dtype=np.bool_)
    raw = np.frombuffer(sarr.buffers()[1], dtype=np.int32, count=n + 1,
                        offset=sarr.offset * 4)
    offsets = (raw - raw[0]).astype(np.int32)
    nbytes = int(offsets[-1])
    buf = sarr.buffers()[2]
    data = (np.frombuffer(buf, dtype=np.uint8, count=nbytes,
                          offset=int(raw[0])).copy()
            if buf is not None and nbytes else np.zeros(0, np.uint8))
    return DeviceColumn(T.STRING, _to_tensor(data, device),
                        _to_tensor(valid, device), _to_tensor(offsets, device))


def _dict_column(arr: pa.DictionaryArray, device,
                 dict_cache: Optional[dict]) -> DeviceColumn:
    dvals = arr.dictionary.cast(pa.string())
    order = np.asarray(pc.sort_indices(dvals))
    if not np.array_equal(order, np.arange(len(dvals))):
        arr = _sort_remap_dictionary(
            pa.DictionaryArray.from_arrays(arr.indices, dvals))
        dvals = arr.dictionary
    # batches sliced from one table share one arrow dictionary buffer, and
    # through this cache one device dictionary object
    key = (dvals.buffers()[2].address if dvals.buffers()[2] is not None
           else 0, len(dvals), str(device))
    dict_col = dict_cache.get(key) if dict_cache is not None else None
    if dict_col is None:
        dict_col = _plain_string_column(dvals, device)
        if dict_cache is not None:
            dict_cache[key] = dict_col
    valid = np.asarray(arr.is_valid(), dtype=np.bool_)
    codes = np.asarray(arr.indices.fill_null(0)).astype(np.int32)
    codes[~valid] = 0
    return DeviceColumn(T.STRING, _to_tensor(codes, device),
                        _to_tensor(valid, device), None, dict_col)


def batch_from_arrow(table, device=None,
                     dict_cache: Optional[dict] = None) -> ColumnarBatch:
    """Host Arrow table -> device batch of its rows.

    Dictionary-typed string columns become dictionary columns; pass one
    ``dict_cache`` across calls so slices of one table share a dictionary."""
    if isinstance(table, pa.RecordBatch):
        table = pa.table(table)
    device = resolve_device(device)
    cols: List[DeviceColumn] = []
    for name in table.column_names:
        arr = table.column(name).combine_chunks()
        dt = T.from_arrow_type(arr.type)
        if isinstance(arr.type, pa.DictionaryType):
            dv = arr.dictionary.cast(pa.string())
            if dt == T.STRING and _dict_bytes_encodable(dv, len(arr)):
                cols.append(_dict_column(arr, device, dict_cache))
                continue
            arr = arr.cast(arr.type.value_type)
        if dt.fixed_width:
            values, valid = _arrow_fixed_to_numpy(arr, dt)
            if valid is None:
                valid = np.ones(len(values), np.bool_)
            cols.append(DeviceColumn(dt, _to_tensor(values, device),
                                     _to_tensor(valid, device)))
        else:
            cols.append(_plain_string_column(arr, device))
    return ColumnarBatch(cols, table.num_rows)


def _validity_buffer(valid: np.ndarray) -> pa.Buffer:
    return pa.py_buffer(np.packbits(valid, bitorder="little").tobytes())


def _string_array(offsets: np.ndarray, data: np.ndarray,
                  valid: Optional[np.ndarray]) -> pa.Array:
    n = len(offsets) - 1
    vbuf = (_validity_buffer(valid)
            if valid is not None and not valid.all() else None)
    return pa.Array.from_buffers(
        pa.string(), n, [vbuf, pa.py_buffer(offsets.astype(np.int32).tobytes()),
                         pa.py_buffer(data.tobytes())])


def _column_to_arrow(col: DeviceColumn, dt: T.DataType) -> pa.Array:
    valid = col.validity.cpu().numpy()
    mask = None if valid.all() else ~valid
    if col.is_dict:
        d = col.dictionary
        dvals = _string_array(d.offsets.cpu().numpy(), d.data.cpu().numpy(),
                              None)
        codes = pa.array(col.data.cpu().numpy().astype(np.int32), pa.int32(),
                         mask=mask)
        return pa.DictionaryArray.from_arrays(codes, dvals).cast(pa.string())
    if col.offsets is not None:
        return _string_array(col.offsets.cpu().numpy(), col.data.cpu().numpy(),
                             valid)
    values = col.data.cpu().numpy()
    if dt == T.DATE:
        return pa.array(values.astype(np.int32), pa.int32(),
                        mask=mask).cast(pa.date32())
    return pa.array(values, type=dt.arrow_type(), mask=mask)


def batch_to_arrow(batch: ColumnarBatch, schema: T.Schema) -> pa.Table:
    """Device batch -> host Arrow table."""
    arrays = [_column_to_arrow(c, f.dtype)
              for c, f in zip(batch.columns, schema)]
    return pa.table(arrays, schema=schema.to_arrow())


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """Concatenate batches on their device (see exec.kernels.concat_device)."""
    from spark_rapids_tpu_torch.exec.kernels import concat_device

    return concat_device(batches)
