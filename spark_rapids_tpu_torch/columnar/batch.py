"""Columnar batches and Arrow interop (counterpart of
spark_rapids_tpu/columnar/batch.py).

A batch holds live rows only: ``num_rows`` is a host int equal to every
column's length, so there is no padding mask and no capacity bucket.
Strings that ``dictionary_encode_table`` encodes arrive as int32 codes into a
bytewise-sorted dictionary shared by every batch sliced from one table
(``dict_cache``), so codes compare and order consistently across batches.
STRUCT, MAP and ARRAY columns upload recursively (``_nested_column``: a
struct's fields and a map's keys and values as child columns, their
strings plain) and download back to Arrow's layouts; an array with a null
element raises (``ELEMENT_NULLS``: the device's arrays have none).
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
    if isinstance(dt, (T.StructType, T.MapType)):
        kids = ([f.dtype for f in dt.fields] if isinstance(dt, T.StructType)
                else [dt.key, dt.value])
        return DeviceColumn(
            dt, torch.zeros(0, dtype=torch.int32, device=device), valid,
            None if isinstance(dt, T.StructType) else torch.zeros(
                1, dtype=torch.int32, device=device),
            children=tuple(empty_column(k, device) for k in kids))
    if isinstance(dt, T.ArrayType):
        return DeviceColumn(dt, torch.zeros(0, dtype=dt.element.torch_dtype,
                                            device=device), valid,
                            torch.zeros(1, dtype=torch.int32, device=device))
    if dt.fixed_width:
        return DeviceColumn(dt, torch.zeros(T.device_shape(dt, 0),
                                            dtype=dt.torch_dtype,
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
    """(values, valid) numpy arrays; null slots read as zero. A DECIMAL128
    column's values are its (n, 2) ``[lo, hi]`` limbs, a view of Arrow's
    buffer."""
    valid = (None if arr.null_count == 0
             else np.asarray(arr.is_valid(), dtype=np.bool_))
    if T.is_wide_decimal(dt):
        values = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                               count=2 * len(arr),
                               offset=arr.offset * 16).reshape(len(arr), 2)
        if valid is not None:
            values = np.where(valid[:, None], values, np.int64(0))
        return values, valid
    if isinstance(dt, T.DecimalType):
        # decimal128 -> int64 unscaled: the low limb of each 16-byte
        # little-endian value is the whole value for precision <= 18
        limbs = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                              count=2 * len(arr), offset=arr.offset * 16)
        values = limbs[0::2].copy()
    elif dt == T.DATE:
        values = np.asarray(arr.fill_null(0).cast(pa.int32()))
    elif dt == T.TIMESTAMP:
        values = timestamp_micros(arr)
    elif dt == T.BOOLEAN:
        values = np.asarray(arr.fill_null(False).cast(pa.int8())).astype(
            np.bool_)
    else:
        np_dtype = torch.empty(0, dtype=dt.torch_dtype).numpy().dtype
        if arr.null_count:
            arr = arr.fill_null(0)
        values = np.asarray(arr).astype(np_dtype, copy=False)
    if valid is not None:
        values = np.where(valid, values, np.zeros((), values.dtype))
    return values, valid


def timestamp_micros(arr: pa.Array) -> np.ndarray:
    """int64 microseconds since the epoch of an Arrow timestamp array of any
    unit or zone (an instant: the zone does not move it); null slots read
    as 0."""
    if arr.type.unit != "us":
        arr = arr.cast(pa.timestamp("us", tz=arr.type.tz))
    return np.asarray(arr.cast(pa.int64()).fill_null(0))


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
        ftype = table.schema.field(i).type
        if not (pa.types.is_string(ftype) or pa.types.is_dictionary(ftype)):
            continue  # not a string: no need to gather its chunks
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


def _plain_string_column(sarr: pa.Array, device,
                         dt: T.DataType = T.STRING) -> DeviceColumn:
    sarr = sarr.cast(dt.arrow_type())
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
    return DeviceColumn(dt, _to_tensor(data, device),
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


ELEMENT_NULLS = "element nulls in arrays are not on the device"


def array_element_nulls(arr, dt: T.DataType) -> bool:
    """Whether an Arrow column of type ``dt`` holds an array with a null
    element anywhere in it (the device's arrays have none)."""
    if isinstance(arr, pa.ChunkedArray):
        return any(array_element_nulls(c, dt) for c in arr.chunks)
    if isinstance(dt, T.ArrayType):
        return _list_values(arr).null_count > 0
    if isinstance(dt, T.StructType):
        return any(array_element_nulls(arr.field(i), f.dtype)
                   for i, f in enumerate(dt.fields))
    if isinstance(dt, T.MapType):
        entries = _list_values(arr)
        return (array_element_nulls(entries.field(0), dt.key)
                or array_element_nulls(entries.field(1), dt.value))
    return False


def _list_values(arr: pa.Array) -> pa.Array:
    """The elements an array (or map) column's rows span, from its first
    row's start: ``values`` (not ``flatten``) keeps the elements under null
    rows, so offsets and elements stay aligned."""
    raw = np.asarray(arr.offsets, dtype=np.int32)
    return arr.values.slice(int(raw[0]), int(raw[-1] - raw[0]))


def _rebased_offsets(arr: pa.Array) -> np.ndarray:
    raw = np.asarray(arr.offsets, dtype=np.int32)
    return (raw - raw[0]).astype(np.int32)


def _valid_mask(arr: pa.Array) -> np.ndarray:
    return (np.ones(len(arr), np.bool_) if arr.null_count == 0
            else np.asarray(arr.is_valid(), dtype=np.bool_))


def _nested_column(arr: pa.Array, dt: T.DataType, device) -> DeviceColumn:
    """An Arrow column of any of the port's types as a device column,
    recursively for STRUCT and MAP children (their strings plain)."""
    valid = _to_tensor(_valid_mask(arr), device)
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    if isinstance(dt, T.StructType):
        kids = tuple(_nested_column(arr.field(i), f.dtype, device)
                     for i, f in enumerate(dt.fields))
        return DeviceColumn(dt, empty, valid, children=kids)
    if isinstance(dt, T.MapType):
        off = _rebased_offsets(arr)
        entries = _list_values(arr)
        keys, items = entries.field(0), entries.field(1)
        return DeviceColumn(dt, empty, valid, _to_tensor(off, device),
                            children=(_nested_column(keys, dt.key, device),
                                      _nested_column(items, dt.value,
                                                     device)))
    if isinstance(dt, T.ArrayType):
        flat = _list_values(arr)
        if flat.null_count:
            raise NotImplementedError(ELEMENT_NULLS)
        values, _ = _arrow_fixed_to_numpy(flat, dt.element)
        return DeviceColumn(dt, _to_tensor(values, device), valid,
                            _to_tensor(_rebased_offsets(arr), device))
    if dt.fixed_width:
        values, _ = _arrow_fixed_to_numpy(arr, dt)
        return DeviceColumn(dt, _to_tensor(values, device), valid)
    return _plain_string_column(arr, device, dt)


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
        if T.is_nested(dt):
            cols.append(_nested_column(arr, dt, device))
        elif dt.fixed_width:
            values, valid = _arrow_fixed_to_numpy(arr, dt)
            if valid is None:
                valid = np.ones(len(values), np.bool_)
            cols.append(DeviceColumn(dt, _to_tensor(values, device),
                                     _to_tensor(valid, device)))
        else:
            cols.append(_plain_string_column(arr, device, dt))
    return ColumnarBatch(cols, table.num_rows)


def _validity_buffer(valid: np.ndarray) -> pa.Buffer:
    return pa.py_buffer(np.packbits(valid, bitorder="little").tobytes())


def _string_array(offsets: np.ndarray, data: np.ndarray,
                  valid: Optional[np.ndarray],
                  arrow_type: pa.DataType = pa.string()) -> pa.Array:
    n = len(offsets) - 1
    vbuf = (_validity_buffer(valid)
            if valid is not None and not valid.all() else None)
    return pa.Array.from_buffers(
        arrow_type, n, [vbuf, pa.py_buffer(offsets.astype(np.int32).tobytes()),
                         pa.py_buffer(data.tobytes())])


def _decimal_array(unscaled: np.ndarray, dt: T.DecimalType,
                   valid: np.ndarray) -> pa.Array:
    """Unscaled values -> Arrow decimal128(p, s): each value is its 16-byte
    little-endian two's complement. int64 values (n,) get their sign limb;
    DECIMAL128 limbs (n, 2) ``[lo, hi]`` are that layout already."""
    if unscaled.ndim == 2:
        limbs = np.ascontiguousarray(unscaled, dtype=np.int64)
    else:
        lo = unscaled.astype(np.int64, copy=False)
        limbs = np.empty((len(lo), 2), np.int64)
        limbs[:, 0] = lo
        limbs[:, 1] = lo >> 63
    vbuf = None if valid.all() else _validity_buffer(valid)
    return pa.Array.from_buffers(dt.arrow_type(), len(limbs),
                                 [vbuf, pa.py_buffer(limbs.tobytes())])


def _column_to_arrow(col: DeviceColumn, dt: T.DataType) -> pa.Array:
    valid = col.validity.cpu().numpy()
    mask = None if valid.all() else ~valid
    if isinstance(dt, T.StructType):
        kids = [_column_to_arrow(c, f.dtype)
                for c, f in zip(col.children, dt.fields)]
        return pa.StructArray.from_arrays(
            kids, fields=list(dt.arrow_type()),
            mask=None if mask is None else pa.array(mask))
    if isinstance(dt, (T.MapType, T.ArrayType)):
        off = col.offsets.cpu().numpy().astype(np.int32)
        vbuf = None if mask is None else _validity_buffer(valid)
        if isinstance(dt, T.MapType):
            entries = pa.StructArray.from_arrays(
                [_column_to_arrow(col.children[0], dt.key),
                 _column_to_arrow(col.children[1], dt.value)],
                fields=[pa.field("key", dt.key.arrow_type(), False),
                        pa.field("value", dt.value.arrow_type())])
        else:  # the elements, none null, as a column of their own
            n = int(off[-1])
            entries = _column_to_arrow(DeviceColumn(
                dt.element, col.data[:n], torch.ones(
                    n, dtype=torch.bool, device=col.device)), dt.element)
        return pa.Array.from_buffers(dt.arrow_type(), len(valid),
                                     [vbuf, pa.py_buffer(off.tobytes())],
                                     children=[entries])
    if col.is_dict:
        d = col.dictionary
        dvals = _string_array(d.offsets.cpu().numpy(), d.data.cpu().numpy(),
                              None)
        codes = pa.array(col.data.cpu().numpy().astype(np.int32), pa.int32(),
                         mask=mask)
        return pa.DictionaryArray.from_arrays(codes, dvals).cast(pa.string())
    if col.offsets is not None:
        return _string_array(col.offsets.cpu().numpy(), col.data.cpu().numpy(),
                             valid, dt.arrow_type())
    values = col.data.cpu().numpy()
    if isinstance(dt, T.DecimalType):
        return _decimal_array(values, dt, valid)
    return fixed_array(values, dt, mask)


def fixed_array(values: np.ndarray, dt: T.DataType,
                mask: Optional[np.ndarray]) -> pa.Array:
    """Arrow array of a fixed-width, non-decimal type from its device
    values (a date's int32 days, a timestamp's int64 microseconds)."""
    if dt == T.DATE:
        return pa.array(values.astype(np.int32, copy=False), pa.int32(),
                        mask=mask).cast(pa.date32())
    if dt == T.TIMESTAMP:
        return pa.array(values.astype(np.int64, copy=False), pa.int64(),
                        mask=mask).cast(dt.arrow_type())
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
