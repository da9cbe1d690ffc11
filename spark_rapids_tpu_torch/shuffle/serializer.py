"""Kudo-style columnar wire format of the shuffle (counterpart of
spark_rapids_tpu/shuffle/serializer.py; the bytes are equal to the
reference's for the same Arrow table).

Wire layout per table (little-endian):
  magic  u32 = 0x54505553 ("SPUT")
  n_rows u32, n_cols u32, codec u8, pad 3B
  per column: type_code u8, has_offsets u8, pad 2B,
              data_len u32, validity_len u32, offsets_len u32
  body_len u32, then the body: per column its data bytes, its packed
  validity bitmask (empty when the column has no null) and its int32
  offsets (strings), compressed as a whole by the codec.

A DECIMAL64 column rides as bigint (its unscaled int64 values) and a
DECIMAL128 one as 16-byte rows; the scale travels out of band, in the
schema the reader is given. BINARY rides as a string does, under its own
type code. The format has no code for a nested type (neither has the
reference's, which fails with a KeyError): serializing an ARRAY, STRUCT
or MAP column raises NotImplementedError naming it. ``merge_tables`` turns many serialized blocks
into one Arrow table on the host (the kudo host merge). Host-only: numpy
and pyarrow, no device.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import timestamp_micros

_MAGIC = 0x54505553

# the reference's type codes
_TYPE_CODES = {
    "boolean": 0, "tinyint": 1, "smallint": 2, "int": 3, "bigint": 4,
    "float": 5, "double": 6, "date": 7, "timestamp": 8, "string": 9,
    "binary": 10, "decimal128": 11,
}
_NUMPY = {T.BYTE: np.int8, T.SHORT: np.int16, T.INT: np.int32,
          T.LONG: np.int64, T.FLOAT: np.float32, T.DOUBLE: np.float64,
          T.DATE: np.int32, T.TIMESTAMP: np.int64}
CODECS = {"none": 0, "zlib": 1, "lz4": 2, "zstd": 3}
_CODEC_NAMES = {v: k for k, v in CODECS.items()}

_HDR = struct.Struct("<IIIBxxx")
_COL = struct.Struct("<BBxxIII")


def _is_wide_dec(dt: T.DataType) -> bool:
    return T.is_wide_decimal(dt)


def _type_code(dt: T.DataType) -> int:
    if T.is_nested(dt):
        raise NotImplementedError(
            f"the shuffle's wire format has no code for the nested type "
            f"{dt.name}")
    if isinstance(dt, T.DecimalType):
        return _TYPE_CODES["decimal128" if _is_wide_dec(dt) else "bigint"]
    return _TYPE_CODES[dt.name]


def _decimal_to_bytes(arr: pa.Array, dt: T.DecimalType) -> bytes:
    limbs = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * len(arr), offset=arr.offset * 16)
    if _is_wide_dec(dt):
        return limbs.tobytes()  # whole (lo, hi) 16-byte rows
    return limbs[0::2].tobytes()


def _string_parts(arr: pa.Array, dt: T.DataType,
                  n_rows: int) -> Tuple[bytes, bytes]:
    """(data bytes, offsets from 0) of a string or BINARY array."""
    sarr = arr.cast(dt.arrow_type())
    raw = np.frombuffer(sarr.buffers()[1], dtype=np.int32, count=n_rows + 1,
                        offset=sarr.offset * 4)
    off = raw - raw[0]
    dbuf = sarr.buffers()[2]
    nbytes = int(off[-1])
    data = (bytes(memoryview(dbuf)[int(raw[0]): int(raw[0]) + nbytes])
            if dbuf is not None else b"")
    return data, off.tobytes()


def serialize_table(table: pa.Table, codec: str = "none") -> bytes:
    """A host Arrow table (one partition's slice) -> wire bytes."""
    n_rows = table.num_rows
    header = [_HDR.pack(_MAGIC, n_rows, table.num_columns, CODECS[codec])]
    bufs: List[bytes] = []
    for col in table.columns:
        arr = col.combine_chunks()
        dt = T.from_arrow_type(arr.type)
        code = _type_code(dt)
        offsets = b""
        if dt == T.BOOLEAN:
            data = np.asarray(arr.fill_null(False)).astype(np.uint8).tobytes()
        elif isinstance(dt, T.DecimalType):
            data = _decimal_to_bytes(arr, dt)
        elif dt == T.DATE:
            data = np.asarray(arr.fill_null(0).cast(pa.int32())).tobytes()
        elif dt == T.TIMESTAMP:  # any unit, as microseconds
            data = timestamp_micros(arr).tobytes()
        elif dt.fixed_width:
            data = np.asarray(arr.fill_null(0)).astype(
                _NUMPY[dt], copy=False).tobytes()
        else:
            data, offsets = _string_parts(arr, dt, n_rows)
        validity = (b"" if arr.null_count == 0 else np.packbits(
            np.asarray(arr.is_valid()), bitorder="little").tobytes())
        header.append(_COL.pack(code, 1 if offsets else 0,
                                len(data), len(validity), len(offsets)))
        bufs.append(data + validity + offsets)
    body = b"".join(bufs)
    if codec == "zlib":
        body = zlib.compress(body, level=1)
    elif codec in ("lz4", "zstd"):
        body = (struct.pack("<Q", len(body))
                + pa.Codec(codec).compress(body, asbytes=True))
    return b"".join(header) + struct.pack("<I", len(body)) + body


def _null_mask(validity: bytes, n_rows: int) -> Optional[np.ndarray]:
    if not validity:
        return None
    bits = np.unpackbits(np.frombuffer(validity, np.uint8),
                         bitorder="little")[:n_rows]
    return ~bits.astype(np.bool_)


def _decimal_from_int64(vals: np.ndarray, mask: Optional[np.ndarray],
                        dt: T.DecimalType) -> pa.Array:
    """Unscaled int64 values -> Arrow decimal128(p, s): each value's
    16-byte two's complement, null slots zero."""
    if mask is not None:
        vals = np.where(mask, np.int64(0), vals)
    limbs = np.empty((len(vals), 2), np.int64)
    limbs[:, 0] = vals
    limbs[:, 1] = vals >> 63
    vbuf = (None if mask is None else pa.py_buffer(
        np.packbits(~mask, bitorder="little").tobytes()))
    return pa.Array.from_buffers(dt.arrow_type(), len(vals),
                                 [vbuf, pa.py_buffer(limbs.tobytes())])


def deserialize_table(buf: bytes, schema: T.Schema,
                      offset: int = 0) -> Tuple[pa.Table, int]:
    """Wire bytes at ``offset`` -> (Arrow table, the next table's offset)."""
    magic, n_rows, n_cols, codec = _HDR.unpack_from(buf, offset)
    if magic != _MAGIC:
        raise ValueError("bad shuffle block magic")
    pos = offset + _HDR.size
    cols_meta = []
    for _ in range(n_cols):
        cols_meta.append(_COL.unpack_from(buf, pos))
        pos += _COL.size
    (body_len,) = struct.unpack_from("<I", buf, pos)
    pos += 4
    body = buf[pos: pos + body_len]
    end = pos + body_len
    cname = _CODEC_NAMES[codec]
    if cname == "zlib":
        body = zlib.decompress(body)
    elif cname in ("lz4", "zstd"):
        (raw_len,) = struct.unpack_from("<Q", body, 0)
        body = pa.Codec(cname).decompress(body[8:], raw_len, asbytes=True)
    arrays = []
    bpos = 0
    for (_tcode, has_off, dlen, vlen, olen), field in zip(cols_meta, schema):
        data = body[bpos: bpos + dlen]
        validity = body[bpos + dlen: bpos + dlen + vlen]
        offs = body[bpos + dlen + vlen: bpos + dlen + vlen + olen]
        bpos += dlen + vlen + olen
        dt = field.dtype
        vbuf = pa.py_buffer(validity) if vlen else None
        if has_off:
            arr = pa.Array.from_buffers(dt.arrow_type(), n_rows,
                                        [vbuf, pa.py_buffer(offs),
                                         pa.py_buffer(data)])
        elif dt == T.BOOLEAN:
            arr = pa.array(np.frombuffer(data, np.uint8).astype(np.bool_),
                           mask=_null_mask(validity, n_rows))
        elif _is_wide_dec(dt):
            arr = pa.Array.from_buffers(dt.arrow_type(), n_rows,
                                        [vbuf, pa.py_buffer(data)])
        elif isinstance(dt, T.DecimalType):
            arr = _decimal_from_int64(np.frombuffer(data, np.int64),
                                      _null_mask(validity, n_rows), dt)
        else:
            arr = pa.array(np.frombuffer(data, _NUMPY[dt]),
                           mask=_null_mask(validity, n_rows))
            if dt in (T.DATE, T.TIMESTAMP):
                arr = arr.cast(dt.arrow_type())
        arrays.append(arr)
    return pa.table(arrays, schema=schema.to_arrow()), end


def merge_tables(blocks: List[bytes], schema: T.Schema) -> Optional[pa.Table]:
    """Host merge of serialized blocks (each may hold several frames) into
    one Arrow table; None when there is no frame."""
    tables = []
    for b in blocks:
        pos = 0
        while pos < len(b):
            t, pos = deserialize_table(b, schema, pos)
            tables.append(t)
    if not tables:
        return None
    return pa.concat_tables(tables)
