"""Spark SQL data types the port carries, mapped onto torch dtypes.

Counterpart of ``spark_rapids_tpu/types.py`` for its scalar types: BOOLEAN,
BYTE, SHORT, INT and LONG (int8/16/32/64, Java's wraparound), FLOAT and
DOUBLE (float32/float64), DATE (int32 days since the epoch), TIMESTAMP
(int64 microseconds since the epoch, UTC; any Arrow timestamp unit or zone
reads as it), DECIMAL64 (``DecimalType`` of precision <= 18, an int64
unscaled value), DECIMAL128 (precision 19-38, one ``(n, 2)`` int64
tensor ``[lo, hi]`` a column: two's complement limbs, Arrow's own 16-byte
little-endian layout; arithmetic in ``exec/int128.py``) and STRING
(dictionary codes or int32 offsets + uint8 bytes). BINARY is a plain
string column's layout (never a dictionary) read out as Arrow ``binary``.

The nested types are the reference's: ARRAY of fixed-width elements
with no element nulls on the device (int32 row offsets over a flat element
buffer), STRUCT (one child column a field, struct-of-columns) and MAP
(int32 row offsets over flat key and value children). Two nested types are
equal when their names are (``array<int>``, ``struct<a:int>``).
"""

from __future__ import annotations

import dataclasses
from typing import List

import pyarrow as pa
import torch


class DataType:
    """Base class for SQL data types."""

    name: str = "?"
    torch_dtype: torch.dtype = None  # type: ignore[assignment]

    @property
    def fixed_width(self) -> bool:
        return True

    def arrow_type(self) -> pa.DataType:
        raise NotImplementedError(self.name)

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(self.name)


class BooleanType(DataType):
    name = "boolean"
    torch_dtype = torch.bool

    def arrow_type(self):
        return pa.bool_()


class ByteType(DataType):
    name = "tinyint"
    torch_dtype = torch.int8

    def arrow_type(self):
        return pa.int8()


class ShortType(DataType):
    name = "smallint"
    torch_dtype = torch.int16

    def arrow_type(self):
        return pa.int16()


class IntegerType(DataType):
    name = "int"
    torch_dtype = torch.int32

    def arrow_type(self):
        return pa.int32()


class LongType(DataType):
    name = "bigint"
    torch_dtype = torch.int64

    def arrow_type(self):
        return pa.int64()


class FloatType(DataType):
    name = "float"
    torch_dtype = torch.float32

    def arrow_type(self):
        return pa.float32()


class DoubleType(DataType):
    name = "double"
    torch_dtype = torch.float64

    def arrow_type(self):
        return pa.float64()


class DateType(DataType):
    """Days since 1970-01-01, stored int32 (Spark/Arrow date32)."""

    name = "date"
    torch_dtype = torch.int32

    def arrow_type(self):
        return pa.date32()


class TimestampType(DataType):
    """Microseconds since 1970-01-01 00:00 UTC, stored int64 (Spark's
    TimestampType)."""

    name = "timestamp"
    torch_dtype = torch.int64

    def arrow_type(self):
        return pa.timestamp("us", tz="UTC")


class DecimalType(DataType):
    """Decimal of ``precision`` digits, ``scale`` of them after the point.

    Precision <= 18 (DECIMAL64) is stored on the device as the int64
    unscaled value (value * 10**scale). Wider decimals (DECIMAL128, up to
    38 digits) hold the unscaled value as two int64 limbs a row: a
    column's data is ``(n, 2)`` ``[lo, hi]`` (``device_shape``)."""

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18
    torch_dtype = torch.int64

    def __init__(self, precision: int = 10, scale: int = 0):
        if not 0 <= scale <= precision:
            raise ValueError(f"decimal({precision},{scale}): scale must lie "
                             f"in [0, precision]")
        if precision > self.MAX_PRECISION:
            raise ValueError(f"decimal({precision},{scale}): precision "
                             f"exceeds {self.MAX_PRECISION}")
        self.precision = precision
        self.scale = scale

    @property
    def name(self):  # type: ignore[override]
        return f"decimal({self.precision},{self.scale})"

    def arrow_type(self):
        return pa.decimal128(self.precision, self.scale)

    def __eq__(self, other) -> bool:
        return (isinstance(other, DecimalType)
                and (self.precision, self.scale)
                == (other.precision, other.scale))

    def __hash__(self) -> int:
        return hash((self.precision, self.scale))

    @property
    def is_wide(self) -> bool:
        """DECIMAL128: more digits than one int64 holds."""
        return self.precision > self.MAX_LONG_DIGITS


def device_shape(dt: DataType, n: int):
    """The shape of a fixed-width column's data of ``n`` rows: ``(n, 2)``
    for DECIMAL128 (``[lo, hi]`` limbs), else ``(n,)``."""
    return (n, 2) if is_wide_decimal(dt) else (n,)


class StringType(DataType):
    name = "string"

    @property
    def fixed_width(self):
        return False

    def arrow_type(self):
        return pa.string()


class BinaryType(DataType):
    """Bytes: a plain string column's layout (int32 offsets, uint8 bytes)
    that reads out as Arrow ``binary``."""

    name = "binary"

    @property
    def fixed_width(self):
        return False

    def arrow_type(self):
        return pa.binary()


class NullType(DataType):
    """The type of an untyped NULL literal (``lit(None)``). No column has
    it: ``exprs.expr.resolve`` gives each such literal the type its parent
    needs, or raises a TypeError where none is implied."""

    name = "void"
    torch_dtype = torch.bool

    def arrow_type(self):
        return pa.null()


class _NestedType(DataType):
    """Base of ARRAY, STRUCT and MAP: variable width, equal by name."""

    @property
    def fixed_width(self):
        return False

    def __eq__(self, other) -> bool:
        return isinstance(other, _NestedType) and self.name == other.name

    def __hash__(self) -> int:
        return hash(self.name)


class ArrayType(_NestedType):
    """Array of fixed-width elements: a flat element buffer and int32 row
    offsets, the offsets of a string column. As the reference's round-1
    contract, the device holds no element nulls (an Arrow array with one
    is refused at upload and the planner keeps it on the CPU engine)."""

    def __init__(self, element: DataType, contains_null: bool = False):
        self.element = element
        self.contains_null = contains_null

    @property
    def name(self):  # type: ignore[override]
        return f"array<{self.element.name}>"

    @property
    def torch_dtype(self):  # type: ignore[override]
        return self.element.torch_dtype

    def arrow_type(self):
        return pa.list_(self.element.arrow_type())


class StructType(_NestedType):
    """Struct of named fields, laid out as one child column a field beside
    one struct-level validity."""

    def __init__(self, fields):
        self.fields = [f if isinstance(f, Field) else Field(f[0], f[1])
                       for f in fields]

    @property
    def name(self):  # type: ignore[override]
        inner = ",".join(f"{f.name}:{f.dtype.name}" for f in self.fields)
        return f"struct<{inner}>"

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def arrow_type(self):
        return pa.struct([pa.field(f.name, f.dtype.arrow_type(), f.nullable)
                          for f in self.fields])


class MapType(_NestedType):
    """Map: int32 row offsets over two flat entry columns, the keys and the
    values, in entry order (Arrow's map layout without its entries
    struct)."""

    def __init__(self, key: DataType, value: DataType,
                 value_contains_null: bool = True):
        self.key = key
        self.value = value
        self.value_contains_null = value_contains_null

    @property
    def name(self):  # type: ignore[override]
        return f"map<{self.key.name},{self.value.name}>"

    def arrow_type(self):
        return pa.map_(self.key.arrow_type(), self.value.arrow_type())


def is_nested(dt: DataType) -> bool:
    return isinstance(dt, _NestedType)


def is_wide_decimal(dt: DataType) -> bool:
    return isinstance(dt, DecimalType) and dt.is_wide


def is_exact_decimal_widening(src: DataType, dst: DataType) -> bool:
    """Whether casting ``src`` to the DECIMAL64 ``dst`` only rescales: a
    tinyint, smallint or int (3, 5 or 10 digits) or a decimal whose
    integer digits and scale both fit ``dst``'s, so no value rounds or
    overflows."""
    if not isinstance(dst, DecimalType) or dst.is_wide:
        return False
    if isinstance(src, DecimalType):
        return (dst.scale >= src.scale and dst.precision - dst.scale
                >= src.precision - src.scale)
    digits = {BYTE: 3, SHORT: 5, INT: 10}.get(src)
    return digits is not None and dst.precision - dst.scale >= digits


def check_device_type(dt: DataType) -> None:
    """Raise NotImplementedError for a type no device column can hold: the
    NULL type of an untyped literal (every other type of the port has a
    device layout, DECIMAL128 included)."""
    if isinstance(dt, NullType):
        raise NotImplementedError(
            "an untyped NULL has no device column; give it a type with "
            "lit(None, dtype)")


BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
STRING = StringType()
BINARY = BinaryType()
NULL = NullType()

INTEGRAL_TYPES = (BYTE, SHORT, INT, LONG)
FRACTIONAL_TYPES = (FLOAT, DOUBLE)


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True

    def __repr__(self):
        return f"{self.name}:{self.dtype}{'' if self.nullable else ' not null'}"


class Schema:
    """Ordered collection of named, typed fields."""

    def __init__(self, fields):
        self.fields: List[Field] = list(fields)
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        if isinstance(i, str):
            return self.fields[self._index[i]]
        return self.fields[i]

    def index_of(self, name: str) -> int:
        return self._index[name]

    def names(self):
        return [f.name for f in self.fields]

    def types(self):
        return [f.dtype for f in self.fields]

    def to_arrow(self) -> pa.Schema:
        return pa.schema([pa.field(f.name, f.dtype.arrow_type(), f.nullable)
                          for f in self.fields])

    @staticmethod
    def from_arrow(schema: pa.Schema) -> "Schema":
        return Schema([Field(f.name, from_arrow_type(f.type), f.nullable)
                       for f in schema])

    def __repr__(self):
        return "Schema(" + ", ".join(repr(f) for f in self.fields) + ")"

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields


def from_arrow_type(t: pa.DataType) -> DataType:
    if pa.types.is_dictionary(t):
        # dictionary encoding is a device-layout detail; the logical type is
        # the value type
        return from_arrow_type(t.value_type)
    if pa.types.is_boolean(t):
        return BOOLEAN
    if pa.types.is_int8(t):
        return BYTE
    if pa.types.is_int16(t):
        return SHORT
    if pa.types.is_int32(t):
        return INT
    if pa.types.is_int64(t):
        return LONG
    if pa.types.is_float32(t):
        return FLOAT
    if pa.types.is_float64(t):
        return DOUBLE
    if pa.types.is_date32(t):
        return DATE
    if pa.types.is_timestamp(t):
        return TIMESTAMP
    if pa.types.is_decimal(t):
        return DecimalType(t.precision, t.scale)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return STRING
    if pa.types.is_binary(t) or pa.types.is_large_binary(t):
        return BINARY
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        elem = from_arrow_type(t.value_type)
        if not elem.fixed_width:
            raise NotImplementedError("nested variable-width arrays")
        return ArrayType(elem)
    if pa.types.is_map(t):
        return MapType(from_arrow_type(t.key_type),
                       from_arrow_type(t.item_type))
    if pa.types.is_struct(t):
        return StructType([Field(t.field(i).name,
                                 from_arrow_type(t.field(i).type),
                                 t.field(i).nullable)
                           for i in range(t.num_fields)])
    raise NotImplementedError(f"arrow type {t} is outside the port's types")
