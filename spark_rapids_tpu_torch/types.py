"""Spark SQL data types the port carries, mapped onto torch dtypes.

Counterpart of ``spark_rapids_tpu/types.py`` for the types TPC-H Q1/Q3/Q5/Q6
use: BOOLEAN, INT, LONG, DOUBLE, DATE (int32 days since the epoch) and
STRING (dictionary codes or int32 offsets + uint8 bytes).
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


class StringType(DataType):
    name = "string"

    @property
    def fixed_width(self):
        return False

    def arrow_type(self):
        return pa.string()


BOOLEAN = BooleanType()
INT = IntegerType()
LONG = LongType()
DOUBLE = DoubleType()
DATE = DateType()
STRING = StringType()

INTEGRAL_TYPES = (INT, LONG)
FRACTIONAL_TYPES = (DOUBLE,)


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
    if pa.types.is_int32(t):
        return INT
    if pa.types.is_int64(t):
        return LONG
    if pa.types.is_float64(t):
        return DOUBLE
    if pa.types.is_date32(t):
        return DATE
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return STRING
    raise NotImplementedError(f"arrow type {t} is outside the port's types")
