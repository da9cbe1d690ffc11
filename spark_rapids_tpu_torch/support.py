"""Machine-checkable (operator, data type) support declarations (the port's
copy of spark_rapids_tpu/support.py, for the port's types).

Every expression class the planner may place on the device carries a
``type_support`` attribute: the type classes it accepts as resolved child
dtypes (``inputs``) and may produce (``outputs``). ``plan/overrides.py``
checks each bound expression against it when it tags a plan, so an
expression whose types fall outside its declaration is placed on the CPU
engine, never run on the device.

The vocabulary is the reference's type classes that the port has:

=============  ========================================================
``boolean``    BooleanType
``integral``   ByteType, ShortType, IntegerType, LongType
``fractional`` FloatType, DoubleType
``decimal64``  DecimalType with precision <= 18 (one int64 on the device)
``decimal128`` DecimalType with precision > 18 (two int64 limbs a row on
               the device; ``plan/overrides.py`` also holds every
               expression that touches one to ``WIDE_OK``)
``date``       DateType
``timestamp``  TimestampType
``string``     StringType
``binary``     BinaryType
``array``      ArrayType
``struct``     StructType
``map``        MapType
=============  ========================================================
"""

from __future__ import annotations

from typing import FrozenSet, Optional

from spark_rapids_tpu_torch import types as T

TYPE_CLASSES = ("boolean", "integral", "fractional", "decimal64",
                "decimal128", "date", "timestamp", "string", "binary",
                "array", "struct", "map")

# named groups of the port's device
NUMERIC = "integral fractional"
DECIMAL = "decimal64 decimal128"
DECIMAL64 = "decimal64"
DECIMAL128 = "decimal128"
DATETIME = "date timestamp"
STRINGY = "string binary"
ORDERABLE = ("boolean integral fractional decimal64 decimal128 date "
             "timestamp")
DEVICE_SCALAR = ("boolean integral fractional decimal64 decimal128 date "
                 "timestamp string")
NESTED = "array struct map"
# the reference's ALL_SCALAR and ALL
ALL_SCALAR = DEVICE_SCALAR + " binary"
ALL = ALL_SCALAR + " " + NESTED


def classify(dtype: T.DataType) -> str:
    """Map a concrete DataType to its support-vocabulary class."""
    if isinstance(dtype, T.BooleanType):
        return "boolean"
    if isinstance(dtype, (T.ByteType, T.ShortType, T.IntegerType,
                          T.LongType)):
        return "integral"
    if isinstance(dtype, (T.FloatType, T.DoubleType)):
        return "fractional"
    if isinstance(dtype, T.DecimalType):
        return "decimal128" if dtype.is_wide else "decimal64"
    if isinstance(dtype, T.DateType):
        return "date"
    if isinstance(dtype, T.TimestampType):
        return "timestamp"
    if isinstance(dtype, T.StringType):
        return "string"
    if isinstance(dtype, T.BinaryType):
        return "binary"
    if isinstance(dtype, T.ArrayType):
        return "array"
    if isinstance(dtype, T.StructType):
        return "struct"
    if isinstance(dtype, T.MapType):
        return "map"
    raise TypeError(f"unclassifiable dtype {dtype!r}")


class TypeSupport:
    """Declared (operator, type) support: which type classes an operator
    accepts as resolved child dtypes (``inputs``) and may produce as its
    result dtype (``outputs``)."""

    __slots__ = ("inputs", "outputs")

    def __init__(self, inputs: FrozenSet[str], outputs: FrozenSet[str]):
        for w in inputs | outputs:
            if w not in TYPE_CLASSES:
                raise ValueError(f"unknown type class {w!r} "
                                 f"(vocabulary: {TYPE_CLASSES})")
        self.inputs = inputs
        self.outputs = outputs

    def ok(self, dtype: T.DataType, *, output: bool = False) -> bool:
        return classify(dtype) in (self.outputs if output else self.inputs)

    def __repr__(self):
        return (f"TypeSupport(in={sorted(self.inputs)}, "
                f"out={sorted(self.outputs)})")


def ts(*classes: str, out: Optional[str] = None) -> TypeSupport:
    """Build a TypeSupport from space-separated type-class words:
    ``ts(NUMERIC, DECIMAL64)`` accepts and produces numerics and DECIMAL64;
    ``ts(DEVICE_SCALAR, out="boolean")`` accepts any device scalar and
    produces a boolean."""
    inputs = frozenset(w for c in classes for w in c.split())
    outputs = frozenset(out.split()) if out is not None else inputs
    return TypeSupport(inputs, outputs)
