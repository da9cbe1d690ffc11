"""Expression trees with Spark typing rules (host-only; counterpart of
spark_rapids_tpu/exprs/expr.py for the nodes the port's TPC-H and TPC-DS
queries build): column references, literals (DATE and DECIMAL included),
Alias, Cast, Add/Subtract/Multiply/Divide, Abs and UnaryMinus, the
comparisons LessThan,
LessThanOrEqual, GreaterThan, GreaterThanOrEqual and EqualTo, And, Or, Not,
IsNull, IsNotNull, In, IsNaN and Nanvl, the conditionals If, CaseWhen and
Coalesce, the string functions Substring and Like, the 32 date-and-time
functions of ``DATETIME_FUNCTIONS``, the 56 scalar functions of
``SCALAR_FUNCTIONS`` (integral division, remainder and pmod, the null-safe
and null functions, greatest/least, rounding, the math, bitwise and hash
families and rand; ``exprs/math.py`` on the device, ``plan/cpu_math.py``
on the CPU engine), and the aggregates of
``AGGREGATES``: Sum, Average, Count, Min, Max, First, Last, AnyValue, the
variance family (VarianceSamp/Pop, StddevSamp/Pop, Skewness, Kurtosis),
CovarSamp, CovarPop and Corr, MinBy/MaxBy, BoolAnd/BoolOr, CountIf, and
the CPU engine's CountDistinct, BitAndAgg/BitOrAgg/BitXorAgg and
Percentile/Median.

Numeric typing is Spark's: BYTE < SHORT < INT < LONG < FLOAT < DOUBLE
widen to the larger (TINYINT + TINYINT stays TINYINT and wraps), a Sum of
an integer is BIGINT and of a float DOUBLE, a DATE compared with a
TIMESTAMP is its midnight. ``cast_supported`` names the casts both
engines evaluate, casts to and from strings among them
(``exprs/cast_strings.py``, ``plan/cpu_cast_strings.py``).

Substring and Like carry literal parameters (a position and a length, a
pattern and an escape character) beside their one child, as the
reference's nodes do; ``resolve`` keeps them.

Decimal typing follows Spark's DecimalPrecision rules: an integral operand
of a decimal operation is an implicit decimal(d, 0) (d = 3, 5, 10 or 20
for TINYINT, SMALLINT, INT or BIGINT), a float operand turns
the whole operation into double, Add/Subtract give
decimal(max(p1-s1, p2-s2) + max(s1, s2) + 1, max(s1, s2)), Multiply gives
decimal(p1 + p2 + 1, s1 + s2), Divide gives scale s = max(6, s1 + p2 + 1)
and precision p1 - s1 + s2 + s, brought back to 38 digits by Spark's
precision-loss rule (keep the integral digits, cut the scale to no less
than min(s, 6)), Sum gives decimal(p + 10, s) and Average decimal(p + 4,
s + 4), each capped at 38 digits. A result wider than 18 digits is
DECIMAL128 (two int64 limbs a row on the device). Divide of anything but
decimals is a double; every Divide is nullable (a zero divisor gives
null, as Spark's non-ANSI mode does, doubles included).

Null semantics: every expression evaluates to (data, validity); arithmetic
and comparisons are null-intolerant, And/Or/Not follow three-valued logic
(``null OR true`` is true, ``null OR false`` null), IsNull/IsNotNull are
never null, and ``x IN (...)`` is null when x is null, or when no item
matches and some item is null. If takes its else branch where the
predicate is null, CaseWhen its first branch whose predicate is true (null
when none is and there is no ELSE), Coalesce its first non-null value.

A conditional is typed by its first value branch, as the reference types
it: ``If(c, decimal(7,2), lit(None, DOUBLE))`` is decimal(7,2). ``resolve``
brings every other value branch to that type: a literal is re-typed (a null
stays null, a number becomes the decimal or number of that type), any
other expression is wrapped in a Cast, which each engine evaluates or
refuses as it does any cast.

An untyped NULL literal (``lit(None)``) has the reference's NULL type
until ``resolve`` gives it the type its parent implies (see ``resolve``);
where none is implied it raises TypeError on both engines, as the
reference does for arithmetic and comparisons.

Each class the planner may place on the device declares ``type_support``
(``spark_rapids_tpu_torch.support``); ``plan/overrides.check_expr`` holds
every bound expression to it.
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

from spark_rapids_tpu_torch import types as T


class Expression:
    children: Tuple["Expression", ...] = ()

    @property
    def dtype(self) -> T.DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children)

    def __repr__(self):
        name = type(self).__name__
        if self.children:
            return f"{name}({', '.join(map(repr, self.children))})"
        return name

    # builder sugar, as the reference's
    def __add__(self, other):
        return Add(self, _lit(other))

    def __sub__(self, other):
        return Subtract(self, _lit(other))

    def __mul__(self, other):
        return Multiply(self, _lit(other))

    def __and__(self, other):
        return And(self, _lit(other))

    def __or__(self, other):
        return Or(self, _lit(other))

    def __invert__(self):
        return Not(self)

    def __lt__(self, other):
        return LessThan(self, _lit(other))

    def __le__(self, other):
        return LessThanOrEqual(self, _lit(other))

    def __gt__(self, other):
        return GreaterThan(self, _lit(other))

    def __ge__(self, other):
        return GreaterThanOrEqual(self, _lit(other))

    def eq(self, other):
        return EqualTo(self, _lit(other))

    def alias(self, name: str):
        return Alias(self, name)


def _lit(v) -> Expression:
    return v if isinstance(v, Expression) else Literal.of(v)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class ColumnRef(Expression):
    """Reference to an input column by ordinal (bound) with known type."""

    index: int
    _dtype: T.DataType
    _nullable: bool = True
    name: str = ""

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def __repr__(self):
        return f"col#{self.index}:{self._dtype}"


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class UnresolvedColumn(Expression):
    """Column referenced by name; resolved against a schema at bind time."""

    name: str

    @property
    def dtype(self):
        raise TypeError(f"unresolved column {self.name!r} has no type yet")

    def __repr__(self):
        return f"col({self.name!r})"


def col(name: str) -> UnresolvedColumn:
    return UnresolvedColumn(name)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class Literal(Expression):
    value: Any
    _dtype: T.DataType

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    @staticmethod
    def of(v, dtype: Optional[T.DataType] = None) -> "Literal":
        if dtype is None:
            if isinstance(v, bool):
                dtype = T.BOOLEAN
            elif isinstance(v, int):
                dtype = T.INT if -(2**31) <= v < 2**31 else T.LONG
            elif isinstance(v, float):
                dtype = T.DOUBLE
            elif isinstance(v, str):
                dtype = T.STRING
            elif isinstance(v, bytes):
                dtype = T.BINARY
            elif v is None:
                dtype = T.NULL
            elif isinstance(v, datetime.datetime):
                dtype = T.TIMESTAMP
            elif isinstance(v, datetime.date):
                dtype = T.DATE
            elif isinstance(v, decimal.Decimal):
                _sign, digits, exp = v.as_tuple()
                scale = max(0, -exp)
                dtype = T.DecimalType(max(len(digits), scale), scale)
            else:
                raise TypeError(f"cannot infer literal type for {v!r}")
        if dtype == T.TIMESTAMP and isinstance(v, datetime.datetime):
            v = timestamp_micros(v)
        elif dtype == T.DATE and isinstance(v, datetime.date):
            if isinstance(v, datetime.datetime):
                v = v.date()
            v = (v - datetime.date(1970, 1, 1)).days
        return Literal(v, dtype)

    def __repr__(self):
        return f"lit({self.value!r})"


def lit(v, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal.of(v, dtype)


_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def timestamp_micros(v: datetime.datetime) -> int:
    """Microseconds since the epoch of a datetime (a naive one is UTC, the
    session zone), exact: an integer delta, never float seconds."""
    if v.tzinfo is None:
        v = v.replace(tzinfo=datetime.timezone.utc)
    return (v - _EPOCH) // datetime.timedelta(microseconds=1)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class Alias(Expression):
    child: Expression
    name: str

    @property
    def children(self):  # type: ignore[override]
        return (self.child,)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return self.child.nullable

    def __repr__(self):
        return f"{self.child!r} AS {self.name}"


class _Binary(Expression):
    def __init__(self, left: Expression, right: Expression):
        self.left = left
        self.right = right
        self.children = (left, right)


def numeric_widen(a: T.DataType, b: T.DataType) -> T.DataType:
    """Spark's binary-arithmetic common type over the port's numerics. A
    decimal meets a float as double, and an integral as the decimal."""
    if isinstance(a, T.DecimalType) or isinstance(b, T.DecimalType):
        if isinstance(a, T.DecimalType) and isinstance(b, T.DecimalType):
            return a  # same-type ops type themselves per operator
        dec, other = (a, b) if isinstance(a, T.DecimalType) else (b, a)
        if other in T.FRACTIONAL_TYPES:
            return T.DOUBLE
        if other in T.INTEGRAL_TYPES:
            return dec
        raise TypeError(f"no common numeric type for {a}, {b}")
    order = [T.BYTE, T.SHORT, T.INT, T.LONG, T.FLOAT, T.DOUBLE]
    if a not in order or b not in order:
        raise TypeError(f"no common numeric type for {a}, {b}")
    return order[max(order.index(a), order.index(b))]


_INTEGRAL_DIGITS = {T.BYTE: 3, T.SHORT: 5, T.INT: 10, T.LONG: 20}


def decimal_operands(lt: T.DataType, rt: T.DataType):
    """Spark DecimalPrecision: an integral operand of a decimal operation is
    an implicit decimal(d, 0) (d = 3 for tinyint, 5 for smallint, 10 for
    int, 20 for bigint). Returns the two operand types as decimals, or
    None when neither side is a decimal or the other side is a float (then
    both sides go to double)."""
    ld, rd = isinstance(lt, T.DecimalType), isinstance(rt, T.DecimalType)
    if not (ld or rd):
        return None
    if ld and rd:
        return lt, rt
    other = rt if ld else lt
    if other not in _INTEGRAL_DIGITS:
        return None
    od = _DecimalShape(_INTEGRAL_DIGITS[other], 0)
    return (lt, od) if ld else (od, rt)


class _DecimalShape(NamedTuple):
    """(precision, scale) of an operand that may be wider than DECIMAL64
    (bigint as decimal(20, 0)); only result types must fit 18 digits."""

    precision: int
    scale: int


class BinaryArithmetic(_Binary):
    symbol = "?"

    @property
    def dtype(self):
        pair = decimal_operands(self.left.dtype, self.right.dtype)
        if pair is not None:
            return self._decimal_result(*pair)
        return numeric_widen(self.left.dtype, self.right.dtype)

    def _decimal_result(self, lt, rt) -> T.DataType:
        raise NotImplementedError(f"decimal {self.symbol}")

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class Add(BinaryArithmetic):
    symbol = "+"

    def _decimal_result(self, lt, rt):
        s = max(lt.scale, rt.scale)
        p = max(lt.precision - lt.scale, rt.precision - rt.scale) + s + 1
        return T.DecimalType(min(p, T.DecimalType.MAX_PRECISION), s)


class Subtract(BinaryArithmetic):
    symbol = "-"
    _decimal_result = Add._decimal_result


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _decimal_result(self, lt, rt):
        return T.DecimalType(min(lt.precision + rt.precision + 1,
                                 T.DecimalType.MAX_PRECISION),
                             lt.scale + rt.scale)


class Divide(BinaryArithmetic):
    """Spark's Divide: a decimal quotient of decimal (or decimal and
    integral) operands, else a double; null where the divisor is zero."""

    symbol = "/"

    @property
    def dtype(self):
        pair = decimal_operands(self.left.dtype, self.right.dtype)
        if pair is None:
            return T.DOUBLE
        lt, rt = pair
        s = max(6, lt.scale + rt.precision + 1)
        p = lt.precision - lt.scale + rt.scale + s
        if p > T.DecimalType.MAX_PRECISION:
            # adjustPrecisionScale (allowPrecisionLoss, Spark's default):
            # keep the integral digits, shrink the scale to no less than
            # min(s, 6)
            int_digits = p - s
            s = max(T.DecimalType.MAX_PRECISION - int_digits, min(s, 6))
            p = T.DecimalType.MAX_PRECISION
        return T.DecimalType(p, s)

    @property
    def nullable(self):
        return True


class IntegralDivide(BinaryArithmetic):
    """a div b: Java's truncated division as a BIGINT, null where b is 0
    (``Long.MIN_VALUE div -1`` wraps). A non-decimal operand is cast to
    BIGINT first (Spark's implicit cast, so a fractional divisor in (-1, 1)
    is 0 and gives null); decimals divide exactly on the CPU engine, a
    quotient past BIGINT null."""

    symbol = "div"

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return True


class Remainder(BinaryArithmetic):
    """a % b with the dividend's sign (Java's ``%``; ``fmod`` for floats),
    null where b is 0 (or NaN). Decimals: decimal(min(p1 - s1, p2 - s2) +
    s, s), s = max(s1, s2), on the CPU engine."""

    symbol = "%"

    def _decimal_result(self, lt, rt):
        s = max(lt.scale, rt.scale)
        p = min(lt.precision - lt.scale, rt.precision - rt.scale) + s
        return T.DecimalType(min(max(p, 1), T.DecimalType.MAX_PRECISION),
                             min(s, T.DecimalType.MAX_PRECISION))

    @property
    def nullable(self):
        return True


class Pmod(Remainder):
    """pmod(a, b), Spark's: r = a % b, and (r + b) % b where r < 0 (in the
    operands' type, wrapping as Java's does)."""

    symbol = "pmod"


class BinaryComparison(_Binary):
    symbol = "?"

    @property
    def dtype(self):
        return T.BOOLEAN

    def __repr__(self):
        return f"({self.left!r} {self.symbol} {self.right!r})"


class EqualTo(BinaryComparison):
    symbol = "="


class EqualNullSafe(BinaryComparison):
    """a <=> b: equality where null equals null and nothing else; never
    null."""

    symbol = "<=>"

    @property
    def nullable(self):
        return False


class LessThan(BinaryComparison):
    symbol = "<"


class LessThanOrEqual(BinaryComparison):
    symbol = "<="


class GreaterThan(BinaryComparison):
    symbol = ">"


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="


class And(_Binary):
    @property
    def dtype(self):
        return T.BOOLEAN


class Or(_Binary):
    @property
    def dtype(self):
        return T.BOOLEAN


class _Unary(Expression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)


class UnaryMinus(_Unary):
    """-x (integers wrap, as Java's)."""

    @property
    def dtype(self):
        return self.child.dtype


class Abs(_Unary):
    """|x| (the integer minimum stays itself, as Java's Math.abs)."""

    @property
    def dtype(self):
        return self.child.dtype


class Not(_Unary):
    @property
    def dtype(self):
        return T.BOOLEAN


class IsNull(_Unary):
    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False


class IsNotNull(_Unary):
    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False


class IsNaN(_Unary):
    """isnan(x): true where a float is NaN; false where it is null."""

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False


class Nanvl(_Binary):
    """nanvl(a, b): b where a is NaN, else a; a double, as the
    reference's."""

    @property
    def dtype(self):
        return T.DOUBLE


class In(Expression):
    """value IN (items)."""

    def __init__(self, value: Expression, items: Sequence[Expression]):
        self.value = value
        self.items = tuple(_lit(i) for i in items)
        self.children = (value,) + self.items

    @property
    def dtype(self):
        return T.BOOLEAN


class Substring(Expression):
    """substring(str, pos, len), Spark's ``substringSQL``: pos > 0 counts
    from 1, pos 0 acts as 1, a negative pos counts back from the end; the
    window [start, start + len) is then clamped into the string, so it may
    come out shorter or empty. Null when the string is null."""

    def __init__(self, child: Expression, pos: int, length: int):
        self.child = child
        self.pos = int(pos)
        self.length = int(length)
        self.children = (child,)

    @property
    def dtype(self):
        return T.STRING

    def __repr__(self):
        return f"substring({self.child!r}, {self.pos}, {self.length})"


class Like(Expression):
    """str LIKE pattern (a literal pattern): ``%`` matches any run of
    bytes, ``_`` any one byte, and ``escape`` makes the next character a
    literal. The whole string must match. Null when the string is null."""

    def __init__(self, child: Expression, pattern: str, escape: str = "\\"):
        self.child = child
        self.pattern = pattern
        self.escape = escape
        self.children = (child,)

    @property
    def dtype(self):
        return T.BOOLEAN

    def __repr__(self):
        return f"({self.child!r} LIKE {self.pattern!r})"


# --- the string family and regex (exprs/strings.py and exprs/regex.py on
# the device, plan/cpu_strings.py on the CPU engine) ---
class _StringFn(Expression):
    """A string function: its expression children and its literal
    parameters (``_params``, in constructor order after the children)."""

    _params: tuple = ()
    # False: the device never runs it (the reference's device_supported)
    device_supported = True

    def rebuild(self, kids: Sequence[Expression]) -> "_StringFn":
        return type(self)(*kids, *self._params)

    @property
    def dtype(self):
        return T.STRING

    def __repr__(self):
        args = [repr(c) for c in self.children] + [repr(p)
                                                   for p in self._params]
        return f"{type(self).__name__}({', '.join(args)})"


class _UnaryString(_StringFn):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)


class Length(_UnaryString):
    """Characters of a string (UTF-8 characters on both engines)."""

    @property
    def dtype(self):
        return T.INT


class OctetLength(_UnaryString):
    """Bytes of a string's UTF-8 form."""

    @property
    def dtype(self):
        return T.INT


class BitLength(OctetLength):
    pass


class Upper(_UnaryString):
    pass


class Lower(_UnaryString):
    pass


class InitCap(_UnaryString):
    pass


class StringReverse(_UnaryString):
    pass


class Base64(_UnaryString):
    pass


class UnBase64(_UnaryString):
    @property
    def dtype(self):
        return T.BINARY

    @property
    def nullable(self):
        return True


class Hex(_UnaryString):
    """hex of a string's bytes, or of an integer's two's complement."""


class Unhex(UnBase64):
    pass


class Ascii(_UnaryString):
    @property
    def dtype(self):
        return T.INT


class Chr(_UnaryString):
    pass


class Bin(_UnaryString):
    """bin(long): the two's complement in binary digits."""

    device_supported = False


class Md5(_UnaryString):
    device_supported = False


class Sha1(Md5):
    pass


class Crc32(Md5):
    @property
    def dtype(self):
        return T.LONG


class StringSpace(Md5):
    """space(n): n spaces (none for n <= 0)."""


class Sha2(_StringFn):
    device_supported = False

    def __init__(self, child: Expression, bits: int = 256):
        self.children = (child,)
        self.bits = int(bits)
        self._params = (self.bits,)


class FormatNumber(_StringFn):
    """format_number(x, d): thousands separators and d decimals."""

    device_supported = False

    def __init__(self, child: Expression, d: int):
        self.children = (child,)
        self.d = int(d)
        self._params = (self.d,)


class _SearchString(_StringFn):
    """startswith / endswith / contains of a pattern (a literal on the
    device)."""

    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, _lit(right)
        self.children = (self.left, self.right)

    @property
    def dtype(self):
        return T.BOOLEAN


class StartsWith(_SearchString):
    pass


class EndsWith(_SearchString):
    pass


class Contains(_SearchString):
    pass


class Levenshtein(_SearchString):
    device_supported = False

    @property
    def dtype(self):
        return T.INT


class StringLeft(_StringFn):
    """left(str, n): substring(str, 1, n)."""

    def __init__(self, child: Expression, n: int):
        self.children = (child,)
        self.n = int(n)
        self._params = (self.n,)


class StringRight(StringLeft):
    """right(str, n): the last n characters."""


class Concat(_StringFn):
    """concat(...): null where any input is null."""

    def __init__(self, *children: Expression):
        self.children = tuple(_lit(c) for c in children)


class ConcatWs(_StringFn):
    """concat_ws(sep, ...): the non-null inputs joined by ``sep`` (a
    literal); never null."""

    def __init__(self, *children: Expression, sep: str = ""):
        self.children = tuple(_lit(c) for c in children)
        self.sep = sep
        self._params = (sep,)

    def rebuild(self, kids):
        return ConcatWs(*kids, sep=self.sep)

    @property
    def nullable(self):
        return False


class StringTrim(_StringFn):
    """trim(str [, chars]): strips ``trim_str``'s characters (a space by
    default) from both ends; StringTrimLeft/Right from one."""

    side = "both"

    def __init__(self, child: Expression, trim_str: Optional[str] = None):
        self.children = (child,)
        self.trim_str = trim_str
        self._params = (trim_str,)


class StringTrimLeft(StringTrim):
    side = "left"


class StringTrimRight(StringTrim):
    side = "right"


class StringReplace(_StringFn):
    def __init__(self, child: Expression, search: str, replacement: str):
        self.children = (child,)
        self.search, self.replacement = search, replacement
        self._params = (search, replacement)


class StringInstr(_StringFn):
    """instr(str, substr): 1-based position of the first occurrence, 0 if
    none."""

    def __init__(self, child: Expression, substr: str):
        self.children = (child,)
        self.substr = substr
        self._params = (substr,)

    @property
    def dtype(self):
        return T.INT


class StringLocate(StringInstr):
    """locate(substr, str, start): instr from position ``start`` (0 for
    start < 1)."""

    def __init__(self, child: Expression, substr: str, start: int = 1):
        super().__init__(child, substr)
        self.start = int(start)
        self._params = (substr, self.start)


class StringLPad(_StringFn):
    side_left = True

    def __init__(self, child: Expression, length: int, pad: str = " "):
        self.children = (child,)
        self.length, self.pad = int(length), pad
        self._params = (self.length, pad)


class StringRPad(StringLPad):
    side_left = False


class StringRepeat(_StringFn):
    def __init__(self, child: Expression, times: int):
        self.children = (child,)
        self.times = int(times)
        self._params = (self.times,)


class StringTranslate(_StringFn):
    def __init__(self, child: Expression, matching: str, replace: str):
        self.children = (child,)
        self.matching, self.replace = matching, replace
        self._params = (matching, replace)


class SubstringIndex(_StringFn):
    def __init__(self, child: Expression, delim: str, count: int):
        self.children = (child,)
        self.delim, self.count = delim, int(count)
        self._params = (delim, self.count)


class FindInSet(_StringFn):
    """find_in_set(str, items): the 1-based index of str among the comma
    list ``items`` (a literal), 0 if absent."""

    def __init__(self, child: Expression, items: str):
        self.children = (child,)
        self.items = items
        self._params = (items,)

    @property
    def dtype(self):
        return T.INT


class Overlay(_StringFn):
    """overlay(str PLACING replace FROM pos [FOR length]). The default
    length (-1: the replacement's characters, per row) runs on the CPU
    engine; an explicit one with pos >= 1 on the device, as substrings and
    a concat."""

    def __init__(self, child: Expression, replace: Expression, pos: int,
                 length: int = -1):
        self.children = (child, _lit(replace))
        self.pos, self.length = int(pos), int(length)
        self._params = (self.pos, self.length)
        self.device_supported = self.length >= 0 and self.pos >= 1


class RLike(_StringFn):
    """str RLIKE pattern (a literal Java regex; find semantics)."""

    def __init__(self, child: Expression, pattern: str):
        self.children = (child,)
        self.pattern = pattern
        self._params = (pattern,)

    @property
    def dtype(self):
        return T.BOOLEAN


class RegexpExtract(_StringFn):
    """regexp_extract(str, pattern, group): the group of the first match,
    "" where none (the CPU engine's)."""

    device_supported = False

    def __init__(self, child: Expression, pattern: str, group: int = 1):
        self.children = (child,)
        self.pattern, self.group = pattern, int(group)
        self._params = (pattern, self.group)


class RegexpReplace(_StringFn):
    """regexp_replace(str, pattern, replacement): every match replaced
    (Java's ``$n`` group references; the CPU engine's)."""

    device_supported = False

    def __init__(self, child: Expression, pattern: str, replacement: str):
        self.children = (child,)
        self.pattern, self.replacement = pattern, replacement
        self._params = (pattern, replacement)


STRING_FUNCTIONS = (Bin, OctetLength, BitLength, StringLeft, StringRight,
                    Length, Upper, Lower, StartsWith, EndsWith, Contains,
                    Concat, ConcatWs, StringTrim, StringTrimLeft,
                    StringTrimRight, StringReplace, StringInstr,
                    StringLocate, StringLPad, StringRPad, StringRepeat,
                    StringReverse, StringTranslate, InitCap, SubstringIndex,
                    Md5, Sha1, Sha2, Crc32, Base64, UnBase64, Hex, Unhex,
                    FormatNumber, StringSpace, Levenshtein, FindInSet,
                    Overlay, Ascii, Chr)
REGEX_FUNCTIONS = (RLike, RegexpExtract, RegexpReplace)
# the string and regex classes only the CPU engine evaluates (Overlay's
# default length is placed there by its own device_supported)
CPU_ONLY_STRINGS = tuple(c for c in STRING_FUNCTIONS + REGEX_FUNCTIONS
                         if not c.device_supported)


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class Cast(Expression):
    """Non-ANSI cast among BOOLEAN, the integers, FLOAT, DOUBLE, DECIMAL,
    DATE and TIMESTAMP, with the reference's ``cast_val`` semantics
    (``cast_supported`` says which pairs): anything -> boolean is ``!=
    0``; a boolean is 0 or 1 of the target's storage (a decimal's unscaled
    value, a date's days, a timestamp's microseconds, as the reference);
    integers narrow by wrapping; a float becomes an integer as Java's
    ``(int)``/``(long)`` (NaN 0, truncation, saturation at the target's
    range); a decimal keeps its whole part and wraps; to a decimal:
    rescaled (HALF_UP down), floats HALF_UP at the scale, null past the
    precision; date -> timestamp is midnight UTC and timestamp -> date
    floors; an integer -> timestamp is seconds and timestamp -> bigint
    floors to seconds; the other casts out of a date or timestamp read its
    storage (days, microseconds), as the reference's do. Casts into a date
    from a number raise naming the cast.

    Casts to and from strings (``exprs/cast_strings.py`` documents the
    formats): a trimmed literal longer than ``PARSE_WINDOW`` (64) bytes, or
    one outside its type's grammar or range, is null. ``ansi`` makes a
    string that does not parse an error; the CPU engine runs such casts
    (and float -> string, string -> decimal), as the reference places
    them. An ANSI cast between two non-string types is not in the port
    (``resolve`` raises)."""

    child: Expression
    to: T.DataType
    ansi: bool = False

    @property
    def children(self):  # type: ignore[override]
        return (self.child,)

    @property
    def dtype(self):
        return self.to

    def __repr__(self):
        return f"cast({self.child!r} as {self.to})"


class If(Expression):
    """IF(predicate, true value, false value)."""

    def __init__(self, pred: Expression, true_val: Expression,
                 false_val: Expression):
        self.children = (pred, true_val, false_val)

    @property
    def dtype(self):
        return self.children[1].dtype


class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... [ELSE e] END."""

    def __init__(self, branches: Sequence[Tuple[Expression, Expression]],
                 else_value: Optional[Expression] = None):
        self.branches = [tuple(b) for b in branches]
        self.else_value = else_value
        flat: List[Expression] = []
        for p, v in self.branches:
            flat += [p, v]
        if else_value is not None:
            flat.append(else_value)
        self.children = tuple(flat)

    @property
    def dtype(self):
        return self.branches[0][1].dtype

    @property
    def nullable(self):
        return self.else_value is None or any(c.nullable
                                              for c in self.children)


class Coalesce(Expression):
    """The first non-null of its children."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self):
        return self.children[0].dtype

    @property
    def nullable(self):
        return all(c.nullable for c in self.children)


# --- the scalar function families (exprs/math.py on the device,
# plan/cpu_math.py on the CPU engine) ---
class _UnaryMath(_Unary):
    """A function of a double: a number or a decimal is read as its double
    (java.lang.Math's functions)."""

    @property
    def dtype(self):
        return T.DOUBLE


class Sqrt(_UnaryMath):
    """sqrt(x): NaN below 0."""

    @property
    def nullable(self):
        return True


class Cbrt(_UnaryMath):
    pass


class Exp(_UnaryMath):
    pass


class Expm1(_UnaryMath):
    pass


class Log(_UnaryMath):
    """ln(x): null where x <= 0 (Spark's Logarithm)."""

    @property
    def nullable(self):
        return True


class Log10(Log):
    pass


class Log2(Log):
    pass


class Log1p(Log):
    """ln(1 + x): null where x <= -1."""


class Sin(_UnaryMath):
    pass


class Cos(_UnaryMath):
    pass


class Tan(_UnaryMath):
    pass


class Cot(_UnaryMath):
    """1 / tan(x)."""


class Sec(_UnaryMath):
    """1 / cos(x)."""


class Csc(_UnaryMath):
    """1 / sin(x)."""


class Asin(_UnaryMath):
    pass


class Acos(_UnaryMath):
    pass


class Atan(_UnaryMath):
    pass


class Sinh(_UnaryMath):
    pass


class Cosh(_UnaryMath):
    pass


class Tanh(_UnaryMath):
    pass


class Asinh(_UnaryMath):
    pass


class Acosh(_UnaryMath):
    pass


class Atanh(_UnaryMath):
    pass


class ToDegrees(_UnaryMath):
    pass


class ToRadians(_UnaryMath):
    pass


class Rint(_UnaryMath):
    """java.lang.Math.rint: the nearest integer as a double, ties to
    even."""


class Signum(_UnaryMath):
    """The sign of x as a double (NaN stays NaN)."""


class Atan2(_Binary):
    @property
    def dtype(self):
        return T.DOUBLE


class Hypot(Atan2):
    pass


class Pow(Atan2):
    pass


class Floor(_Unary):
    """floor(x): a BIGINT of a number (a double through Java's (long):
    NaN 0, saturating); of a decimal(p, s) a decimal(p - s + 1, 0) (the CPU
    engine, as the reference places it)."""

    @property
    def dtype(self):
        c = self.child.dtype
        if isinstance(c, T.DecimalType):
            if c.scale == 0:
                return c
            return T.DecimalType(min(c.precision - c.scale + 1,
                                     T.DecimalType.MAX_PRECISION), 0)
        return T.LONG


class Ceil(Floor):
    pass


def round_decimal_type(c: T.DecimalType, scale: int) -> T.DecimalType:
    """The type of a decimal rounded at ``scale`` (the reference's BRound
    rule, which Round shares in the port)."""
    s = min(scale, c.scale) if scale >= 0 else 0
    p = c.precision - (c.scale - s) + (1 if s < c.scale else 0)
    return T.DecimalType(min(max(p, 1), T.DecimalType.MAX_PRECISION),
                         max(s, 0))


class Round(Expression):
    """round(x, scale), HALF_UP at a literal scale. A double rounds the
    decimal text of its shortest representation, as Spark's
    ``BigDecimal(d)`` does (``round(1.005, 2)`` is 1.01); an integer at a
    negative scale rounds to a multiple of 10**-scale in its own type
    (wrapping); a decimal becomes ``round_decimal_type`` (the CPU
    engine)."""

    HALF_EVEN = False

    def __init__(self, child: Expression, scale: int = 0):
        self.child = child
        self.scale = int(scale)
        self.children = (child,)

    @property
    def dtype(self):
        c = self.child.dtype
        if isinstance(c, T.DecimalType):
            return round_decimal_type(c, self.scale)
        return c

    @property
    def nullable(self):
        return self.child.nullable or isinstance(self.child.dtype,
                                                 T.DecimalType)

    def __repr__(self):
        return f"{type(self).__name__}({self.child!r}, {self.scale})"


class BRound(Round):
    """bround(x, scale): Round with HALF_EVEN."""

    HALF_EVEN = True


class Factorial(_Unary):
    """factorial(n) of an INT n in 0..20, else null."""

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return True


class Positive(_Unary):
    """+x."""

    @property
    def dtype(self):
        return self.child.dtype


class BitCount(_Unary):
    """bit_count(x): the set bits of x sign-extended to 64 bits (Java's
    ``Long.bitCount``), an INT; a boolean counts 1 or 0."""

    @property
    def dtype(self):
        return T.INT


class BitGet(_Binary):
    """bit_get(x, pos): bit ``pos`` of x as a TINYINT; null where pos is
    outside [0, bits of x's type) (the reference's; Spark raises)."""

    @property
    def dtype(self):
        return T.BYTE

    @property
    def nullable(self):
        return True


class Murmur3Hash(Expression):
    """hash(...): the engine's own splitmix64 mix of the argument tuple (as
    the reference's: not Spark's murmur3_x86_32), equal to the key hash
    ``kernels.hash_keys`` gives the same columns; never null (a null
    argument mixes a fixed word)."""

    VARIANT = 0

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False


class XxHash64(Murmur3Hash):
    """xxhash64(...): the engine hash's second, independent variant (not
    Spark's xxHash64)."""

    VARIANT = 1


class Rand(Expression):
    """rand(seed): a uniform double in [0, 1), the splitmix64 of (seed, row
    index in the batch): equal to the reference at the same batching. The
    reference's planner keeps it on the CPU engine (rows are numbered per
    batch), and so does the port's."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.children = ()

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return False

    def __repr__(self):
        return f"Rand({self.seed})"


def _least_common(a: T.DataType, b: T.DataType) -> T.DataType:
    """Spark's least common type of greatest/least: decimals keep the most
    integral digits and the largest scale (an integer is decimal(d, 0)),
    numbers widen, equal types stay."""
    if a == b:
        return a
    pair = decimal_operands(a, b)
    if pair is not None:
        lt, rt = pair
        s = max(lt.scale, rt.scale)
        p = max(lt.precision - lt.scale, rt.precision - rt.scale) + s
        return T.DecimalType(min(p, T.DecimalType.MAX_PRECISION), s)
    return numeric_widen(a, b)


class Greatest(Expression):
    """greatest(...): the largest non-null value (NaN above every double);
    null only where every value is. ``resolve`` casts each value to the
    least common type."""

    def __init__(self, *children: Expression):
        self.children = tuple(children)

    @property
    def dtype(self):
        out = self.children[0].dtype
        for c in self.children[1:]:
            out = _least_common(out, c.dtype)
        return out

    @property
    def nullable(self):
        return all(c.nullable for c in self.children)


class Least(Greatest):
    """least(...): the smallest non-null value."""


class NullIf(_Binary):
    """nullif(a, b): null where a = b (both non-null), else a."""

    @property
    def dtype(self):
        return self.left.dtype

    @property
    def nullable(self):
        return True


class Nvl2(Expression):
    """nvl2(x, a, b): a where x is not null, else b; ``resolve`` brings a
    and b to one type."""

    def __init__(self, ref: Expression, a: Expression, b: Expression):
        self.children = (ref, a, b)

    @property
    def dtype(self):
        a, b = self.children[1].dtype, self.children[2].dtype
        if a == b or a == T.STRING:
            return a
        return _least_common(a, b)

    @property
    def nullable(self):
        return self.children[1].nullable or self.children[2].nullable


class BitwiseAnd(_Binary):
    """a & b over the wider integral type."""

    @property
    def dtype(self):
        return numeric_widen(self.left.dtype, self.right.dtype)


class BitwiseOr(BitwiseAnd):
    pass


class BitwiseXor(BitwiseAnd):
    pass


class BitwiseNot(_Unary):
    @property
    def dtype(self):
        return self.child.dtype


class ShiftLeft(_Binary):
    """shiftleft(x, n) of an INT or BIGINT x (a TINYINT or SMALLINT x is
    cast to INT, Spark's implicit cast) by n masked to the type's width
    (Java's ``<<``: n & 31 or n & 63)."""

    @property
    def dtype(self):
        return self.left.dtype


class ShiftRight(ShiftLeft):
    """Java's ``>>`` (arithmetic)."""


class ShiftRightUnsigned(ShiftLeft):
    """Java's ``>>>`` (logical)."""


UNARY_MATH = (Sqrt, Cbrt, Exp, Expm1, Log, Log10, Log2, Log1p, Sin, Cos,
              Tan, Cot, Sec, Csc, Asin, Acos, Atan, Sinh, Cosh, Tanh, Asinh,
              Acosh, Atanh, ToDegrees, ToRadians)
BITWISE = (BitwiseAnd, BitwiseOr, BitwiseXor, BitwiseNot, ShiftLeft,
           ShiftRight, ShiftRightUnsigned, BitCount, BitGet)
# the 56 scalar functions of the division, null, rounding, math, bitwise
# and hash families
SCALAR_FUNCTIONS = ((IntegralDivide, Remainder, Pmod, EqualNullSafe, NullIf,
                     Nvl2, Greatest, Least, Round, BRound, Floor, Ceil,
                     Rint) + UNARY_MATH
                    + (Signum, Atan2, Hypot, Pow, Factorial, Positive)
                    + BITWISE + (Murmur3Hash, XxHash64, Rand))


_CASTABLE = T.INTEGRAL_TYPES + T.FRACTIONAL_TYPES + (T.BOOLEAN, T.DATE,
                                                     T.TIMESTAMP)


def cast_supported(src: T.DataType, dst: T.DataType) -> bool:
    """Whether both engines evaluate ``Cast(src -> dst)``: every pair of
    BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, DECIMAL, DATE and
    TIMESTAMP that the reference's ``cast_val`` takes (not a number or a
    decimal into a date, not a float or a decimal into a timestamp, not a
    DECIMAL128 into a boolean, date or timestamp), every one of them to
    and from STRING (float -> string and string -> decimal on the CPU
    engine only, as ``plan/overrides.py`` places them), and BINARY to and
    from STRING (the same bytes)."""
    if src == dst:
        return True
    if T.BINARY in (src, dst):
        return {src, dst} == {T.STRING, T.BINARY}
    if T.STRING in (src, dst):
        other = dst if src == T.STRING else src
        return other in _CASTABLE or isinstance(other, T.DecimalType)
    dec_s, dec_d = isinstance(src, T.DecimalType), isinstance(dst,
                                                              T.DecimalType)
    if not ((dec_s or src in _CASTABLE) and (dec_d or dst in _CASTABLE)):
        return False
    if dst == T.BOOLEAN:
        return not T.is_wide_decimal(src)
    if src == T.BOOLEAN:
        return not T.is_wide_decimal(dst)
    if dst == T.DATE:
        return src == T.TIMESTAMP
    if dst == T.TIMESTAMP:
        return src == T.DATE or src in T.INTEGRAL_TYPES
    if T.is_wide_decimal(src) or T.is_wide_decimal(dst):
        return (src in T.INTEGRAL_TYPES + T.FRACTIONAL_TYPES
                or dst in T.INTEGRAL_TYPES + (T.DOUBLE, T.FLOAT)
                or (dec_s and dec_d))
    return True


def torch_bits(dt: T.DataType) -> int:
    """Bits of an integral type's values."""
    return {T.BYTE: 8, T.SHORT: 16, T.INT: 32, T.LONG: 64}[dt]


def value_as(e: Expression, dt: T.DataType) -> Expression:
    """A conditional's value branch brought to the conditional's type
    ``dt``: unchanged when it has it, a literal re-typed when its value
    converts exactly, else a Cast."""
    if e.dtype == dt:
        return e
    if isinstance(e, Literal):
        v = e.value
        if v is None:
            return Literal(None, dt)
        if (isinstance(dt, T.DecimalType) and not isinstance(v, bool)
                and isinstance(v, (int, float, decimal.Decimal))):
            d = decimal.Decimal(str(v) if isinstance(v, float) else v)
            q = d.quantize(decimal.Decimal(1).scaleb(-dt.scale),
                           rounding=decimal.ROUND_HALF_UP)
            if q == d and abs(q.scaleb(dt.scale)) < 10 ** dt.precision:
                return Literal(q, dt)
        elif dt == T.DOUBLE and isinstance(v, (int, float)) \
                and not isinstance(v, bool):
            return Literal(float(v), dt)
        elif dt in T.INTEGRAL_TYPES and isinstance(v, int) \
                and not isinstance(v, bool):
            bits = torch_bits(dt) - 1
            if -(2 ** bits) <= v < 2 ** bits:
                return Literal(v, dt)
    return Cast(e, dt)


# --- dates and timestamps (exprs/datetime.py on the device, plan/cpu.py on
# the CPU engine). A DATE is int32 days and a TIMESTAMP int64 microseconds
# since the epoch, UTC. ``resolve`` casts a TIMESTAMP input of a function
# of days to DATE and a DATE input of a function of instants to TIMESTAMP
# (midnight), as Spark's implicit casts do. ---
class _DatePart(_Unary):
    """A calendar field of a date (a timestamp's UTC date) as an INT."""

    @property
    def dtype(self):
        return T.INT


class Year(_DatePart):
    pass


class Month(_DatePart):
    pass


class DayOfMonth(_DatePart):
    pass


class DayOfWeek(_DatePart):
    """1 = Sunday ... 7 = Saturday."""


class DayOfYear(_DatePart):
    pass


class Quarter(_DatePart):
    pass


class WeekOfYear(_DatePart):
    """The ISO-8601 week (weeks start on Monday; week 1 holds the year's
    first Thursday)."""


class Hour(_Unary):
    """The hour of a timestamp's UTC time of day (floor-mod, so instants
    before the epoch read their own day's time)."""

    @property
    def dtype(self):
        return T.INT


class Minute(Hour):
    pass


class Second(Hour):
    pass


class LastDay(_Unary):
    @property
    def dtype(self):
        return T.DATE


class AddMonths(_Binary):
    """add_months(date, n): the day clamped to the target month's
    length."""

    @property
    def dtype(self):
        return T.DATE


class MonthsBetween(_Binary):
    """months_between(end, start): whole months, plus the difference of
    the days and seconds over a 31-day month unless both days are equal
    or both are their month's last; rounded HALF_UP to 8 places
    (``roundOff``)."""

    @property
    def dtype(self):
        return T.DOUBLE


class TruncDate(Expression):
    """trunc(date, fmt): the first day of the date's year ("year", "yyyy",
    "yy"), quarter ("quarter"), month ("month", "mon", "mm") or ISO week
    ("week")."""

    FORMATS = {"year": "year", "yyyy": "year", "yy": "year",
               "quarter": "quarter", "month": "month", "mon": "month",
               "mm": "month", "week": "week"}

    def __init__(self, child: Expression, fmt: str):
        if fmt.lower() not in self.FORMATS:
            raise NotImplementedError(f"trunc format {fmt!r} is not one of "
                                      f"{sorted(self.FORMATS)}")
        self.child = child
        self.fmt = fmt
        self.children = (child,)

    @property
    def unit(self) -> str:
        return self.FORMATS[self.fmt.lower()]

    @property
    def dtype(self):
        return T.DATE

    def __repr__(self):
        return f"trunc({self.child!r}, {self.fmt!r})"


class NextDay(Expression):
    """next_day(date, day): the first date after ``date`` that falls on
    ``day`` ("MO", "MON" or "MONDAY", any case, as Spark takes them)."""

    _DOW = {"su": 1, "mo": 2, "tu": 3, "we": 4, "th": 5, "fr": 6, "sa": 7}
    _NAMES = ("sunday", "monday", "tuesday", "wednesday", "thursday",
              "friday", "saturday")

    def __init__(self, child: Expression, day: str):
        d = day.lower()
        if not any(d in (n[:2], n[:3], n) for n in self._NAMES):
            raise ValueError(f"next_day: {day!r} is not a day of the week")
        self.child = child
        self.day = day
        self.children = (child,)

    @property
    def target(self) -> int:
        """The day's number, 1 = Sunday ... 7 = Saturday."""
        return self._DOW[self.day.lower()[:2]]

    @property
    def dtype(self):
        return T.DATE

    def __repr__(self):
        return f"next_day({self.child!r}, {self.day!r})"


class DateAdd(_Binary):
    @property
    def dtype(self):
        return T.DATE


class DateSub(_Binary):
    @property
    def dtype(self):
        return T.DATE


class DateDiff(_Binary):
    """datediff(end, start) in days."""

    @property
    def dtype(self):
        return T.INT


class UnixTimestampOf(_Unary):
    """to_unix_timestamp(ts): seconds since the epoch (floor)."""

    @property
    def dtype(self):
        return T.LONG


class FromUnixTime(_Unary):
    """Seconds since the epoch -> a TIMESTAMP (the reference's: its string
    formatting is a cast downstream)."""

    @property
    def dtype(self):
        return T.TIMESTAMP


class MakeDate(Expression):
    """make_date(y, m, d); null for a date that does not exist or a year
    outside 1..9999 (non-ANSI)."""

    def __init__(self, year: Expression, month: Expression,
                 day: Expression):
        self.children = (year, month, day)

    @property
    def dtype(self):
        return T.DATE

    @property
    def nullable(self):
        return True


class MakeTimestamp(Expression):
    """make_timestamp(y, m, d, h, min, sec), sec a number with fractional
    microseconds (rounded half to even); null for invalid fields."""

    def __init__(self, *children: Expression):
        if len(children) != 6:
            raise TypeError("make_timestamp takes year, month, day, hour, "
                            "minute and second")
        self.children = tuple(children)

    @property
    def dtype(self):
        return T.TIMESTAMP

    @property
    def nullable(self):
        return True


class TimestampSeconds(_Unary):
    """timestamp_seconds(n): n * SCALE microseconds (wrapping)."""

    SCALE = 1_000_000

    @property
    def dtype(self):
        return T.TIMESTAMP


class TimestampMillis(TimestampSeconds):
    SCALE = 1_000


class TimestampMicros(TimestampSeconds):
    SCALE = 1


class UnixSeconds(_Unary):
    """unix_seconds(ts): the microseconds floor-divided by DIV."""

    DIV = 1_000_000

    @property
    def dtype(self):
        return T.LONG


class UnixMillis(UnixSeconds):
    DIV = 1_000


class UnixMicros(UnixSeconds):
    DIV = 1


class UnixDate(_Unary):
    """unix_date(d): days since the epoch."""

    @property
    def dtype(self):
        return T.INT


class DateFromUnixDate(_Unary):
    """date_from_unix_date(n)."""

    @property
    def dtype(self):
        return T.DATE


class FromUTCTimestamp(Expression):
    """from_utc_timestamp(ts, tz): the UTC instant as the zone's wall time
    (``utils/tzdb.py``'s transition table)."""

    def __init__(self, child: Expression, tz: str):
        self.child = child
        self.tz = tz
        self.children = (child,)

    @property
    def dtype(self):
        return T.TIMESTAMP

    def __repr__(self):
        return f"{type(self).__name__}({self.child!r}, {self.tz!r})"


class ToUTCTimestamp(FromUTCTimestamp):
    """to_utc_timestamp(ts, tz): the zone's wall time as a UTC instant; a
    wall time in a DST overlap takes the earlier offset (java.time's
    default), one in a gap the offset after it."""


# functions of days: a TIMESTAMP input is cast to its DATE first
DAY_FUNCTIONS = (_DatePart, LastDay, AddMonths, TruncDate, NextDay,
                 DateAdd, DateSub, DateDiff, UnixDate)
# functions of instants: a DATE input is cast to midnight first
INSTANT_FUNCTIONS = (Hour, FromUTCTimestamp, UnixSeconds)
DATETIME_FUNCTIONS = (Year, Month, DayOfMonth, DayOfWeek, DayOfYear,
                      Quarter, WeekOfYear, Hour, Minute, Second, LastDay,
                      AddMonths, MonthsBetween, TruncDate, NextDay, DateAdd,
                      DateSub, DateDiff, UnixTimestampOf, FromUnixTime,
                      MakeDate, MakeTimestamp, TimestampSeconds,
                      TimestampMillis, TimestampMicros, UnixSeconds,
                      UnixMillis, UnixMicros, UnixDate, DateFromUnixDate,
                      FromUTCTimestamp, ToUTCTimestamp)


# --- aggregate functions (consumed by exec/aggregate.py) ---
class AggregateExpression(Expression):
    """Marker base; aggregates appear only inside aggregation operators."""


class Sum(AggregateExpression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        c = self.child.dtype
        if isinstance(c, T.DecimalType):
            return T.DecimalType(min(T.DecimalType.MAX_PRECISION,
                                     c.precision + 10), c.scale)
        return T.LONG if c in T.INTEGRAL_TYPES else T.DOUBLE

    @property
    def nullable(self):
        return True


class Count(AggregateExpression):
    def __init__(self, child: Optional[Expression] = None):
        self.child = child
        self.children = (child,) if child is not None else ()

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False


class _Extremum(AggregateExpression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True


class Min(_Extremum):
    pass


class Max(_Extremum):
    pass


class Average(AggregateExpression):
    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        c = self.child.dtype
        if isinstance(c, T.DecimalType):
            return T.DecimalType(min(T.DecimalType.MAX_PRECISION,
                                     c.precision + 4),
                                 min(T.DecimalType.MAX_PRECISION,
                                     c.scale + 4))
        return T.DOUBLE

    @property
    def nullable(self):
        return True


class First(_Extremum):
    """first(x) as the reference computes it: the first non-null value of
    the group or frame (Spark's first(x, ignoreNulls = true)), in input
    order (across partitions, by map index)."""


class Last(_Extremum):
    """last(x): the last non-null value of the group or frame (Spark's
    last(x, ignoreNulls = true))."""


class AnyValue(_Extremum):
    """any_value(x): First's value, as the reference's."""


class CountDistinct(AggregateExpression):
    """COUNT(DISTINCT x): the number of distinct non-null values. The CPU
    engine reduces it natively; on the device the planner rewrites it
    into a distinct aggregate under a Count (``plan/overrides.py``)."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False


class _VarianceBase(AggregateExpression):
    """The moment aggregates over a double (a number or decimal input is
    cast to DOUBLE). Both engines keep central moments (n, mean, M2[, M3,
    M4]), merged by the pairwise (Chan/Pebay) formulas, as Spark's
    CentralMomentAgg does: the reference's raw power sums lose every digit
    under a common offset. ``_samp`` of one row is null; Skewness and
    Kurtosis are NaN where M2 is 0."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return True


class VarianceSamp(_VarianceBase):
    pass


class VariancePop(_VarianceBase):
    pass


class StddevSamp(_VarianceBase):
    pass


class StddevPop(_VarianceBase):
    pass


class Skewness(_VarianceBase):
    """sqrt(n) * M3 / M2^1.5."""


class Kurtosis(_VarianceBase):
    """Excess kurtosis n * M4 / M2^2 - 3."""


class _CovarianceBase(AggregateExpression):
    """covar_samp, covar_pop and corr over the (x, y) pairs whose sides
    are both non-null, each cast to DOUBLE; buffers (n, mean x, mean y,
    Cxy[, M2x, M2y]). CovarSamp of fewer than 2 pairs is null, Corr is
    null where either M2 is 0 (or NaN, as the reference's)."""

    def __init__(self, left: Expression, right: Expression):
        self.left, self.right = left, right
        self.children = (left, right)

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return True


class CovarSamp(_CovarianceBase):
    pass


class CovarPop(_CovarianceBase):
    pass


class Corr(_CovarianceBase):
    pass


class MinBy(AggregateExpression):
    """min_by(value, ordering): the value at the least non-null ordering,
    the first row among ties (which may hold a null value)."""

    def __init__(self, value: Expression, ordering: Expression):
        self.value, self.ordering = value, ordering
        self.children = (value, ordering)

    @property
    def dtype(self):
        return self.value.dtype

    @property
    def nullable(self):
        return True


class MaxBy(MinBy):
    """max_by(value, ordering): the value at the greatest ordering."""


class BoolAnd(AggregateExpression):
    """bool_and / every: null when no value is non-null."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return True


class BoolOr(BoolAnd):
    """bool_or / any / some."""


class CountIf(AggregateExpression):
    """count_if(p): the rows where ``p`` is true (null is not)."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return T.LONG

    @property
    def nullable(self):
        return False


class BitAndAgg(AggregateExpression):
    """bit_and over an integral column (the CPU engine only, as in the
    reference)."""

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True


class BitOrAgg(BitAndAgg):
    pass


class BitXorAgg(BitAndAgg):
    pass


class Percentile(AggregateExpression):
    """percentile(x, p): Spark's exact percentile, linear interpolation at
    rank p * (n - 1) of the sorted non-null values (a decimal read as its
    double). The CPU engine only, as in the reference; it does not merge
    by partial buffers."""

    def __init__(self, child: Expression, percentage: float):
        self.child = child
        self.children = (child,)
        self.percentage = float(percentage)

    @property
    def dtype(self):
        return T.DOUBLE

    @property
    def nullable(self):
        return True

    def __repr__(self):
        return f"Percentile({self.child!r}, {self.percentage})"


class Median(Percentile):
    """median(x) = percentile(x, 0.5)."""

    def __init__(self, child: Expression):
        super().__init__(child, 0.5)

    def __repr__(self):
        return f"Median({self.child!r})"


class CollectList(AggregateExpression):
    """collect_list(x): the group's non-null values as an array, in input
    order. The CPU engine only, as in the reference (its device path is
    future work there too)."""

    device_supported = False

    def __init__(self, child: Expression):
        self.child = child
        self.children = (child,)

    @property
    def dtype(self):
        return T.ArrayType(self.child.dtype)

    @property
    def nullable(self):
        return False


class CollectSet(CollectList):
    """collect_set(x): the group's distinct non-null values, sorted (the
    reference sorts them so that the answer is deterministic)."""


# ---------------------------------------------------------------------------
# Nested types and JSON
# ---------------------------------------------------------------------------


class GetStructField(_Unary):
    """struct.field: on the struct-of-columns layout the field's child
    column, null where the struct is."""

    def __init__(self, child: Expression, field: str):
        super().__init__(child)
        self.field = field

    @property
    def dtype(self):
        st = self.child.dtype
        if not isinstance(st, T.StructType):
            raise TypeError(f"GetStructField needs a struct, not {st}")
        return st.fields[st.field_index(self.field)].dtype

    @property
    def nullable(self):
        return True

    def __repr__(self):
        return f"{self.child!r}.{self.field}"


class CreateNamedStruct(Expression):
    """named_struct(name1, value1, ...): ``names`` are fixed, the children
    are the value expressions; never null."""

    def __init__(self, names, *values: Expression):
        self.names = tuple(names)
        self.children = tuple(values)
        if len(self.names) != len(self.children):
            raise ValueError("named_struct needs one value a name")

    @property
    def dtype(self):
        return T.StructType([T.Field(n, c.dtype, c.nullable)
                             for n, c in zip(self.names, self.children)])

    @property
    def nullable(self):
        return False

    def __repr__(self):
        inner = ", ".join(f"{n!r}, {c!r}" for n, c in
                          zip(self.names, self.children))
        return f"CreateNamedStruct({inner})"


class MapKeys(_Unary):
    """map_keys(m): the keys as an array (the map's offsets over its key
    child)."""

    @property
    def dtype(self):
        mt = self.child.dtype
        if not isinstance(mt, T.MapType):
            raise TypeError(f"{type(self).__name__} needs a map, not {mt}")
        return T.ArrayType(mt.key)


class MapValues(_Unary):
    """map_values(m): the values as an array. The CPU engine only: the
    reference's device set lacks it."""

    @property
    def dtype(self):
        mt = self.child.dtype
        if not isinstance(mt, T.MapType):
            raise TypeError(f"MapValues needs a map, not {mt}")
        return T.ArrayType(mt.value)


class Size(_Unary):
    """size(array or map). With ``legacy_null`` (Spark 3's default,
    spark.sql.legacy.sizeOfNull) a null input gives -1, else null."""

    def __init__(self, child: Expression, legacy_null: bool = True):
        super().__init__(child)
        self.legacy_null = legacy_null

    @property
    def dtype(self):
        return T.INT

    @property
    def nullable(self):
        return not self.legacy_null

    def __repr__(self):
        return f"Size({self.child!r}, legacy_null={self.legacy_null})"


class ElementAt(_Binary):
    """element_at(map, key), or element_at(array, index) with a 1-based
    index (a negative one counts from the end); null when nothing is
    there (non-ANSI)."""

    @property
    def dtype(self):
        ct = self.left.dtype
        if isinstance(ct, T.MapType):
            return ct.value
        if not isinstance(ct, T.ArrayType):
            raise TypeError(f"ElementAt needs an array or a map, not {ct}")
        return ct.element

    @property
    def nullable(self):
        return True


class ArrayContains(_Binary):
    """array_contains(array, value)."""

    @property
    def dtype(self):
        return T.BOOLEAN


class GetJsonObject(_Unary):
    """get_json_object(json, path): the value at a JSONPath of the subset
    ``$``, ``.name``, ``['name']`` and ``[index]`` as a string (a string
    unquoted and unescaped, a number as written, a container compacted);
    null for JSON null, a missing path or text that is not JSON. A path
    outside the subset runs on the CPU engine."""

    def __init__(self, child: Expression, path: str):
        super().__init__(child)
        self.path = path

    @property
    def dtype(self):
        return T.STRING

    @property
    def nullable(self):
        return True

    def __repr__(self):
        return f"GetJsonObject({self.child!r}, {self.path!r})"


class JsonToStructsText(_Unary):
    """from_json as text: a JSON document normalised to compact canonical
    text, null when it does not parse. The CPU engine only, as in the
    reference."""

    device_supported = False

    @property
    def dtype(self):
        return T.STRING

    @property
    def nullable(self):
        return True


NESTED_FUNCTIONS = (GetStructField, CreateNamedStruct, MapKeys, Size,
                    ElementAt, ArrayContains)


VARIANCE_FAMILY = (VarianceSamp, VariancePop, StddevSamp, StddevPop,
                   Skewness, Kurtosis)
# every aggregate of the port, device and CPU engine
AGGREGATES = (Sum, Count, Average, Min, Max, First, Last, AnyValue,
              CountDistinct, CovarSamp, CovarPop, Corr, MinBy, MaxBy,
              BoolAnd, BoolOr, CountIf, BitAndAgg, BitOrAgg, BitXorAgg,
              Percentile, Median, CollectList, CollectSet) + VARIANCE_FAMILY


# expressions the device evaluates
SUPPORTED = (ColumnRef, UnresolvedColumn, Literal, Alias, Cast, Add,
             Subtract, Multiply, Divide, UnaryMinus, Abs, EqualTo, LessThan,
             LessThanOrEqual, GreaterThan, GreaterThanOrEqual, And, Or, Not,
             IsNull, IsNotNull, In, If, CaseWhen, Coalesce, Substring, Like,
             IsNaN, Nanvl, Sum, Count, Average, Min, Max, First, Last,
             AnyValue, CovarSamp, CovarPop, Corr, MinBy, MaxBy, BoolAnd,
             BoolOr, CountIf) + VARIANCE_FAMILY + DATETIME_FUNCTIONS + tuple(
                 c for c in SCALAR_FUNCTIONS if c is not Rand) + tuple(
                 c for c in STRING_FUNCTIONS + REGEX_FUNCTIONS
                 if c not in CPU_ONLY_STRINGS) + NESTED_FUNCTIONS + (
                     GetJsonObject,)
# expressions only the CPU engine evaluates (the reference's
# device_supported = False aggregates and Rand among them)
CPU_ONLY = (CountDistinct, BitAndAgg, BitOrAgg, BitXorAgg, Percentile,
            Median, Rand, CollectList, CollectSet, MapValues,
            JsonToStructsText) + CPU_ONLY_STRINGS


def check_supported(expr: Expression) -> None:
    """Raise NotImplementedError naming the first node outside the port."""
    if type(expr) not in SUPPORTED + CPU_ONLY:
        raise NotImplementedError(
            f"expression {type(expr).__name__} is not in the port yet")
    for c in expr.children:
        check_supported(c)


def _is_null_type(e: Expression) -> bool:
    return isinstance(e, Literal) and e.dtype == T.NULL


def _typed(e: Expression, dt: T.DataType) -> Expression:
    """``e``, or a NULL literal of type ``dt`` when ``e`` is untyped."""
    return Literal(None, dt) if _is_null_type(e) else e


def _value_type(kids: Sequence[Expression], what: str) -> T.DataType:
    """A conditional's type: its first value branch that is not an untyped
    NULL literal."""
    for k in kids:
        if not _is_null_type(k):
            return k.dtype
    raise TypeError(f"{what} has only untyped NULL values; give one a type "
                    f"with lit(None, dtype)")


def resolve(expr: Expression, schema: T.Schema) -> Expression:
    """Replace UnresolvedColumn with a typed ColumnRef against a schema,
    and type every untyped NULL literal (``lit(None)``) from its parent:
    a conditional's value takes the type of its first typed branch, an
    ``IN`` item the value's type, a Cast its target type, And/Or/Not,
    IsNull/IsNotNull, BoolAnd/BoolOr and CountIf a boolean, Sum, Average,
    Count, the variance family and the covariances a double (as the
    reference, Spark's sum(NULL) is a double). Arithmetic, comparisons,
    Min, Max and a bare projected NULL raise TypeError, as the reference
    types them ("no common numeric type")."""
    out = _resolve(expr, schema)
    if _is_null_type(out):
        raise TypeError("an untyped NULL literal has no type here; give it "
                        "one with lit(None, dtype)")
    return out


def _resolve(expr: Expression, schema: T.Schema) -> Expression:
    if isinstance(expr, UnresolvedColumn):
        i = schema.index_of(expr.name)
        f = schema[i]
        return ColumnRef(i, f.dtype, f.nullable, f.name)
    if isinstance(expr, (ColumnRef, Literal)):
        return expr
    kids: List[Expression] = [_resolve(c, schema) for c in expr.children]
    if isinstance(expr, Alias):
        if _is_null_type(kids[0]):
            raise TypeError(f"an untyped NULL literal has no type as "
                            f"{expr.name!r}; give it one with "
                            f"lit(None, dtype)")
        return Alias(kids[0], expr.name)
    if isinstance(expr, Cast):
        if expr.ansi and T.STRING not in (kids[0].dtype, expr.to):
            raise NotImplementedError(
                f"ANSI cast {kids[0].dtype} -> {expr.to} is not in the port")
        if _is_null_type(kids[0]):
            return Literal(None, expr.to)
        return Cast(kids[0], expr.to, expr.ansi)
    if isinstance(expr, Count):
        return Count(_typed(kids[0], T.BOOLEAN) if kids else None)
    if isinstance(expr, (Sum, Average, _VarianceBase, _CovarianceBase)):
        return type(expr)(*[_typed(k, T.DOUBLE) for k in kids])
    if isinstance(expr, (BoolAnd, CountIf)):
        return type(expr)(_typed(kids[0], T.BOOLEAN))
    if isinstance(expr, Median):
        return Median(kids[0])
    if isinstance(expr, Percentile):
        return Percentile(kids[0], expr.percentage)
    if isinstance(expr, (And, Or, Not, IsNull, IsNotNull)):
        return type(expr)(*[_typed(k, T.BOOLEAN) for k in kids])
    if isinstance(expr, In):
        dt = _value_type(kids, "IN")
        return In(_typed(kids[0], dt), [_typed(k, dt) for k in kids[1:]])
    if isinstance(expr, If):
        dt = _value_type(kids[1:], "IF")
        return If(_typed(kids[0], T.BOOLEAN), value_as(kids[1], dt),
                  value_as(kids[2], dt))
    if isinstance(expr, CaseWhen):
        n = len(expr.branches)
        vals = [kids[2 * i + 1] for i in range(n)]
        if expr.else_value is not None:
            vals.append(kids[2 * n])
        dt = _value_type(vals, "CASE WHEN")
        branches = [(_typed(kids[2 * i], T.BOOLEAN),
                     value_as(kids[2 * i + 1], dt)) for i in range(n)]
        else_v = (value_as(kids[2 * n], dt)
                  if expr.else_value is not None else None)
        return CaseWhen(branches, else_v)
    if isinstance(expr, Coalesce):
        dt = _value_type(kids, "COALESCE")
        return Coalesce(*[value_as(k, dt) for k in kids])
    if isinstance(expr, (Substring, Like)):
        child = _typed(kids[0], T.STRING)
        if child.dtype != T.STRING:
            raise TypeError(f"{type(expr).__name__} takes a string, not "
                            f"{child.dtype}")
        if isinstance(expr, Substring):
            return Substring(child, expr.pos, expr.length)
        return Like(child, expr.pattern, expr.escape)
    if isinstance(expr, DATETIME_FUNCTIONS):
        return _resolve_datetime(expr, kids)
    if isinstance(expr, GetStructField):
        return GetStructField(kids[0], expr.field)
    if isinstance(expr, CreateNamedStruct):
        return CreateNamedStruct(expr.names, *kids)
    if isinstance(expr, Size):
        return Size(kids[0], expr.legacy_null)
    if isinstance(expr, GetJsonObject):
        return GetJsonObject(_typed(kids[0], T.STRING), expr.path)
    if isinstance(expr, (ElementAt, ArrayContains)):
        # an untyped NULL probe takes the type the function looks up
        ct = kids[0].dtype
        if isinstance(expr, ArrayContains):
            want = getattr(ct, "element", T.NULL)
        else:
            want = ct.key if isinstance(ct, T.MapType) else T.INT
        return type(expr)(kids[0], _typed(kids[1], want))
    if isinstance(expr, _StringFn):
        return _resolve_string(expr, kids)
    if isinstance(expr, SCALAR_FUNCTIONS):
        return _resolve_scalar(expr, kids)
    check_supported(expr)
    if any(_is_null_type(k) for k in kids):
        if isinstance(expr, _Binary):
            raise TypeError(f"no common numeric type for {kids[0].dtype}, "
                            f"{kids[1].dtype}")
        raise TypeError(f"{type(expr).__name__} of an untyped NULL literal "
                        f"has no type; give it one with lit(None, dtype)")
    return type(expr)(*kids)


def _common_type(kids: Sequence[Expression], what: str) -> T.DataType:
    """The least common type of typed values (untyped NULLs skipped)."""
    typed = [k.dtype for k in kids if not _is_null_type(k)]
    if not typed:
        raise TypeError(f"{what} has only untyped NULL values; give one a "
                        f"type with lit(None, dtype)")
    out = typed[0]
    for t in typed[1:]:
        out = _least_common(out, t)
    return out


def _resolve_scalar(expr: Expression, kids: List[Expression]) -> Expression:
    """A scalar function over resolved children with Spark's implicit casts:
    untyped NULLs take the type the function reads, IntegralDivide reads
    BIGINTs unless an operand is a decimal, a shift or a factorial an INT
    (a TINYINT or SMALLINT shifted value too), and Greatest, Least and
    Nvl2's values one common type."""
    name = type(expr).__name__
    if isinstance(expr, (Round, BRound)):
        return type(expr)(_typed(kids[0], T.DOUBLE), expr.scale)
    if isinstance(expr, Rand):
        return Rand(expr.seed)
    if isinstance(expr, (Murmur3Hash,)):
        return type(expr)(*[_typed(k, T.INT) for k in kids])
    if isinstance(expr, (Greatest,)):
        dt = _common_type(kids, name)
        return type(expr)(*[value_as(_typed(k, dt), dt) for k in kids])
    if isinstance(expr, Nvl2):
        dt = _common_type(kids[1:], "NVL2")
        a, b = (_typed(k, dt) for k in kids[1:])
        dt = Nvl2(kids[0], a, b).dtype
        return Nvl2(_typed(kids[0], T.BOOLEAN), value_as(a, dt),
                    value_as(b, dt))
    if isinstance(expr, (NullIf, EqualNullSafe)):
        dt = _value_type(kids, name)
        return type(expr)(*[_typed(k, dt) for k in kids])
    if isinstance(expr, IntegralDivide):
        kids = [_typed(k, T.LONG) for k in kids]
        dts = [k.dtype for k in kids]
        if (not any(isinstance(t, T.DecimalType) for t in dts)
                or any(t in T.FRACTIONAL_TYPES for t in dts)):
            kids = [value_as(k, T.LONG) for k in kids]
        return IntegralDivide(*kids)
    if isinstance(expr, ShiftLeft):
        x = _typed(kids[0], T.INT)
        if x.dtype in (T.BYTE, T.SHORT):
            x = value_as(x, T.INT)
        return type(expr)(x, value_as(_typed(kids[1], T.INT), T.INT))
    if isinstance(expr, BitGet):
        return BitGet(_typed(kids[0], T.LONG),
                      value_as(_typed(kids[1], T.INT), T.INT))
    if isinstance(expr, Factorial):
        return Factorial(value_as(_typed(kids[0], T.INT), T.INT))
    if isinstance(expr, (BitwiseNot, BitCount)):
        return type(expr)(_typed(kids[0], T.LONG))
    if isinstance(expr, (BinaryArithmetic, BitwiseAnd)):
        if any(_is_null_type(k) for k in kids):
            raise TypeError(f"no common numeric type for {kids[0].dtype}, "
                            f"{kids[1].dtype}")
        return type(expr)(*kids)
    return type(expr)(*[_typed(k, T.DOUBLE) for k in kids])


# the type an untyped NULL child of a string function takes
_NUMBER_INPUT = {Chr: T.LONG, Bin: T.LONG, StringSpace: T.INT,
                 FormatNumber: T.DOUBLE}


def _resolve_string(expr: "_StringFn", kids: List[Expression]
                    ) -> Expression:
    """A string function over resolved children: an untyped NULL takes the
    type the function reads (a string, or Chr/Bin's BIGINT, space's INT,
    format_number's DOUBLE); a string input that is not a string or bytes
    raises TypeError (Hex also takes an integer)."""
    want = _NUMBER_INPUT.get(type(expr), T.STRING)
    kids = [_typed(k, want) for k in kids]
    for k in kids:
        if want == T.STRING:
            ok = k.dtype in (T.STRING, T.BINARY) or (
                isinstance(expr, Hex) and k.dtype in T.INTEGRAL_TYPES)
        elif want == T.DOUBLE:
            ok = (k.dtype in T.INTEGRAL_TYPES + T.FRACTIONAL_TYPES
                  or isinstance(k.dtype, T.DecimalType))
        else:
            ok = k.dtype in T.INTEGRAL_TYPES
        if not ok:
            raise TypeError(f"{type(expr).__name__} takes "
                            f"{'a string' if want == T.STRING else want}, "
                            f"not {k.dtype}")
    return expr.rebuild(kids)


def _resolve_datetime(expr: Expression, kids: List[Expression]
                      ) -> Expression:
    """A date-time function over resolved children: an untyped NULL takes
    the type the function reads, a TIMESTAMP input of a function of days
    becomes its DATE and a DATE input of a function of instants its
    midnight (Spark's implicit casts)."""
    if isinstance(expr, DAY_FUNCTIONS):
        first = _typed(kids[0], T.DATE)
        if first.dtype == T.TIMESTAMP:
            first = Cast(first, T.DATE)
        rest = [_typed(k, T.DATE if isinstance(expr, DateDiff) else T.INT)
                for k in kids[1:]]
        if isinstance(expr, DateDiff) and rest[0].dtype == T.TIMESTAMP:
            rest[0] = Cast(rest[0], T.DATE)
        kids = [first] + rest
    elif isinstance(expr, INSTANT_FUNCTIONS):
        first = _typed(kids[0], T.TIMESTAMP)
        if first.dtype == T.DATE:
            first = Cast(first, T.TIMESTAMP)
        kids = [first]
    elif isinstance(expr, MonthsBetween):
        kids = [_typed(k, T.TIMESTAMP) for k in kids]
    elif isinstance(expr, (UnixTimestampOf,)):
        kids = [_typed(kids[0], T.TIMESTAMP)]
    else:
        kids = [_typed(k, T.DOUBLE if isinstance(expr, MakeTimestamp)
                       and i == 5 else T.INT if not isinstance(
                           expr, (FromUnixTime, TimestampSeconds)) else
                       T.LONG) for i, k in enumerate(kids)]
    if isinstance(expr, TruncDate):
        return TruncDate(kids[0], expr.fmt)
    if isinstance(expr, NextDay):
        return NextDay(kids[0], expr.day)
    if isinstance(expr, FromUTCTimestamp):
        return type(expr)(kids[0], expr.tz)
    return type(expr)(*kids)


# type_support declarations of the device path (spark_rapids_tpu_torch.support)
from spark_rapids_tpu_torch.support import (  # noqa: E402
    ALL, ALL_SCALAR, DATETIME, DECIMAL, DEVICE_SCALAR, NUMERIC, STRINGY, ts)

Expression.type_support = None
for _cls in (ColumnRef, UnresolvedColumn, Literal, Alias):
    _cls.type_support = ts(ALL)
# the casts cast_supported names; check_expr refuses the rest and places
# float -> string, string -> decimal and ANSI string casts on the CPU engine
Cast.type_support = ts("boolean", NUMERIC, DECIMAL, DATETIME, STRINGY)
# Divide inherits; check_expr gates the decimal divide's rescale
BinaryArithmetic.type_support = ts(NUMERIC, DECIMAL)
UnaryMinus.type_support = ts(NUMERIC, DECIMAL)
Abs.type_support = ts(NUMERIC, DECIMAL)
# check_expr places string ordering comparisons and string equality of two
# columns on the CPU engine
BinaryComparison.type_support = ts(ALL_SCALAR, out="boolean")
And.type_support = ts("boolean")
Or.type_support = ts("boolean")
Not.type_support = ts("boolean")
IsNull.type_support = ts(ALL, out="boolean")
IsNotNull.type_support = ts(ALL, out="boolean")
In.type_support = ts(ALL_SCALAR, out="boolean")
# a predicate is boolean; value branches are any device scalar
If.type_support = ts(ALL_SCALAR)
CaseWhen.type_support = ts(ALL_SCALAR)
Coalesce.type_support = ts(ALL)
IsNaN.type_support = ts("fractional", out="boolean")
Nanvl.type_support = ts("fractional")
_DatePart.type_support = ts("date", out="integral")
Hour.type_support = ts("timestamp", out="integral")
LastDay.type_support = ts("date")
AddMonths.type_support = ts("date integral", out="date")
MonthsBetween.type_support = ts(DATETIME, out="fractional")
TruncDate.type_support = ts("date")
NextDay.type_support = ts("date")
DateAdd.type_support = ts("date integral", out="date")
DateSub.type_support = ts("date integral", out="date")
DateDiff.type_support = ts("date", out="integral")
UnixTimestampOf.type_support = ts(DATETIME, out="integral")
FromUnixTime.type_support = ts("integral", out="timestamp")
MakeDate.type_support = ts("integral", out="date")
MakeTimestamp.type_support = ts("integral fractional", out="timestamp")
TimestampSeconds.type_support = ts("integral", out="timestamp")
UnixSeconds.type_support = ts("timestamp", out="integral")
UnixDate.type_support = ts("date", out="integral")
DateFromUnixDate.type_support = ts("integral", out="date")
FromUTCTimestamp.type_support = ts("timestamp")
Substring.type_support = ts("string")
# the string family and RLIKE, as the reference declares them; check_expr
# places the reference's CPU-only classes, Overlay's default length and a
# pattern outside the regex subset on the CPU engine
_StringFn.type_support = ts(STRINGY, "integral", out=STRINGY)
for _cls in (Length, OctetLength, Ascii, StringInstr, FindInSet):
    _cls.type_support = ts(STRINGY, out="integral")
for _cls in (_SearchString, RLike):
    _cls.type_support = ts(STRINGY, out="boolean")
Upper.type_support = ts(STRINGY)
Lower.type_support = ts(STRINGY)
StringLocate.type_support = ts(STRINGY, "integral", out="integral")
Chr.type_support = ts("integral", "boolean", out="string")
Hex.type_support = ts("integral", STRINGY, out="string")
Base64.type_support = ts(STRINGY, out="string")
UnBase64.type_support = ts(STRINGY, out="binary")
Overlay.type_support = ts(STRINGY, out=STRINGY)
# the scalar families, as the reference declares them; check_expr places
# decimal floor/ceil/round and decimal division on the CPU engine
Positive.type_support = ts(NUMERIC, DECIMAL)
NullIf.type_support = ts(ALL_SCALAR)
Nvl2.type_support = ts(ALL_SCALAR)
_UnaryMath.type_support = ts(NUMERIC, DECIMAL, out="fractional")
Floor.type_support = ts(NUMERIC)
Round.type_support = ts(NUMERIC)
Atan2.type_support = ts(NUMERIC, DECIMAL, out="fractional")
Factorial.type_support = ts("integral")
Greatest.type_support = ts(NUMERIC, DECIMAL)
BitCount.type_support = ts("integral", "boolean", out="integral")
BitGet.type_support = ts("integral")
BitwiseAnd.type_support = ts("integral")
BitwiseNot.type_support = ts("integral")
ShiftLeft.type_support = ts("integral")
Murmur3Hash.type_support = ts(DEVICE_SCALAR, out="integral")
Like.type_support = ts("string", out="boolean")
Sum.type_support = ts(NUMERIC, DECIMAL)
Average.type_support = ts(NUMERIC, DECIMAL, out="fractional " + DECIMAL)
Count.type_support = ts(ALL, out="integral")
# strings and BINARY reduce exactly in byte order (a dictionary's codes
# are in it)
Min.type_support = ts(ALL_SCALAR)
Max.type_support = ts(ALL_SCALAR)
First.type_support = ts(ALL)
Last.type_support = ts(ALL)
AnyValue.type_support = ts(ALL_SCALAR)
_VarianceBase.type_support = ts(NUMERIC, DECIMAL, out="fractional")
_CovarianceBase.type_support = ts(NUMERIC, DECIMAL, out="fractional")
# overrides.check_expr gates the ordering's and the value's types further
MinBy.type_support = ts(ALL_SCALAR)
BoolAnd.type_support = ts("boolean")
CountIf.type_support = ts("boolean", out="integral")
# not on the device (not in SUPPORTED): the distinct rewrite replaces it
CountDistinct.type_support = ts(DEVICE_SCALAR, out="integral")
# the CPU engine's (not in SUPPORTED), declared as the reference's
BitAndAgg.type_support = ts("integral")
Percentile.type_support = ts(NUMERIC, DECIMAL, out="fractional")
# the nested types, as the reference declares them (overrides.NESTED_OK
# holds every expression that touches a nested value further)
GetStructField.type_support = ts(ALL)
CreateNamedStruct.type_support = ts(ALL, out="struct")
MapKeys.type_support = ts("map", out="array")
Size.type_support = ts("array map", out="integral")
ElementAt.type_support = ts(ALL)
ArrayContains.type_support = ts("array", ALL_SCALAR, out="boolean")
GetJsonObject.type_support = ts(STRINGY)
