"""Casts between strings and the scalar types in the port, held against the
JAX package on the CPU with the reference's corpora
(``tests/test_cast_strings.py``), in both directions, over dictionary and
plain string columns, on the port's device path and on its CPU engine.

Tolerance: exact, except string -> FLOAT/DOUBLE, whose value is within 1
ulp of the correctly rounded parse (Python's ``float()``, Java's
``parseDouble``), with the same null rows as the reference's device path.

Literals longer than the 64-byte parse window are null on both engines
(the reference's bound). Float/double -> string, string -> decimal and
ANSI string casts run on the CPU engine, named by ``explain`` with the
reference's reasons; float -> string equals the reference's CPU engine
for doubles, and a FLOAT prints its own shortest digits (the reference
prints its double's, ROADMAP queue 3's fault 18). String -> integral
accepts and drops a fraction, as Spark's ``UTF8String.toLong`` does (the
reference's null is fault 19; its device parse also nulls a mantissa of
more than 15 digits and Spark's ``inf``/``nan`` literals, fault 20).
"""

import datetime
import decimal
import math
import re

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import dictionary_encode_table
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.mem.pool import get_pool
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal
ENGINES = {"device": None, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                          "false"}}

# the reference's corpora (tests/test_cast_strings.py)
STR_INTS = ["0", "1", "-1", "  42  ", "+7", "9223372036854775807",
            "-9223372036854775808", "9223372036854775808",  # overflow
            "128", "-129", "32768", "-32769", "2147483648",
            "abc", "", " ", "1x", "x1", "--1", "1-", "+", "-",
            "00123", "  -00042", None, "999999999999999999999999"]
STR_BOOLS = ["true", "TRUE", "t", "T", "yes", "Y", "1", "false", "FALSE",
             "f", "no", "N", "0", "tr", "2", "", "  true ", None, "yess"]
STR_DATES = ["2020-01-02", "1999-12-31", "2020-1-2", "2020-02-29",
             "2021-02-29", "2020-13-01", "2020-00-10", "2020-01-32",
             "2020", "2020-06", "0001-01-01", "9999-12-31",
             " 2015-03-05 ", "not-a-date", "", "2020-01-02x", None,
             "1970-01-01", "1969-12-31"]
STR_TS = ["2020-01-02 03:04:05", "2020-01-02T03:04:05", "2020-01-02",
          "2020-01-02 03:04:05.1", "2020-01-02 03:04:05.123456",
          "2020-01-02 03:04:05.1234567", "2020-01-02 23:59:59",
          "2020-01-02 24:00:00", "2020-01-02 03:60:05", "1969-12-31 23:59:59",
          "2020-01-02 03:04:05Z", "2020-01-02 03:04:05UTC",
          "bad ts", "", None, "1970-01-01 00:00:00", "2020-01-02 3:4:5"]
STR_FLOATS = ["1.5", "-0.25", "1e10", "-2.5E-3", "  3.25  ", "0.0", "-0.0",
              "12345.6789", "1e308", "1e-300", "Infinity", "-Infinity",
              "NaN", ".5", "5.", "1e", "e5", "1.2.3", "abc", "", None,
              "+4.5", "123456789012345"]
# the parse window: 34 bytes parse, 71 do not, whitespace never counts
LONG_LITERALS = ["0" * 32 + "42", "0" * 70 + "7", " " * 100 + "5" + " " * 100,
                 "1" * 65, "2020-01-02" + " " * 80, "0" * 60 + "1.5e1",
                 "0" * 63 + "1", "0" * 64 + "1"]

CORPORA = {"integral": (STR_INTS + LONG_LITERALS,
                        ("LONG", "INT", "SHORT", "BYTE")),
           "boolean": (STR_BOOLS, ("BOOLEAN",)),
           "date": (STR_DATES + LONG_LITERALS, ("DATE",)),
           "timestamp": (STR_TS + LONG_LITERALS, ("TIMESTAMP",)),
           # the reference's device parse nulls a mantissa of more than 15
           # digits (a fault, held by its own test below)
           "float": (STR_FLOATS + [v for v in LONG_LITERALS
                                   if len(v.strip()) == 1
                                   or len(v.strip()) > 64],
                     ("DOUBLE", "FLOAT"))}


def _table(strings, layout: str) -> pa.Table:
    """The strings as a column the port ingests as a dictionary (each
    repeated three times) or plain (followed by as many distinct
    fillers)."""
    if layout == "dict":
        vals = strings * 3
    else:
        vals = strings + [f"filler {k}" for k in range(2 * len(strings))]
    t = pa.table({"s": pa.array(vals, pa.string())})
    enc = dictionary_encode_table(t).column("s").type
    assert pa.types.is_dictionary(enc) == (layout == "dict")
    return t


def _casts(M, T, names):
    return [M.Cast(M.col("s"), getattr(T, n)).alias(n.lower())
            for n in names]


_JAX = {}


def _jax(t, build, conf=None, key=None):
    """The JAX package's rows (kept under ``key`` for the other engine's
    case)."""
    if key is not None and key in _JAX:
        return _JAX[key]
    df = jax_from_arrow(t, None if conf is None else JConf(conf))
    df.shuffle_partitions = 1
    out = df.select(*build(JE, JT)).collect()
    if key is not None:
        _JAX[key] = out
    return out


def _port(t, build, engine):
    conf = ENGINES[engine]
    df = port_from_arrow(t, None if conf is None else RapidsConf(conf),
                         device="cpu")
    return df.select(*build(PE, PT))


def _ulps(a: float, b: float, f32: bool) -> float:
    if math.isinf(a) or math.isinf(b) or a == b:
        return 0.0 if a == b else math.inf
    t = np.float32 if f32 else np.float64
    return abs(a - b) / float(np.spacing(t(abs(b))))


def _python_parse(s: str, f32: bool):
    t = s.strip("".join(chr(c) for c in range(0x21)))
    x = float(t.rstrip("dDfF"))
    with np.errstate(over="ignore"):  # past FLOAT's range: inf
        return float(np.float32(x)) if f32 else x


@pytest.mark.parametrize("layout", ["dict", "plain"])
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_cast_from_string_matches_jax(corpus, engine, layout):
    strings, names = CORPORA[corpus]
    t = _table(strings, layout)
    build = lambda M, T: _casts(M, T, names)  # noqa: E731
    df = _port(t, build, engine)
    if engine == "device":
        assert "!" not in df.explain()
    got, exp = df.collect(), _jax(t, build, key=(corpus, layout))
    vals = t.column("s").to_pylist()
    for s, g, e in zip(vals, got, exp):
        for k in e:
            if corpus != "float" or g[k] is None or e[k] is None:
                assert g[k] == e[k], (corpus, k, s, g[k], e[k])
                continue
            want = _python_parse(s, k == "float")
            if math.isnan(want):
                assert math.isnan(g[k]) and math.isnan(e[k]), (s, g, e)
            else:
                assert _ulps(g[k], want, k == "float") <= 1, (s, g[k], want)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_cast_to_string_matches_jax(engine):
    t = pa.table({
        "l": pa.array([0, 1, -1, 42, -9223372036854775808,
                       9223372036854775807, 1000000, -99, None], pa.int64()),
        "i": pa.array([0, -2147483648, 2147483647, 7, None, 12, -5, 100, 3],
                      pa.int32()),
        "h": pa.array([0, -32768, 32767, 7, None, 12, -5, 100, 3],
                      pa.int16()),
        "b8": pa.array([0, -128, 127, 7, None, 12, -5, 100, 3], pa.int8()),
        "b": pa.array([True, False, None, True, False, True, None, False,
                       True]),
        "d": pa.array([D("1.20"), D("-0.05"), D("0.00"), D("12345.67"),
                       D("-99999999999999.99"), None, D("-1.00"), D("0.10"),
                       D("7.00")], pa.decimal128(16, 2)),
        "w": pa.array([D("123456789012345678901.50"), D("-0.01"),
                       D("0.00"), D("-88888888888888888888.25"), None,
                       D("7.00"), D("-99999999999999999999999.99"),
                       D("0.10"), D("1.00")], pa.decimal128(25, 2)),
        "i0": pa.array([D("5"), D("-7"), D("0"), None, D("123"), D("-1"),
                        D("9999999999"), D("-9999999999"), D("10")],
                       pa.decimal128(10, 0)),
        "dt": pa.array([datetime.date(2020, 1, 2), datetime.date(1999, 12, 31),
                        datetime.date(1970, 1, 1), datetime.date(1969, 12, 31),
                        datetime.date(1, 1, 1), datetime.date(9999, 12, 31),
                        None, datetime.date(2000, 2, 29),
                        datetime.date(1600, 3, 1)], pa.date32()),
        "ts": pa.array([datetime.datetime(2020, 1, 2, 3, 4, 5),
                        datetime.datetime(2020, 1, 2, 3, 4, 5, 123456),
                        datetime.datetime(2020, 1, 2, 3, 4, 5, 100000),
                        datetime.datetime(1969, 12, 31, 23, 59, 59),
                        datetime.datetime(1970, 1, 1),
                        datetime.datetime(9999, 12, 31, 23, 59, 59, 999999),
                        None, datetime.datetime(1900, 6, 30, 12, 0, 0, 10),
                        datetime.datetime(1969, 12, 31, 23, 59, 59, 999000)],
                       pa.timestamp("us")),
    })
    build = lambda M, T: [M.Cast(M.col(c), T.STRING).alias(c)  # noqa: E731
                          for c in t.column_names]
    df = _port(t, build, engine)
    if engine == "device":
        assert "!" not in df.explain()
    got, exp = df.collect(), _jax(t, build, key="to_string")
    assert got == exp


@pytest.mark.parametrize("engine", list(ENGINES))
def test_float_to_string_is_the_cpu_engines_java_text(engine):
    vals = [1.5, -0.25, 1e20, float("nan"), None, 0.0, -0.0,
            float("inf"), float("-inf"), 1e7, 9999999.0, 1e-3, 9.99e-4,
            0.1, 1 / 3, 123456.789, 1e-300, 2.5e-7, 4.35, 100.0, 1e22,
            -1234567.125]
    t = pa.table({"f": pa.array(vals, pa.float64())})
    build = lambda M, T: [M.Cast(M.col("f"), T.STRING).alias("s")]  # noqa
    df = _port(t, build, engine)
    if engine == "device":
        assert "float to string cast not on device" in df.explain()
    got = df.collect()
    exp = _jax(t, build, {"spark.rapids.tpu.sql.enabled": "false"},
               key="float_to_string")
    assert got == exp
    assert got[0]["s"] == "1.5" and got[2]["s"] == "1.0E20"


def test_a_float_prints_its_own_digits():
    """Float.toString(1.1f) is "1.1"; the reference's CPU engine prints the
    double of the float ("1.100000023841858")."""
    t = pa.table({"f": pa.array([1.1, 0.1, 3.4e38, 1e-5, None],
                                pa.float32())})
    build = lambda M, T: [M.Cast(M.col("f"), T.STRING).alias("s")]  # noqa
    ref = _jax(t, build, {"spark.rapids.tpu.sql.enabled": "false"})
    assert ref[0]["s"] == "1.100000023841858"
    for engine in ENGINES:
        got = [r["s"] for r in _port(t, build, engine).collect()]
        assert got == ["1.1", "0.1", "3.4E38", "1.0E-5", None]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_string_to_integral_drops_a_fraction_as_spark(engine):
    """Spark's UTF8String.toLong accepts ``1.9`` (1); the reference's parse
    gives null."""
    t = pa.table({"s": pa.array(["1.9", "-2.5", ".", "-.7", "3.", "1.2.3",
                                 "1.x", "+", "7"])})
    build = lambda M, T: [M.Cast(M.col("s"), T.INT).alias("i")]  # noqa
    ref = [r["i"] for r in _jax(t, build)]
    assert ref[:2] == [None, None] and ref[-1] == 7
    got = [r["i"] for r in _port(t, build, engine).collect()]
    assert got == [1, -2, 0, 0, 3, None, None, None, 7]


def test_spark_float_literals_and_suffixes():
    """Spark reads ``inf``, ``infinity`` and ``nan`` in any case and Java's
    ``d``/``f`` suffixes and long exponents; the reference's device parse
    nulls them (a fault). Hexadecimal literals are null in both (a known
    difference from Java)."""
    t = pa.table({"s": pa.array(["inf", "-INF", "+Infinity", "nan", "NaN",
                                 "-NaN", "-nan", "1d", "2.5F", "1e5f",
                                 "0x1p3", "1e0000000000000000005",
                                 "123456789012345678901234", "4.9e-324",
                                 "1e-400", "1.7976931348623157e308",
                                 "1.8e308"])})
    build = lambda M, T: [M.Cast(M.col("s"), T.DOUBLE).alias("d")]  # noqa
    ref = [r["d"] for r in _jax(t, build)]
    assert ref[:2] == [None, None] and ref[2] == math.inf
    assert ref[3] is None and ref[6:12] == [None] * 6
    for engine in ENGINES:
        got = [r["d"] for r in _port(t, build, engine).collect()]
        assert got[:3] == [math.inf, -math.inf, math.inf]
        assert all(math.isnan(x) for x in got[3:6]) and got[6] is None
        assert got[7:10] == [1.0, 2.5, 1e5]
        assert got[10] is None  # hexadecimal: a known difference
        assert got[11] == 1e5
        assert _ulps(got[12], 1.2345678901234568e23, False) <= 1
        assert got[13:17] == [5e-324, 0.0, 1.7976931348623157e308,
                              math.inf]


def test_a_long_mantissa_parses_as_java_parses_it():
    """Java's parseDouble reads any number of mantissa digits; the
    reference's device parse nulls more than 15 (its CPU engine does
    not)."""
    vals = ["0" * 32 + "42", "1234567890123456.5", "0.1234567890123456789"]
    t = pa.table({"s": pa.array(vals)})
    build = lambda M, T: [M.Cast(M.col("s"), T.DOUBLE).alias("d")]  # noqa
    assert [r["d"] for r in _jax(t, build)] == [None, None, None]
    for engine in ENGINES:
        got = [r["d"] for r in _port(t, build, engine).collect()]
        for g, v in zip(got, vals):
            assert _ulps(g, float(v), False) <= 1, (g, v)


def test_string_to_decimal_and_ansi_casts_run_on_the_cpu_engine():
    t = pa.table({"s": pa.array([" 1.255 ", "-7.5e1", "x", None, "1e-3",
                                 ".5", "99999999.995", "+3."])})
    df = port_from_arrow(t, device="cpu")
    out = df.select(PE.Cast(PE.col("s"), PT.DecimalType(10, 2)).alias("d"))
    assert "string to decimal cast not on device" in out.explain()
    assert [r["d"] for r in out.collect()] == [
        D("1.26"), D("-75.00"), None, None, D("0.00"), D("0.50"), None,
        D("3.00")]
    ansi = df.select(PE.Cast(PE.col("s"), PT.INT, ansi=True).alias("i"))
    assert "ANSI string cast not on device" in ansi.explain()
    used = get_pool().used
    with pytest.raises(ValueError, match="invalid input"):
        ansi.collect()
    # the run that raised has released its scan's batches
    assert get_pool().used == used
    ok = df.filter(PE.IsNotNull(PE.col("s"))).select(
        PE.Cast(PE.lit("12"), PT.INT, ansi=True).alias("i"))
    assert {r["i"] for r in ok.collect()} == {12}
    with pytest.raises(NotImplementedError, match="ANSI cast"):
        df.select(PE.Cast(PE.lit(1), PT.SHORT, ansi=True).alias("x")
                  ).collect()


@pytest.mark.parametrize("engine", list(ENGINES))
def test_random_values_round_trip_through_strings(engine):
    rng = np.random.default_rng(15)
    n = 3000
    longs = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    doubles = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    us = rng.integers(-5 * 10 ** 16, 2 * 10 ** 17, n, dtype=np.int64)
    days = rng.integers(-700000, 2900000, n).astype(np.int32)
    t = pa.table({"l": pa.array(longs), "ds": pa.array(
        [repr(float(x)) for x in doubles]),
        "ts": pa.array(us, pa.int64()).cast(pa.timestamp("us")),
        "dt": pa.array(days, pa.int32()).cast(pa.date32()),
        "m": pa.array([D(int(x)).scaleb(-4) for x in longs // 1000],
                      pa.decimal128(18, 4))})
    build = lambda M, T: [  # noqa: E731
        M.Cast(M.Cast(M.col("l"), T.STRING), T.LONG).alias("l"),
        M.Cast(M.col("ds"), T.DOUBLE).alias("d"),
        M.Cast(M.Cast(M.col("ts"), T.STRING), T.TIMESTAMP).alias("ts"),
        M.Cast(M.Cast(M.col("dt"), T.STRING), T.DATE).alias("dt"),
        M.Cast(M.col("m"), T.STRING).alias("ms")]
    got = _port(t, build, engine).collect()
    for k, r in enumerate(got):
        assert r["l"] == int(longs[k])
        assert _ulps(r["d"], float(doubles[k]), False) <= 1, (r, doubles[k])
        assert r["ms"] == str(D(int(longs[k] // 1000)).scaleb(-4))
    assert [r["ts"] for r in got] == t.column("ts").cast(
        pa.timestamp("us", tz="UTC")).to_pylist()
    assert [r["dt"] for r in got] == t.column("dt").to_pylist()


def test_the_grammar_matches_the_cpu_engines_on_fuzzed_literals():
    """Strings built from the grammar's pieces (digits, signs, dots,
    exponents, separators, zones, spaces) parse to the same rows on both
    engines, for every target type."""
    rng = np.random.default_rng(7)
    pieces = ["1", "0", "9", "12", "2020", "-", "+", ".", "e", "E", ":",
              " ", "T", "Z", "UTC", "01", "31", "23", "59", "60", "x",
              "inf", "NaN", "d", "00", "1e5", "99999999999999999999"]
    vals = ["".join(rng.choice(pieces, rng.integers(1, 9)))
            for _ in range(3000)]
    t = pa.table({"s": pa.array(vals)})
    names = ("LONG", "INT", "BYTE", "BOOLEAN", "DATE", "TIMESTAMP",
             "DOUBLE", "FLOAT")
    build = lambda M, T: _casts(M, T, names)  # noqa: E731
    dev = _port(t, build, "device").collect()
    cpu = _port(t, build, "cpu_engine").collect()
    for s, a, b in zip(vals, dev, cpu):
        for k in a:
            if isinstance(a[k], float) and b[k] is not None:
                if math.isnan(b[k]):
                    assert math.isnan(a[k]), (s, k)
                else:
                    assert _ulps(a[k], b[k], k == "float") <= 1, (s, k, a, b)
            else:
                assert a[k] == b[k], (s, k, a[k], b[k])
    assert any(r["date"] is not None for r in dev)
    assert any(r["timestamp"] is not None for r in dev)
    assert any(r["double"] is not None and not re.fullmatch(
        r"[0-9]+", s) for s, r in zip(vals, dev))
