"""The aggregate family on both of the port's engines, held against the
JAX package on the CPU: the variance family, covariance and correlation,
MinBy/MaxBy, BoolAnd/BoolOr, CountIf, AnyValue, group-by First/Last and
string Min/Max/First/Last (device and CPU engine), and the CPU engine's
BitAndAgg/BitOrAgg/BitXorAgg and Percentile/Median, placed there with the
reference's reasons.

The family runs over the table of ``tests/test_agg_ext.py`` (500 rows,
nulls every 11th, 13th and 17th row, 128-row batches, 3 shuffle
partitions; here also a decimal and a date column) in one plan through
the JAX package's device path and its CPU engine, and through the port's
device path (one source split, and 4 splits with the fast path off, so
the partial/final aggregate crosses a hash exchange) and CPU engine.
The order-dependent aggregates (First, Last, AnyValue) are held against
the JAX package's CPU engine, whose row order is the input's.

Tolerance: doubles within relative 1e-6 with an absolute floor of 1e-9
(``close``); counts, booleans, integers, decimals and strings exactly.

Two reference faults are held to the exact answer (``fractions``), with
the JAX package's answer recorded beside it: its device string Min/Max
compares a 16-byte prefix (a plain string past a 16-byte tie), and its
moment aggregates take raw power sums, which lose every digit under a
common offset of 1e8.
"""

import datetime
import decimal
import math
from fractions import Fraction

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

REL, ABS = 1e-6, 1e-9
ORDER_DEPENDENT = ("first_x", "last_y", "first_s", "last_s", "first_dec",
                   "any_o")
_CACHE = {}


def table(n=500, seed=1234):
    """``tests/test_agg_ext.py``'s table (same generator and seed), with a
    decimal(9,2) column (nulls every 19th row) and a date column."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 7, n)
    x = rng.uniform(-10, 10, n)
    y = 2.5 * x + rng.normal(0, 1, n)
    b = rng.integers(0, 2, n).astype(bool)
    o = rng.integers(0, 1000, n)
    t = pa.table({
        "k": pa.array(k, pa.int64()),
        "x": pa.array([None if i % 11 == 0 else float(v)
                       for i, v in enumerate(x)], pa.float64()),
        "y": pa.array([None if i % 13 == 0 else float(v)
                       for i, v in enumerate(y)], pa.float64()),
        "b": pa.array([None if i % 17 == 0 else bool(v)
                       for i, v in enumerate(b)], pa.bool_()),
        "o": pa.array(o, pa.int64()),
        "w": pa.array(rng.integers(0, 255, n), pa.int64()),
        "s": pa.array(np.array(["aa", "bb", "cc"])[rng.integers(0, 3, n)]),
    })
    dec = [None if i % 19 == 0 else decimal.Decimal(int(v)).scaleb(-2)
           for i, v in enumerate(rng.integers(-10**6, 10**6, n))]
    days = rng.integers(0, 400, n)
    return t.append_column("dec", pa.array(dec, pa.decimal128(9, 2))) \
        .append_column("dt", pa.array(
            [datetime.date(2000, 1, 1) + datetime.timedelta(int(v))
             for v in days], pa.date32()))


def family(M):
    """Every device aggregate of the family, grouped by ``k``."""
    c = M.col
    return [
        M.VarianceSamp(c("x")).alias("var_samp_x"),
        M.VariancePop(c("x")).alias("var_pop_x"),
        M.StddevSamp(c("o")).alias("stddev_samp_o"),
        M.StddevPop(c("dec")).alias("stddev_pop_dec"),
        M.Skewness(c("x")).alias("skew_x"),
        M.Kurtosis(c("o")).alias("kurt_o"),
        M.VarianceSamp(c("dec")).alias("var_samp_dec"),
        M.Corr(c("x"), c("y")).alias("corr_xy"),
        M.CovarSamp(c("x"), c("y")).alias("covar_samp_xy"),
        M.CovarPop(c("o"), c("dec")).alias("covar_pop_o_dec"),
        M.MinBy(c("x"), c("o")).alias("min_by_x_o"),
        M.MaxBy(c("o"), c("w")).alias("max_by_o_w"),
        M.MinBy(c("w"), c("dt")).alias("min_by_w_dt"),
        M.BoolAnd(c("b")).alias("bool_and"),
        M.BoolOr(c("b")).alias("bool_or"),
        M.CountIf(M.GreaterThan(c("x"), M.lit(0.0))).alias("count_if"),
        M.AnyValue(c("o")).alias("any_o"),
        M.First(c("x")).alias("first_x"),
        M.Last(c("y")).alias("last_y"),
        M.First(c("s")).alias("first_s"),
        M.Last(c("s")).alias("last_s"),
        M.First(c("dec")).alias("first_dec"),
        M.Min(c("s")).alias("min_s"),
        M.Max(c("s")).alias("max_s"),
        M.Count().alias("n"),
    ]


def close(a, b) -> bool:
    if a is None or b is None:
        return a is b
    if isinstance(a, float) or isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if math.isinf(a) or math.isinf(b):
            return a == b
        return abs(a - b) <= max(REL * max(abs(a), abs(b)), ABS)
    return a == b


def assert_rows(got, exp, skip=()):
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert list(g) == list(e)
        for key in g:
            if key not in skip:
                assert close(g[key], e[key]), (key, g[key], e[key], g, e)


def _jax(t, build, device: bool, batch_rows=128):
    df = jax_from_arrow(t, JConf({"spark.rapids.tpu.sql.enabled": device}),
                        batch_rows=batch_rows)
    df.shuffle_partitions = 3
    return build(df).collect()


def _jax_family(device: bool):
    key = ("family", device)
    if key not in _CACHE:
        _CACHE[key] = _jax(table(), lambda df: df.group_by("k").agg(
            *family(JE)).sort("k"), device)
    return _CACHE[key]


PORT_ENGINES = {
    "device": ({}, 1),
    "device_4_splits": ({"spark.rapids.gpu.fastpath.enabled": "false"}, 4),
    "cpu_engine": ({"spark.rapids.gpu.sql.enabled": "false"}, 1),
}


def _port(t, build, engine, batch_rows=128):
    conf, splits = PORT_ENGINES[engine]
    df = from_arrow(t, RapidsConf(conf), batch_rows=batch_rows,
                    device="cpu", partitions=splits)
    df.shuffle_partitions = 3
    return build(df)


@pytest.mark.parametrize("engine", list(PORT_ENGINES))
def test_family_matches_jax(engine):
    q = _port(table(), lambda df: df.group_by("k").agg(
        *family(PE)).sort("k"), engine)
    text = q.explain()
    assert ("!" in text) == (engine == "cpu_engine"), text
    if engine == "device_4_splits":
        assert "HashPartitioner(3)" in q.physical_plan().explain()
    got = q.collect()
    assert len(got) == 7 and all(v is not None for v in got[0].values())
    assert_rows(got, _jax_family(True), skip=ORDER_DEPENDENT)
    assert_rows(got, _jax_family(False))


def test_global_family_matches_jax():
    """No group key: one row, through a single-partition exchange with 4
    splits."""
    def build(M):
        return lambda df: df.agg(*family(M))

    exp = _jax(table(), build(JE), False)
    for engine in PORT_ENGINES:
        assert_rows(_port(table(), build(PE), engine).collect(), exp)


def edge_table():
    """Groups of edge cases: 1 all null; 2 one row; 3 identical values
    with tied orderings; 4 a NaN; 5 +inf; 6 -inf and +inf; 7 pairs with
    one null side; 8 strings longer than 16 bytes sharing a prefix
    (dictionary strings)."""
    inf, nan = float("inf"), float("nan")
    p = "prefix-sixteen-b"  # 16 bytes
    rows = [
        (1, None, None, None, None, None),
        (1, None, None, None, None, None),
        (2, 2.5, 1.0, 7, True, p + "z"),
        (3, 5.0, 1.0, 3, True, p + "q"),
        (3, 5.0, 2.0, 3, False, p + "q"),
        (3, 5.0, 3.0, 3, True, p + "q"),
        (4, 1.0, 1.0, 1, True, "a"),
        (4, nan, 2.0, 2, False, "b"),
        (4, 2.0, 3.0, 3, None, "c"),
        (5, inf, 1.0, 5, True, "x"),
        (5, 1.0, 2.0, 4, True, "y"),
        (6, -inf, 1.0, 9, False, "x"),
        (6, inf, 2.0, 8, False, "y"),
        (7, 1.0, None, 2, True, "m"),
        (7, 2.0, 2.0, None, True, "n"),
        (7, None, 3.0, 1, None, "o"),
        (7, 4.0, 5.0, 1, False, "p"),
        (7, 8.0, 1.0, 0, True, None),
        (8, 1.0, 1.0, 1, True, p + "zz"),
        (8, 2.0, 4.0, 2, True, p + "b"),
        (8, 4.0, 9.0, 2, True, p + "m"),
        (8, 8.0, 16.0, 0, True, p),
    ]
    cols = list(zip(*rows))
    return pa.table({
        "k": pa.array(cols[0], pa.int64()),
        "x": pa.array(cols[1], pa.float64()),
        "y": pa.array(cols[2], pa.float64()),
        "o": pa.array(cols[3], pa.int64()),
        "b": pa.array(cols[4], pa.bool_()),
        "s": pa.array(cols[5], pa.string()),
    })


def edge_aggs(M):
    c = M.col
    return [
        M.VarianceSamp(c("x")).alias("var_samp"),
        M.VariancePop(c("x")).alias("var_pop"),
        M.StddevSamp(c("x")).alias("stddev_samp"),
        M.StddevPop(c("x")).alias("stddev_pop"),
        M.Skewness(c("x")).alias("skew"),
        M.Kurtosis(c("x")).alias("kurt"),
        M.Corr(c("x"), c("y")).alias("corr"),
        M.CovarSamp(c("x"), c("y")).alias("covar_samp"),
        M.CovarPop(c("x"), c("y")).alias("covar_pop"),
        M.MinBy(c("y"), c("o")).alias("min_by"),
        M.MaxBy(c("y"), c("o")).alias("max_by"),
        M.BoolAnd(c("b")).alias("bool_and"),
        M.BoolOr(c("b")).alias("bool_or"),
        M.CountIf(c("b")).alias("count_if"),
        M.First(c("s")).alias("first_s"),
        M.Last(c("s")).alias("last_s"),
        M.Min(c("s")).alias("min_s"),
        M.Max(c("s")).alias("max_s"),
        M.Count(c("x")).alias("n_x"),
    ]


@pytest.mark.parametrize("engine", list(PORT_ENGINES))
def test_edge_cases_match_jax(engine):
    t = edge_table()

    def build(M):
        return lambda df: df.group_by("k").agg(*edge_aggs(M)).sort("k")

    if "edge" not in _CACHE:
        _CACHE["edge"] = _jax(t, build(JE), False, batch_rows=8)
    got = _port(t, build(PE), engine, batch_rows=8).collect()
    assert_rows(got, _CACHE["edge"])
    by_k = {r["k"]: r for r in got}
    assert all(v is None for key, v in by_k[1].items()
               if key not in ("k", "count_if", "n_x")), by_k[1]
    assert by_k[1]["count_if"] == 0 and by_k[1]["n_x"] == 0
    assert by_k[2]["var_samp"] is None and by_k[2]["var_pop"] == 0.0
    assert by_k[3]["var_samp"] == 0.0 and math.isnan(by_k[3]["skew"])
    assert by_k[3]["min_by"] == 1.0 and by_k[3]["max_by"] == 1.0  # ties
    assert by_k[3]["corr"] is None  # x has no spread
    for k in (4, 5, 6):
        assert math.isnan(by_k[k]["var_pop"]), by_k[k]
    assert by_k[8]["min_s"] == "prefix-sixteen-b"
    assert by_k[8]["max_s"] == "prefix-sixteen-bzz"


def test_global_aggregate_over_no_row_matches_jax():
    """Every row filtered out: one row, counts 0, every other value
    null (an empty group)."""
    def build(M):
        return lambda df: df.filter(M.GreaterThan(M.col("k"), M.lit(99))) \
            .agg(*edge_aggs(M))

    exp = _jax(edge_table(), build(JE), False)
    assert exp[0]["count_if"] == 0
    for engine in PORT_ENGINES:
        assert_rows(_port(edge_table(), build(PE), engine).collect(), exp)


def _exact_moments(xs):
    """(var_samp, var_pop, skewness, kurtosis) of ``xs`` in exact
    arithmetic."""
    q = [Fraction(v) for v in xs]
    n = len(q)
    mean = sum(q) / n
    m2 = sum((v - mean) ** 2 for v in q)
    m3 = sum((v - mean) ** 3 for v in q)
    m4 = sum((v - mean) ** 4 for v in q)
    return (m2 / (n - 1), m2 / n,
            math.sqrt(n) * float(m3) / float(m2) ** 1.5,
            float(n * m4 / (m2 * m2)) - 3.0)


def test_variance_family_at_a_1e8_offset_is_exact():
    """Reference fault 12: the JAX package's moment buffers are raw power
    sums (m2 = sum x^2 - n mean^2), which lose every digit under a common
    offset. The port's central moments give the exact answer (within
    1e-12 relative); the JAX package's answers are recorded."""
    xs = [1e8, 1e8 + 1, 1e8 + 2]
    t = pa.table({"k": pa.array([1, 1, 1], pa.int64()),
                  "x": pa.array(xs, pa.float64()),
                  "y": pa.array([2 * v for v in xs], pa.float64())})

    def build(M):
        c = M.col
        return lambda df: df.group_by("k").agg(
            M.VarianceSamp(c("x")).alias("var_samp"),
            M.VariancePop(c("x")).alias("var_pop"),
            M.StddevSamp(c("x")).alias("stddev_samp"),
            M.Skewness(c("x")).alias("skew"),
            M.Kurtosis(c("x")).alias("kurt"),
            M.CovarSamp(c("x"), c("y")).alias("covar_samp"),
            M.Corr(c("x"), c("y")).alias("corr"))

    var_samp, var_pop, skew, kurt = _exact_moments(xs)
    exact = {"var_samp": float(var_samp), "var_pop": float(var_pop),
             "stddev_samp": math.sqrt(var_samp), "skew": skew,
             "kurt": kurt, "covar_samp": float(2 * var_samp), "corr": 1.0}
    assert exact["var_samp"] == 1.0 and exact["kurt"] == -1.5
    for engine in PORT_ENGINES:
        got = _port(t, build(PE), engine).collect()[0]
        for key, want in exact.items():
            assert abs(got[key] - want) <= 1e-12 * max(1.0, abs(want)), (
                engine, key, got[key], want)
    jdev = _jax(t, build(JE), True)[0]
    jcpu = _jax(t, build(JE), False)[0]
    # the JAX package's answers: 0.5 on its device path, 0.0 on its CPU
    # engine, where the exact sample variance is 1.0
    assert jdev["var_samp"] == 0.5 and jcpu["var_samp"] == 0.0


def test_plain_string_min_max_past_a_16_byte_prefix_is_exact():
    """Reference fault 11: the JAX package's device string Min/Max compares
    a 16-byte prefix of a plain (not dictionary) string and takes the
    first row among ties. The port's is exact in byte order on both
    engines (a proper prefix first); the JAX package's device answer is
    recorded."""
    base = "a" * 16
    vals = [base + "zz", base + "b", base + "m", base, "q" * 20]
    t = pa.table({"k": pa.array([1, 1, 1, 1, 2], pa.int64()),
                  "s": pa.array(vals, pa.string())})

    def build(M):
        plain = M.Substring(M.col("s"), 1, 30)  # a plain string column
        return lambda df: df.group_by("k").agg(
            M.Min(plain).alias("mn"), M.Max(plain).alias("mx"),
            M.First(plain).alias("first"),
            M.Last(plain).alias("last")).sort("k")

    exact = [{"k": 1, "mn": base, "mx": base + "zz", "first": base + "zz",
              "last": base},
             {"k": 2, "mn": "q" * 20, "mx": "q" * 20, "first": "q" * 20,
              "last": "q" * 20}]
    for engine in PORT_ENGINES:
        assert _port(t, build(PE), engine).collect() == exact
    jdev = _jax(t, build(JE), True)
    # the JAX package's device path: every row ties on the 16-byte prefix
    # "aaaaaaaaaaaaaaaa", so min and max are the group's first row
    assert (jdev[0]["mn"], jdev[0]["mx"]) == (base + "zz", base + "zz")
    assert _jax(t, build(JE), False) == exact


def _reasons(text: str):
    out = set()
    for ln in text.splitlines():
        if ln.lstrip().startswith("!") and "because " in ln:
            out |= {r.strip() for r in ln.split("because ", 1)[1]
                    .split("  [")[0].split(";")}
    return out


CPU_ONLY = {
    "bit_aggs": (lambda M: [M.BitAndAgg(M.col("w")).alias("a"),
                            M.BitOrAgg(M.col("w")).alias("o"),
                            M.BitXorAgg(M.col("w")).alias("x")],
                 {"expression BitAndAgg not on device",
                  "expression BitOrAgg not on device",
                  "expression BitXorAgg not on device"}),
    "percentile": (lambda M: [M.Percentile(M.col("o"), 0.9).alias("p"),
                              M.Median(M.col("dec")).alias("m")],
                   {"expression Percentile not on device",
                    "expression Median not on device"}),
    "min_by_float_ordering": (
        lambda M: [M.MinBy(M.col("o"), M.col("x")).alias("m")],
        {"min_by/max_by ordering/value type not on device"}),
    "max_by_string_value": (
        lambda M: [M.MaxBy(M.col("s"), M.col("o")).alias("m")],
        {"min_by/max_by ordering/value type not on device"}),
    "min_by_decimal": (
        lambda M: [M.MinBy(M.col("dec"), M.col("o")).alias("m"),
                   M.MaxBy(M.col("o"), M.col("dec")).alias("m2")],
        {"min_by/max_by ordering/value type not on device"}),
}


@pytest.mark.parametrize("case", sorted(CPU_ONLY))
def test_cpu_engine_aggregates_match_jax_with_its_reasons(case):
    """The reference's CPU-only aggregates and the gated MinBy types run
    on the CPU engine under a device scan, explained with the reference's
    reasons, and equal its CPU engine."""
    aggs, reasons = CPU_ONLY[case]
    q = _port(table(), lambda df: df.group_by("k").agg(*aggs(PE)).sort("k"),
              "device")
    text = q.explain()
    assert _reasons(text) == reasons, text
    assert "* InMemoryScan" in text
    jdf = jax_from_arrow(table())
    assert reasons <= _reasons(jdf.group_by("k").agg(*aggs(JE)).explain())
    exp = _jax(table(), lambda df: df.group_by("k").agg(*aggs(JE)).sort(
        "k"), False)
    assert_rows(q.collect(), exp)
    off = from_arrow(table(), RapidsConf(
        {"spark.rapids.gpu.sql.fallback.enabled": "false"}), device="cpu")
    with pytest.raises(NotImplementedError, match="not on device"):
        off.group_by("k").agg(*aggs(PE)).collect()
