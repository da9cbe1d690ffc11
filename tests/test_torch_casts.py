"""Narrowing numeric casts and untyped NULL literals in the port, held
against the JAX package on the CPU, on the device path and on the CPU
engine (``spark.rapids.gpu.sql.enabled=false``):

- double -> int and bigint (NaN is 0, +-inf and out-of-range values
  saturate, -0.0 is 0, the rest truncate toward zero), bigint -> int
  (wraps), decimal -> int and bigint (the whole part, wrapping), and a
  conditional whose later branch needs such a cast
  (``If(c, int_col, double_col)``, ``CaseWhen`` over bigint and double,
  where the reference rounds a bigint past 2^53 through a double and the
  port keeps it exact: a known difference, checked row by row);
- ``lit(None)`` typed by its parent as the reference types it: a
  conditional's other branch, ``IN``'s value, a Cast's target, a boolean
  under And/Or/Not and IsNull, a double under Sum and Average, and a
  TypeError on both engines where the reference raises one (arithmetic
  and comparisons with an untyped NULL);
- casts the port does not have (double or decimal -> timestamp, bigint or
  decimal -> date) raise on both engines naming the cast.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal
ENGINES = {"device": None, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                          "false"}}
DOUBLES = [float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e20,
           -1e20, 2.7, -2.7, 2147483647.5, -2147483648.9, 2147483648.0,
           -2147483649.0, 9.3e18, -9.3e18, 9223372036854775807.0,
           -9223372036854775808.0, 0.49, -0.51, None]


def _table():
    n = len(DOUBLES)
    rng = np.random.default_rng(4)
    longs = [2**40 + 5, -2**40 - 7, 2**31, -2**31 - 1, 2**63 - 1, -2**63, 7,
             None] + [int(x) for x in rng.integers(-2**62, 2**62, n - 8)]
    decs = [D("-12345.67"), D("99999.99"), D("-0.99"), D("0.99"), None] + [
        D(int(x)).scaleb(-2) for x in rng.integers(-9999999, 9999999, n - 5)]
    return pa.table({
        "d": pa.array(DOUBLES, pa.float64()),
        "l": pa.array(longs, pa.int64()),
        "m": pa.array(decs, pa.decimal128(7, 2)),
        "i": pa.array(np.arange(n) - 5, pa.int32()),
        "c": pa.array([[True, False, None][j % 3] for j in range(n)],
                      pa.bool_()),
    })


def _jax(build):
    df = jax_from_arrow(_table())
    df.shuffle_partitions = 1
    return df.select(*build(JE, JT)).collect()


def _port(build, engine):
    conf = ENGINES[engine]
    df = port_from_arrow(_table(), None if conf is None else RapidsConf(conf),
                         device="cpu")
    out = df.select(*build(PE, PT))
    plan = out.explain()
    if engine == "device":
        assert "!" not in plan  # every node on the device path
    return out.collect()


def _same(got, exp):
    assert len(got) == len(exp)
    for rg, re_ in zip(got, exp):
        assert list(rg) == list(re_)
        for k in rg:
            a, b = rg[k], re_[k]
            if isinstance(a, float) and isinstance(b, float):
                assert (a == b) or (a != a and b != b), (k, a, b)
            else:
                assert a == b and type(a) is type(b), (k, a, b)


CASTS = {
    "double_to_int": lambda M, T: [M.Cast(M.col("d"), T.INT).alias("x")],
    "double_to_bigint": lambda M, T: [M.Cast(M.col("d"), T.LONG)
                                      .alias("x")],
    "bigint_to_int": lambda M, T: [M.Cast(M.col("l"), T.INT).alias("x")],
    "decimal_to_int": lambda M, T: [M.Cast(M.col("m"), T.INT).alias("x")],
    "decimal_to_bigint": lambda M, T: [M.Cast(M.col("m"), T.LONG)
                                       .alias("x")],
    "if_int_double": lambda M, T: [M.If(M.col("c"), M.col("i"), M.col("d"))
                                   .alias("x")],
    "casewhen_bigint_double": lambda M, T: [M.CaseWhen(
        [(M.col("c"), M.col("l"))], M.col("d")).alias("x")],
    "coalesce_int_double": lambda M, T: [M.Coalesce(
        M.If(M.col("c"), M.col("i"), M.lit(None, T.INT)),
        M.col("d")).alias("x")],
    "cast_of_arithmetic": lambda M, T: [M.Cast(
        M.Multiply(M.col("d"), M.lit(1e10)), T.INT).alias("x"),
        M.Cast(M.Add(M.col("m"), M.col("i")), T.INT).alias("y")],
}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("case", list(CASTS))
def test_narrowing_cast_matches_jax(case, engine):
    exp = _jax(CASTS[case])
    got = _port(CASTS[case], engine)
    if case == "casewhen_bigint_double":
        # a known difference (ROADMAP.md queue 3): where the bigint branch
        # is taken, the port gives its exact value, the reference the
        # value rounded through a double (it selects in float64 first)
        t = _table()
        for j, (c, v) in enumerate(zip(t.column("c").to_pylist(),
                                       t.column("l").to_pylist())):
            if c and v is not None and abs(v) > 2 ** 53:
                assert got[j]["x"] == v
                assert exp[j]["x"] == int(float(v)) != v
                got[j] = exp[j] = {"x": None}
    _same(got, exp)


NULLS = {
    "if_value_null": lambda M, T: [M.If(M.col("c"), M.col("i"), M.lit(None))
                                   .alias("x")],
    "coalesce_null_last": lambda M, T: [M.Coalesce(M.col("l"), M.lit(None))
                                        .alias("x")],
    "in_null_item": lambda M, T: [M.In(M.col("i"), [M.lit(1), M.lit(None)])
                                  .alias("x")],
    "cast_null": lambda M, T: [M.Cast(M.lit(None), T.INT).alias("x")],
    "and_or_not_null": lambda M, T: [
        M.And(M.col("c"), M.lit(None)).alias("a"),
        M.Or(M.col("c"), M.lit(None)).alias("o"),
        M.Not(M.lit(None)).alias("n")],
    "is_null_of_null": lambda M, T: [M.IsNull(M.lit(None)).alias("x"),
                                     M.IsNotNull(M.lit(None)).alias("y")],
    "casewhen_null_then": lambda M, T: [M.CaseWhen(
        [(M.col("c"), M.lit(None, T.DOUBLE))], M.col("d")).alias("x")],
}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("case", list(NULLS))
def test_null_literal_matches_jax(case, engine):
    exp = _jax(NULLS[case])
    _same(_port(NULLS[case], engine), exp)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_null_literal_aggregates_match_jax(engine):
    def aggs(M):
        return [M.Sum(M.lit(None)).alias("s"), M.Count(M.lit(None))
                .alias("n"), M.Average(M.lit(None)).alias("a"),
                M.Sum(M.If(M.col("c"), M.col("d"), M.lit(None)))
                .alias("sd")]
    jdf = jax_from_arrow(_table())
    jdf.shuffle_partitions = 1
    exp = jdf.agg(*aggs(JE)).collect()
    conf = ENGINES[engine]
    got = port_from_arrow(_table(), None if conf is None
                          else RapidsConf(conf), device="cpu").agg(
        *aggs(PE)).collect()
    assert got[0]["s"] is None and got[0]["a"] is None
    assert got[0]["n"] == exp[0]["n"] == 0
    assert got[0]["s"] == exp[0]["s"] and got[0]["a"] == exp[0]["a"]
    assert got[0]["sd"] != got[0]["sd"] and exp[0]["sd"] != exp[0]["sd"]
    assert PE.resolve(PE.Sum(PE.lit(None)), PT.Schema([])).dtype == \
        PT.DOUBLE


TYPE_ERRORS = {
    "add": lambda M, T: [M.Add(M.col("i"), M.lit(None)).alias("x")],
    "multiply": lambda M, T: [M.Multiply(M.col("d"), M.lit(None))
                              .alias("x")],
    "equal_to": lambda M, T: [M.EqualTo(M.col("l"), M.lit(None))
                              .alias("x")],
}


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("case", list(TYPE_ERRORS))
def test_untyped_null_in_arithmetic_raises_like_jax(case, engine):
    with pytest.raises(TypeError, match="no common numeric type"):
        _jax(TYPE_ERRORS[case])
    with pytest.raises(TypeError, match="no common numeric type"):
        _port(TYPE_ERRORS[case], engine)


def test_untyped_null_where_no_type_is_implied_raises():
    """A bare projected NULL, a conditional of NULLs only and Max(NULL)
    have no type: a TypeError on both engines, before any row runs (the
    reference fails in Arrow conversion there)."""
    cases = [[PE.lit(None).alias("x")],
             [PE.If(PE.col("c"), PE.lit(None), PE.lit(None)).alias("x")],
             [PE.Coalesce(PE.lit(None)).alias("x")]]
    for engine, conf in ENGINES.items():
        df = port_from_arrow(_table(), None if conf is None
                             else RapidsConf(conf), device="cpu")
        for exprs in cases:
            with pytest.raises(TypeError, match="untyped NULL"):
                df.select(*exprs).collect()
        with pytest.raises(TypeError, match="untyped NULL"):
            df.agg(PE.Max(PE.lit(None)).alias("x")).collect()


@pytest.mark.parametrize("engine", list(ENGINES))
def test_unported_casts_raise_naming_them(engine):
    conf = ENGINES[engine]
    df = port_from_arrow(_table(), None if conf is None
                         else RapidsConf(conf), device="cpu")
    for src, dst in (("d", PT.TIMESTAMP), ("m", PT.TIMESTAMP),
                     ("m", PT.DATE), ("l", PT.DATE)):
        with pytest.raises(NotImplementedError, match="cast"):
            df.select(PE.Cast(PE.col(src), dst).alias("x")).collect()
