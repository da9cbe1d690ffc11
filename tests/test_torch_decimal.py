"""DECIMAL64 in the port (spark_rapids_tpu_torch) held against the JAX
package on the same seeded tables: Arrow upload/download round trips,
Spark's DecimalPrecision result types, decimal arithmetic, casts and
comparisons (exact; decimal with double within rel 1e-12), and the Sum,
Average, Min, Max and Count aggregates (exact), with negative values,
nulls and exact .5 ties at the average's result scale."""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exec import (BatchSourceExec as JSource,
                                   FilterExec as JFilter,
                                   HashAggregateExec as JAgg,
                                   ProjectExec as JProject)
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec as PAgg
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.project import (FilterExec as PFilter,
                                                 ProjectExec as PProject)
from spark_rapids_tpu_torch.exprs import expr as PE

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal


def _dec(unscaled, scale):
    return [None if u is None else D(int(u)).scaleb(-scale)
            for u in unscaled]


def _sources(table, rows_per_batch):
    jcache, pcache = {}, {}
    slices = [table.slice(i, rows_per_batch)
              for i in range(0, max(table.num_rows, 1), rows_per_batch)]
    jb = [JB.batch_from_arrow(s, 16, dict_cache=jcache) for s in slices]
    pb = [PB.batch_from_arrow(s, "cpu", dict_cache=pcache) for s in slices]
    return (JSource([jb], JT.Schema.from_arrow(table.schema)),
            PSource([pb], PT.Schema.from_arrow(table.schema)))


def _rows(node, B):
    tables = [B.batch_to_arrow(b, node.output_schema)
              for b in node.execute(0)]
    return pa.concat_tables(tables).to_pylist() if tables else []


def _table(n=600, seed=5):
    rng = np.random.default_rng(seed)
    return pa.table({
        "g": pa.array(rng.integers(0, 9, n), pa.int64()),
        "d": pa.array(_dec(rng.integers(-10**7 + 1, 10**7, n), 2),
                      pa.decimal128(7, 2), mask=rng.random(n) < 0.1),
        "e": pa.array(_dec(rng.integers(-99999, 100000, n), 3),
                      pa.decimal128(5, 3), mask=rng.random(n) < 0.1),
        "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int32),
                      pa.int32()),
        "q": pa.array(rng.integers(1, 101, n).astype(np.float64),
                      pa.float64()),
    })


@pytest.mark.parametrize("p,s", [(7, 2), (18, 4), (1, 0), (18, 0)])
def test_arrow_round_trip(p, s):
    rng = np.random.default_rng(p * 31 + s)
    top = 10 ** p - 1
    vals = np.concatenate([[top, -top, 0, 1, -1],
                           rng.integers(-top, top, 200, endpoint=True)])
    arr = pa.array(_dec(vals, s), pa.decimal128(p, s),
                   mask=rng.random(len(vals)) < 0.2)
    t = pa.table({"x": arr})
    for part in (t, t.slice(3, 150)):  # a slice reads at an offset
        b = PB.batch_from_arrow(part, "cpu")
        assert b.columns[0].data.dtype == PT.DecimalType(p, s).torch_dtype
        out = PB.batch_to_arrow(b, PT.Schema.from_arrow(part.schema))
        assert out.equals(part.combine_chunks())
        jb = JB.batch_from_arrow(part, 16)
        np.testing.assert_array_equal(
            b.columns[0].data.numpy(),
            np.where(np.asarray(jb.columns[0].validity)[:part.num_rows],
                     np.asarray(jb.columns[0].data)[:part.num_rows], 0))


def test_decimal128_raises():
    """DECIMAL128 (p > 18) uploads as (n, 2) ``[lo, hi]`` limbs and plans on
    the device; what the device still refuses raises naming DECIMAL128: a
    DECIMAL128 join key (the reference's device refuses it too)."""
    from spark_rapids_tpu_torch.exec.join import HashJoinExec as PJoin

    t = pa.table({"x": pa.array([D("1.00"), None, D("-2.50")],
                                pa.decimal128(19, 2))})
    b = PB.batch_from_arrow(t, "cpu")
    assert b.columns[0].data.shape == (3, 2)
    assert b.columns[0].data.tolist() == [[100, 0], [0, 0], [-250, -1]]
    wide = PE.Sum(PE.ColumnRef(0, PT.DecimalType(9, 2))).dtype
    assert repr(wide) == repr(
        JE.Sum(JE.ColumnRef(0, JT.DecimalType(9, 2))).dtype)
    PT.check_device_type(wide)  # a device type now
    narrow = pa.table({"x": pa.array([D("1.00")], pa.decimal128(9, 2))})
    src = PSource([[PB.batch_from_arrow(narrow, "cpu")]],
                  PT.Schema.from_arrow(narrow.schema))
    agg = PAgg([], [PE.Sum(PE.col("x")).alias("s")], src)
    assert agg.output_schema["s"].dtype == wide
    wsrc = PSource([[b]], PT.Schema.from_arrow(t.schema))
    with pytest.raises(NotImplementedError, match="DECIMAL128"):
        PJoin([PE.col("x")], [PE.col("x")], "inner", wsrc, wsrc)


def _typed(M, T, name):
    return {"d72": T.DecimalType(7, 2), "d53": T.DecimalType(5, 3),
            "int": T.INT, "double": T.DOUBLE}[name]


@pytest.mark.parametrize("lt,rt", [("d72", "d53"), ("d72", "int"),
                                   ("int", "d53"), ("d72", "double"),
                                   ("double", "d53"), ("d72", "d72")])
def test_result_types_follow_the_reference(lt, rt):
    def types(M, T):
        a = M.ColumnRef(0, _typed(M, T, lt))
        b = M.ColumnRef(1, _typed(M, T, rt))
        out = [repr(M.Add(a, b).dtype), repr(M.Subtract(a, b).dtype),
               repr(M.Multiply(a, b).dtype)]
        for c in (a, b):
            out += [repr(M.Sum(c).dtype), repr(M.Average(c).dtype)]
        return out

    assert types(PE, PT) == types(JE, JT)
    assert repr(PE.lit(D("-12.340")).dtype) == repr(JE.lit(D("-12.340")).dtype)


def _projection(M, T):
    return [
        M.col("g"),
        M.Alias(M.Multiply(M.col("d"), M.col("q")), "d_x_q"),
        M.Alias(M.Multiply(M.col("d"), M.col("i")), "d_x_i"),
        M.Alias(M.Multiply(M.col("d"), M.col("e")), "d_x_e"),
        M.Alias(M.Add(M.col("d"), M.col("e")), "d_p_e"),
        M.Alias(M.Subtract(M.col("d"), M.col("i")), "d_m_i"),
        M.Alias(M.Cast(M.col("d"), T.DOUBLE), "d_dbl"),
        M.Alias(M.LessThanOrEqual(M.col("d"), M.lit(10)), "le_10"),
        M.Alias(M.GreaterThan(M.col("d"), M.lit(D("1.5"))), "gt_15"),
        M.Alias(M.GreaterThanOrEqual(M.col("d"), M.col("e")), "ge_e"),
        M.Alias(M.LessThan(M.col("e"), M.col("d")), "e_lt_d"),
        M.Alias(M.LessThan(M.col("d"), M.lit(2.5)), "lt_dbl"),
        M.Alias(M.EqualTo(M.col("d"), M.lit(D("0.50"))), "eq_half"),
        M.Alias(M.EqualTo(M.col("d"), M.col("e")), "eq_e"),
    ]


def test_decimal_expressions_match_jax():
    t = _table()
    # rows where d equals e at mixed scales, and d exactly 0.50
    extra = pa.table({"g": pa.array([1, 2, 3], pa.int64()),
                      "d": pa.array([D("1.25"), D("0.50"), D("-3.10")],
                                    pa.decimal128(7, 2)),
                      "e": pa.array([D("1.250"), D("0.499"), D("-3.100")],
                                    pa.decimal128(5, 3)),
                      "i": pa.array([1, 2, 3], pa.int32()),
                      "q": pa.array([1.0, 2.0, 3.0])})
    t = pa.concat_tables([t, extra])
    js, ps = _sources(t, 256)
    exp = _rows(JProject(_projection(JE, JT), js), JB)
    got = _rows(PProject(_projection(PE, PT), ps), PB)
    assert [list(r) for r in got[:1]] == [list(r) for r in exp[:1]]
    assert len(got) == len(exp) == t.num_rows
    for rg, re_ in zip(got, exp):
        for k, v in rg.items():
            if isinstance(v, float):
                assert abs(v - re_[k]) <= 1e-12 * max(1.0, abs(v)), k
            else:
                assert v == re_[k], (k, rg, re_)
    assert any(r["eq_e"] for r in got) and any(r["eq_half"] for r in got)


def test_decimal_filter_matches_jax():
    js, ps = _sources(_table(), 200)

    def cond(M):
        return M.And(M.LessThanOrEqual(M.col("d"), M.lit(D("25000.00"))),
                     M.GreaterThan(M.col("e"), M.lit(-50)))

    exp = _rows(JFilter(cond(JE), js), JB)
    got = _rows(PFilter(cond(PE), ps), PB)
    assert got == exp and 0 < len(got) < 600


def _agg_table():
    """Random groups plus groups whose average ends in an exact .5 at the
    result scale (6): 0.01 / 32 = 0.0003125 and 0.01 / 160 = 0.0000625,
    both signs, a group of nulls only, and large magnitudes."""
    rng = np.random.default_rng(12)
    g, u = [], []
    for k in range(6):
        n = int(rng.integers(20, 120))
        g += [k] * n
        u += rng.integers(-10**7 + 1, 10**7, n).tolist()
    for k, n, one in ((10, 32, 1), (11, 32, -1), (12, 160, 1),
                      (13, 160, -1), (14, 32, 3)):
        g += [k] * n
        u += [one] + [0] * (n - 1)
    g += [20] * 40
    u += [9_999_999] * 40
    mask = [False] * len(u)
    g += [30] * 5
    u += [7] * 5
    mask += [True] * 5
    perm = rng.permutation(len(g))
    return pa.table({
        "g": pa.array(np.array(g)[perm], pa.int64()),
        "d": pa.array(_dec(np.array(u)[perm], 2), pa.decimal128(7, 2),
                      mask=np.array(mask)[perm]),
    })


def _aggs(M):
    return [M.Sum(M.col("d")).alias("s"), M.Average(M.col("d")).alias("a"),
            M.Min(M.col("d")).alias("mn"), M.Max(M.col("d")).alias("mx"),
            M.Count(M.col("d")).alias("n")]


@pytest.mark.parametrize("rows_per_batch", [100, 5000])
def test_decimal_sum_average_match_jax(rows_per_batch):
    js, ps = _sources(_agg_table(), rows_per_batch)
    exp = _rows(JAgg([JE.col("g")], _aggs(JE), js), JB)
    got = _rows(PAgg([PE.col("g")], _aggs(PE), ps), PB)
    assert rows_match(got, exp)
    by_g = {r["g"]: r for r in got}
    assert by_g == {r["g"]: r for r in exp}  # exact, Decimal for Decimal
    # HALF_UP away from zero at scale 6
    assert by_g[10]["a"] == D("0.000313") and by_g[11]["a"] == D("-0.000313")
    assert by_g[12]["a"] == D("0.000063") and by_g[13]["a"] == D("-0.000063")
    assert by_g[20]["s"] == D("3999999.60")
    assert by_g[30]["s"] is None and by_g[30]["a"] is None
    assert by_g[30]["n"] == 0


def test_global_decimal_aggregate_matches_jax():
    js, ps = _sources(_agg_table(), 333)
    exp = _rows(JAgg([], _aggs(JE), js), JB)
    got = _rows(PAgg([], _aggs(PE), ps), PB)
    assert got == exp and len(got) == 1
