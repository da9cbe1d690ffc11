"""Divide, Abs, UnaryMinus and DECIMAL128 on the port's device path
(spark_rapids_tpu_torch on the CPU) held against the JAX package's device
path on the same seeded tables: Spark's result types; decimal Divide
(HALF_UP at the result scale, null on a zero divisor or past the
precision) at narrow and wide results; wide Add, Subtract and Multiply;
comparisons at mixed scales; casts to and from DECIMAL128; If and
Coalesce over wide branches; the Sum, Average, Min, Max and Count
aggregates over DECIMAL128 and into it; DECIMAL128 group and order keys;
window Sum and Average into DECIMAL128 (exact, Decimal for Decimal, rel
1e-12 on doubles). The port's CPU engine gives the device's rows for every
expression. Arrow round trips keep a negative value, 10^p - 1 and a null.
A double or integer Divide by zero is null in the port (Spark's non-ANSI
Divide) where the reference gives IEEE inf/NaN for a fractional divisor:
held both ways."""

import decimal
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exec import (BatchSourceExec as JSource,
                                   HashAggregateExec as JAgg,
                                   ProjectExec as JProject)
from spark_rapids_tpu.exec.sort import SortExec as JSort
from spark_rapids_tpu.exec.sort import SortOrder as JOrd
from spark_rapids_tpu.exec.window import WindowExec as JWindow
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec as PAgg
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.project import ProjectExec as PProject
from spark_rapids_tpu_torch.exec.sort import SortExec as PSort
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exec.window import WindowExec as PWindow
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import window as PW
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal


def _dec(unscaled, scale, mask=None):
    # from text: exact at any precision (scaleb would round to the
    # context's 28 digits)
    return [None if (mask is not None and m) else D(f"{int(u)}E-{scale}")
            for u, m in zip(unscaled, mask if mask is not None
                            else [False] * len(unscaled))]


def _big(rng, n, digits):
    """``n`` seeded signed integers of up to ``digits`` digits (every
    magnitude from 1 digit up)."""
    lens = rng.integers(1, digits + 1, n)
    out = []
    for k in lens.tolist():
        v = int("".join(str(int(x)) for x in rng.integers(0, 10, k)))
        out.append(-v if rng.random() < 0.5 else v)
    return out


def _table(n=300, seed=8):
    """Narrow and wide decimals, integers and doubles with zeros, nulls,
    exact HALF_UP ties and the precision's edges."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-10**7 + 1, 10**7, n)
    d[:6] = [5, -5, 15, -15, 9_999_999, -9_999_999]
    z = rng.integers(-3, 4, n)  # decimal(7,2) divisors, zeros included
    z[:6] = [2, 2, 2, 2, 0, 0]
    w = _big(rng, n, 26)
    w[:4] = [10**27 - 1, -(10**27 - 1), 25, -25]
    m = rng.integers(-10**17 + 1, 10**17, n)
    v = _big(rng, n, 37)
    v[:2] = [10**38 - 1, -(10**38 - 1)]
    i = rng.integers(-50, 50, n).astype(np.int32)
    i[:4] = [3, 0, -7, 0]
    x = rng.normal(0, 100, n)
    nulls = rng.random(n) < 0.08
    return pa.table({
        "g": pa.array(rng.integers(0, 7, n), pa.int64()),
        "d": pa.array(_dec(d, 2), pa.decimal128(7, 2)),
        "e": pa.array(_dec(rng.integers(-99999, 100000, n), 3),
                      pa.decimal128(5, 3)),
        "z": pa.array(_dec(z, 2), pa.decimal128(7, 2)),
        "m": pa.array(_dec(m, 2, nulls), pa.decimal128(17, 2)),
        "w": pa.array(_dec(w, 2, nulls[::-1]), pa.decimal128(27, 2)),
        "v": pa.array(_dec(v, 10), pa.decimal128(38, 10)),
        "i": pa.array(i, pa.int32()),
        "l": pa.array(rng.integers(-10**12, 10**12, n), pa.int64()),
        "x": pa.array(x),
        "q": pa.array(np.where(np.abs(x) < 1, 1.0, x)),
    })


def _sources(table, rows_per_batch):
    jcache, pcache = {}, {}
    slices = [table.slice(k, rows_per_batch)
              for k in range(0, max(table.num_rows, 1), rows_per_batch)]
    jb = [JB.batch_from_arrow(s, 16, dict_cache=jcache) for s in slices]
    pb = [PB.batch_from_arrow(s, "cpu", dict_cache=pcache) for s in slices]
    return (JSource([jb], JT.Schema.from_arrow(table.schema)),
            PSource([pb], PT.Schema.from_arrow(table.schema)))


def _rows(node, B):
    tables = [B.batch_to_arrow(b, node.output_schema)
              for b in node.execute(0)]
    return pa.concat_tables(tables).to_pylist() if tables else []


def _same_rows(got, exp, ordered=True):
    """Exact for everything but doubles (rel 1e-12); null for null."""
    assert [list(r) for r in got[:1]] == [list(r) for r in exp[:1]]
    assert len(got) == len(exp)
    if not ordered:
        key = repr
        got, exp = sorted(got, key=key), sorted(exp, key=key)
    for rg, re_ in zip(got, exp):
        for k, v in rg.items():
            if isinstance(v, float):
                assert (math.isnan(v) and math.isnan(re_[k])) or abs(
                    v - re_[k]) <= 1e-12 * max(1.0, abs(v)), (k, rg, re_)
            else:
                assert v == re_[k], (k, rg, re_)


# each case: (name, builder over an expression module M and types T)
EXPRS = {
    # decimal Divide: narrow result, a zero divisor, wide results
    "divide_narrow": lambda M, T: M.Divide(M.col("d"), M.col("e")),
    "divide_zero": lambda M, T: M.Divide(M.col("d"), M.col("z")),
    "divide_wide": lambda M, T: M.Divide(M.col("w"), M.col("d")),
    "divide_wide_wide": lambda M, T: M.Divide(M.col("w"), M.col("v")),
    "divide_by_int": lambda M, T: M.Divide(M.col("m"), M.col("i")),
    "divide_sums": lambda M, T: M.Divide(M.col("m"), M.col("m")),
    "divide_ints": lambda M, T: M.Divide(M.col("l"), M.col("i")),
    "divide_doubles": lambda M, T: M.Divide(M.col("x"), M.col("q")),
    "divide_decimal_double": lambda M, T: M.Divide(M.col("w"), M.col("q")),
    # Abs and UnaryMinus, narrow and wide
    "abs_wide": lambda M, T: M.Abs(M.Subtract(M.col("m"), M.col("w"))),
    "abs_narrow": lambda M, T: M.Abs(M.col("d")),
    "minus_wide": lambda M, T: M.UnaryMinus(M.col("v")),
    "minus_int": lambda M, T: M.UnaryMinus(M.col("i")),
    # wide Add/Subtract/Multiply, overflow to null
    "add_wide": lambda M, T: M.Add(M.col("w"), M.col("e")),
    "subtract_wide": lambda M, T: M.Subtract(M.col("v"), M.col("w")),
    "multiply_narrow_to_wide": lambda M, T: M.Multiply(M.col("m"),
                                                       M.col("l")),
    "multiply_wide": lambda M, T: M.Multiply(M.col("w"), M.col("d")),
    "multiply_overflow": lambda M, T: M.Multiply(M.col("w"), M.col("v")),
    "multiply_wide_double": lambda M, T: M.Multiply(M.col("w"),
                                                    M.lit(1.5)),
    # comparisons at mixed scales, with integers and doubles
    "less_wide": lambda M, T: M.LessThan(M.col("w"), M.col("v")),
    "equal_wide_narrow": lambda M, T: M.EqualTo(
        M.col("w"), M.Multiply(M.col("d"), M.lit(1))),
    "ge_wide_int": lambda M, T: M.GreaterThanOrEqual(M.col("v"),
                                                     M.col("i")),
    "gt_wide_double": lambda M, T: M.GreaterThan(M.col("w"), M.lit(0.5)),
    "le_quotient": lambda M, T: M.LessThanOrEqual(
        M.Divide(M.col("m"), M.col("d")), M.Divide(M.col("w"), M.col("d"))),
    # casts into and out of DECIMAL128
    "cast_up": lambda M, T: M.Cast(M.col("d"), T.DecimalType(30, 5)),
    "cast_int_up": lambda M, T: M.Cast(M.col("i"), T.DecimalType(25, 3)),
    "cast_down_round": lambda M, T: M.Cast(M.col("v"),
                                           T.DecimalType(38, 2)),
    "cast_to_narrow": lambda M, T: M.Cast(M.col("w"),
                                          T.DecimalType(18, 2)),
    "cast_to_long": lambda M, T: M.Cast(M.col("w"), T.LONG),
    "cast_to_double": lambda M, T: M.Cast(M.col("v"), T.DOUBLE),
    # conditionals over wide branches
    "if_wide": lambda M, T: M.If(M.GreaterThan(M.col("g"), M.lit(3)),
                                 M.col("w"),
                                 M.lit(None, T.DecimalType(27, 2))),
    "coalesce_wide": lambda M, T: M.Coalesce(M.col("w"),
                                             M.Cast(M.col("d"),
                                                    T.DecimalType(27, 2))),
}


def _projection(M, T, name):
    return [M.col("g"), M.Alias(EXPRS[name](M, T), "r")]


# DECIMAL128 read as a double: the reference adds the signed limbs as
# doubles, which cancels for small negative values (ROADMAP queue 3); these
# cases are held against the exact value of each Decimal instead, and
# against the reference where it is exact
TO_DOUBLE = {"cast_to_double": ("v", lambda a, t: a),
             "divide_decimal_double": ("w", lambda a, t: a / t["q"]),
             "multiply_wide_double": ("w", lambda a, t: a * 1.5)}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(name):
    t = _table()
    js, ps = _sources(t, 128)
    port = PProject(_projection(PE, PT, name), ps)
    jax = JProject(_projection(JE, JT, name), js)
    assert repr(port.output_schema["r"].dtype) == repr(
        jax.output_schema["r"].dtype)
    exp = _rows(jax, JB)
    got = _rows(port, PB)
    if name in TO_DOUBLE:
        src, op = TO_DOUBLE[name]
        rows = t.to_pylist()
        exact = [{"g": r["g"], "r": None if r[src] is None
                  else op(float(r[src]), r)} for r in rows]
        _same_rows(got, exact)
        # the reference agrees wherever its sum of limbs does not cancel:
        # positive values, and magnitudes far past 2^64 units
        far = [k for k, r in enumerate(rows) if r[src] is not None and (
            r[src] > 0 or abs(r[src].scaleb(t.schema.field(src).type.scale))
            > 2 ** 80)]
        assert len(far) > 100
        _same_rows([got[k] for k in far], [exp[k] for k in far])
        return
    _same_rows(got, exp)
    if name in ("divide_zero", "multiply_overflow", "cast_to_narrow"):
        assert any(r["r"] is None for r in got)  # nulls where Spark's are


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_cpu_engine_matches_device(name):
    """The port's CPU engine (``spark.rapids.gpu.sql.enabled=false``) and
    its device give the same rows for every expression."""
    t = _table()

    def run(conf):
        df = port_from_arrow(t, RapidsConf(conf), batch_rows=100,
                             device="cpu")
        q = df.select(*_projection(PE, PT, name))
        return q.explain(), q.collect()

    dev_plan, dev = run({})
    cpu_plan, cpu = run({"spark.rapids.gpu.sql.enabled": "false"})
    assert "!" not in dev_plan and all(
        ln.lstrip().startswith("!") for ln in cpu_plan.splitlines())
    _same_rows(cpu, dev)


@pytest.mark.parametrize("lt,rt", [
    ((7, 2), (7, 2)), ((17, 2), (17, 2)), ((18, 2), (18, 2)),
    ((27, 2), (21, 6)), ((38, 10), (5, 3)), ((7, 2), "int"),
    ("bigint", (7, 2)), ("int", "int"), ((7, 2), "double")])
def test_divide_result_type_follows_the_reference(lt, rt):
    def typ(M, T, x):
        if x == "int":
            return T.INT
        if x == "bigint":
            return T.LONG
        if x == "double":
            return T.DOUBLE
        return T.DecimalType(*x)

    def div(M, T):
        e = M.Divide(M.ColumnRef(0, typ(M, T, lt)),
                     M.ColumnRef(1, typ(M, T, rt)))
        return repr(e.dtype), e.nullable, repr(M.Abs(e).dtype), repr(
            M.UnaryMinus(e).dtype)

    assert div(PE, PT) == div(JE, JT)


def _aggs(M):
    return [M.Sum(M.col("w")).alias("sw"), M.Average(M.col("w")).alias("aw"),
            M.Min(M.col("w")).alias("mnw"), M.Max(M.col("w")).alias("mxw"),
            M.Sum(M.col("m")).alias("sm"), M.Average(M.col("m")).alias("am"),
            M.Min(M.col("v")).alias("mnv"), M.Max(M.col("v")).alias("mxv"),
            M.Count(M.col("w")).alias("n")]


@pytest.mark.parametrize("keys,rows_per_batch", [
    ("g", 64), ("g", 5000), ("", 77), ("w", 90)])
def test_wide_aggregates_match_jax(keys, rows_per_batch):
    """Sum into and over DECIMAL128 (decimal(17,2) -> (27,2), (27,2) ->
    (37,2)), Average through the 128-bit divide-first rule (-> (21,6) and
    (31,6)), Min/Max of both limbs, grouped by an int key, globally, and
    by a DECIMAL128 key (duplicated values)."""
    t = _table()
    if keys == "w":  # repeat each wide value a few times
        t = pa.concat_tables([t, t.slice(0, 100), t.slice(50, 100)])
    js, ps = _sources(t, rows_per_batch)
    group = [keys] if keys else []
    exp = _rows(JAgg([JE.col(k) for k in group], _aggs(JE), js), JB)
    got = _rows(PAgg([PE.col(k) for k in group], _aggs(PE), ps), PB)
    _same_rows(got, exp, ordered=False)
    assert any(isinstance(r["aw"], D) and r["aw"] != 0 for r in got)


@pytest.mark.parametrize("ascending,nulls_first", [(True, None),
                                                   (False, None),
                                                   (False, True)])
def test_wide_order_keys_match_jax(ascending, nulls_first):
    t = _table()
    t = pa.concat_tables([t, t.slice(0, 40)])  # ties
    js, ps = _sources(t, 100)
    exp = _rows(JSort([JOrd(JE.col("w"), ascending, nulls_first),
                       JOrd(JE.col("v"))], js), JB)
    got = _rows(PSort([POrd(PE.col("w"), ascending, nulls_first),
                       POrd(PE.col("v"))], ps), PB)
    assert [(r["w"], r["v"]) for r in got] == [(r["w"], r["v"]) for r in exp]


@pytest.mark.parametrize("frame", ["unbounded", "running_rows",
                                   "running_range"])
def test_wide_window_sum_average_match_jax(frame):
    """Window Sum and Average of decimal(17,2) (-> decimal(27,2) and
    decimal(21,6)) and of decimal(27,2) (-> decimal(37,2) and
    decimal(31,6)) over DECIMAL128-aware partitions, ordered by a
    DECIMAL128 key; the port's sums are three add-scans of the
    segmented-scan kernel's plain version here."""
    t = _table()
    js, ps = _sources(t, 128)
    fr = {"unbounded": ("rows", None, None), "running_rows": ("rows", None, 0),
          "running_range": ("range", None, 0)}[frame]

    def node(M, W, Ord, Window, src):
        spec = W.window_spec(partition_by=["g"],
                             order_by=[Ord(M.col("w")), Ord(M.col("v"))],
                             frame=W.WindowFrame(*fr))
        return Window([W.over(M.Sum(M.col("m")), spec).alias("sm"),
                       W.over(M.Average(M.col("m")), spec).alias("am"),
                       W.over(M.Sum(M.col("w")), spec).alias("sw"),
                       W.over(M.Average(M.col("w")), spec).alias("aw")],
                      src)

    exp = _rows(node(JE, JW, JOrd, JWindow, js), JB)
    got = _rows(node(PE, PW, POrd, PWindow, ps), PB)
    _same_rows(got, exp, ordered=False)
    assert PT.DecimalType(27, 2) == PWindow(
        [PW.over(PE.Sum(PE.col("m")), PW.window_spec(["g"])).alias("s")],
        ps).output_schema["s"].dtype


@pytest.mark.parametrize("p,s", [(19, 2), (27, 2), (38, 0), (38, 10)])
def test_decimal128_arrow_round_trip(p, s):
    """A negative value, 10^p - 1, -(10^p - 1), zero and a null come back
    from the device as they went up, in the reference's limbs."""
    vals = [D(f"{u}E-{s}") if u is not None else None
            for u in (-12345, 10**p - 1, -(10**p - 1), 0, None, 7)]
    t = pa.table({"x": pa.array(vals, pa.decimal128(p, s))})
    b = PB.batch_from_arrow(t, "cpu")
    assert b.columns[0].data.shape == (len(vals), 2)
    out = PB.batch_to_arrow(b, PT.Schema.from_arrow(t.schema))
    assert out.equals(t) and out.column(0).to_pylist() == vals
    jb = JB.batch_from_arrow(t, 16)
    np.testing.assert_array_equal(
        b.columns[0].data[:, 0].numpy(),
        np.asarray(jb.columns[0].data)[: len(vals)])
    np.testing.assert_array_equal(
        b.columns[0].data[:, 1].numpy(),
        np.asarray(jb.columns[0].data2)[: len(vals)])


@pytest.mark.parametrize("divisor", ["zero", "negative_zero", "int_zero"])
def test_divide_by_zero_is_null_where_the_reference_gives_inf(divisor):
    """A known, deliberate difference (ROADMAP queue 3): the port follows
    Spark's non-ANSI Divide, null for any zero divisor, on both of its
    engines; the reference's engines give IEEE inf/NaN for a fractional
    divisor (its integer divisor gives null, as the port's)."""
    x = (pa.array([3, -2, 0, 5, 1], pa.int32()) if divisor == "int_zero"
         else pa.array([3.0, -2.0, 0.0, float("nan"), 1.0]))
    y = {"zero": pa.array([0.0, 0.0, 0.0, 0.0, 2.0]),
         "negative_zero": pa.array([-0.0, -0.0, -0.0, 0.0, 4.0]),
         "int_zero": pa.array([0, 0, 0, 0, 2], pa.int32())}[divisor]
    t = pa.table({"x": x, "y": y})
    fractional = divisor != "int_zero"
    for conf in ({}, {"spark.rapids.gpu.sql.enabled": "false"}):
        got = port_from_arrow(t, RapidsConf(conf), device="cpu").select(
            PE.Divide(PE.col("x"), PE.col("y")).alias("r")).collect()
        assert [r["r"] for r in got][:4] == [None] * 4
        assert got[4]["r"] == (0.5 if divisor != "negative_zero" else 0.25)
    for conf in ({}, {"spark.rapids.tpu.sql.enabled": "false"}):
        from spark_rapids_tpu.config import conf as JC

        jdf = jax_from_arrow(t, JC.RapidsConf(conf))
        jdf.shuffle_partitions = 1
        exp = [r["r"] for r in jdf.select(
            JE.Divide(JE.col("x"), JE.col("y")).alias("r")).collect()]
        if fractional:
            sign = -1.0 if divisor == "negative_zero" else 1.0
            assert exp[0] == sign * math.inf and exp[1] == -sign * math.inf
            assert math.isnan(exp[2]) and math.isnan(exp[3])
        else:
            assert exp[:4] == [None] * 4
