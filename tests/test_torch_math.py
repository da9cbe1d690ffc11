"""The scalar function families in the port (integral division, remainder
and pmod, the null-safe and null functions, greatest/least, rounding, the
math, bitwise and hash families and rand), held against the JAX package's
device path on the CPU over edge values: NaN, +-inf and +-0.0, each
integral type's MIN and MAX, zero divisors, shift counts -1, 0, 31, 32,
63, 64 and 65, scales -3 to 5 with .5 ties, and nulls in every operand;
on the port's device path and on its CPU engine.

Tolerance: every integer, boolean, string, decimal and hash result is
exact, and so are Floor, Ceil, Rint, Round and BRound; the transcendental
functions (``TRANSCENDENTAL``: libdevice, numpy and XLA round them a few
ulps apart) within relative 1e-12 of the reference, or absolute 1e-15
where the reference's value is within 1e-3 of 0.

Where the reference is not Spark (ROADMAP queue 3, faults 13-17), the port
gives Spark's answer and a test holds both: Pmod adds the divisor to every
remainder (Spark only to a negative one), Round and BRound of a double
scale its binary value (Spark rounds its shortest decimal text: round(1.005,
2) is 1.01), Round of a BIGINT at a negative scale goes through a double,
the math family reads a decimal's unscaled value, BRound of a decimal on
the CPU engine scales the result by 10**scale too much and Round of one
leaves it unrounded, and a decimal Floor/Ceil keeps the input's type. The known differences by design (queue 3's list) have tests
too: IntegralDivide casts a fractional operand to BIGINT first, a
TINYINT/SMALLINT shift is an INT shift.
"""

import decimal
import math

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
N = 40
ENGINES = {"device": None, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                          "false"}}
I32, I64 = (-2 ** 31, 2 ** 31 - 1), (-2 ** 63, 2 ** 63 - 1)
BIG = 2 ** 53 + 1


def _cycle(vals, n=N):
    return [vals[i % len(vals)] for i in range(n)]


def edge_table() -> pa.Table:
    rng = np.random.default_rng(15)
    ints = [I32[0], I32[1], 0, 1, -1, 7, -7, 100, None, 5, 3, -3, 12345,
            -99999, 2 ** 30, 64]
    longs = [I64[0], I64[1], 0, 1, -1, BIG, -BIG, 10, None, 15, 995, -995,
             2 ** 40 + 7, -123456789012, 5, 25]
    divs = [0, -1, 1, 2, -3, 0, 7, None, 10, -10, 3, 1000]
    doubles = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 2.5,
               -2.5, 0.125, -0.375, 1e300, -3.75, 3.7, None, 0.5, 1.5,
               -1e-5, 0.999, 42.0, 1e-3, -7.25]
    ddivs = [0.0, float("nan"), 2.0, -2.0, float("inf"), 0.5, None, -0.75,
             3.0, 1e-3]
    shifts = [-1, 0, 31, 32, 63, 64, 65, 1, 5, None, 2, 33]
    return pa.table({
        "i": pa.array(_cycle(ints), pa.int32()),
        "j": pa.array(_cycle(divs), pa.int32()),
        "l": pa.array(_cycle(longs), pa.int64()),
        "m": pa.array(_cycle(divs[::-1]), pa.int64()),
        "b": pa.array(_cycle([-128, 127, 0, 1, -1, 5, None, -7]), pa.int8()),
        "h": pa.array(_cycle([-32768, 32767, 0, -1, 9, None, 300]),
                      pa.int16()),
        "d": pa.array(_cycle(doubles), pa.float64()),
        "e": pa.array(_cycle(ddivs), pa.float64()),
        "f": pa.array(_cycle([1.5, -2.5, None, 0.1, float("nan"), 3.25,
                              -0.0, 1e10]), pa.float32()),
        "sh": pa.array(_cycle(shifts), pa.int32()),
        "p": pa.array(_cycle([D("1.25"), D("-99999.99"), None, D("0.00"),
                              D("12.50"), D("-0.05"), D("7.77")]),
                      pa.decimal128(7, 2)),
        "w": pa.array(_cycle([D("123456789012345678.125"), None,
                              D("-0.001"), D("12.500"), D("-7.770")]),
                      pa.decimal128(24, 3)),
        "flag": pa.array(_cycle([True, False, None]), pa.bool_()),
        "dt": pa.array(_cycle([0, 18262, -1, None, 2932896]), pa.int32())
        .cast(pa.date32()),
        "sd": pa.array(_cycle(["a", "bb", None, "", "ccc"]), pa.string()),
        "sp": pa.array([None if k % 9 == 4 else f"k{k}-{x}"
                        for k, x in enumerate(rng.integers(0, 10 ** 6, N))],
                       pa.string()),
    })


def _jax(build):
    df = jax_from_arrow(edge_table())
    df.shuffle_partitions = 1
    return df.select(*build(JE, JT)).collect()


def _port(build, engine, table=None):
    conf = ENGINES[engine]
    df = port_from_arrow(edge_table() if table is None else table,
                         None if conf is None else RapidsConf(conf),
                         device="cpu")
    out = df.select(*build(PE, PT))
    if engine == "device":
        plan = out.explain()
        assert "!" not in plan, plan  # every node on the device path
    return out.collect()


TRANSCENDENTAL = {"sqrt", "cbrt", "exp", "expm1", "log", "log10", "log2",
                  "log1p", "sin", "cos", "tan", "cot", "sec", "csc", "asin",
                  "acos", "atan", "sinh", "cosh", "tanh", "asinh", "acosh",
                  "atanh", "degrees", "radians", "atan2", "hypot", "pow"}


def same(a, b, name: str) -> bool:
    """The equivalence bar: exact, NaN equal to NaN, the transcendental
    functions within rel 1e-12 (abs 1e-15 near 0)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        a, b = float(a), float(b)
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if any(name.startswith(t) for t in TRANSCENDENTAL):
            if math.isinf(a) or math.isinf(b):
                return a == b
            if abs(b) < 1e-3:
                return abs(a - b) <= 1e-15
            return abs(a - b) <= 1e-12 * abs(b)
        return a == b
    return a == b


def check(got, exp):
    assert len(got) == len(exp)
    for i, (g, e) in enumerate(zip(got, exp)):
        for k in e:
            assert same(g[k], e[k], k), (i, k, g[k], e[k], g, e)


DIVISION = lambda M, T: [  # noqa: E731
    M.IntegralDivide(M.col("l"), M.col("m")).alias("div_l"),
    M.IntegralDivide(M.col("i"), M.col("j")).alias("div_i"),
    M.IntegralDivide(M.col("l"), M.col("j")).alias("div_lj"),
    M.Remainder(M.col("l"), M.col("m")).alias("rem_l"),
    M.Remainder(M.col("i"), M.col("j")).alias("rem_i"),
    M.Remainder(M.col("b"), M.col("b")).alias("rem_b"),
    M.Remainder(M.col("h"), M.col("j")).alias("rem_h"),
    M.Remainder(M.col("d"), M.col("e")).alias("rem_d"),
    M.Remainder(M.col("i"), M.col("d")).alias("rem_id"),
]
NULLS = lambda M, T: [  # noqa: E731
    M.EqualNullSafe(M.col("i"), M.col("j")).alias("ens_i"),
    M.EqualNullSafe(M.col("d"), M.col("e")).alias("ens_d"),
    M.EqualNullSafe(M.col("sd"), M.col("sp")).alias("ens_s"),
    M.EqualNullSafe(M.col("sd"), M.lit("bb")).alias("ens_lit"),
    M.EqualNullSafe(M.col("p"), M.col("w")).alias("ens_dec"),
    M.NullIf(M.col("i"), M.col("j")).alias("nullif_i"),
    M.NullIf(M.col("d"), M.lit(2.5)).alias("nullif_d"),
    M.NullIf(M.col("sd"), M.lit("bb")).alias("nullif_s"),
    M.Nvl2(M.col("i"), M.col("d"), M.col("e")).alias("nvl2_d"),
    M.Nvl2(M.col("flag"), M.col("l"), M.col("m")).alias("nvl2_l"),
    M.Nvl2(M.col("j"), M.col("sd"), M.col("sp")).alias("nvl2_s"),
    M.Greatest(M.col("i"), M.col("j"), M.col("l")).alias("greatest_il"),
    M.Least(M.col("i"), M.col("j")).alias("least_i"),
    M.Greatest(M.col("d"), M.col("e")).alias("greatest_d"),
    M.Least(M.col("d"), M.col("e"), M.col("f")).alias("least_d"),
    M.Greatest(M.col("p"), M.col("i")).alias("greatest_pi"),
    M.Least(M.col("p"), M.col("w")).alias("least_wide"),
    M.Greatest(M.col("w"), M.col("p")).alias("greatest_wide"),
]
ROUNDING = lambda M, T: [  # noqa: E731
    M.Floor(M.col("d")).alias("floor_d"),
    M.Ceil(M.col("d")).alias("ceil_d"),
    M.Floor(M.col("i")).alias("floor_i"),
    M.Ceil(M.col("f")).alias("ceil_f"),
    M.Rint(M.col("d")).alias("rint_d"),
    M.Rint(M.col("i")).alias("rint_i"),
    M.Round(M.col("i"), 2).alias("round_i"),
    M.BRound(M.col("l"), 1).alias("bround_l"),
] + [M.BRound(M.col(c), s).alias(f"bround_{c}{s}") for c in ("i", "b")
     for s in (-1, -2, -3)]
# Round and BRound of doubles (and Round of integers at a negative scale)
# are the reference's faults 14-15: their own tests hold Spark's answers
MATH = lambda M, T: [  # noqa: E731
    getattr(M, cls)(M.col("d")).alias(name) for cls, name in (
        ("Sqrt", "sqrt"), ("Cbrt", "cbrt"), ("Exp", "exp"),
        ("Expm1", "expm1"), ("Log", "log"), ("Log10", "log10"),
        ("Log2", "log2"), ("Log1p", "log1p"), ("Sin", "sin"),
        ("Cos", "cos"), ("Tan", "tan"), ("Cot", "cot"), ("Sec", "sec"),
        ("Csc", "csc"), ("Asin", "asin"), ("Acos", "acos"),
        ("Atan", "atan"), ("Sinh", "sinh"), ("Cosh", "cosh"),
        ("Tanh", "tanh"), ("Asinh", "asinh"), ("Acosh", "acosh"),
        ("Atanh", "atanh"), ("ToDegrees", "degrees"),
        ("ToRadians", "radians"), ("Signum", "signum"))] + [
    M.Sqrt(M.col("i")).alias("sqrt_i"),
    M.Log(M.col("l")).alias("log_l"),
    M.Exp(M.col("f")).alias("exp_f"),
    M.Signum(M.col("i")).alias("signum_i"),
    M.Atan2(M.col("d"), M.col("e")).alias("atan2"),
    M.Hypot(M.col("d"), M.col("e")).alias("hypot"),
    M.Pow(M.col("d"), M.col("e")).alias("pow"),
    M.Pow(M.col("j"), M.col("i")).alias("pow_i"),
    M.Factorial(M.col("i")).alias("factorial"),
    M.Factorial(M.col("j")).alias("factorial_j"),
    M.Positive(M.col("d")).alias("positive_d"),
    M.Positive(M.col("p")).alias("positive_p"),
]
BITWISE = lambda M, T: [  # noqa: E731
    M.BitwiseAnd(M.col("i"), M.col("j")).alias("and_i"),
    M.BitwiseOr(M.col("l"), M.col("m")).alias("or_l"),
    M.BitwiseXor(M.col("i"), M.col("l")).alias("xor_il"),
    M.BitwiseAnd(M.col("b"), M.col("h")).alias("and_bh"),
    M.BitwiseNot(M.col("l")).alias("not_l"),
    M.BitwiseNot(M.col("b")).alias("not_b"),
    M.BitCount(M.col("i")).alias("bitcount_i"),
    M.BitCount(M.col("l")).alias("bitcount_l"),
    M.BitCount(M.col("b")).alias("bitcount_b"),
    M.BitCount(M.col("flag")).alias("bitcount_flag"),
    M.BitGet(M.col("i"), M.col("sh")).alias("bitget_i"),
    M.BitGet(M.col("l"), M.col("sh")).alias("bitget_l"),
] + [getattr(M, cls)(M.col(c), M.col("sh")).alias(f"{cls}_{c}")
     for cls in ("ShiftLeft", "ShiftRight", "ShiftRightUnsigned")
     for c in ("i", "l")]
HASHES = lambda M, T: [  # noqa: E731
    M.Murmur3Hash(M.col("i")).alias("hash_i"),
    M.Murmur3Hash(M.col("l"), M.col("sd")).alias("hash_ls"),
    M.Murmur3Hash(M.col("sp")).alias("hash_plain"),
    M.Murmur3Hash(M.col("d"), M.col("f")).alias("hash_df"),
    M.Murmur3Hash(M.col("p"), M.col("flag"), M.col("dt")).alias("hash_pfd"),
    M.Murmur3Hash(M.col("b"), M.col("h"), M.col("j")).alias("hash_bhj"),
    M.XxHash64(M.col("i")).alias("xx_i"),
    M.XxHash64(M.col("sd"), M.col("sp"), M.col("d")).alias("xx_sd"),
    M.XxHash64(M.col("l"), M.col("m")).alias("xx_lm"),
]
FAMILIES = {"division": DIVISION, "nulls": NULLS, "rounding": ROUNDING,
            "math": MATH, "bitwise": BITWISE, "hashes": HASHES}
_JAX = {}


def _expected(family):
    if family not in _JAX:
        _JAX[family] = _jax(FAMILIES[family])
    return _JAX[family]


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_scalar_family_matches_jax(family, engine):
    check(_port(FAMILIES[family], engine), _expected(family))


def test_every_scalar_class_is_covered():
    names = set()
    for build in FAMILIES.values():
        for e in build(PE, PT):
            stack = [e]
            while stack:
                x = stack.pop()
                names.add(type(x).__name__)
                stack.extend(x.children)
    names |= {"Pmod", "Round", "Rand"}  # held by their own tests below
    missing = [c.__name__ for c in PE.SCALAR_FUNCTIONS
               if c.__name__ not in names]
    assert not missing, missing
    assert len(PE.SCALAR_FUNCTIONS) == 56


# ---------------------------------------------------------------------------
# Rand: the splitmix of (seed, row index) in one batch
# ---------------------------------------------------------------------------


def test_rand_is_bit_equal_to_the_reference_in_one_batch():
    from spark_rapids_tpu.exprs import eval as JEV
    from spark_rapids_tpu.columnar.batch import batch_from_arrow as jbatch
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.exprs import eval as PEV

    t = edge_table()
    jb = jbatch(t)
    jp = JEV.bind_projection([JE.Alias(JE.Rand(11), "r")],
                             JT.Schema.from_arrow(t.schema))
    exp = np.asarray(JEV.project_batch(jb, tuple(jp), False).columns[0].data
                     )[:t.num_rows]
    pb = batch_from_arrow(t, "cpu")
    pp = PEV.bind_projection([PE.Alias(PE.Rand(11), "r")],
                             PT.Schema.from_arrow(t.schema))
    got = PEV.project_batch(pb, pp).columns[0].data.numpy()
    assert np.array_equal(got, exp)
    assert ((got >= 0) & (got < 1)).all()
    # the CPU engine (where the planner places Rand) numbers the same rows
    rows = _port(lambda M, T: [M.Rand(11).alias("r")], "cpu_engine")
    assert [r["r"] for r in rows] == got.tolist()


def test_rand_is_placed_on_the_cpu_engine_with_the_reference_reason():
    df = port_from_arrow(edge_table(), device="cpu").select(
        PE.Rand(1).alias("r"))
    assert "expression Rand not on device" in df.explain()


# ---------------------------------------------------------------------------
# the CPU engine's cases: decimal division and rounding, with explain
# ---------------------------------------------------------------------------


def test_decimal_division_runs_on_the_cpu_engine_exactly():
    t = edge_table()
    exprs = lambda M, T: [  # noqa: E731
        M.IntegralDivide(M.col("p"), M.lit(D("0.3"))).alias("div"),
        M.Remainder(M.col("p"), M.col("i")).alias("rem"),
        M.Remainder(M.col("w"), M.lit(D("0.7"))).alias("rem_w")]
    ref = _jax(exprs)
    for engine in ENGINES:
        df = port_from_arrow(t, None if ENGINES[engine] is None
                             else RapidsConf(ENGINES[engine]), device="cpu")
        out = df.select(*exprs(PE, PT))
        if engine == "device":
            assert "decimal division not on device" in out.explain()
        check(out.collect(), ref)
    # Spark's answers, by Python's decimal
    ps = t.column("p").to_pylist()
    got = port_from_arrow(t, device="cpu").select(
        PE.Pmod(PE.col("p"), PE.lit(D("-0.7"))).alias("pm")).collect()
    for x, r in zip(ps, got):
        if x is None:
            assert r["pm"] is None
            continue
        rem = x.copy_abs() % D("0.7") * (1 if x >= 0 else -1)
        want = (rem - D("0.7")) % D("0.7") if rem < 0 else rem
        assert r["pm"] == want, (x, r)


def _spark_round(x: float, scale: int, mode) -> float:
    """Spark's round/bround of a double: its shortest decimal text rounded
    at ``scale``."""
    if math.isnan(x) or math.isinf(x):
        return x
    q = D(repr(x)).quantize(D(1).scaleb(-scale), rounding=mode)
    return float(q)


def test_decimal_rounding_runs_on_the_cpu_engine_spark_exact():
    t = edge_table()
    builds = []
    for s in (-2, -1, 0, 1, 2, 3):
        builds += [PE.Round(PE.col("p"), s).alias(f"round_{s}"),
                   PE.BRound(PE.col("p"), s).alias(f"bround_{s}"),
                   PE.Round(PE.col("w"), s).alias(f"wround_{s}")]
    builds += [PE.Floor(PE.col("p")).alias("floor"),
               PE.Ceil(PE.col("p")).alias("ceil"),
               PE.Floor(PE.col("w")).alias("wfloor")]
    for engine in ENGINES:
        df = port_from_arrow(t, None if ENGINES[engine] is None
                             else RapidsConf(ENGINES[engine]), device="cpu")
        out = df.select(*builds)
        if engine == "device":
            assert "decimal floor/ceil/round not on device" in out.explain()
        rows = out.collect()
        for col_name, src in (("", "p"), ("w", "w")):
            for x, r in zip(t.column(src).to_pylist(), rows):
                for s in (-2, -1, 0, 1, 2, 3):
                    keys = ([f"{col_name}round_{s}"] if col_name
                            else [f"round_{s}", f"bround_{s}"])
                    for k in keys:
                        mode = (decimal.ROUND_HALF_EVEN if k.startswith("b")
                                else decimal.ROUND_HALF_UP)
                        want = (None if x is None else
                                x.quantize(D(1).scaleb(-max(s, 0)),
                                           rounding=mode)
                                if s >= 0 else
                                (x.scaleb(s).quantize(D(1), rounding=mode)
                                 .scaleb(-s)))
                        assert r[k] == want, (k, x, r[k], want)
        for x, r in zip(t.column("p").to_pylist(), rows):
            if x is None:
                assert r["floor"] is None and r["ceil"] is None
                continue
            assert r["floor"] == D(math.floor(x))
            assert r["ceil"] == D(math.ceil(x))
    sch = port_from_arrow(t, device="cpu").select(*builds).schema
    assert sch["floor"].dtype == PT.DecimalType(6, 0)
    assert sch["round_1"].dtype == PT.DecimalType(7, 1)
    assert sch["round_-1"].dtype == PT.DecimalType(6, 0)


# ---------------------------------------------------------------------------
# reference faults (ROADMAP queue 3): the port gives Spark's answer
# ---------------------------------------------------------------------------


def _java_rem(x, y):
    r = abs(x) % abs(y)
    return -r if x < 0 else r


def _wrap(v, bits):
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= 1 << (bits - 1) else v


@pytest.mark.parametrize("engine", list(ENGINES))
def test_pmod_is_sparks_where_the_reference_adds_the_divisor(engine):
    t = edge_table()
    build = lambda M, T: [  # noqa: E731
        M.Pmod(M.col("i"), M.col("j")).alias("pmod_i"),
        M.Pmod(M.col("l"), M.col("m")).alias("pmod_l"),
        M.Pmod(M.col("d"), M.col("e")).alias("pmod_d")]
    got, ref = _port(build, engine), _jax(build)
    seen_fault = 0
    cols = {c: t.column(c).to_pylist() for c in ("i", "j", "l", "m", "d",
                                                  "e")}
    for r, (g, x) in enumerate(zip(got, ref)):
        for k, a, b, bits in (("pmod_i", "i", "j", 32),
                              ("pmod_l", "l", "m", 64)):
            a, b = cols[a][r], cols[b][r]
            if a is None or b is None or b == 0:
                assert g[k] is None and x[k] is None
                continue
            rem = _java_rem(a, b)
            spark = (_java_rem(_wrap(rem + b, bits), b) if rem < 0 else rem)
            reference = _java_rem(_wrap(rem + b, bits), b)
            assert g[k] == spark, (k, a, b, g[k], spark)
            assert x[k] == reference, (k, a, b, x[k], reference)
            seen_fault += spark != reference
        a, b = cols["d"][r], cols["e"][r]
        if a is None or b is None or b == 0 or math.isnan(b):
            assert g["pmod_d"] is None
            continue
        with np.errstate(invalid="ignore"):
            rem = float(np.fmod(a, b))
            spark = float(np.fmod(rem + b, b)) if rem < 0 else rem
        assert same(g["pmod_d"], spark, "pmod_d"), (a, b, g, spark)
    assert seen_fault >= 3  # 5 pmod -3 is 2 in Spark, -1 in the reference


def test_round_of_a_double_rounds_its_decimal_text():
    """round(1.005, 2) is 1.01 in Spark (BigDecimal(d) reads Double.
    toString); the reference scales the binary value and gives 1.0."""
    rng = np.random.default_rng(3)
    vals = ([1.005, 2.675, 1.115, -1.005, 0.285, 1.0049999999999999,
             1234.5675, 0.5, 2.5, -2.5, 1e-7, 9007199254740993.0, 123.456,
             float("nan"), float("inf"), -0.0]
            + [float(f"{x:.3f}") for x in rng.uniform(-100, 100, 300)]
            + [float(f"{x:.6f}") for x in rng.uniform(-1, 1, 200)])
    t = pa.table({"x": pa.array(vals, pa.float64()),
                  "y": pa.array(vals, pa.float32())})
    scales = (-2, -1, 0, 1, 2, 3, 5)
    build = lambda M, T: (  # noqa: E731
        [M.Round(M.col("x"), s).alias(f"r{s}") for s in scales]
        + [M.BRound(M.col("x"), s).alias(f"b{s}") for s in scales]
        + [M.Round(M.col("y"), 2).alias("f2"),
           M.BRound(M.col("y"), 1).alias("fb1")])
    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1
    ref = jdf.select(*build(JE, JT)).collect()
    differs = 0
    for engine in ENGINES:
        rows = _port(build, engine, t)
        for v, r, x in zip(vals, rows, ref):
            for s in scales:
                up = _spark_round(v, s, decimal.ROUND_HALF_UP)
                even = _spark_round(v, s, decimal.ROUND_HALF_EVEN)
                assert same(r[f"r{s}"], up, "r"), (v, s, r[f"r{s}"], up)
                assert same(r[f"b{s}"], even, "b"), (v, s, r[f"b{s}"], even)
                if engine == "device":
                    differs += not same(x[f"r{s}"], up, "r")
            f = float(np.float32(v))
            if not (math.isnan(f) or math.isinf(f)):
                want = float(np.float32(float(D(str(np.float32(v))).quantize(
                    D("0.01"), rounding=decimal.ROUND_HALF_UP))))
                assert r["f2"] == want, (v, r["f2"], want)
    assert differs > 0
    # round(1.005, 2): the reference's 1.0 against Spark's 1.01
    assert ref[0]["r2"] == 1.0 and _port(build, "device", t)[0]["r2"] == 1.01


def test_round_of_a_bigint_at_a_negative_scale_stays_exact():
    """The reference goes through a double: past 2^53 it loses digits, and
    it saturates where Spark's ``BigDecimal.longValue`` wraps."""
    vals = [BIG, -BIG, 15, -15, 25, 2 ** 62 + 5, I64[1], I64[0], None]
    t = pa.table({"l": pa.array(vals, pa.int64())})
    build = lambda M, T: [M.Round(M.col("l"), -1).alias("r"),  # noqa: E731
                          M.BRound(M.col("l"), -1).alias("b")]
    wide = lambda M, T: [M.Round(M.col("l"), -19).alias("r19"),  # noqa
                         M.BRound(M.col("l"), -19).alias("b19"),
                         M.Round(M.col("l"), -20).alias("r20")]
    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1
    ref = jdf.select(*build(JE, JT)).collect()
    # the reference: through a double, saturating at the ends
    assert [ref[k]["r"] for k in (5, 6, 7)] == [4611686018427387904,
                                                 I64[1], I64[0]]
    for engine in ENGINES:
        rows = _port(build, engine, t)
        for v, r in zip(vals, rows):
            if v is None:
                assert r["r"] is None
                continue
            up = D(v).quantize(D("1E1"), rounding=decimal.ROUND_HALF_UP)
            even = D(v).quantize(D("1E1"), rounding=decimal.ROUND_HALF_EVEN)
            assert r["r"] == _wrap(int(up), 64), (v, r)
            assert r["b"] == _wrap(int(even), 64), (v, r)
        assert rows[0]["r"] == 9007199254740990
        # past 18 digits the multiples are 0 and +-10**19, wrapped
        for v, r in zip(vals, _port(wide, engine, t)):
            if v is None:
                continue
            for k, mode in (("r19", decimal.ROUND_HALF_UP),
                            ("b19", decimal.ROUND_HALF_EVEN)):
                want = D(v).quantize(D("1E19"), rounding=mode)
                assert r[k] == _wrap(int(want), 64), (v, k, r[k])
            assert r["r20"] == 0
        assert [rows[k]["r"] for k in (5, 6, 7)] == [
            4611686018427387910, -9223372036854775806, 9223372036854775806]


def test_the_math_family_reads_a_decimal_as_its_value():
    """Spark reads a decimal as its double; the reference reads the
    unscaled integer (sqrt(1.44) is 12 there)."""
    t = pa.table({"p": pa.array([D("1.44"), D("100.00"), None],
                                pa.decimal128(7, 2))})
    build = lambda M, T: [M.Sqrt(M.col("p")).alias("sqrt"),  # noqa: E731
                          M.Log10(M.col("p")).alias("log10")]
    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1
    ref = jdf.select(*build(JE, JT)).collect()
    assert same(ref[0]["sqrt"], 12.0, "sqrt")
    for engine in ENGINES:
        rows = _port(build, engine, t)
        assert same(rows[0]["sqrt"], 1.2, "sqrt")
        assert same(rows[1]["log10"], 2.0, "log10")
        assert rows[2]["sqrt"] is None


def test_decimal_bround_and_round_on_the_reference_cpu_engine():
    """The reference's CPU engine scales a decimal BRound's result by
    10**scale once too often and leaves a decimal Round unrounded (it
    rounds the unscaled value as a double); its Floor/Ceil keep the input
    type. The port gives Spark's values and types."""
    t = pa.table({"p": pa.array([D("1.25"), D("-2.35")],
                                pa.decimal128(7, 2))})
    build = lambda M, T: [M.BRound(M.col("p"), 1).alias("b"),  # noqa: E731
                          M.Round(M.col("p"), 1).alias("r"),
                          M.Floor(M.col("p")).alias("f")]
    from spark_rapids_tpu.config.conf import RapidsConf as JConf
    jdf = jax_from_arrow(t, JConf({"spark.rapids.tpu.sql.enabled": "false"}))
    jdf.shuffle_partitions = 1
    ref = jdf.select(*build(JE, JT))
    rows = ref.collect()
    assert rows[0]["b"] == D("12.0")   # the reference: 10x
    assert rows[0]["r"] == D("1.25")   # unrounded
    assert ref.schema["f"].dtype == JT.DecimalType(7, 2)
    got = _port(build, "cpu_engine", t)
    assert [r["b"] for r in got] == [D("1.2"), D("-2.4")]
    assert [r["r"] for r in got] == [D("1.3"), D("-2.4")]
    assert [r["f"] for r in got] == [D("1"), D("-3")]


# ---------------------------------------------------------------------------
# known differences by design
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", list(ENGINES))
def test_integral_divide_casts_a_fraction_to_bigint_first(engine):
    """Spark's implicit cast: 7.9 div 0.5 is 7 div 0, null; the reference
    divides by the truncated 0 as if by 1."""
    t = pa.table({"x": pa.array([7.9, -7.9, 9.0, None]),
                  "y": pa.array([0.5, 2.5, -2.0, 1.0])})
    rows = _port(lambda M, T: [M.IntegralDivide(M.col("x"), M.col("y"))
                               .alias("q")], engine, t)
    assert [r["q"] for r in rows] == [None, -3, -4, None]


@pytest.mark.parametrize("engine", list(ENGINES))
def test_narrow_shifts_are_int_shifts(engine):
    t = pa.table({"b": pa.array([1, -128, 64], pa.int8()),
                  "n": pa.array([10, 1, 33], pa.int32())})
    df = port_from_arrow(t, None if ENGINES[engine] is None
                         else RapidsConf(ENGINES[engine]), device="cpu")
    out = df.select(PE.ShiftLeft(PE.col("b"), PE.col("n")).alias("s"),
                    PE.ShiftRightUnsigned(PE.col("b"), PE.col("n"))
                    .alias("u"))
    assert out.schema["s"].dtype == PT.INT
    rows = out.collect()
    assert [r["s"] for r in rows] == [1024, -256, 128]
    assert [r["u"] for r in rows] == [0, 2147483584, 32]
