"""The port's TINYINT, SMALLINT, FLOAT and TIMESTAMP, held against the JAX
package on the CPU:

- Arrow round trips of each type (a ``timestamp[ms]`` column reads as
  microseconds) through the device path and the CPU engine, and through
  a spill to host and disk;
- the whole cast matrix among BOOLEAN, TINYINT, SMALLINT, INT, BIGINT,
  FLOAT, DOUBLE, DECIMAL64, DECIMAL128, DATE and TIMESTAMP (each pair the
  port has, ``E.cast_supported``; every other pair raises naming it), and
  the narrow types' arithmetic (TINYINT + TINYINT stays TINYINT and wraps,
  an integral operand of a decimal is decimal(3, 0) or (5, 0)), against
  the JAX device path on both of the port's engines;
- a DATE compared with a TIMESTAMP (the date as its midnight);
- sort order, group keys (Sum, Average, Min, Max, Count), join keys,
  hash partition ids and kudo bytes of each type against the reference's.

Tolerance: integers, decimals, dates and timestamps bit-equal; doubles
and floats within the equivalence bar's relative 1e-6 (the reference's
compiled path divides a decimal by 10**scale as a multiplication by the
reciprocal, an ulp from the port's division), and a FLOAT group Sum or
Average, added in float64 in another order, within relative 1e-12.

Two differences from the reference are held as such: an integer or
DECIMAL64 rescaled into a DECIMAL64 past int64 is null in the port
(Spark's overflow) where the reference's int64 product wraps; and the
reference's CPU path flushes subnormal floats to zero (XLA's CPU
defaults), so the inputs hold no subnormal.
"""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu.shuffle import partition as JP
from spark_rapids_tpu.shuffle import serializer as JS
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.mem import pool as PPOOL
from spark_rapids_tpu_torch.mem import spill as PSPILL
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.shuffle import partition as PP
from spark_rapids_tpu_torch.shuffle import serializer as PS
from test_torch_datetime import ENGINES, _storage, assert_bit_equal

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

US = 1_000_000


def _typed(n: int = 400, seed: int = 5, nulls: bool = True) -> pa.Table:
    """The new types with their edges, and one column of every other
    scalar type for the cast matrix."""
    rng = np.random.default_rng(seed)

    def mask():
        return (rng.random(n) < 0.1) if nulls else None

    b = rng.integers(-128, 128, n).astype(np.int8)
    b[:4] = [-128, 127, 0, -1]
    h = rng.integers(-2**15, 2**15, n).astype(np.int16)
    h[:4] = [-2**15, 2**15 - 1, 0, 300]
    f = (rng.normal(0, 1e3, n) * 10.0 ** rng.integers(-3, 8, n)).astype(
        np.float32)
    f[:10] = [np.nan, np.inf, -np.inf, -0.0, 0.0, 3.4e38, -3.4e38, 2.5,
              -2.5, 1e-30]
    d = rng.normal(0, 1e9, n)
    d[:8] = [np.nan, np.inf, -np.inf, -0.0, 9.3e18, -9.3e18, 0.5, -0.5]
    ts = rng.integers(-4 * 10**15, 4 * 10**15, n)
    ts[:4] = [0, -1, -86_400 * US, 1_700_000_000 * US + 999_999]
    return pa.table({
        "b": pa.array(b, mask=mask()),
        "h": pa.array(h, mask=mask()),
        "f": pa.array(f, mask=mask()),
        "t": pa.array(ts, pa.int64(), mask=mask()).cast(
            pa.timestamp("us", tz="UTC")),
        "z": pa.array(rng.random(n) < 0.5, mask=mask()),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=mask()),
        "l": pa.array(rng.integers(-2**62, 2**62, n)
                      // 10 ** rng.integers(0, 18, n), mask=mask()),
        "d": pa.array(d, mask=mask()),
        "m": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                       for v in rng.integers(-10**8, 10**8, n)],
                      pa.decimal128(9, 2), mask=mask()),
        "w": pa.array([decimal.Decimal(int(v) * 1000 + 7).scaleb(-3)
                       for v in rng.integers(-10**16, 10**16, n)],
                      pa.decimal128(25, 3)),
        "dt": pa.array(rng.integers(-40000, 40000, n).astype(np.int32),
                       mask=mask()).cast(pa.date32()),
    })


SOURCES = {"z": "BOOLEAN", "b": "BYTE", "h": "SHORT", "i": "INT",
           "l": "LONG", "f": "FLOAT", "d": "DOUBLE", "m": "dec(9,2)",
           "w": "dec(25,3)", "dt": "DATE", "t": "TIMESTAMP"}


def _targets(T):
    return {"BOOLEAN": T.BOOLEAN, "BYTE": T.BYTE, "SHORT": T.SHORT,
            "INT": T.INT, "LONG": T.LONG, "FLOAT": T.FLOAT,
            "DOUBLE": T.DOUBLE, "dec(5,1)": T.DecimalType(5, 1),
            "dec(9,2)": T.DecimalType(9, 2),
            "dec(18,6)": T.DecimalType(18, 6),
            "dec(25,3)": T.DecimalType(25, 3),
            "dec(30,8)": T.DecimalType(30, 8), "DATE": T.DATE,
            "TIMESTAMP": T.TIMESTAMP}


def _src_type(c):
    return PT.Schema.from_arrow(_typed().schema)[c].dtype


def _pairs(c):
    src = _src_type(c)
    return [(name, dst) for name, dst in _targets(PT).items()
            if dst != src and PE.cast_supported(src, dst)]


def _port(table, exprs, engine):
    conf = ENGINES[engine]
    df = port_from_arrow(table, None if conf is None else RapidsConf(conf),
                         device="cpu")
    out = df.select(*exprs)
    if engine == "device":
        assert "!" not in out.explain()  # every node on the device path
    return out.to_arrow()


def _jax(table, exprs):
    df = jax_from_arrow(table)
    df.shuffle_partitions = 1
    return df.select(*exprs).to_arrow()


@pytest.mark.parametrize("engine", list(ENGINES))
def test_arrow_round_trip_of_each_type(engine):
    """int8, int16, float32, timestamp[us, UTC] and timestamp[ms] in and
    back out, the same types and values (the ms column as microseconds),
    through a projection and a filter that touch every row."""
    t = _typed().select(["b", "h", "f", "t"])
    t = t.append_column("tm", pa.array(
        np.arange(t.num_rows) * 1_234_567 - 10**8, pa.int64()).cast(
        pa.timestamp("ms")))
    conf = ENGINES[engine]
    df = port_from_arrow(t, None if conf is None else RapidsConf(conf),
                         device="cpu")
    out = df.filter(PE.IsNotNull(PE.col("t")) | PE.IsNull(PE.col("t"))
                    ).select(*[PE.col(c) for c in t.column_names],
                             PE.Alias(PE.col("b"), "b2")).to_arrow()
    assert [f.type for f in out.schema][:4] == [f.type for f in t.schema][:4]
    assert out.schema.field("tm").type == pa.timestamp("us", tz="UTC")
    for c in ("b", "h", "f", "t"):
        assert np.array_equal(_storage(out[c].combine_chunks()),
                              _storage(t[c].combine_chunks()))
        assert out[c].null_count == t[c].null_count
    ms = np.asarray(t["tm"].cast(pa.int64()))
    assert np.array_equal(np.asarray(out["tm"].cast(pa.int64())),
                          ms * 1000)
    # the device batch holds the types' own dtypes, nulls zeroed
    b = PB.batch_from_arrow(t, "cpu")
    assert [c.data.dtype for c in b.columns] == [
        torch.int8, torch.int16, torch.float32, torch.int64, torch.int64]
    for c in b.columns:
        assert not c.data[~c.validity].bool().any()


@pytest.mark.parametrize("tier", ["HOST", "DISK"])
def test_spill_round_trip_of_a_typed_batch(tier, tmp_path):
    """A batch of the new types spilled to host (and on to disk) comes
    back equal, and its handle accounts each type's element size."""
    t = _typed(3000, 6).select(["b", "h", "f", "t", "dt"])
    batch = PB.batch_from_arrow(t, "cpu")
    expect = sum(c.data.numel() * c.data.element_size()
                 + c.validity.numel() for c in batch.columns)
    assert expect == 3000 * (1 + 2 + 4 + 8 + 4 + 5)
    pool = PPOOL.HbmPool(1 << 30)
    fw = PSPILL.SpillFramework(pool, host_limit_bytes=1 if tier == "DISK"
                               else 1 << 30, spill_dir=str(tmp_path),
                               chunk_bytes=4096)
    h = PSPILL.SpillableBatch(batch, fw)
    assert h.nbytes == expect == PSPILL.batch_nbytes(batch)
    assert fw.spill_device_bytes(1) == expect and h.state == tier
    with h as back:
        assert [c.data.dtype for c in back.columns] == [
            c.data.dtype for c in batch.columns]
        out = PB.batch_to_arrow(back, PT.Schema.from_arrow(t.schema))
    assert_bit_equal(out, t)  # NaN included
    h.close()
    assert pool.used == 0


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("src", list(SOURCES))
def test_cast_matrix_matches_jax(src, engine):
    """Every cast the port has from one source type, bit-equal to the JAX
    device path (nulls and NaNs included)."""
    t = _typed()
    pairs = _pairs(src)
    assert pairs
    jt = _targets(JT)
    exp = _jax(t, [JE.Alias(JE.Cast(JE.col(src), jt[n]), n)
                   for n, _ in pairs])
    got = _port(t, [PE.Alias(PE.Cast(PE.col(src), d), n)
                    for n, d in pairs], engine)
    wraps = _reference_rescale_wraps(t, src, pairs)
    assert_bit_equal(got, exp, rel=1e-6, skip=wraps)
    for n, rows in wraps.items():
        assert not np.asarray(got[n].is_valid())[rows].any(), n


def _reference_rescale_wraps(t, src, pairs):
    """{target: rows} where the reference's int64 rescale of an integer
    or DECIMAL64 into a DECIMAL64 wraps (the exact value is past int64;
    the port's result is null there)."""
    st = _src_type(src)
    if not (st in PT.INTEGRAL_TYPES or (isinstance(st, PT.DecimalType)
                                        and not st.is_wide)):
        return {}
    col = t[src].combine_chunks()
    vals = [int(v) for v in (_storage(col)[:, 0] if col.type.id ==
                             pa.decimal128(1, 0).id else _storage(col))]
    out = {}
    for n, d in pairs:
        if isinstance(d, PT.DecimalType) and not d.is_wide:
            k = d.scale - getattr(st, "scale", 0)
            rows = [i for i, v in enumerate(vals)
                    if k > 0 and abs(v * 10 ** k) >= 2 ** 63]
            if rows:
                out[n] = np.array(rows)
    return out


@pytest.mark.parametrize("engine", list(ENGINES))
def test_casts_the_port_does_not_have_raise_naming_them(engine):
    t = _typed(20)
    conf = ENGINES[engine]
    df = port_from_arrow(t, None if conf is None else RapidsConf(conf),
                         device="cpu")
    refused = [(c, dst) for c in SOURCES
               for dst in list(_targets(PT).values()) + [PT.STRING]
               if dst != _src_type(c)
               and not PE.cast_supported(_src_type(c), dst)]
    assert ("i", PT.DATE) in refused and ("d", PT.TIMESTAMP) in refused
    for c, dst in refused:
        with pytest.raises(NotImplementedError, match="cast"):
            df.select(PE.Cast(PE.col(c), dst).alias("x")).collect()


ARITH = {
    "byte_plus_byte": lambda M, T: M.Add(M.col("b"), M.col("b")),
    "byte_times_byte": lambda M, T: M.Multiply(M.col("b"), M.col("b")),
    "short_minus_short": lambda M, T: M.Subtract(
        M.col("h"), M.Multiply(M.col("h"), M.lit(3, T.SHORT))),
    "byte_plus_short": lambda M, T: M.Add(M.col("b"), M.col("h")),
    "short_plus_int": lambda M, T: M.Add(M.col("h"), M.col("i")),
    "neg_byte": lambda M, T: M.UnaryMinus(M.col("b")),
    "abs_short": lambda M, T: M.Abs(M.col("h")),
    "byte_plus_decimal": lambda M, T: M.Add(M.col("b"), M.col("m")),
    "short_times_decimal": lambda M, T: M.Multiply(M.col("h"), M.col("m")),
    "byte_vs_decimal": lambda M, T: M.LessThan(M.col("b"), M.col("m")),
    "float_plus_float": lambda M, T: M.Add(M.col("f"), M.col("f")),
    "float_times_double": lambda M, T: M.Multiply(M.col("f"), M.col("d")),
    "float_plus_decimal": lambda M, T: M.Add(M.col("f"), M.col("m")),
    "float_div_byte": lambda M, T: M.Divide(M.col("f"), M.col("b")),
    "float_eq_literal": lambda M, T: M.EqualTo(M.col("f"), M.lit(2.5)),
    "float_lt_float": lambda M, T: M.LessThan(M.col("f"), M.UnaryMinus(
        M.col("f"))),
    "date_gt_timestamp": lambda M, T: M.GreaterThan(M.col("dt"),
                                                    M.col("t")),
    "timestamp_eq_date": lambda M, T: M.EqualTo(
        M.col("t"), M.col("dt")),
    "timestamp_lt_literal": lambda M, T: M.LessThan(
        M.col("t"), M.lit(datetime.datetime(1990, 5, 1, 12, 30,
                                            tzinfo=datetime.timezone.utc),
                          T.TIMESTAMP)),
    "byte_in": lambda M, T: M.In(M.col("b"), [M.lit(-128, T.BYTE),
                                              M.lit(5, T.BYTE)]),
    "coalesce_float": lambda M, T: M.Coalesce(M.col("f"),
                                              M.lit(-1.0, T.FLOAT)),
}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_narrow_type_arithmetic_matches_jax(engine):
    """Spark's numeric rules over the narrow types: TINYINT + TINYINT stays
    TINYINT and wraps (-128 appears), TINYINT and SMALLINT meet a decimal
    as decimal(3, 0) and decimal(5, 0), a FLOAT meets a DOUBLE or a
    decimal as a double; comparisons of each, a date against a timestamp
    (its midnight) and a timestamp literal."""
    t = _typed()
    exp = _jax(t, [JE.Alias(f(JE, JT), n) for n, f in ARITH.items()])
    got = _port(t, [PE.Alias(f(PE, PT), n) for n, f in ARITH.items()],
                engine)
    # a zero divisor: null in the port (Spark's non-ANSI Divide), IEEE
    # inf/NaN in the reference (a known difference, ROADMAP queue 3)
    zero = np.flatnonzero(np.asarray(t["b"].fill_null(1)) == 0)
    assert len(zero)
    assert_bit_equal(got, exp, rel=1e-6, skip={"float_div_byte": zero})
    assert not np.asarray(got["float_div_byte"].is_valid())[zero].any()
    bb = got["byte_plus_byte"]
    assert bb.type == pa.int8() and -128 in bb.to_pylist()
    assert got["byte_plus_decimal"].type == pa.decimal128(10, 2)
    assert got["short_times_decimal"].type == pa.decimal128(15, 2)


def test_timestamp_literal_inference():
    """A datetime.datetime literal is a TIMESTAMP (naive means UTC) and a
    datetime.date a DATE."""
    lit = PE.lit(datetime.datetime(1969, 12, 31, 23, 59, 59, 999999))
    assert lit.dtype == PT.TIMESTAMP and lit.value == -1
    aware = PE.lit(datetime.datetime(2000, 1, 1, 1, tzinfo=datetime.timezone(
        datetime.timedelta(hours=1))))
    assert aware.value == 946_684_800 * US
    d = PE.lit(datetime.date(1969, 12, 31))
    assert d.dtype == PT.DATE and d.value == -1


def _sorted_rows(tbl: pa.Table):
    return sorted(tbl.to_pylist(), key=repr)


@pytest.mark.parametrize("key", ["b", "h", "f", "t"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_sort_order_matches_jax(key, engine):
    """ORDER BY each new type, ascending and descending, with Spark's null
    and NaN order: the permuted rows equal the reference's, row for row
    (a second key makes the order total)."""
    t = _typed(500, 8)
    for asc in (True, False):
        jdf = jax_from_arrow(t)
        jdf.shuffle_partitions = 1
        from spark_rapids_tpu.exec.sort import SortOrder as JO
        from spark_rapids_tpu_torch.exec.sort import SortOrder as PO

        exp = jdf.sort(JO(JE.col(key), asc), JO(JE.col("l"))).to_arrow()
        conf = ENGINES[engine]
        pdf = port_from_arrow(t, None if conf is None else RapidsConf(conf),
                              device="cpu")
        got = pdf.sort(PO(PE.col(key), asc), PO(PE.col("l"))).to_arrow()
        assert_bit_equal(got.select([key, "l"]), exp.select([key, "l"]))


def _agg_exprs(M, key):
    return [M.Alias(M.Count(), "n"), M.Alias(M.Sum(M.col("b")), "sb"),
            M.Alias(M.Sum(M.col("h")), "sh"), M.Alias(M.Sum(M.col("f")),
                                                        "sf"),
            M.Alias(M.Average(M.col("b")), "ab"),
            M.Alias(M.Average(M.col("f")), "af"),
            M.Alias(M.Min(M.col("b")), "minb"),
            M.Alias(M.Max(M.col("h")), "maxh"),
            M.Alias(M.Min(M.col("f")), "minf"),
            M.Alias(M.Max(M.col("f")), "maxf"),
            M.Alias(M.Min(M.col("t")), "mint"),
            M.Alias(M.Max(M.col("t")), "maxt"),
            M.Alias(M.Count(M.col("t")), "nt")]


@pytest.mark.parametrize("key", ["b", "h", "f", "t"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_group_keys_and_aggregates_match_jax(key, engine):
    """GROUP BY each new type (NaN one group, -0.0 with 0.0, null one
    group): Sum of TINYINT/SMALLINT is BIGINT, of FLOAT a DOUBLE added in
    float64 (relative 1e-12 against the reference's order), Average a
    DOUBLE, Min/Max keep the type (FLOAT NaN largest), Count."""
    rng = np.random.default_rng(9)
    t = _typed(700, 9)
    # few distinct keys, so groups hold many rows
    keys = {"b": pa.array(rng.integers(-3, 3, 700).astype(np.int8)),
            "h": pa.array(rng.integers(-3, 3, 700).astype(np.int16)),
            "f": pa.array(np.array([np.nan, -0.0, 0.0, 1.5, -2.5],
                                   np.float32)[rng.integers(0, 5, 700)],
                          mask=rng.random(700) < 0.1),
            "t": pa.array(rng.integers(-3, 3, 700) * 3_600 * US,
                          pa.int64()).cast(pa.timestamp("us", tz="UTC"))}
    t = t.append_column("k", keys[key])
    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1
    exp = jdf.group_by("k").agg(*_agg_exprs(JE, key)).to_arrow()
    conf = ENGINES[engine]
    pdf = port_from_arrow(t, None if conf is None else RapidsConf(conf),
                          device="cpu")
    got = pdf.group_by("k").agg(*_agg_exprs(PE, key)).to_arrow()
    assert got.schema.types == exp.schema.types
    assert [f.type for f in got.schema][2:4] == [pa.int64(), pa.int64()]
    order_g = np.lexsort([_storage(got["k"].combine_chunks()),
                          np.asarray(got["k"].is_valid())])
    order_e = np.lexsort([_storage(exp["k"].combine_chunks()),
                          np.asarray(exp["k"].is_valid())])
    got, exp = got.take(order_g), exp.take(order_e)
    inexact = ("sf", "af", "ab")
    assert_bit_equal(got.drop(list(inexact)), exp.drop(list(inexact)))
    for c in inexact:
        a = np.asarray(got[c].fill_null(0.0), np.float64)
        b = np.asarray(exp[c].fill_null(0.0), np.float64)
        assert np.array_equal(np.isnan(a), np.isnan(b)), c
        ok = ~np.isnan(a)
        np.testing.assert_allclose(a[ok], b[ok], rtol=1e-12, err_msg=c)


@pytest.mark.parametrize("key", ["b", "h", "f", "t"])
@pytest.mark.parametrize("how", ["inner", "left_anti"])
def test_join_keys_match_jax(key, how):
    """An equi-join on each new type (NaN joins NaN, -0.0 joins 0.0, null
    joins nothing) through the port's device path, as the reference."""
    rng = np.random.default_rng(10)
    t = _typed(300, 10).select([key, "l"])
    right = t.slice(0, 120).rename_columns([key, "r"])
    right = right.set_column(1, "r", pa.array(rng.integers(0, 9, 120)))
    if key == "f":
        extra = pa.table({key: pa.array([np.nan, -0.0], pa.float32()),
                          "r": pa.array([100, 101])})
        right = pa.concat_tables([right, extra])
        t = pa.concat_tables([t, pa.table({
            key: pa.array([np.nan, 0.0], pa.float32()),
            "l": pa.array([1, 2])})])
    jl, jr = jax_from_arrow(t), jax_from_arrow(right)
    jl.shuffle_partitions = jr.shuffle_partitions = 1
    exp = jl.join(jr, on=key, how=how).to_arrow()
    got = port_from_arrow(t, device="cpu").join(
        port_from_arrow(right, device="cpu"), on=key, how=how).to_arrow()
    assert got.num_rows == exp.num_rows and got.num_rows > 0
    assert _sorted_rows(got.select(["l"] + (["r"] if how == "inner" else [])
                                   )) == _sorted_rows(
        exp.select(["l"] + (["r"] if how == "inner" else [])))


def _key_batches(t):
    return (JB.batch_from_arrow(t), PB.batch_from_arrow(t, "cpu"))


@pytest.mark.parametrize("n", [1, 4, 7])
@pytest.mark.parametrize("cols", [[0], [1], [2], [3], [0, 3], [2, 1]])
def test_hash_partition_ids_equal_the_reference(cols, n):
    t = _typed(600, 12).select(["b", "h", "f", "t"])
    jb, pb = _key_batches(t)
    exp = np.asarray(JP.HashPartitioner(cols, n).partition_ids(jb))[
        : t.num_rows].astype(np.int64)
    got = PP.HashPartitioner(cols, n).partition_ids(pb).numpy()
    assert np.array_equal(exp, got)


@pytest.mark.parametrize("col", [2, 3])
@pytest.mark.parametrize("ascending", [True, False])
def test_range_partition_ids_equal_the_reference(col, ascending):
    """The range partitioner over FLOAT and TIMESTAMP keys (bounds from a
    sample of the column's own values)."""
    t = _typed(600, 13).select(["b", "h", "f", "t"])
    pb = PB.batch_from_arrow(t, "cpu")
    c = pb.columns[col]
    sample = c.data[c.validity].double().numpy()
    sample = sample[np.isfinite(sample)]
    jp = JP.RangePartitioner.from_sample(sample, 5, col, ascending)
    pp = PP.RangePartitioner.from_sample(sample, 5, col, ascending)
    exp = np.asarray(jp.partition_ids(JB.batch_from_arrow(t)))[
        : t.num_rows].astype(np.int64)
    got = pp.partition_ids(pb).numpy()
    assert np.array_equal(exp, got) and len(set(got.tolist())) > 2


@pytest.mark.parametrize("codec", ["none", "zlib", "lz4"])
@pytest.mark.parametrize("nulls", [False, True])
def test_kudo_bytes_equal_the_reference(codec, nulls):
    t = _typed(500, 14, nulls).select(["b", "h", "f", "t"])
    t = t.append_column("tm", pa.array(np.arange(500) * 7 - 99,
                                       pa.int64()).cast(pa.timestamp("ms")))
    for part in (t, t.slice(77, 200)):
        blob = PS.serialize_table(part, codec)
        assert blob == JS.serialize_table(part, codec)
        back, end = PS.deserialize_table(blob, PT.Schema.from_arrow(
            part.schema))
        assert end == len(blob)
        assert_bit_equal(back.select(["b", "h", "f", "t"]),
                         part.select(["b", "h", "f", "t"]))
        assert np.array_equal(np.asarray(back["tm"].cast(pa.int64())),
                              np.asarray(part["tm"].cast(pa.int64())) * 1000)
