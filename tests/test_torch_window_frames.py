"""The rest of the port's window surface (spark_rapids_tpu_torch.exec.window)
held against the JAX package's WindowExec (its device path, on the CPU) on
the same seeded tables, split into several batches: ntile, percent_rank,
cume_dist, lead/lag with and without a default, first/last, and Sum,
Count, Average, Min and Max over bounded ROWS frames (around, before and
after the current row, and with one side unbounded) and bounded RANGE
frames over an ascending integer order key with nulls and ties, and
partition keys that are plain (not dictionary-encoded) strings. Rows come
out partition-sorted on both sides and are compared row by row in order:
integers, decimals, strings and nulls exactly, doubles within 1e-9
relative (float sums of another order; the bar is 1e-6). DECIMAL128
sums, averages and first/last values over bounded ROWS and RANGE frames
are held against the JAX device path too. Then the port's CPU engine
against its device path over the same surface (lead/lag defaults over
every column kind, DECIMAL128 lead/lag among them), the min/max scans
through the segmented-scan wrapper, the reference's
First (the first non-null value, not Spark's default first) and the
group-by First/Last on both engines against the JAX package's CPU
engine."""

import decimal
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exec import BatchSourceExec as JSource
from spark_rapids_tpu.exec.sort import SortOrder as JOrd
from spark_rapids_tpu.exec.window import WindowExec as JWindow
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec import kernels as PK
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exec.window import WindowExec as PWindow
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import window as PW
from spark_rapids_tpu_torch.plan import from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

REL = 1e-9
DEC = decimal.Decimal


def _data(n=480, seed=11):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 10, n)
    v[rng.random(n) < 0.05] = np.nan
    v[rng.random(n) < 0.03] = -0.0
    names = [f"brand #{i:02d}" + "x" * int(i % 7 * 3) for i in range(40)]
    return pa.table({
        "g": pa.array(rng.integers(0, 5, n), pa.int64(),
                      mask=rng.random(n) < 0.04),
        "io": pa.array(rng.integers(0, 40, n).astype(np.int32), pa.int32(),
                       mask=rng.random(n) < 0.06),
        "v": pa.array(v, pa.float64(), mask=rng.random(n) < 0.08),
        "iv": pa.array(rng.integers(-500, 500, n), pa.int64(),
                       mask=rng.random(n) < 0.08),
        "dv": pa.array([DEC(int(x)).scaleb(-2) for x in
                        rng.integers(-10**6, 10**6, n)], pa.decimal128(7, 2),
                       mask=rng.random(n) < 0.08),
        "cat": pa.array(np.array(["Books", "Home", "Music", "Shoes"])[
            rng.integers(0, 4, n)].tolist(), pa.string()),
        "name": pa.array([names[i] for i in rng.integers(0, 40, n)],
                         pa.string(), mask=rng.random(n) < 0.03),
    })


def _sources(table, rows_per_batch, encode=True):
    """The table as JAX and port batch sources; ``encode`` false keeps the
    strings plain (not dictionary-encoded)."""
    t = JB.dictionary_encode_table(table, ["cat"]) if encode else table
    jcache, pcache = {}, {}
    slices = [t.slice(i, rows_per_batch)
              for i in range(0, max(t.num_rows, 1), rows_per_batch)]
    jb = [JB.batch_from_arrow(s, 16, dict_cache=jcache) for s in slices]
    pb = [PB.batch_from_arrow(s, "cpu", dict_cache=pcache) for s in slices]
    return (JSource([jb], JT.Schema.from_arrow(table.schema)),
            PSource([pb], PT.Schema.from_arrow(table.schema)))


def _rows(node, B):
    out = []
    for b in node.execute(0):
        out.extend(B.batch_to_arrow(b, node.output_schema).to_pylist())
    return out


def _assert_rows_equal(got, exp):
    assert len(got) == len(exp) and len(got) > 0
    assert list(got[0]) == list(exp[0])
    for rg, re_ in zip(got, exp):
        for k, vg in rg.items():
            ve = re_[k]
            if isinstance(vg, float) or isinstance(ve, float):
                assert vg is not None and ve is not None, (k, rg, re_)
                if math.isnan(ve):
                    assert math.isnan(vg), (k, rg, re_)
                else:
                    assert abs(vg - ve) <= REL * max(1.0, abs(ve)), (k, vg, ve)
            else:
                assert vg == ve, (k, rg, re_)


def _lag(W, child, offset=1, default=None):
    """Lag(child, offset, default). The reference's device Lag reads the
    row ``offset`` rows after, as Lead does (its WindowExec tests
    ``isinstance(f, Lead)``, which a Lag is; ROADMAP queue 3,
    ``test_reference_lag_reads_ahead``): the JAX side states a lag as a
    Lead with the negated offset, which it computes as Spark's lag."""
    if W is JW:
        return JW.Lead(child, -offset, default)
    return W.Lag(child, offset, default)


def _offsets(M, W, plain_strings):
    """ntile, percent_rank, cume_dist and lead/lag, as (alias, function).
    A string lead/lag has no default: the reference drops a string
    default (the CPU-engine test below holds those)."""
    out = [("nt4", W.NTile(4)), ("nt7", W.NTile(7)),
           ("pr", W.PercentRank()), ("cd", W.CumeDist()),
           ("lead_v", W.Lead(M.col("v"))),
           ("lag_iv2", _lag(W, M.col("iv"), 2)),
           ("lead_dv", W.Lead(M.col("dv"), 1,
                              M.Literal(DEC("1.50"), M.DecimalType(7, 2)))),
           ("lag_iv_d", _lag(W, M.col("iv"), 3, M.lit(-7))),
           ("lead_cat", W.Lead(M.col("cat"), 2))]
    if plain_strings:
        out.append(("lag_name", _lag(W, M.col("name"))))
    return out


def _aggs(M):
    return [("s_v", M.Sum(M.col("v"))), ("s_iv", M.Sum(M.col("iv"))),
            ("s_dv", M.Sum(M.col("dv"))), ("c_v", M.Count(M.col("v"))),
            ("c_all", M.Count()), ("a_v", M.Average(M.col("v"))),
            ("a_dv", M.Average(M.col("dv"))), ("mn_v", M.Min(M.col("v"))),
            ("mx_v", M.Max(M.col("v"))), ("mn_iv", M.Min(M.col("iv"))),
            ("mx_dv", M.Max(M.col("dv"))), ("f_v", M.First(M.col("v"))),
            ("l_iv", M.Last(M.col("iv"))), ("f_dv", M.First(M.col("dv")))]


ROWS_FRAMES = {"r_m3_p3": (-3, 3), "r_m2_m1": (-2, -1), "r_p1_p4": (1, 4),
               "r_u_p2": (None, 2), "r_m2_u": (-2, None)}
RANGE_FRAMES = {"g_m5_p5": (-5, 5), "g_0_p3": (0, 3), "g_u_p2": (None, 2),
                "g_m3_u": (-3, None), "g_m4_m1": (-4, -1)}

# (partition keys, order keys as (column, ascending), frame set, plain
# strings): bounded RANGE frames need one ascending integral order key
SPECS = {
    "g_by_io_rows": (["g"], [("io", True)], ROWS_FRAMES, False),
    "g_by_io_range": (["g"], [("io", True)], RANGE_FRAMES, False),
    "name_by_iv_desc": (["name"], [("iv", False), ("dv", True)],
                        ROWS_FRAMES, True),
    "io_only_range": ([], [("io", True)], RANGE_FRAMES, False),
}


def _exprs(M, W, Sort, spec_name):
    parts, orders, frames, plain = SPECS[spec_name]
    order_by = [Sort(M.col(c), asc) for c, asc in orders]
    base = W.window_spec(partition_by=parts, order_by=order_by)
    out = [W.over(f, base).alias(a) for a, f in _offsets(M, W, plain)]
    for fname, (a, b) in frames.items():
        kind = "rows" if fname.startswith("r_") else "range"
        spec = W.window_spec(partition_by=parts, order_by=order_by,
                             frame=W.WindowFrame(kind, a, b))
        out += [W.over(f, spec).alias(f"{n}@{fname}") for n, f in _aggs(M)]
    return out


class _JaxTypes:
    """The JAX package's expression module, with its DecimalType."""

    def __getattr__(self, name):
        if name == "DecimalType":
            return JT.DecimalType
        return getattr(JE, name)


class _PortTypes:
    def __getattr__(self, name):
        if name == "DecimalType":
            return PT.DecimalType
        return getattr(PE, name)


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_window_rest_matches_jax(spec_name):
    plain = SPECS[spec_name][3]
    js, ps = _sources(_data(), 160, encode=not plain)
    exp = _rows(JWindow(_exprs(_JaxTypes(), JW, JOrd, spec_name), js), JB)
    got = _rows(PWindow(_exprs(_PortTypes(), PW, POrd, spec_name), ps), PB)
    _assert_rows_equal(got, exp)


def _wide_data(n=360, seed=5):
    """_data with a DECIMAL128 column (decimal(22,2), values past 2^63
    unscaled) and a nullable date column."""
    t = _data(n, seed)
    rng = np.random.default_rng(seed + 1)
    wide = [DEC(int(x) * 10**6 + int(y)).scaleb(-2) for x, y in
            zip(rng.integers(-10**13, 10**13, n), rng.integers(0, 10**6, n))]
    days = rng.integers(10_000, 10_060, n).astype(np.int32)
    return t.append_column("wide", pa.array(
        wide, pa.decimal128(22, 2), mask=rng.random(n) < 0.1)).append_column(
        "day", pa.array(days, pa.int32(), mask=rng.random(n) < 0.05).cast(
            pa.date32()))


def _surface(M, W, Sort, parts, orders):
    """Every function of the slice over one spec: the offsets with and
    without defaults over every column kind, and each aggregate over a
    bounded ROWS and a bounded RANGE frame (the RANGE frames over the
    first order key, ascending integral)."""
    order_by = [Sort(M.col(c), asc) for c, asc in orders]

    def spec(frame=None):
        return W.window_spec(partition_by=parts, order_by=order_by,
                             frame=frame)
    fs = [("nt3", W.NTile(3)), ("pr", W.PercentRank()),
          ("cd", W.CumeDist()), ("rk", W.Rank()),
          ("lead_v", W.Lead(M.col("v"), 1, M.lit(0.5))),
          ("lag_io", W.Lag(M.col("io"), 2, M.lit(-1))),
          ("lag_dv", W.Lag(M.col("dv"), 1, M.lit(None))),
          ("lead_wide", W.Lead(M.col("wide"), 2)),
          ("lag_wide", W.Lag(M.col("wide"), 1, M.lit(3))),
          ("lead_cat", W.Lead(M.col("cat"), 1, M.lit("none"))),
          ("lag_name", W.Lag(M.col("name"), 3, M.lit("-"))),
          ("lead_name", W.Lead(M.col("name")))]
    out = [W.over(f, spec()).alias(a) for a, f in fs]
    frames = {"rows": W.WindowFrame("rows", -2, 3),
              "rows_after": W.WindowFrame("rows", 1, 5),
              "range": W.WindowFrame("range", -6, 2),
              "range_tail": W.WindowFrame("range", 3, None)}
    for fname, fr in frames.items():
        out += [W.over(f, spec(fr)).alias(f"{a}@{fname}") for a, f in (
            ("s_v", M.Sum(M.col("v"))), ("s_dv", M.Sum(M.col("dv"))),
            ("s_wide", M.Sum(M.col("wide"))), ("a_wide",
                                               M.Average(M.col("wide"))),
            ("a_iv", M.Average(M.col("iv"))), ("n", M.Count(M.col("io"))),
            ("mn_v", M.Min(M.col("v"))), ("mx_io", M.Max(M.col("io"))),
            ("mn_dv", M.Min(M.col("dv"))), ("f_wide", M.First(M.col("wide"))),
            ("l_v", M.Last(M.col("v"))), ("f_cat_n", M.Count(M.col("cat"))))]
    return out


WIDE_FRAMES = {"rows": ("rows", -2, 3), "rows_after": ("rows", 1, 5),
               "rows_tail": ("rows", -1, None), "range": ("range", -6, 2),
               "range_tail": ("range", 3, None),
               "range_head": ("range", None, -2)}


def _wide_exprs(M, W, Sort):
    """Sum, Average, First and Last over decimal(22,2) (values past 2^63
    unscaled, nulls) over bounded ROWS and RANGE frames, partitioned by g
    and ordered by io (ascending, nulls and ties)."""
    order_by = [Sort(M.col("io"), True)]
    out = []
    for fname, (kind, a, b) in WIDE_FRAMES.items():
        spec = W.window_spec(partition_by=["g"], order_by=order_by,
                             frame=W.WindowFrame(kind, a, b))
        out += [W.over(f, spec).alias(f"{n}@{fname}") for n, f in (
            ("s", M.Sum(M.col("wide"))), ("a", M.Average(M.col("wide"))),
            ("f", M.First(M.col("wide"))), ("l", M.Last(M.col("wide"))))]
    return out


def test_wide_window_frames_match_jax():
    """DECIMAL128 window sums, averages and first/last values over
    bounded frames against the reference's device path (its
    ``_wide_agg_window``), exactly: the port's three differenced 128-bit
    lanes against its 128-bit prefix scans."""
    js, ps = _sources(_wide_data(), 120)
    exp = _rows(JWindow(_wide_exprs(_JaxTypes(), JW, JOrd), js), JB)
    got = _rows(PWindow(_wide_exprs(_PortTypes(), PW, POrd), ps), PB)
    _assert_rows_equal(got, exp)
    big = [r["s@rows"] for r in got if r["s@rows"] is not None]
    assert any(abs(x) > 2**63 / 100 for x in big)
    assert any(r["f@rows_after"] is None for r in got)


@pytest.mark.parametrize("spec_name", ["g_by_io", "name_by_day",
                                       "empty"])
def test_cpu_engine_window_rest_matches_device(spec_name):
    """The CPU engine's window operator against the device's WindowExec
    (both on the CPU) over the slice's surface: lead/lag defaults over
    doubles, ints, decimals, DECIMAL128, dictionary and plain strings
    (the reference has no DECIMAL128 lead/lag on its device and drops a
    string default, so these are held against the port's device alone);
    every aggregate over bounded ROWS and RANGE frames; bounded RANGE
    frames over an int and a date order key; and no input row at all."""
    parts, orders = {"g_by_io": (["g"], [("io", True)]),
                     "name_by_day": (["name"], [("day", True)]),
                     "empty": (["g"], [("io", True)])}[spec_name]
    t = _wide_data()
    if spec_name == "empty":
        t = t.slice(0, 0)

    def q(conf):
        df = from_arrow(t, RapidsConf(conf), batch_rows=100, device="cpu")
        out = df.with_window(*_surface(PE, PW, POrd, parts, orders))
        return out.explain(), out.collect()

    dev_plan, dev = q({})
    cpu_plan, cpu = q({"spark.rapids.gpu.sql.enabled": "false"})
    assert "!" not in dev_plan and "! Window" in cpu_plan
    if spec_name == "empty":
        assert dev == cpu == []
        return
    _assert_rows_equal(cpu, dev)
    names = [r["name"] for r in dev]
    assert any(r["lag_name"] == "-" for r in dev)
    assert any(r["lead_cat"] == "none" for r in dev)
    assert len(set(names)) > 30  # the plain-string key partitions


def test_bounded_minmax_scans_go_through_the_segscan_wrapper(monkeypatch):
    """A bounded ROWS Min/Max runs its prefix and suffix min/max scans
    through the kernel's wrapper (floats canonical as float64, NaN-free),
    its counts through add-scans."""
    calls = []
    real = PK.segmented_scan_kernel

    def spy(values, is_start, op_name="add"):
        assert values.is_contiguous() and is_start.is_contiguous()
        if values.is_floating_point():
            assert not bool(torch.isnan(values).any())
        calls.append((values.dtype, op_name))
        return real(values, is_start, op_name)

    monkeypatch.setattr(PK, "segmented_scan_kernel", spy)
    _, ps = _sources(_data(), 160)
    spec = PW.window_spec(["g"], [POrd(PE.col("io"))],
                          PW.WindowFrame("rows", -3, 3))
    rows = _rows(PWindow([PW.over(PE.Min(PE.col("v")), spec).alias("mn"),
                          PW.over(PE.Max(PE.col("iv")), spec).alias("mx")],
                         ps), PB)
    assert len(rows) == 480
    geometry = [(torch.int32, "max")] * 4
    assert calls[:4] == geometry
    assert calls[4:] == [(torch.float64, "min"), (torch.float64, "min"),
                         (torch.int64, "add"), (torch.int64, "add"),
                         (torch.int64, "max"), (torch.int64, "max"),
                         (torch.int64, "add")]


def test_first_is_the_first_non_null_value_as_in_the_reference():
    """first(x)/last(x) skip nulls, as the reference's (Spark's
    first(x, ignoreNulls = true)); Spark's default first(x) would give
    the frame's first row, null or not (ROADMAP queue 3)."""
    t = pa.table({"g": pa.array([1, 1, 1, 2, 2], pa.int64()),
                  "o": pa.array([1, 2, 3, 1, 2], pa.int32()),
                  "x": pa.array([None, 5, None, None, None], pa.int64())})
    js, ps = _sources(t, 5)
    for B, W, M, Ord, node in ((JB, JW, JE, JOrd, JWindow),
                               (PB, PW, PE, POrd, PWindow)):
        spec = W.window_spec(["g"], [Ord(M.col("o"))],
                             W.WindowFrame("rows", None, None))
        rows = _rows(node([W.over(M.First(M.col("x")), spec).alias("f"),
                           W.over(M.Last(M.col("x")), spec).alias("l")],
                          js if B is JB else ps), B)
        assert [(r["f"], r["l"]) for r in rows] == [(5, 5)] * 3 + [
            (None, None)] * 2


def test_reference_lag_reads_ahead():
    """The reference's device Lag(x, k) reads the row k rows after, as
    Lead(x, k) does (its WindowExec tests ``isinstance(f, Lead)``, which a
    Lag is); the port's is Spark's lag, the row k rows before (ROADMAP
    queue 3)."""
    t = pa.table({"o": pa.array([1, 2, 3, 4], pa.int32()),
                  "x": pa.array([10, 20, 30, 40], pa.int64())})
    js, ps = _sources(t, 4)
    jspec = JW.window_spec(order_by=[JOrd(JE.col("o"))])
    pspec = PW.window_spec(order_by=[POrd(PE.col("o"))])
    ref = _rows(JWindow([JW.over(JW.Lag(JE.col("x")), jspec).alias("w")],
                        js), JB)
    port = _rows(PWindow([PW.over(PW.Lag(PE.col("x")), pspec).alias("w")],
                         ps), PB)
    assert [r["w"] for r in ref] == [20, 30, 40, None]
    assert [r["w"] for r in port] == [None, 10, 20, 30]


@pytest.mark.parametrize("agg", ["First", "Last"])
def test_group_by_first_last_raises_on_both_engines(agg):
    """Group-by First/Last raised on both engines until the aggregate
    family was ported; now both engines run them and give the first
    (last) non-null value of each group in row order, as the JAX
    package's CPU engine does."""
    from spark_rapids_tpu.config.conf import RapidsConf as JConf
    from spark_rapids_tpu.plan import from_arrow as jax_from_arrow

    t = _data(40)
    jdf = jax_from_arrow(t, JConf({"spark.rapids.tpu.sql.enabled": False}))
    exp = jdf.group_by("g").agg(getattr(JE, agg)(JE.col("iv")).alias(
        "x")).sort("g").collect()
    assert any(r["x"] is not None for r in exp)
    for conf in ({}, {"spark.rapids.gpu.sql.enabled": "false"}):
        df = from_arrow(t, RapidsConf(conf), batch_rows=16, device="cpu")
        got = df.group_by("g").agg(getattr(PE, agg)(PE.col("iv")).alias(
            "x")).sort("g").collect()
        assert got == exp
