"""The variance family as window functions (VarianceSamp/Pop,
StddevSamp/Pop) over every frame the port has, UNBOUNDED, running (the
default RANGE frame), bounded ROWS and bounded RANGE, on the port's device
path and its CPU engine, held against the JAX package's device WindowExec
(on the CPU) over the same seeded table: partition keys with nulls, an
integer order key with ties and nulls, a double input with nulls, split
into several batches. Rows are compared by a row id: nulls exactly,
doubles within relative 1e-6 with an absolute floor of 1e-9 (a standard
deviation through its square).

Also: Skewness and Kurtosis windows, which the planner places on the CPU
engine with the reference's reason, against a numpy computation of each
frame's central moments; a bounded ROWS variance streaming across batch
edges against one batch; a NaN or an infinity in a frame (NaN, as
Spark's update gives, where the reference's prefix differences also
poison the frames after it); and reference fault 12 in its window form,
held to the exact answer: the JAX package scans raw power sums, which
lose every digit under a common offset of 1e8, and reads a decimal input
as its unscaled integer.
"""

import decimal
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exec.sort import SortOrder as JOrd
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exec.window import WindowExec as PWindow
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import window as PW
from spark_rapids_tpu_torch.plan import from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

REL, ABS = 1e-6, 1e-9
FRAMES = {"unbounded": ("rows", None, None), "running": ("range", None, 0),
          "rows": ("rows", -3, 2), "range": ("range", -5, 0)}
FUNCS = ("VarianceSamp", "VariancePop", "StddevSamp", "StddevPop")
_CACHE = {}


def _table(n=300, seed=5):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n)
    o = rng.integers(0, 40, n)
    x = rng.normal(50, 20, n)
    return pa.table({
        "rid": pa.array(np.arange(n), pa.int64()),
        "g": pa.array([None if i % 23 == 0 else int(v)
                       for i, v in enumerate(g)], pa.int64()),
        "o": pa.array([None if i % 29 == 0 else int(v)
                       for i, v in enumerate(o)], pa.int64()),
        "x": pa.array([None if i % 7 == 0 else float(v)
                       for i, v in enumerate(x)], pa.float64()),
    })


def _windows(M, W, Ord, col="x", frames=FRAMES, funcs=FUNCS):
    out = []
    for fk, (kind, a, b) in frames.items():
        spec = W.WindowSpec((M.col("g"),), (Ord(M.col("o")),),
                            W.WindowFrame(kind, a, b))
        for fn in funcs:
            out.append(M.Alias(W.WindowExpression(
                getattr(M, fn)(M.col(col)), spec), f"{fn}_{fk}"))
    return out


def _by_rid(rows):
    return sorted(rows, key=lambda r: r["rid"])


def close(a, b) -> bool:
    if a is None or b is None or a == b:
        return a == b
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return abs(a - b) <= max(REL * max(abs(a), abs(b)), ABS)


def assert_rows(got, exp):
    """Row by row; a standard deviation through its square (a variance):
    the reference's one-value frames give the square root of its
    rounding noise (about 1e-6) where the exact answer is 0."""
    assert len(got) == len(exp)
    for g, e in zip(got, exp):
        assert list(g) == list(e)
        for key in g:
            a, b = g[key], e[key]
            if key.startswith("Stddev") and a is not None and b is not None:
                a, b = a * a, b * b
            assert close(a, b) if isinstance(a, float) or isinstance(
                b, float) else a == b, (key, g, e)


def _jax_rows(t, exprs, device=True):
    df = jax_from_arrow(t, JConf({"spark.rapids.tpu.sql.enabled": device}),
                        batch_rows=64)
    df.shuffle_partitions = 1
    return _by_rid(df.with_window(*exprs).collect())


def _port_rows(t, exprs, conf=None):
    df = from_arrow(t, RapidsConf(conf or {}), batch_rows=64, device="cpu")
    q = df.with_window(*exprs)
    return q, _by_rid(q.collect())


ENGINES = {"device": {}, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                        "false"}}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_variance_windows_match_jax_over_every_frame(engine):
    t = _table()
    if "jax" not in _CACHE:
        _CACHE["jax"] = _jax_rows(t, _windows(JE, JW, JOrd))
    q, got = _port_rows(t, _windows(PE, PW, POrd), ENGINES[engine])
    assert ("!" in q.explain()) == (engine == "cpu_engine")
    assert_rows(got, _CACHE["jax"])
    assert sum(r["VarianceSamp_rows"] is not None for r in got) > 200


def _exact_window(xs, frame):
    """Per row (in order), the frame's exact sample variance, from
    fractions."""
    from fractions import Fraction

    kind, a, b = frame
    out = []
    for i in range(len(xs)):
        lo = 0 if a is None else max(0, i + a)
        hi = len(xs) - 1 if b is None else min(len(xs) - 1, i + b)
        w = [Fraction(v) for v in xs[lo: hi + 1]]
        if len(w) < 2:
            out.append(None)
            continue
        m = sum(w) / len(w)
        out.append(float(sum((v - m) ** 2 for v in w) / (len(w) - 1)))
    return out


def test_window_variance_at_a_1e8_offset_is_exact():
    """Reference fault 12, window form: the JAX package differences prefix
    sums of x and x^2 over the whole input, so under a common offset of
    1e8 every digit cancels. The port shifts each value by its partition's
    first value before its add-scans: the exact answer on both engines
    (relative 1e-9); the JAX package's device answers are recorded as
    far off."""
    xs = [1e8 + v for v in (0.0, 1.0, 2.0, 4.0, 7.0, 3.0)]
    t = pa.table({"rid": pa.array(range(6), pa.int64()),
                  "g": pa.array([1] * 6, pa.int64()),
                  "o": pa.array(range(6), pa.int64()),
                  "x": pa.array(xs, pa.float64())})
    frames = {"unbounded": ("rows", None, None), "rows": ("rows", -2, 0)}
    exact = {fk: _exact_window(xs, fr) for fk, fr in frames.items()}
    for conf in ENGINES.values():
        _q, got = _port_rows(t, _windows(PE, PW, POrd, frames=frames,
                                         funcs=("VarianceSamp",)), conf)
        for fk in frames:
            for r, want in zip(got, exact[fk]):
                v = r[f"VarianceSamp_{fk}"]
                assert (v is None) == (want is None)
                assert v is None or abs(v - want) <= 1e-9 * abs(want), (
                    fk, v, want)
    jax = _jax_rows(t, _windows(JE, JW, JOrd, frames=frames,
                                funcs=("VarianceSamp",)))
    # the reference's ROWS 2 PRECEDING variance of (1e8, 1e8+1, 1e8+2)
    # is far from its exact 1.0
    assert abs(jax[2]["VarianceSamp_rows"] - 1.0) > 0.1


def test_window_variance_of_a_decimal_reads_its_value():
    """A decimal input is cast to DOUBLE (Spark's rule), as in the port's
    group-by variance; the JAX package's device window reads its unscaled
    integer, a variance 10^(2 scale) too large (recorded)."""
    vals = ["1.50", "2.25", "4.00", "-3.10", "0.05"]
    t = pa.table({"rid": pa.array(range(5), pa.int64()),
                  "g": pa.array([1] * 5, pa.int64()),
                  "o": pa.array(range(5), pa.int64()),
                  "d": pa.array([decimal.Decimal(v) for v in vals],
                                pa.decimal128(7, 2))})
    frames = {"unbounded": ("rows", None, None)}
    want = float(np.var([float(v) for v in vals], ddof=1))
    for conf in ENGINES.values():
        _q, got = _port_rows(t, _windows(PE, PW, POrd, "d", frames,
                                         ("VarianceSamp",)), conf)
        assert all(abs(r["VarianceSamp_unbounded"] - want) <= 1e-12 * want
                   for r in got)
    jax = _jax_rows(t, _windows(JE, JW, JOrd, "d", frames,
                                ("VarianceSamp",)))
    assert abs(jax[0]["VarianceSamp_unbounded"] / want - 1e4) < 1e-6


def test_nan_and_infinity_poison_only_their_frames():
    """A NaN or an infinity makes its frames NaN, on both engines; a frame
    without one is finite (Spark's answer: the reference's differences of
    prefix sums give NaN from the infinity on)."""
    xs = [1.0, 2.0, float("inf"), 3.0, 5.0, 6.0, float("nan"), 8.0, 9.0,
          10.0]
    t = pa.table({"rid": pa.array(range(10), pa.int64()),
                  "g": pa.array([1] * 10, pa.int64()),
                  "o": pa.array(range(10), pa.int64()),
                  "x": pa.array(xs, pa.float64())})
    frames = {"rows": ("rows", -1, 0)}
    rows = [_port_rows(t, _windows(PE, PW, POrd, frames=frames,
                                   funcs=("VariancePop",)), conf)[1]
            for conf in ENGINES.values()]
    assert_rows(rows[0], rows[1])
    v = [r["VariancePop_rows"] for r in rows[0]]
    assert [math.isnan(a) for a in v] == [False, False, True, True, False,
                                          False, True, True, False, False]
    assert v[4] == 1.0 and v[9] == 0.25


def _exact_moment_windows(t, spec_rows, fn):
    """Per row id, the numpy skewness or kurtosis of its ROWS frame."""
    g = t.column("g").to_pylist()
    o = t.column("o").to_pylist()
    x = t.column("x").to_pylist()
    rid = t.column("rid").to_pylist()
    a, b = spec_rows
    out = {}
    for part in set(g):
        idx = [i for i in range(len(g)) if g[i] == part]
        # the port orders by (o, rid): nulls first, ties by row id
        idx.sort(key=lambda i: (o[i] is not None, o[i] or 0, rid[i]))
        for pos, i in enumerate(idx):
            w = [x[j] for j in idx[max(0, pos + a): pos + b + 1]
                 if x[j] is not None]
            if not w:
                out[rid[i]] = None
                continue
            w = np.array(w)
            d = w - w.mean()
            m2 = float((d * d).sum())
            if m2 == 0:
                out[rid[i]] = float("nan")
            elif fn == "Skewness":
                out[rid[i]] = (math.sqrt(len(w)) * float((d ** 3).sum())
                               / m2 ** 1.5)
            else:
                out[rid[i]] = len(w) * float((d ** 4).sum()) / m2 ** 2 - 3
    return out


def test_skewness_kurtosis_windows_run_on_the_cpu_engine():
    """The reference places them on the CPU engine; so does the port,
    naming its reason; each frame against numpy (relative 1e-6, absolute
    1e-9; 3 PRECEDING to CURRENT ROW over (o, rid), a total order)."""
    t = _table(120)
    ws = []
    for fn in ("Skewness", "Kurtosis"):
        spec = PW.WindowSpec((PE.col("g"),), (POrd(PE.col("o")),
                                              POrd(PE.col("rid"))),
                             PW.WindowFrame("rows", -3, 0))
        ws.append(PE.Alias(PW.WindowExpression(getattr(PE, fn)(
            PE.col("x")), spec), fn))
    q, got = _port_rows(t, ws)
    bad = [ln for ln in q.explain().splitlines()
           if ln.lstrip().startswith("!")]
    assert len(bad) == 1 and "! Window" in bad[0]
    assert "skewness/kurtosis window functions not on device" in bad[0]
    jspec = JW.WindowSpec((JE.col("g"),), (JOrd(JE.col("o")),
                                           JOrd(JE.col("rid"))),
                          JW.WindowFrame("rows", -3, 0))
    jdf = jax_from_arrow(t).with_window(JE.Alias(JW.WindowExpression(
        JE.Skewness(JE.col("x")), jspec), "s"))
    assert "skewness/kurtosis window functions not on device" in \
        jdf.explain()
    for fn in ("Skewness", "Kurtosis"):
        exp = _exact_moment_windows(t, (-3, 0), fn)
        for r in got:
            assert close(r[fn], exp[r["rid"]]), (fn, r, exp[r["rid"]])
    with pytest.raises(NotImplementedError, match="skewness/kurtosis"):
        PWindow(ws, PSource([[PB.batch_from_arrow(t, "cpu")]],
                            PT.Schema.from_arrow(t.schema)))


def test_bounded_rows_variance_streams_across_batches():
    """A bounded ROWS variance streams with its context rows (the
    planner's ``bounded`` mode); presorted batches cut by hand through a
    streaming WindowExec equal one batch."""
    t = _table(200)
    order = np.lexsort((np.arange(200),
                        np.nan_to_num(np.array(t.column("o").to_pylist(),
                                               dtype=float), nan=-1.0),
                        np.nan_to_num(np.array(t.column("g").to_pylist(),
                                               dtype=float), nan=-1.0)))
    t = t.take(pa.array(order))
    spec = PW.WindowSpec((PE.col("g"),), (POrd(PE.col("o")),
                                          POrd(PE.col("rid"))),
                         PW.WindowFrame("rows", -4, 1))
    ws = [PE.Alias(PW.WindowExpression(PE.VarianceSamp(PE.col("x")), spec),
                   "v"),
          PE.Alias(PW.WindowExpression(PE.StddevPop(PE.col("x")), spec),
                   "s")]
    schema = PT.Schema.from_arrow(t.schema)
    cuts = [PB.batch_from_arrow(t.slice(i, 37), "cpu")
            for i in range(0, 200, 37)]
    stream = PWindow(ws, PSource([cuts], schema), streaming=True)
    assert stream.node_description().endswith("streaming=bounded")
    one = PWindow(ws, PSource([[PB.batch_from_arrow(t, "cpu")]], schema))

    def rows(node):
        return _by_rid(pa.concat_tables(
            [PB.batch_to_arrow(b, node.output_schema)
             for b in node.execute(0)]).to_pylist())

    got = rows(stream)
    assert stream.metrics["streamedBatches"].value > 1
    assert_rows(got, rows(one))
