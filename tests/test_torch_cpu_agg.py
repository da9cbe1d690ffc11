"""The CPU engine's aggregate (``plan/cpu_agg.py``: one group order per
aggregate node shared by its functions, each distinct input expression
evaluated once, keys factorised by hash), held against the JAX package's
planner and against the pandas references:

- the headline (q3/q7/q42/q52/q96) and joins (q9/q28/q40/q43/q87/q88/
  q93/q97) queries wholly on the CPU engine against their pandas
  references at SF 0.01;
- keyed and global aggregates over a table with an all-null group, a
  null group key, a long sum that wraps, a decimal(38,0) sum that
  overflows to null, HALF_UP decimal averages, doubles with NaN and -0.0
  keys, COUNT(DISTINCT) with nulls and several functions over one shared
  ``If`` input, against the JAX package;
- a global aggregate over no rows (counts 0, everything else null).
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
from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal
CPU_ONLY = RapidsConf({"spark.rapids.gpu.sql.enabled": "false"})
_CACHE = {}


@pytest.mark.parametrize("q", PQ.HEADLINE + PQ.JOINS)
def test_cpu_engine_query_matches_pandas(q):
    if "t" not in _CACHE:
        _CACHE["t"] = PS.tables_for(0.01, names=PS.BASE_TABLES
                                    + PS.JOIN_TABLES)
    tables = _CACHE["t"]
    df = PQ.QUERIES[q](PQ.df_tables(tables, CPU_ONLY, device="cpu"))
    assert all(ln.lstrip().startswith("!")
               for ln in df.explain().splitlines())
    got = df.to_arrow().to_pylist()
    assert got
    assert PQ.check_rows(q, got, PQ.PANDAS[q](tables)) == (True, "")


def _table():
    rng = np.random.default_rng(12)
    n = 600
    g = rng.integers(0, 6, n)
    # group 5's values are all null; some group keys are null
    x = rng.integers(-50, 50, n)
    xmask = (g == 5) | (rng.random(n) < 0.1)
    big = np.where(g == 1, 2**62, rng.integers(-2**40, 2**40, n))
    wide = [D(10) ** 37 * 9 if gi == 2 else D(int(v))
            for gi, v in zip(g, rng.integers(-10**6, 10**6, n))]
    d = rng.normal(size=n)
    d[::17] = np.nan
    d[::23] = -0.0
    return pa.table({
        "g": pa.array(g, pa.int64(), mask=rng.random(n) < 0.05),
        "x": pa.array(x, pa.int64(), mask=xmask),
        "big": pa.array(big, pa.int64()),
        "wide": pa.array(wide, pa.decimal128(38, 0)),
        "p": pa.array([D(int(v)).scaleb(-2) for v in
                       rng.integers(-99999, 99999, n)], pa.decimal128(7, 2)),
        "d": pa.array(d, pa.float64()),
    })


def _aggs(M, wide=True):
    v = M.If(M.GreaterThan(M.col("x"), M.lit(0)), M.col("p"),
             M.lit(None, JT.DecimalType(7, 2) if M is JE
                   else PT.DecimalType(7, 2)))
    return [M.Sum(M.col("x")).alias("sx"), M.Count(M.col("x")).alias("cx"),
            M.Average(M.col("x")).alias("ax"),
            M.Sum(M.col("big")).alias("sbig")] + (
        [M.Sum(M.col("wide")).alias("swide")] if wide else []) + [
            M.Average(M.col("p")).alias("ap"), M.Sum(v).alias("sv"),
            M.Average(v).alias("av"), M.Count(v).alias("cv"),
            M.Sum(M.col("d")).alias("sd"),
            M.CountDistinct(M.col("x")).alias("nx"), M.Count().alias("n")]


@pytest.mark.parametrize("keys", [[], ["g"], ["d"]])
def test_cpu_engine_aggregate_edge_cases_match_jax(keys):
    """Against the JAX package, but for the decimal(38,0) sum: the port
    (Spark) gives null past 38 digits, where the reference's sum wraps
    (ROADMAP.md queue 3); it is held against exact Python sums. The
    reference fails to group a double key holding NaN (a KeyError in its
    CPU aggregate), so that case is held against the port's device path
    instead, without the DECIMAL128 column."""
    t = _table()
    wide = keys != ["d"]
    if wide:
        jdf = jax_from_arrow(t)
        jdf.shuffle_partitions = 1
        jq = (jdf.group_by(*keys).agg(*_aggs(JE)) if keys
              else jdf.agg(*_aggs(JE)))
    else:
        jq = port_from_arrow(t, device="cpu").group_by(*keys).agg(
            *_aggs(PE, wide))
    exp = jq.collect()
    pdf = port_from_arrow(t, CPU_ONLY, device="cpu")
    pq = (pdf.group_by(*keys).agg(*_aggs(PE, wide)) if keys
          else pdf.agg(*_aggs(PE, wide)))
    got = pq.collect()
    assert len(got) == len(exp)
    if wide:
        g = t.column("g").to_pylist() if keys else [0] * t.num_rows
        sums = {}
        for gi, w in zip(g, t.column("wide").to_pylist()):
            sums[gi] = sums.get(gi, 0) + int(w)
        for r in got:
            total = sums[r["g"] if keys else 0]
            want = D(total) if abs(total) < 10 ** 38 else None
            assert r.pop("swide") == want
        for r in exp:
            r.pop("swide")
    assert rows_match(got, exp)
    if keys == ["g"]:
        by_key = {r["g"]: r for r in got}
        assert by_key[5]["sx"] is None and by_key[5]["cx"] == 0
        assert by_key[5]["nx"] == 0 and by_key[5]["ax"] is None
        assert None in by_key  # the null group key is a group
        n1 = sum(1 for r in t.column("g").to_pylist() if r == 1)
        assert by_key[1]["sbig"] == ((n1 * 2**62 + 2**63) % 2**64) - 2**63
        assert sums[2] >= 10 ** 38  # group 2's wide sum overflows: null
    if keys == ["d"]:
        # NaN is one group and -0.0 groups with 0.0
        ds = [r["d"] for r in got]
        assert sum(1 for v in ds if v != v) == 1
        assert len([v for v in ds if v == 0.0]) == 1


def test_cpu_engine_global_aggregate_over_no_rows():
    t = _table().slice(0, 0)
    got = port_from_arrow(t, CPU_ONLY, device="cpu").agg(
        *_aggs(PE)).collect()
    assert got == [{"sx": None, "cx": 0, "ax": None, "sbig": None,
                    "swide": None, "ap": None, "sv": None, "av": None,
                    "cv": 0, "sd": None, "nx": 0, "n": 0}]
