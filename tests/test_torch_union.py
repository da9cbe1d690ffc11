"""The port's UNION ALL (spark_rapids_tpu_torch.plan.logical.Union,
exec.misc.UnionExec on the device path with CPU tensors, plan.cpu
CpuUnionExec on the CPU engine), held against the JAX package's planner on
the same seeded tables (one shuffle partition):

- the union schema: int with bigint, decimal(7,2) with decimal(15,4), a
  non-nullable column with a nullable one, names from the first branch;
  the branch casts run on the device (a rescale for the decimals);
- branches whose string columns hold different dictionaries, plain
  strings and a projected literal, feeding a group-by, an ORDER BY with a
  limit and a join build, in several batches a branch: no branch is lost
  above the union's one partition;
- three-way unions and an empty branch.

Rows must equal the JAX package's (``rows_match``: exact keys, decimals,
strings and counts; ORDER BY results in order).
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec.sort import SortOrder as JOrd
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.config import conf as PC
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.plan import logical as PL

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal
CPU_ONLY = {"spark.rapids.gpu.sql.enabled": "false"}
ENGINES = ["device", "cpu_engine"]


def _branch(n, seed, int_type, dec, words, base, plain=False,
            nullable=True):
    """One branch's table: ``i`` unique across branches (from ``base``),
    ``k`` of ``int_type``, ``d`` decimal of ``dec`` = (precision, scale),
    ``s`` strings from ``words`` (dictionary-encodable) or, with
    ``plain``, many distinct strings."""
    rng = np.random.default_rng(seed)
    p, s = dec
    if plain:
        strs = [f"{words[int(x) % len(words)]}-{int(y)}" for x, y in
                zip(rng.integers(0, 99, n), rng.integers(0, 10**6, n))]
    else:
        strs = [words[int(x)] for x in rng.integers(0, len(words), n)]
    mask = (rng.random(n) < 0.1) if nullable else None
    schema = pa.schema([pa.field("i", pa.int64(), nullable=False),
                        pa.field("k", int_type, nullable=nullable),
                        pa.field("d", pa.decimal128(p, s)),
                        pa.field("s", pa.string())])
    return pa.table({
        "i": pa.array(np.arange(base, base + n), pa.int64()),
        "k": pa.array(rng.integers(0, 12, n), int_type, mask=mask),
        "d": pa.array([D(int(u)).scaleb(-s) for u in
                       rng.integers(-10**(p - 1), 10**(p - 1), n)],
                      pa.decimal128(p, s), mask=rng.random(n) < 0.05),
        "s": pa.array(strs, pa.string(), mask=rng.random(n) < 0.05),
    }, schema=schema)


def _tables():
    return {
        "a": _branch(300, 1, pa.int32(), (7, 2), ["a0", "a1", "a2", "x"],
                     0, nullable=False),
        "b": _branch(200, 2, pa.int64(), (15, 4), ["b0", "a1", "x", "b3"],
                     1000),
        "c": _branch(150, 3, pa.int32(), (7, 2), ["c0", "c1"], 2000,
                     plain=True),
        "e": _branch(0, 4, pa.int64(), (15, 4), ["e0"], 3000),
        "probe": _branch(120, 5, pa.int64(), (7, 2), ["p0"], 5000),
    }


def _jax_frames(tables):
    out = {}
    for k, t in tables.items():
        df = jax_from_arrow(t)
        df.shuffle_partitions = 1
        out[k] = df
    return out


def _port_frames(tables, engine):
    conf = PC.RapidsConf(CPU_ONLY if engine == "cpu_engine" else {})
    return {k: port_from_arrow(t, conf, batch_rows=64, device="cpu")
            for k, t in tables.items()}


def _unioned(M, d):
    """a (int, decimal(7,2), dictionary strings, non-nullable k) UNION b
    (bigint, decimal(15,4), another dictionary) UNION c (plain strings)
    UNION a with the literal "channel" as its strings UNION an empty
    branch."""
    lit_branch = d["a"].select(M.col("i"), M.col("k"), M.col("d"),
                               M.Alias(M.lit("channel"), "s"))
    return (d["a"].union(d["b"]).union(d["c"]).union(lit_branch)
            .union(d["e"]))


def _queries(M, Ord, d):
    u = _unioned(M, d)
    return {
        "all": u,
        # (a sum of the decimal(15,4) would need DECIMAL128)
        "group": u.group_by("s").agg(M.Alias(M.Count(), "n"),
                                     M.Alias(M.Max(M.col("d")), "mx"),
                                     M.Alias(M.Min(M.col("d")), "mn"),
                                     M.Alias(M.Sum(M.col("k")), "sk")),
        "sort": u.sort(Ord(M.col("d"), ascending=False), Ord(M.col("i")),
                       limit=40),
        "join_build": d["probe"].select(
            M.Alias(M.col("k"), "pk"), M.Alias(M.col("i"), "pi")).join(
            u, left_on="pk", right_on="k").group_by("pk").agg(
            M.Alias(M.Count(), "n"), M.Alias(M.Sum(M.col("i")), "si")),
    }


def test_union_schema_widens_as_jax():
    tables = _tables()
    jq = _unioned(JE, _jax_frames(tables))
    pq = _unioned(PE, _port_frames(tables, "device"))
    assert pq.schema.to_arrow() == jq.schema.to_arrow()
    s = pq.schema
    assert [f.name for f in s] == ["i", "k", "d", "s"]
    assert s["k"].dtype == PT.LONG and s["d"].dtype == PT.DecimalType(15, 4)
    assert s["k"].nullable and not s["i"].nullable
    assert PL.union_widen(PT.DecimalType(7, 2), PT.DecimalType(15, 4)) == \
        PT.DecimalType(15, 4)
    assert PL.union_widen(PT.DecimalType(20, 0), PT.DecimalType(20, 10)) == \
        PT.DecimalType(30, 10)
    assert PL.union_widen(PT.INT, PT.DOUBLE) == PT.DOUBLE
    # the casts are a Project of its own under the union, on the device
    plan = pq.explain()
    assert "!" not in plan
    assert "cast(col#1:int as bigint)" in plan
    assert "cast(col#2:decimal(7,2) as decimal(15,4))" in plan


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("query", ["all", "group", "sort", "join_build"])
def test_union_feeds_operators_as_jax(query, engine):
    tables = _tables()
    exp = _queries(JE, JOrd, _jax_frames(tables))[query].collect()
    df = _queries(PE, POrd, _port_frames(tables, engine))[query]
    plan = df.explain()
    if engine == "device":
        assert "!" not in plan
    got = df.collect()
    assert len(got) == len(exp) and rows_match(got, exp)
    if query == "sort":
        assert got == exp
    n_rows = sum(tables[k].num_rows for k in "abc") + tables["a"].num_rows
    if query == "all":
        assert len(got) == n_rows
    if query == "group":  # every branch's rows reach the aggregate
        assert sum(r["n"] for r in got) == n_rows
        assert {"channel", "a0", "b0", "x"} <= {r["s"] for r in got}
        assert any(r["s"].startswith("c") for r in got if r["s"])
    if query == "join_build":  # every branch's rows reach the build side
        assert {r["si"] for r in got} and sum(r["n"] for r in got) > 0


@pytest.mark.parametrize("engine", ENGINES)
def test_union_of_three_branches_with_a_channel_literal(engine):
    """q5's shape: three branches, each a projected channel literal, then
    a group-by on (channel, key) and a sort."""
    tables = _tables()

    def q(M, d):
        def chan(name, t):
            return d[t].select(M.Alias(M.lit(name), "channel"),
                               M.Alias(M.col("k"), "id"),
                               M.Alias(M.col("d"), "sales"))
        u = chan("store", "a").union(chan("catalog", "b")).union(
            chan("web", "c"))
        return (u.group_by("channel", "id")
                .agg(M.Alias(M.Max(M.col("sales")), "sales"),
                     M.Alias(M.Count(), "n"))
                .sort("channel", "id"))
    exp = q(JE, _jax_frames(tables)).collect()
    df = q(PE, _port_frames(tables, engine))
    if engine == "device":
        assert "!" not in df.explain()
    got = df.collect()
    assert got == exp
    assert [r["channel"] for r in got[:1]] == ["catalog"]
    assert {r["channel"] for r in got} == {"store", "catalog", "web"}


@pytest.mark.parametrize("engine", ENGINES)
def test_union_with_an_empty_branch(engine):
    tables = _tables()

    def q(M, d):
        none = d["b"].filter(M.LessThan(M.col("k"), M.lit(-1)))
        return none.union(d["a"]).union(d["e"]).agg(
            M.Alias(M.Count(), "n"), M.Alias(M.Max(M.col("d")), "mx"))
    exp = q(JE, _jax_frames(tables)).collect()
    got = q(PE, _port_frames(tables, engine)).collect()
    assert got == exp and got[0]["n"] == tables["a"].num_rows


def test_union_of_only_empty_branches():
    tables = _tables()
    for engine in ENGINES:
        d = _port_frames(tables, engine)
        none = d["b"].filter(PE.LessThan(PE.col("k"), PE.lit(-1)))
        u = none.union(d["e"])
        assert u.collect() == []
        assert u.agg(PE.Alias(PE.Count(), "n")).collect() == [{"n": 0}]
