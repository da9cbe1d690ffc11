"""The port's outer, semi and anti joins, conditional expressions and
distinct aggregates, held against the JAX package on the CPU:

- every join type (inner, left, right, full, left_semi, left_anti)
  through the port's ``HashJoinExec`` (the probe kernel's plain version on
  the CPU) against the reference's ``HashJoinExec`` on its hash-table
  path, and through the port's CPU engine (``CpuJoinExec``): null keys on
  both sides, duplicate build keys, an empty build side, an empty probe
  side, three probe batches (so that right/full joins carry their
  build-side matched flags across batches), a chunk budget small enough
  that one batch's candidates split into several chunks, two-column keys
  and plain-string keys. Results are compared as row multisets;
- a residual join condition (a string inequality, an ordering between
  the sides, a condition that rejects every key-equal pair of some probe
  rows and a condition that is always null) for every join type, on the
  hash-table path and on the sorted-hash path of the port's join and on
  its CPU engine, against the reference's ``HashJoinExec`` with the same
  condition;
- If, CaseWhen and Coalesce against the reference's ``compile_projection``
  on the device path and on the CPU engine, with null predicates and
  decimal, double, integer and string branches;
- the distinct-aggregate rewrite (keyed and global) against the
  reference's planner, and a nullable group key that keeps the aggregate
  on the CPU engine.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exec import BatchSourceExec as JSource
from spark_rapids_tpu.exec import HashJoinExec as JJoin
from spark_rapids_tpu.exec import kernels as JK
from spark_rapids_tpu.exprs import eval as JEV
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config import conf as PC
from spark_rapids_tpu_torch.exec import kernels as PK
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.join import HashJoinExec as PJoin
from spark_rapids_tpu_torch.exec.project import ProjectExec as PProject
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal
JOIN_TYPES = ["inner", "left", "right", "full", "left_semi", "left_anti"]
CPU_ONLY = {"spark.rapids.gpu.sql.enabled": "false"}
# the JAX join takes its general hash-table path under these
HT_CONF = {"spark.rapids.tpu.sql.join.denseKey.maxDomain": "0",
           "spark.rapids.tpu.sql.join.uniqueTable.maxSlots": "0"}
CHUNK_KEY = "gatherChunkTargetRows"


def _sources(table, rows_per_batch):
    """(JAX source, port source) over the same batches of one table."""
    t = JB.dictionary_encode_table(table)
    jcache, pcache = {}, {}
    slices = [t.slice(i, rows_per_batch)
              for i in range(0, max(t.num_rows, 1), rows_per_batch)]
    jb = [JB.batch_from_arrow(s, 16, dict_cache=jcache) for s in slices]
    pb = [PB.batch_from_arrow(s, "cpu", dict_cache=pcache) for s in slices]
    return (JSource([jb], JT.Schema.from_arrow(table.schema)),
            PSource([pb], PT.Schema.from_arrow(table.schema)))


def _rows(node, to_arrow):
    tables = [to_arrow(b, node.output_schema) for b in node.execute(0)]
    return pa.concat_tables(tables).to_pylist() if tables else []


def _left(n, seed, domain=30):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, domain, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "k2": pa.array(rng.integers(0, 3, n), pa.int64()),
        # many distinct values: the column stays a plain string
        "s": pa.array([f"name-{int(x)}" for x in rng.integers(0, 40, n)],
                      pa.string(), mask=rng.random(n) < 0.1),
        "v": pa.array(rng.normal(size=n), pa.float64()),
    })


def _right(n, seed, domain=40):
    rng = np.random.default_rng(seed)
    return pa.table({
        "rk": pa.array(rng.integers(0, domain, n), pa.int64(),
                       mask=rng.random(n) < 0.1),
        "rk2": pa.array(rng.integers(0, 3, n), pa.int64()),
        "rs": pa.array([f"name-{int(x)}" for x in rng.integers(0, 60, n)],
                       pa.string(), mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(0, 1000, n), pa.int64()),
    })


# case -> (left table, left batch rows, right table, right batch rows,
#          left keys, right keys, chunk budget)
CASES = {
    "one_key": lambda: (_left(300, 1), 100, _right(80, 2), 40, ["k"],
                        ["rk"], None),
    "two_keys": lambda: (_left(300, 3), 100, _right(120, 4), 50,
                         ["k", "k2"], ["rk", "rk2"], None),
    "plain_string": lambda: (_left(240, 5), 80, _right(90, 6), 90, ["s"],
                             ["rs"], None),
    "empty_build": lambda: (_left(200, 7), 100, _right(80, 8).slice(0, 0),
                            40, ["k"], ["rk"], None),
    "empty_probe": lambda: (_left(200, 9).slice(0, 0), 100, _right(80, 10),
                            40, ["k"], ["rk"], None),
    # 5 distinct build keys, 60 rows each: a 400-row probe batch has about
    # 19,000 candidates, cut into chunks of at most 1,024
    "chunked": lambda: (_left(800, 11, domain=6), 400, _right(300, 12,
                                                              domain=5),
                        300, ["k"], ["rk"], 1024),
}


def _port_cpu_engine(left, right, lk, rk, how):
    conf = PC.RapidsConf(CPU_ONLY)
    df = port_from_arrow(left, conf, device="cpu").join(
        port_from_arrow(right, conf, device="cpu"), left_on=lk,
        right_on=rk, how=how)
    assert all(ln.lstrip().startswith("!")
               for ln in df.explain().splitlines())
    return df.collect()


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("case", list(CASES))
def test_join_type_matches_jax_and_cpu_engine(case, how):
    left, lrows, right, rrows, lk, rk, chunk = CASES[case]()
    jl, pl = _sources(left, lrows)
    jr, pr = _sources(right, rrows)
    jconf = dict(HT_CONF)
    pconf = {}
    if chunk is not None:
        jconf["spark.rapids.tpu.sql.join." + CHUNK_KEY] = str(chunk)
        pconf["spark.rapids.gpu.sql.join." + CHUNK_KEY] = str(chunk)
    saved = JC.get_active()
    JC.set_active(JC.RapidsConf(jconf))
    before = JK.counters()["hashtbl_probe_total"]
    try:
        exp = _rows(JJoin([JE.col(c) for c in lk], [JE.col(c) for c in rk],
                          how, jl, jr), JB.batch_to_arrow)
    finally:
        JC.set_active(saved)
    if right.num_rows and left.num_rows:
        assert JK.counters()["hashtbl_probe_total"] > before  # JAX took ht
    psaved = PC.get_active()
    PC.set_active(PC.RapidsConf(pconf))
    try:
        node = PJoin([PE.col(c) for c in lk], [PE.col(c) for c in rk], how,
                     pl, pr)
        got = _rows(node, PB.batch_to_arrow)
    finally:
        PC.set_active(psaved)
    assert rows_match(got, exp), (len(got), len(exp))
    assert len(got) == len(exp)
    if case == "chunked" and how != "right":
        assert node.metrics["numChunks"].value > node.metrics[
            "numProbeBatches"].value
    assert rows_match(_port_cpu_engine(left, right, lk, rk, how), exp)
    # the hazards spelled out: an empty side still emits the other side's
    # rows where the join type keeps them
    if case == "empty_build":
        assert len(got) == {"left": 200, "full": 200,
                            "left_anti": 200}.get(how, 0)
    if case == "empty_probe":
        assert len(got) == (80 if how in ("right", "full") else 0)
    if how in ("left", "full", "left_anti") and case != "empty_probe":
        # probe rows with a null key are kept, unmatched
        assert any(any(r[c] is None for c in lk) for r in got)


def test_semi_and_anti_joins_emit_each_probe_row_once():
    """Repeated build keys pair a probe row many times; semi and anti
    joins still emit it once, and together they partition the probe
    side (a null key lands in the anti join)."""
    left, right = _left(300, 21), _right(200, 22, domain=10)
    _, pl = _sources(left, 100)
    _, pr = _sources(right, 200)
    semi = _rows(PJoin([PE.col("k")], [PE.col("rk")], "left_semi", pl, pr),
                 PB.batch_to_arrow)
    anti = _rows(PJoin([PE.col("k")], [PE.col("rk")], "left_anti", pl, pr),
                 PB.batch_to_arrow)
    assert rows_match(semi + anti, left.to_pylist())
    keys = set(right.column("rk").drop_null().to_pylist())
    assert all(r["k"] in keys for r in semi)
    assert all(r["k"] not in keys for r in anti)


# ---------------------------------------------------------------------------
# residual join conditions
# ---------------------------------------------------------------------------


def _conditions(M, T):
    col, lit = M.col, M.lit
    return {
        # a string inequality of two plain-string columns (q24/q46/q68)
        "string_neq": M.Not(M.EqualTo(col("s"), col("rs"))),
        # an ordering between the sides (q72)
        "less_than": M.LessThan(col("k2"), col("rk2")),
        # false for every pair of a probe row whose v <= 0: outer and anti
        # joins keep those rows unmatched
        "rejects_row": M.GreaterThan(col("v"), lit(0.0)),
        # null for every pair: nothing matches
        "null": M.LessThan(col("w"), lit(None, T.LONG)),
    }


@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("cond", ["string_neq", "less_than", "rejects_row",
                                  "null"])
def test_join_condition_matches_jax_on_both_paths(cond, how):
    left, right = _left(300, 51), _right(120, 52, domain=20)
    jl, pl = _sources(left, 100)
    jr, pr = _sources(right, 60)
    saved = JC.get_active()
    JC.set_active(JC.RapidsConf(HT_CONF))
    try:
        exp = _rows(JJoin([JE.col("k")], [JE.col("rk")], how, jl, jr,
                          condition=_conditions(JE, JT)[cond]),
                    JB.batch_to_arrow)
    finally:
        JC.set_active(saved)
    pcond = _conditions(PE, PT)[cond]
    psaved = PC.get_active()
    for hashtable in ("true", "false"):
        PC.set_active(PC.RapidsConf(
            {"spark.rapids.gpu.sql.join.hashTable.enabled": hashtable}))
        try:
            node = PJoin([PE.col("k")], [PE.col("rk")], how, pl, pr,
                         condition=pcond)
            got = _rows(node, PB.batch_to_arrow)
        finally:
            PC.set_active(psaved)
        assert node.join_path == ("ht" if hashtable == "true" else "sorted")
        assert len(got) == len(exp) and rows_match(got, exp), hashtable
    conf = PC.RapidsConf(CPU_ONLY)
    on_cpu = port_from_arrow(left, conf, device="cpu").join(
        port_from_arrow(right, conf, device="cpu"), left_on="k",
        right_on="rk", how=how, condition=pcond).collect()
    assert len(on_cpu) == len(exp) and rows_match(on_cpu, exp)
    keys = set(right.column("rk").drop_null().to_pylist())
    if cond == "null":
        assert len(got) == {"left": 300, "full": 420, "right": 120,
                            "left_anti": 300}.get(how, 0)
    if cond == "rejects_row" and how in ("left", "full", "left_anti"):
        # a row whose key matches but whose every pair fails is kept,
        # unmatched
        kept = [r for r in got if r["k"] in keys and r["v"] <= 0]
        assert kept and all(r.get("rk") is None for r in kept)


# ---------------------------------------------------------------------------
# conditionals
# ---------------------------------------------------------------------------


def _cond_table(n=300, seed=31):
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.15
    words = np.array(["A", "B", "MIDDLE", "", "é", "Zz"])
    return pa.table({
        "i": pa.array(rng.integers(-20, 20, n), pa.int64(), mask=nulls()),
        "f": pa.array(rng.normal(0, 10, n).round(1), pa.float64(),
                      mask=nulls()),
        "d": pa.array([D(int(u)).scaleb(-2) for u in
                       rng.integers(-500, 500, n)], pa.decimal128(7, 2),
                      mask=nulls()),
        "d2": pa.array([D(int(u)).scaleb(-2) for u in
                        rng.integers(0, 900, n)], pa.decimal128(7, 2),
                       mask=nulls()),
        "s": pa.array([f"k{int(x)}" for x in rng.integers(0, 10**6, n)],
                      pa.string(), mask=nulls()),
        "c": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                      pa.string(), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
    })


def _cond_exprs(M, T):
    col, lit = M.col, M.lit
    pos = M.GreaterThan(col("i"), lit(0))  # null where i is null
    return [
        M.Alias(M.If(pos, col("d"), lit(None, T.DOUBLE)), "if_dec_null"),
        M.Alias(M.If(col("b"), col("f"), lit(-1.5)), "if_double"),
        M.Alias(M.If(pos, col("i"), lit(7)), "if_int"),
        M.Alias(M.If(pos, lit(1), lit(0)), "if_flag"),
        M.Alias(M.If(col("b"), col("c"), col("c")), "if_dict"),
        M.Alias(M.If(pos, col("s"), col("c")), "if_plain_dict"),
        M.Alias(M.Coalesce(col("d"), lit(0.0)), "coalesce_dec"),
        M.Alias(M.Coalesce(col("d"), col("d2"), lit(0.0)), "coalesce3"),
        M.Alias(M.Coalesce(col("f"), lit(None, T.DOUBLE)), "coalesce_null"),
        M.Alias(M.Coalesce(col("s"), col("c")), "coalesce_str"),
        M.Alias(M.CaseWhen([(M.LessThan(col("i"), lit(-5)), col("d")),
                            (pos, col("d2"))], lit(0.0)), "case_dec"),
        M.Alias(M.CaseWhen([(M.LessThan(col("i"), lit(-5)), col("f")),
                            (col("b"), lit(2.0))]), "case_no_else"),
        M.Alias(M.CaseWhen([(pos, col("c"))], col("c")), "case_dict"),
    ]


def _jax_project(exprs, t):
    t = JB.dictionary_encode_table(t)
    schema = JT.Schema.from_arrow(t.schema)
    bound = JEV.bind_projection(exprs, schema)
    out = JEV.compile_projection(exprs, schema)(JB.batch_from_arrow(t))
    return JB.batch_to_arrow(out, JEV.output_schema(bound)).to_pylist()


@pytest.mark.parametrize("engine", ["device", "cpu_engine"])
def test_conditionals_match_jax(engine):
    t = _cond_table()
    exp = _jax_project(_cond_exprs(JE, JT), t)
    exprs = _cond_exprs(PE, PT)
    if engine == "device":
        enc = PB.dictionary_encode_table(t)
        batch = PB.batch_from_arrow(enc, "cpu")
        assert batch.columns[5].is_dict and not batch.columns[4].is_dict
        node = PProject(exprs, PSource([[batch]],
                                       PT.Schema.from_arrow(enc.schema)))
        got = PB.batch_to_arrow(next(node.execute(0)),
                                node.output_schema).to_pylist()
    else:
        df = port_from_arrow(t, PC.RapidsConf(CPU_ONLY), device="cpu")
        got = df.select(*exprs).collect()
    assert got == exp
    # a null predicate takes the else branch; CASE with no ELSE is null
    assert all(r["if_int"] == 7 for r, i in
               zip(got, t.column("i").to_pylist()) if i is None)
    assert any(r["case_no_else"] is None for r in got)
    # the typing: the first value branch's type
    assert isinstance(got[0]["coalesce_dec"], D)
    assert all(r["coalesce_dec"] is not None for r in got)


def test_conditional_typing_follows_the_first_value_branch():
    schema = PT.Schema.from_arrow(_cond_table().schema)
    col, lit = PE.col, PE.lit
    r = PE.resolve(PE.If(col("b"), col("d"), lit(None, PT.DOUBLE)), schema)
    assert r.dtype == PT.DecimalType(7, 2)
    assert r.children[2].dtype == PT.DecimalType(7, 2)
    r = PE.resolve(PE.Coalesce(col("d"), lit(0.0)), schema)
    assert r.dtype == PT.DecimalType(7, 2)
    assert isinstance(r.children[1], PE.Literal)  # re-typed, not a Cast
    assert PE.Sum(PE.resolve(PE.If(col("b"), lit(1), lit(0)),
                             schema)).dtype == PT.LONG
    # a non-literal branch of another type becomes a Cast, which tagging
    # holds to the device's casts: double -> decimal is one of them, so
    # the projection runs on the device, as the CPU engine computes it
    r = PE.resolve(PE.If(col("b"), col("d"), col("f")), schema)
    assert isinstance(r.children[2], PE.Cast)
    sel = [PE.Alias(PE.If(col("b"), col("d"), col("f")), "x")]
    df = port_from_arrow(_cond_table(), device="cpu").select(*sel)
    assert "!" not in df.explain()
    cpu = port_from_arrow(_cond_table(), PC.RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
    assert df.collect() == cpu.select(*sel).collect()


# ---------------------------------------------------------------------------
# the distinct rewrite
# ---------------------------------------------------------------------------


def _distinct_table(n=500, seed=41):
    """g and gs are declared non-nullable (the keyed rewrite needs that);
    gn is nullable and holds nulls."""
    rng = np.random.default_rng(seed)
    schema = pa.schema([pa.field("g", pa.int64(), nullable=False),
                        pa.field("gs", pa.string(), nullable=False),
                        ("gn", pa.int64()), ("x", pa.int64()),
                        ("p", pa.decimal128(7, 2))])
    return pa.table({
        "g": pa.array(rng.integers(0, 7, n), pa.int64()),
        "gs": pa.array([f"grp{int(x)}" for x in rng.integers(0, 4, n)],
                       pa.string()),
        "gn": pa.array(rng.integers(0, 5, n), pa.int64(),
                       mask=rng.random(n) < 0.1),
        "x": pa.array(rng.integers(0, 40, n), pa.int64(),
                      mask=rng.random(n) < 0.1),
        "p": pa.array([D(int(u)).scaleb(-2) for u in
                       rng.integers(0, 300, n)], pa.decimal128(7, 2)),
    }, schema=schema)


def _distinct_query(M, df, keys, alias_keys=False):
    if alias_keys:
        keys = [M.Alias(M.col(k), k) for k in keys]
    cond = M.GreaterThan(M.col("x"), M.lit(10))
    v = M.If(cond, M.col("p"), M.lit(None, JT.DOUBLE if M is JE
                                     else PT.DOUBLE))
    aggs = [M.Alias(M.CountDistinct(M.col("x")), "nx"),
            M.Alias(M.Sum(M.col("p")), "sp"),
            M.Alias(M.CountDistinct(v), "nv"),
            M.Alias(M.Count(v), "cv")]
    return df.group_by(*keys).agg(*aggs) if keys else df.agg(*aggs)


@pytest.mark.parametrize("keys", [[], ["g"], ["g", "gs"], ["gn"]])
def test_distinct_rewrite_matches_jax(keys):
    t = _distinct_table()
    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1
    # the reference's keyed rewrite names its output keys by their repr,
    # so it plans only aliased keys (ROADMAP.md, queue 3)
    exp = _distinct_query(JE, jdf, keys, alias_keys=True).collect()
    df = _distinct_query(PE, port_from_arrow(t, batch_rows=128,
                                             device="cpu"), keys)
    plan = df.explain()
    if keys == ["gn"]:
        # a nullable group key: not rewritten, the aggregate on the CPU
        assert "#dx" not in plan
        assert [ln.strip()[:11] for ln in plan.splitlines()
                if ln.lstrip().startswith("!")] == ["! Aggregate"]
    else:
        assert "!" not in plan and "#dx1" in plan
        assert plan.count("Join[inner]") == 2
    got = df.collect()
    assert rows_match(got, exp) and len(got) == len(exp)
    on_cpu = _distinct_query(PE, port_from_arrow(
        t, PC.RapidsConf(CPU_ONLY), device="cpu"), keys)
    assert "#dx" not in on_cpu.explain()  # the CPU engine counts natively
    assert rows_match(on_cpu.collect(), exp)
    assert [list(r) for r in got[:1]] == [list(r) for r in exp[:1]]


@pytest.mark.parametrize("keys", [[], ["g"], ["gn"]])
def test_single_distinct_rewrite_matches_jax(keys):
    """An aggregate whose only function is one COUNT(DISTINCT x) plans as
    two aggregates on the device, no join, nullable keys included (the
    null key is a group of its own). Without keys the reference returns
    no row at all (ROADMAP.md queue 3); the port's one row is held
    against the distinct non-null values counted in Python."""
    t = _distinct_table()
    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1

    def query(M, df, alias_keys):
        ks = [M.Alias(M.col(k), k) for k in keys] if alias_keys else keys
        agg = M.Alias(M.CountDistinct(M.col("x")), "nx")
        return df.group_by(*ks).agg(agg) if keys else df.agg(agg)
    exp = query(JE, jdf, True).collect()
    if not keys:
        assert exp == []
        exp = [{"nx": len({v for v in t.column("x").to_pylist()
                           if v is not None})}]
    df = query(PE, port_from_arrow(t, batch_rows=128, device="cpu"), False)
    plan = df.explain()
    assert "!" not in plan and "Join" not in plan and "#dx0" in plan
    got = df.collect()
    assert len(got) == len(exp) and rows_match(got, exp)
    if keys == ["gn"]:
        assert any(r["gn"] is None for r in got)
