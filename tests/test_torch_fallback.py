"""The port's plan tagging and CPU fallback engine
(spark_rapids_tpu_torch.plan.overrides / plan.cpu / plan.cpu_agg), held
against the JAX package on the same seeded tables:

- Or, Not, IsNull, IsNotNull and In on the device path and in the CPU
  engine against the JAX package's compile_projection, over plain strings,
  dictionary strings, int64, double and decimal(7,2), with nulls;
- ORDER BY on plain strings of 0-40 bytes with shared prefixes and nulls
  against the reference's sort_indices, both directions;
- one mixed device/CPU plan per fallback trigger (a string ordering
  comparison, a DECIMAL128 result), each equal to the JAX planner, marked
  ``!`` in explain, and raising NotImplementedError naming its reason
  when fallback is disabled; string equality of two columns, a trigger
  until the device compared two string columns, now plans wholly on the
  device and equals the JAX planner with fallback disabled too;
- the CPU engine's operators with the whole plan on the host
  (``spark.rapids.gpu.sql.enabled=false``) against the JAX planner;
- the transitions (one conversion each way) and the placement rules.
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exec import kernels as JK
from spark_rapids_tpu.exec.sort import SortOrder as JOrd
from spark_rapids_tpu.exprs import eval as JEV
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec import kernels as PK
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.project import ProjectExec as PProject
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import cpu as PCPU
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

D = decimal.Decimal
CPU_ONLY = {"spark.rapids.gpu.sql.enabled": "false"}
NO_FALLBACK = {"spark.rapids.gpu.sql.fallback.enabled": "false"}


def _table(n=400, seed=3):
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < 0.15

    f = rng.normal(0, 10, n).round(1)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    words = np.array(["A", "B", "MIDDLE", "", "é", "Zz"])
    return pa.table({
        "i": pa.array(rng.integers(-20, 20, n), pa.int64(), mask=nulls()),
        "f": pa.array(f, pa.float64(), mask=nulls()),
        "d": pa.array([D(int(u)).scaleb(-2) for u in
                       rng.integers(-500, 500, n)], pa.decimal128(7, 2),
                      mask=nulls()),
        "s": pa.array([f"k{int(x)}" for x in rng.integers(0, 10**6, n)],
                      pa.string(), mask=nulls()),
        "c": pa.array(words[rng.integers(0, len(words), n)].tolist(),
                      pa.string(), mask=nulls()),
        "b1": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
        "b2": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
    })


def _logic_exprs(M, T):
    col, lit = M.col, M.lit
    sample_s = "k" + str(int(np.random.default_rng(3).integers(0, 10**6)))
    return [
        M.Alias(M.Or(col("b1"), col("b2")), "or"),
        M.Alias(M.Not(col("b1")), "not"),
        M.Alias(M.Not(M.Or(M.And(col("b1"), col("b2")), col("b1"))), "nor"),
        M.Alias(M.Or(M.GreaterThan(col("i"), lit(5)), M.IsNull(col("f"))),
                "or_cmp"),
        M.Alias(M.IsNull(col("s")), "isnull_s"),
        M.Alias(M.IsNotNull(col("c")), "notnull_c"),
        M.Alias(M.IsNull(col("d")), "isnull_d"),
        M.Alias(M.IsNotNull(col("f")), "notnull_f"),
        M.Alias(M.In(col("i"), [lit(3), lit(7), lit(-11)]), "in_i"),
        M.Alias(M.In(col("i"), [lit(3), lit(None, T.LONG)]), "in_i_null"),
        M.Alias(M.In(col("f"), [lit(0.5), lit(-0.0), lit(float("nan"))]),
                "in_f"),
        M.Alias(M.In(col("d"), [lit(D("1.50")), lit(D("-3.25"))]), "in_d"),
        M.Alias(M.In(col("s"), [lit(sample_s), lit("k1")]), "in_s"),
        M.Alias(M.In(col("s"), [lit("k1"), lit(None, T.STRING)]),
                "in_s_null"),
        M.Alias(M.In(col("c"), [lit("A"), lit("é")]), "in_c"),
        M.Alias(M.In(col("c"), [lit("Zz"), lit(None, T.STRING)]),
                "in_c_null"),
        M.Alias(M.Not(M.In(col("c"), [lit("B"), lit("MIDDLE")])), "not_in_c"),
    ]


def _jax_project(exprs, t):
    t = JB.dictionary_encode_table(t)
    schema = JT.Schema.from_arrow(t.schema)
    bound = JEV.bind_projection(exprs, schema)
    out = JEV.compile_projection(exprs, schema)(JB.batch_from_arrow(t))
    return JB.batch_to_arrow(out, JEV.output_schema(bound)).to_pylist()


@pytest.mark.parametrize("engine", ["device", "cpu_engine"])
def test_logic_expressions_match_jax(engine):
    t = _table()
    exp = _jax_project(_logic_exprs(JE, JT), t)
    exprs = _logic_exprs(PE, PT)
    if engine == "device":
        enc = PB.dictionary_encode_table(t)
        assert PB.batch_from_arrow(enc, "cpu").columns[4].is_dict
        assert not PB.batch_from_arrow(enc, "cpu").columns[3].is_dict
        node = PProject(exprs, PSource([[PB.batch_from_arrow(enc, "cpu")]],
                                       PT.Schema.from_arrow(enc.schema)))
        got = PB.batch_to_arrow(next(node.execute(0)),
                                node.output_schema).to_pylist()
    else:
        df = port_from_arrow(t, RapidsConf(CPU_ONLY), device="cpu")
        got = df.select(*exprs).collect()
    assert got == exp
    # three-valued logic, spelled out once: null OR true is true, null OR
    # false is null, and IN with a null item and no match is null
    assert any(r["or"] is None for r in got)
    assert any(r["in_i_null"] is None for r in got)


def _strings(n, seed):
    rng = np.random.default_rng(seed)
    prefixes = ["", "a", "ab", "abcdefgh", "abcdefghij", "abcdefghijklmnop"]
    out = []
    for _ in range(n):
        p = prefixes[rng.integers(0, len(prefixes))]
        tail = "".join(chr(c) for c in rng.integers(97, 100,
                                                    rng.integers(0, 30)))
        out.append((p + tail)[:40])
    return out


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("nulls_first", [None, True, False])
def test_plain_string_order_matches_reference(ascending, nulls_first):
    rng = np.random.default_rng(17)
    vals = _strings(600, 5)
    t = pa.table({"s": pa.array(vals, pa.string(),
                                mask=rng.random(600) < 0.1),
                  "r": pa.array(np.arange(600), pa.int64())})
    pb = PB.batch_from_arrow(t, "cpu")
    assert pb.columns[0].offsets is not None  # plain, not a dictionary
    got = PK.sort_indices(pb, [PK.SortSpec(0, ascending, nulls_first)])
    jb = JB.batch_from_arrow(t)
    specs = JK.str_key_words(jb, [JK.SortSpec(0, ascending, nulls_first)])
    exp = np.asarray(JK.sort_indices(jb, specs))[:600]
    np.testing.assert_array_equal(got.numpy(), exp)


def test_plain_string_order_breaks_ties_past_the_end():
    vals = ["ab\x00", "ab", "a", "", "ab\x00\x00", "abc", "aa" * 20,
            "aa" * 20 + "\x00", "b"]
    t = pa.table({"s": pa.array(vals, pa.string())})
    pb = PB.batch_from_arrow(t, "cpu")
    for asc in (True, False):
        got = PK.sort_indices(pb, [PK.SortSpec(0, asc)]).tolist()
        exp = sorted(range(len(vals)), key=lambda i: vals[i].encode(),
                     reverse=not asc)
        assert got == exp


def _mixed_table(n=300, seed=11):
    rng = np.random.default_rng(seed)
    s = [f"v{int(x)}" for x in rng.integers(0, 50, n)]
    s2 = [v if rng.random() < 0.3 else f"v{int(x)}"
          for v, x in zip(s, rng.integers(0, 50, n))]
    return pa.table({
        "g": pa.array(rng.integers(0, 5, n), pa.int64()),
        "s": pa.array(s, pa.string(), mask=rng.random(n) < 0.1),
        "s2": pa.array(s2, pa.string()),
        "x": pa.array(rng.integers(-100, 100, n), pa.int64()),
        "w": pa.array([D(int(u)).scaleb(-2) for u in
                       rng.integers(-10**17, 10**17, n)],
                      pa.decimal128(18, 2), mask=rng.random(n) < 0.1),
    })


def _trigger_query(M, which, df):
    col, lit = M.col, M.lit
    if which == "string_ordering":
        q = (df.filter(M.LessThan(col("s"), lit("v3")))
             .group_by("g").agg(M.Sum(col("x")).alias("sx"),
                                M.Count().alias("n")))
    elif which == "string_equality_of_columns":
        q = (df.filter(M.EqualTo(col("s"), col("s2")))
             .group_by("g").agg(M.Count().alias("n")))
    else:  # a decimal(28,2) sum of a decimal(18,2) column
        return df.group_by("g").agg(M.Sum(col("w")).alias("sw"),
                                    M.Count(col("w")).alias("n"))
    return q.sort("g")


# (explain mark, reason) of each trigger; None: the case runs wholly on
# the device (string equality of two columns: codes or bytes compared
# there; a DECIMAL128 sum: two int64 limbs a row there)
TRIGGERS = {"string_ordering": ("! Filter", "string ordering comparison"),
            "string_equality_of_columns": None,
            "decimal128_result": None}


@pytest.mark.parametrize("which", sorted(TRIGGERS))
def test_fallback_trigger_gives_mixed_plan_equal_to_jax(which):
    t = _mixed_table()
    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1
    exp = _trigger_query(JE, which, jdf).collect()
    q = _trigger_query(PE, which, port_from_arrow(t, batch_rows=64,
                                                  device="cpu"))
    text = q.explain()
    bad = [ln for ln in text.splitlines() if ln.lstrip().startswith("!")]
    if TRIGGERS[which] is None:
        assert not bad, text
        got = q.collect()
        assert len(got) == len(exp) == 5
        # no ORDER BY over the wide sum: its rows as a multiset
        same = rows_match if which == "decimal128_result" else (
            lambda a, b: a == b)
        assert same(got, exp)
        assert same(_trigger_query(PE, which, port_from_arrow(
            t, RapidsConf(NO_FALLBACK), device="cpu")).collect(), exp)
        return
    mark, reason = TRIGGERS[which]
    assert len(bad) == 1 and bad[0].lstrip().startswith(mark), text
    assert reason in bad[0]
    assert "* InMemoryScan" in text  # the scan stays on the device
    assert q.explain("NOT_ON_GPU").strip() == bad[0].strip()
    got = q.collect()
    assert len(got) == len(exp) == 5
    assert got == exp
    with pytest.raises(NotImplementedError, match=reason):
        _trigger_query(PE, which, port_from_arrow(
            t, RapidsConf(NO_FALLBACK), device="cpu")).collect()


def test_decimal128_column_keeps_its_consumers_on_the_cpu():
    # a wide column whose consumer the device refuses keeps that node on
    # the CPU engine: the decimal(28,2) sums are made on the device, and an
    # aggregate grouped by them (a DECIMAL128 group key, which the
    # reference's device refuses too) runs on the CPU engine, the sort
    # above it on the device again
    t = _mixed_table()
    q = (_trigger_query(PE, "decimal128_result",
                        port_from_arrow(t, device="cpu"))
         .group_by("sw").agg(PE.Count().alias("k")).sort("sw"))
    text = q.explain()
    off = [ln for ln in text.splitlines() if ln.lstrip().startswith("!")]
    assert len(off) == 1 and "decimal128 group key" in off[0], text
    assert "* Sort" in text and "* Aggregate" in text
    got = q.to_arrow()
    assert str(got.schema.field("sw").type) == "decimal128(28, 2)"
    on_cpu = (_trigger_query(PE, "decimal128_result", port_from_arrow(
        t, RapidsConf({"spark.rapids.gpu.sql.enabled": "false"}),
        device="cpu")).group_by("sw").agg(PE.Count().alias("k")).sort("sw"))
    assert got.to_pylist() == on_cpu.to_arrow().to_pylist()
    assert sum(r["k"] for r in got.to_pylist()) == 5


def test_decimal128_window_min_max_runs_on_the_cpu_engine():
    """A window Min/Max over decimal(22,2) is not on the device (the
    reference's rule); the Window node runs on the CPU engine in a mixed
    plan, its values exact, equal to the JAX planner's (whose CPU engine
    runs it too)."""
    from spark_rapids_tpu.exprs import window as JW
    from spark_rapids_tpu_torch.exprs import window as PW

    rng = np.random.default_rng(17)
    n = 120
    t = pa.table({
        "r": pa.array(np.arange(n), pa.int64()),
        "g": pa.array(rng.integers(0, 4, n), pa.int64()),
        "w": pa.array([D(int(u) * 10**7 + int(v)).scaleb(-2) for u, v in zip(
            rng.integers(-10**12, 10**12, n), rng.integers(0, 10**7, n))],
            pa.decimal128(22, 2), mask=rng.random(n) < 0.15)})

    def q(M, W, Ord, df):
        order = [Ord(M.col("r"))]
        return df.with_window(
            W.over(M.Max(M.col("w")), W.window_spec(["g"], order)).alias(
                "run_mx"),
            W.over(M.Min(M.col("w")), W.window_spec(
                ["g"], order, W.WindowFrame("rows", -2, 1))).alias("mn"),
            W.over(M.Max(M.col("w")), W.window_spec(
                ["g"], order, W.WindowFrame("rows", None, None))).alias(
                "mx")).select("r", "g", "w", "run_mx", "mn", "mx").sort("r")

    jdf = jax_from_arrow(t)
    jdf.shuffle_partitions = 1
    exp = q(JE, JW, JOrd, jdf).collect()
    port = q(PE, PW, POrd, port_from_arrow(t, batch_rows=32, device="cpu"))
    text = port.explain()
    off = [ln for ln in text.splitlines() if ln.lstrip().startswith("!")]
    assert len(off) == 1 and off[0].lstrip().startswith("! Window"), text
    assert "decimal128 window function not on device" in off[0]
    got = port.collect()
    assert len(got) == n and got == exp
    assert any(r["mn"] is not None and abs(r["mn"]) > 2**63 / 100
               for r in got)
    with pytest.raises(NotImplementedError, match="decimal128 window"):
        q(PE, PW, POrd, port_from_arrow(t, RapidsConf(NO_FALLBACK),
                                        device="cpu")).collect()


def _cpu_engine_query(M, which, d):
    col, lit = M.col, M.lit
    Ord, T = (JOrd, JT) if M is JE else (POrd, PT)
    fact, dim = d["fact"], d["dim"]
    if which == "aggregate":
        return fact.group_by("c", "b1").agg(
            M.Sum(col("d")).alias("sd"), M.Average(col("d")).alias("ad"),
            M.Average(col("f")).alias("af"), M.Min(col("f")).alias("mnf"),
            M.Max(col("f")).alias("mxf"), M.Sum(col("i")).alias("si"),
            M.Average(col("i")).alias("ai"), M.Count(col("d")).alias("cd"),
            M.Count().alias("n"))
    if which == "join":
        return fact.join(dim, left_on="i", right_on="k").select(
            "i", "c", "v", "d")
    if which == "sort":
        return fact.select("f", "i", "c", "r").sort(
            Ord(col("f"), False), Ord(col("c"), True, False), "r", limit=120)
    if which == "filter_project":
        return fact.filter(M.Or(M.GreaterThan(col("i"), lit(4)),
                                M.IsNull(col("d")))).select(
            col("r"), M.Alias(M.Multiply(col("d"), col("i")), "di"),
            M.Alias(M.Add(col("d"), lit(D("0.125"))), "dd"),
            M.Alias(M.Cast(col("d"), T.DOUBLE), "dbl"))
    if which == "limit":
        return fact.select("r", "c").limit(7, offset=3)
    if which == "global_empty":
        return fact.filter(M.GreaterThan(col("i"), lit(1000))).agg(
            M.Sum(col("d")).alias("sd"), M.Count().alias("n"),
            M.Average(col("f")).alias("af"))
    raise KeyError(which)


def _engine_tables():
    t = _table(500, 21).append_column(
        "r", pa.array(np.arange(500), pa.int64()))
    rng = np.random.default_rng(4)
    dim = pa.table({"k": pa.array(rng.integers(-25, 25, 60), pa.int64(),
                                  mask=rng.random(60) < 0.1),
                    "v": pa.array(rng.normal(0, 1, 60), pa.float64())})
    return {"fact": t, "dim": dim}


@pytest.mark.parametrize("which", ["aggregate", "join", "sort",
                                   "filter_project", "limit",
                                   "global_empty"])
def test_cpu_engine_matches_jax(which):
    tabs = _engine_tables()
    jd = {}
    for k, v in tabs.items():
        jd[k] = jax_from_arrow(v)
        jd[k].shuffle_partitions = 1
    exp = _cpu_engine_query(JE, which, jd).collect()
    pd_ = {k: port_from_arrow(v, RapidsConf(CPU_ONLY), device="cpu")
           for k, v in tabs.items()}
    q = _cpu_engine_query(PE, which, pd_)
    assert all(ln.lstrip().startswith("!") for ln in
               q.explain().splitlines())
    got = q.collect()
    dev = _cpu_engine_query(PE, which, {
        k: port_from_arrow(v, batch_rows=128, device="cpu")
        for k, v in tabs.items()}).collect()
    if which in ("sort", "limit"):
        # ordered results: exactly, in order (NaN compared as a string)
        assert _nan_str(got) == _nan_str(exp) == _nan_str(dev)
    else:
        assert rows_match(got, exp) and rows_match(dev, exp)
        assert len(got) == len(exp)
    if which == "global_empty":
        assert got == [{"sd": None, "n": 0, "af": None}]


def _nan_str(rows):
    return [{k: "NaN" if isinstance(v, float) and v != v else v
             for k, v in r.items()} for r in rows]


def test_transitions_convert_once_each_way(monkeypatch):
    t = _mixed_table()
    calls = {"up": 0, "down": 0}
    real_up, real_down = PCPU.batch_from_arrow, PCPU.batch_to_arrow

    def up(*a, **k):
        calls["up"] += 1
        return real_up(*a, **k)

    def down(*a, **k):
        calls["down"] += 1
        return real_down(*a, **k)

    monkeypatch.setattr(PCPU, "batch_from_arrow", up)
    monkeypatch.setattr(PCPU, "batch_to_arrow", down)
    # device scan (5 batches) -> CPU filter -> device aggregate and sort
    q = _trigger_query(PE, "string_ordering",
                       port_from_arrow(t, batch_rows=64, device="cpu"))
    node = q.physical_plan()
    assert type(node).__name__ == "SortExec"
    assert type(node.children[0].children[0]).__name__ == "CpuFilterExec"
    q.collect()
    assert calls == {"up": 5, "down": 5}


def test_placement_is_decided_at_plan_time():
    t = _mixed_table()
    df = port_from_arrow(t, device="cpu")
    q = df.filter(PE.EqualTo(PE.col("s"), PE.lit("v3"))).select("g", "s")
    assert "!" not in q.explain()
    node = q.physical_plan()
    assert not any(isinstance(n, PCPU.CpuExec) for n in _walk(node))
    off = port_from_arrow(t, RapidsConf(CPU_ONLY), device="cpu")
    node = off.filter(PE.EqualTo(PE.col("s"), PE.lit("v3"))).physical_plan()
    assert all(isinstance(n, PCPU.CpuExec) for n in _walk(node))
    assert node.plan_device().type == "cpu"


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def test_nodes_neither_side_runs_raise_naming_the_reason():
    t = _mixed_table()
    df = port_from_arrow(t, device="cpu")
    with pytest.raises(NotImplementedError, match="cross join"):
        df.join(df, on="g", how="cross").collect()
    from spark_rapids_tpu_torch.exprs import window as PW

    spec = PW.window_spec(partition_by=["g"], order_by=[POrd(PE.col("x"))])
    bounded = PW.window_spec(["g"], [POrd(PE.col("x"), False)],
                             PW.WindowFrame("range", -1, 1))
    with pytest.raises(NotImplementedError, match="bounded RANGE"):
        df.with_window(PW.over(PE.Sum(PE.col("x")), bounded).alias("w")
                       ).collect()
    # the CPU engine's window operator has the device's window surface: a
    # bounded RANGE frame over a descending order key raises there too, a
    # rank and a lead/lag run and give the device's rows
    cpu = port_from_arrow(t, RapidsConf(CPU_ONLY), device="cpu")
    with pytest.raises(NotImplementedError, match="bounded RANGE"):
        cpu.with_window(PW.over(PE.Sum(PE.col("x")), bounded).alias("w")
                        ).collect()
    for f in (PW.Rank(), PW.Lead(PE.col("x")), PW.Lag(PE.col("x"), 2)):
        on_cpu = cpu.with_window(PW.over(f, spec).alias("w"))
        assert all(ln.lstrip().startswith("!")
                   for ln in on_cpu.explain().splitlines())
        assert on_cpu.collect() == df.with_window(
            PW.over(f, spec).alias("w")).collect()


@pytest.mark.parametrize("conf", [None, CPU_ONLY])
def test_typing_errors_raise_instead_of_placing_on_the_cpu(conf):
    """An unknown column is an error on both engines: tagging (or the CPU
    engine) raises it, it is never a reason that moves the node to the CPU
    engine."""
    df = port_from_arrow(_mixed_table(), conf and RapidsConf(conf),
                         device="cpu")
    with pytest.raises(KeyError, match="nope"):
        df.filter(PE.col("nope") > PE.lit(1)).collect()
    with pytest.raises(KeyError, match="nope"):
        df.select(PE.Cast(PE.col("nope"), PT.DOUBLE).alias("c")).collect()


def test_global_aggregate_over_an_empty_join_is_one_row():
    t = _mixed_table()
    dim = pa.table({"k": pa.array([10_000], pa.int64())})
    for conf in (None, RapidsConf(CPU_ONLY)):
        df = port_from_arrow(t, conf, batch_rows=64, device="cpu")
        q = df.join(port_from_arrow(dim, conf, device="cpu"),
                    left_on="g", right_on="k").agg(
            PE.Count().alias("n"), PE.Sum(PE.col("w")).alias("sw"),
            PE.Average(PE.col("x")).alias("ax"))
        assert q.collect() == [{"n": 0, "sw": None, "ax": None}]


def test_string_hash_power_table_stays_on_its_device():
    t = pa.table({"s": pa.array(_strings(300, 9), pa.string())})
    col = PB.batch_from_arrow(t, "cpu").columns[0]
    PK._POW_TABLES.clear()
    first = PK._string_hash(col, 1)
    table = PK._POW_TABLES[(1, col.device)]
    longest = int(col.lengths().max())
    # the longest row, rounded up by doubling; not the column's total bytes
    assert longest <= table.numel() < 2 * longest < col.data.numel()
    assert table.numel() & (table.numel() - 1) == 0
    again = PK._string_hash(col, 1)
    assert PK._POW_TABLES[(1, col.device)] is table  # nothing rebuilt
    assert PK._string_hash(PB.batch_from_arrow(t.slice(0, 10), "cpu")
                           .columns[0], 1).equal(first[:10])
    assert torch.equal(first, again)
    p = PK._STR_P[1]
    assert [int(v) & (2**64 - 1) for v in table[:5]] == [
        pow(p, k, 2**64) for k in range(5)]
    exp = np.asarray(JK.hash_keys(JB.batch_from_arrow(t), [0], variant=1))
    got = PK.hash_keys(PB.batch_from_arrow(t, "cpu"), [0], variant=1)
    assert np.array_equal(got.numpy().view(np.uint64), exp[:300])



@pytest.mark.parametrize("mode", ["NONE", "NOT_ON_GPU", "ALL"])
def test_explain_conf_prints_the_tag_tree_at_planning(mode, capsys):
    t = _mixed_table()
    conf = RapidsConf({"spark.rapids.gpu.sql.explain": mode})
    q = _trigger_query(PE, "string_ordering",
                       port_from_arrow(t, conf, device="cpu"))
    q.physical_plan()
    out = capsys.readouterr().out
    if mode == "NONE":
        assert out == ""
    else:
        assert out.strip() == q.explain(mode).strip()
        assert ("* InMemoryScan" in out) == (mode == "ALL")
        assert "! Filter" in out
    with pytest.raises(ValueError, match="NOT_ON_GPU"):
        RapidsConf({"spark.rapids.gpu.sql.explain": "SOME"})
