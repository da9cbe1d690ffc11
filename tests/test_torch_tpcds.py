"""TPC-DS at SF 0.01 through the port's planner
(spark_rapids_tpu_torch.plan.from_arrow on the CPU): the headline queries
q3/q7/q42/q52/q96 (inner-join stars, group-by, sort with a limit or a
global count) and the window queries q44/q67 (ranks over decimal(7,2)
money columns), each held against the JAX package's planner on the same
tables (one shuffle partition) and against the pandas reference:
``rows_match`` (rel 1e-6 on doubles, exact keys, decimals and counts) and
the ORDER BY columns in order. The headline queries also run wholly on
the CPU engine (``spark.rapids.gpu.sql.enabled=false``) with the same
rows, and wholly on the device path by default. The joins slice's
queries q9/q28/q40/q43/q87/q88/q93/q97 (outer, semi and anti joins,
If/CaseWhen/Coalesce, COUNT(DISTINCT)) are held the same way, on the
device path and on the CPU engine, and so are the breadth slice's 33
queries (``PQ.BREADTH``, over all 24 tables), on the device path, on the
CPU engine and on the device path with the hash table off (the
sorted-hash join); each must show values (``PQ.informative``) except
the four named in ``PQ.EMPTY_AT_SF``, which are held again at the
smallest SF where they show values. The port's generated tables equal
the reference's."""

import pytest

from spark_rapids_tpu.bench import tpcds_queries as JQ
from spark_rapids_tpu.bench import tpcds_schema as JS
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
from spark_rapids_tpu_torch.plan.overrides import join_paths

SF = 0.01
_CACHE = {}


def _tables():
    if "t" not in _CACHE:
        _CACHE["t"] = PS.tables_for(SF)
    return _CACHE["t"]


def _join_tables():
    if "j" not in _CACHE:
        _CACHE["j"] = PS.tables_for(SF, names=PQ.tables_of(PQ.JOINS))
    return _CACHE["j"]


def _breadth_tables():
    if "b" not in _CACHE:
        _CACHE["b"] = PS.tables_for(SF, names=PQ.tables_of(PQ.BREADTH))
    return _CACHE["b"]


def _jax_rows(q, tables=None):
    """The JAX package's answer, once per query per process (on the
    test's tables unless ``tables`` are given)."""
    key = ("jax", q, tables is None)
    if key not in _CACHE:
        dfs = {}
        tables = tables or (
            _tables() if q not in PQ.TABLES else
            {k: (_breadth_tables() if q in PQ.BREADTH
                 else _join_tables())[k] for k in PQ.TABLES[q]})
        for k, v in tables.items():
            df = jax_from_arrow(v)
            df.shuffle_partitions = 1
            dfs[k] = df
        _CACHE[key] = JQ.QUERIES[q](dfs).collect()
    return _CACHE[key]


@pytest.mark.parametrize("seed", [0, 5])
def test_generated_tables_equal_the_reference(seed):
    ref = JS.tables_for(SF, seed=seed)
    got = PS.tables_for(SF, seed=seed)
    assert sorted(got) == ["customer_demographics", "date_dim",
                           "household_demographics", "item", "promotion",
                           "store", "store_sales", "time_dim"]
    for name, t in got.items():
        assert t.equals(ref[name]), name
    assert str(got["store_sales"].schema.field("ss_net_profit").type) == \
        "decimal128(7, 2)"
    # the joins slice's tables, generated only when named
    more = PS.tables_for(SF, seed=seed, names=PS.JOIN_TABLES)
    assert sorted(more) == sorted(PS.JOIN_TABLES)
    for name, t in more.items():
        assert t.equals(ref[name]), name
    assert more["store_returns"].num_rows == got["store_sales"].num_rows // 10
    assert PS.tables_for(SF, seed=seed, names=("reason",))["reason"].equals(
        ref["reason"])
    # the breadth slice's nine tables, with the reference's seeds
    more = PS.tables_for(SF, seed=seed, names=PS.BREADTH_TABLES)
    assert sorted(more) == sorted(PS.BREADTH_TABLES)
    for name, t in more.items():
        assert t.equals(ref[name]), name
    assert sorted(PS.ALL_TABLES) == sorted(ref)
    assert str(more["web_returns"].schema.field("wr_fee").type) == \
        "decimal128(7, 2)"
    assert more["inventory"].num_rows == 19836


@pytest.mark.parametrize("q", ["q44", "q67"])
def test_tpcds_window_query_matches_jax_and_pandas(q):
    d = PQ.df_tables(_tables(), batch_rows=8192, device="cpu")
    got = PQ.QUERIES[q](d).to_arrow().to_pylist()
    assert len(got) == (10 if q == "q44" else 100)
    exp = _jax_rows(q)
    assert PQ.check_rows(q, got, exp) == (True, "")
    for rg, re_ in zip(got, exp):
        for k, v in rg.items():
            if not isinstance(v, float):
                assert v == re_[k]  # keys, ranks and names exactly
    assert PQ.check_rows(q, got, PQ.PANDAS[q](_tables())) == (True, "")


@pytest.mark.parametrize("q", ["q3", "q7", "q42", "q52", "q96"])
def test_tpcds_headline_query_matches_jax_and_pandas(q):
    d = PQ.df_tables(_tables(), batch_rows=8192, device="cpu")
    df = PQ.QUERIES[q](d)
    assert "!" not in df.explain()  # every node on the device path
    got = df.to_arrow().to_pylist()
    exp = _jax_rows(q)
    assert len(got) == len(exp) and len(got) >= 1
    assert PQ.check_rows(q, got, exp) == (True, "")
    for rg, re_ in zip(got, exp):
        for k, v in rg.items():
            if not isinstance(v, float):
                assert v == re_[k]  # keys, decimals and counts exactly
    assert PQ.check_rows(q, got, PQ.PANDAS[q](_tables())) == (True, "")
    cpu = PQ.df_tables(_tables(), RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
    on_cpu = PQ.QUERIES[q](cpu)
    assert all(ln.lstrip().startswith("!")
               for ln in on_cpu.explain().splitlines())
    assert PQ.check_rows(q, on_cpu.to_arrow().to_pylist(), got) == (True,
                                                                    "")


@pytest.mark.parametrize("q", ["q9", "q28", "q40", "q43", "q87", "q88",
                               "q93", "q97"])
def test_tpcds_join_query_matches_jax_and_pandas(q):
    tables = _join_tables()
    d = PQ.df_tables({k: tables[k] for k in PQ.TABLES[q]}, batch_rows=8192,
                     device="cpu")
    df = PQ.QUERIES[q](d)
    plan = df.explain()
    assert "!" not in plan  # every node on the device path
    if q == "q28":
        assert plan.count("Join[inner]") == 6  # the global distinct rewrite
    got = df.to_arrow().to_pylist()
    exp = _jax_rows(q)
    assert len(got) == len(exp) and len(got) >= 1
    assert PQ.check_rows(q, got, exp) == (True, "")
    def exact(r):
        return repr([v for v in r.values() if not isinstance(v, float)])
    for rg, re_ in zip(sorted(got, key=exact), sorted(exp, key=exact)):
        for k, v in rg.items():
            if not isinstance(v, float):
                assert v == re_[k]  # keys, decimals and counts exactly
    assert PQ.check_rows(q, got, PQ.PANDAS[q](tables)) == (True, "")
    cpu = PQ.df_tables({k: tables[k] for k in PQ.TABLES[q]}, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
    on_cpu = PQ.QUERIES[q](cpu)
    assert all(ln.lstrip().startswith("!")
               for ln in on_cpu.explain().splitlines())
    assert PQ.check_rows(q, on_cpu.to_arrow().to_pylist(), got) == (True,
                                                                    "")


@pytest.mark.parametrize("q", PQ.BREADTH)
def test_tpcds_breadth_query_matches_jax(q):
    """Each breadth query against the JAX package: exact for integers,
    decimals, strings and nulls, rel 1e-6 on doubles, ORDER BY order per
    ``ORDER_KEYS`` (``TIED_AT_LIMIT`` queries: the last tie group by its
    count). Mixed plans (q1/q30/q65/q81: a decimal(21,6) average) name
    DECIMAL128 for their CPU-engine nodes; the rest run wholly on the
    device path."""
    tables = {k: _breadth_tables()[k] for k in PQ.TABLES[q]}
    d = PQ.df_tables(tables, batch_rows=8192, device="cpu")
    df = PQ.QUERIES[q](d)
    off = [ln for ln in df.explain().splitlines()
           if ln.lstrip().startswith("!")]
    if q in ("q1", "q30", "q65", "q81"):
        assert off and all("DECIMAL128" in ln for ln in off)
    else:
        assert not off
    got = df.to_arrow().to_pylist()
    exp = _jax_rows(q)
    assert len(got) == len(exp)
    # a result with no value proves nothing: only the queries named in
    # EMPTY_AT_SF show none here (each is held below at a larger SF)
    assert PQ.informative(got) == (q not in PQ.EMPTY_AT_SF[SF])
    assert PQ.check_rows(q, got, exp) == (True, "")

    def exact(r):
        return repr([v for v in r.values() if not isinstance(v, float)])
    if q not in PQ.TIED_AT_LIMIT or len(got) < PQ.TIED_AT_LIMIT[q]:
        for rg, re_ in zip(sorted(got, key=exact), sorted(exp, key=exact)):
            for k, v in rg.items():
                if not isinstance(v, float):
                    assert v == re_[k]  # keys, decimals, strings, nulls
    cpu = PQ.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.enabled": "false"}), device="cpu")
    on_cpu = PQ.QUERIES[q](cpu)
    assert all(ln.lstrip().startswith("!")
               for ln in on_cpu.explain().splitlines())
    assert PQ.check_rows(q, on_cpu.to_arrow().to_pylist(), exp) == (True,
                                                                     "")
    off_ht = PQ.QUERIES[q](PQ.df_tables(tables, RapidsConf(
        {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}),
        batch_rows=8192, device="cpu")).physical_plan()
    assert PQ.check_rows(q, execute_to_arrow(off_ht).to_pylist(), exp) == (
        True, "")
    assert "ht" not in join_paths(off_ht)


# the smallest SF of seed 0 at which each query of EMPTY_AT_SF[SF] has values
_NONEMPTY_SF = {"q32": 0.1, "q41": 0.1, "q65": 0.1, "q92": 0.15}


@pytest.mark.parametrize("q", sorted(_NONEMPTY_SF))
def test_tpcds_breadth_empty_query_matches_jax_at_larger_sf(q):
    """The breadth queries whose result at SF 0.01 shows nothing, held
    against the JAX package where it shows values: on the device path, on
    the CPU engine and with the hash table off."""
    assert set(_NONEMPTY_SF) == set(PQ.EMPTY_AT_SF[SF])
    tables = PS.tables_for(_NONEMPTY_SF[q], names=PQ.TABLES[q])
    exp = _jax_rows(q, tables)
    assert PQ.informative(exp)
    for conf in ({}, {"spark.rapids.gpu.sql.enabled": "false"},
                 {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}):
        got = PQ.QUERIES[q](PQ.df_tables(tables, RapidsConf(conf),
                                         batch_rows=8192, device="cpu"))
        assert PQ.check_rows(q, got.to_arrow().to_pylist(), exp) == (True,
                                                                      "")
