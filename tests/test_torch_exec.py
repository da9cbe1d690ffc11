"""The port's physical operators (spark_rapids_tpu_torch.exec) held against
the JAX package's on small seeded tables split into several batches:
Filter, Project, HashJoin (the hash-table path on both sides), HashAggregate
and Sort with a limit."""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exec import (BatchSourceExec as JSource,
                                   FilterExec as JFilter,
                                   HashAggregateExec as JAgg,
                                   HashJoinExec as JJoin,
                                   ProjectExec as JProject, SortOrder as JOrd)
from spark_rapids_tpu.exec import kernels as JK
from spark_rapids_tpu.exec.misc import take_ordered_and_project
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.exec.aggregate import HashAggregateExec as PAgg
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.join import HashJoinExec as PJoin
from spark_rapids_tpu_torch.exec.project import (FilterExec as PFilter,
                                                 ProjectExec as PProject)
from spark_rapids_tpu_torch.exec.sort import SortExec as PSort
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.exprs import expr as PE

# the JAX join takes its general hash-table path under these
HT_CONF = {"spark.rapids.tpu.sql.join.denseKey.maxDomain": "0",
           "spark.rapids.tpu.sql.join.uniqueTable.maxSlots": "0"}


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


def _run_jax(node):
    tables = [JB.batch_to_arrow(b, node.output_schema)
              for b in node.execute(0)]
    return pa.concat_tables(tables).to_pylist() if tables else []


def _run_port(node):
    tables = [PB.batch_to_arrow(b, node.output_schema)
              for b in node.execute(0)]
    return pa.concat_tables(tables).to_pylist() if tables else []


def _fact(n, seed):
    rng = np.random.default_rng(seed)
    flags = np.array(["A", "N", "R"])
    return pa.table({
        "k": pa.array(rng.integers(0, 60, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "k2": pa.array(rng.integers(0, 4, n), pa.int64()),
        "flag": pa.array(flags[rng.integers(0, 3, n)].tolist(), pa.string()),
        "price": pa.array(np.round(rng.uniform(1, 1000, n), 2), pa.float64()),
        "disc": pa.array(rng.integers(0, 11, n) * 0.01, pa.float64()),
        "day": pa.array(rng.integers(8000, 10000, n).astype(np.int32),
                        pa.int32()).cast(pa.date32()),
    })


def _dim(n, seed, dup):
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, 80, n) if dup
            else rng.permutation(np.arange(0, 2 * n, 2)))
    return pa.table({
        "dk": pa.array(keys, pa.int64()),
        "dk2": pa.array(rng.integers(0, 4, n), pa.int64()),
        "name": pa.array([f"NATION_{int(x):02d}" for x in
                          rng.integers(0, 30, n)], pa.string()),
    })


def _filter_cond(E, T):
    return E.And(E.GreaterThanOrEqual(E.col("day"), E.lit(8500, T.DATE)),
                 E.LessThan(E.col("price"), E.lit(700.0)))


@pytest.mark.parametrize("rows_per_batch", [64, 1000])
def test_filter_matches(rows_per_batch):
    js, ps = _sources(_fact(700, 1), rows_per_batch)
    exp = _run_jax(JFilter(_filter_cond(JE, JT), js))
    got = _run_port(PFilter(_filter_cond(PE, PT), ps))
    assert got == exp and len(got) > 0


def test_filter_on_dictionary_string_equality():
    js, ps = _sources(_fact(300, 2), 128)
    exp = _run_jax(JFilter(JE.col("flag").eq("R"), js))
    got = _run_port(PFilter(PE.col("flag").eq("R"), ps))
    assert got == exp and 0 < len(got) < 300


def test_project_matches():
    js, ps = _sources(_fact(300, 3), 100)

    def exprs(E):
        return [E.col("flag"),
                E.Alias(E.Multiply(E.col("price"),
                                   E.Subtract(E.lit(1.0), E.col("disc"))),
                        "rev"),
                E.Alias(E.Add(E.col("k"), E.lit(7)), "k7")]

    exp = _run_jax(JProject(exprs(JE), js))
    got = _run_port(PProject(exprs(PE), ps))
    assert got == exp


@pytest.mark.parametrize("dup,multi", [(True, False), (False, False),
                                       (True, True)])
def test_hash_join_matches_row_for_row(dup, multi):
    fact, dim = _fact(600, 4), _dim(120, 5, dup)
    jf, pf = _sources(fact, 150)
    jd, pd_ = _sources(dim, 50)
    lk = ["k", "k2"] if multi else ["k"]
    rk = ["dk", "dk2"] if multi else ["dk"]
    saved = JC.get_active()
    JC.set_active(JC.RapidsConf(HT_CONF))
    before = JK.counters()["hashtbl_probe_total"]
    try:
        exp = _run_jax(JJoin([JE.col(c) for c in lk],
                             [JE.col(c) for c in rk], "inner", jf, jd))
    finally:
        JC.set_active(saved)
    assert JK.counters()["hashtbl_probe_total"] > before  # JAX took `ht`
    got = _run_port(PJoin([PE.col(c) for c in lk], [PE.col(c) for c in rk],
                          "inner", pf, pd_))
    assert len(got) > 0
    assert got == exp


def test_hash_join_candidate_explosion_guard():
    fact, dim = _fact(200, 6), _dim(200, 7, True)
    _, pf = _sources(fact, 200)
    _, pd_ = _sources(dim, 200)
    node = PJoin([PE.col("k")], [PE.col("dk")], "inner", pf, pd_,
                 max_candidate_rows=10)
    with pytest.raises(RuntimeError, match="candidate explosion"):
        _run_port(node)


def _agg_exprs(E):
    return [E.Sum(E.col("price")).alias("s"),
            E.Sum(E.col("k")).alias("sk"),
            E.Average(E.col("disc")).alias("a"),
            E.Count().alias("n")]


@pytest.mark.parametrize("keys", [[], ["flag"], ["flag", "k2"], ["k"]])
def test_hash_aggregate_matches(keys):
    js, ps = _sources(_fact(900, 8), 200)
    exp = _run_jax(JAgg([JE.col(k) for k in keys], _agg_exprs(JE), js))
    got = _run_port(PAgg([PE.col(k) for k in keys], _agg_exprs(PE), ps))
    assert len(got) == len(exp)
    assert rows_match(got, exp)


def test_hash_aggregate_plain_string_key_and_empty_input():
    js, ps = _sources(_dim(200, 9, True), 64)
    exp = _run_jax(JAgg([JE.col("name")], [JE.Count().alias("n")], js))
    got = _run_port(PAgg([PE.col("name")], [PE.Count().alias("n")], ps))
    assert rows_match(got, exp)
    # a global aggregate over no rows still yields one row
    js, ps = _sources(_fact(50, 1), 64)

    def empty(E, T, src):
        return E.LessThan(E.col("price"), E.lit(-1.0))

    exp = _run_jax(JAgg([], _agg_exprs(JE),
                        JFilter(empty(JE, JT, js), js)))
    got = _run_port(PAgg([], _agg_exprs(PE),
                         PFilter(empty(PE, PT, ps), ps)))
    assert got == exp == [{"s": None, "sk": None, "a": None, "n": 0}]


@pytest.mark.parametrize("limit", [None, 10])
def test_sort_with_limit_matches(limit):
    js, ps = _sources(_fact(500, 10), 128)

    def orders(Ord, E):
        return [Ord(E.col("flag")), Ord(E.col("price"), ascending=False),
                Ord(E.col("k"))]

    if limit is None:
        from spark_rapids_tpu.exec import SortExec as JSort

        jnode = JSort(orders(JOrd, JE), js)
    else:
        jnode = take_ordered_and_project(orders(JOrd, JE), limit, js)
    exp = _run_jax(jnode)
    got = _run_port(PSort(orders(POrd, PE), ps, limit=limit))
    assert got == exp
    assert len(got) == (limit or 500)


def test_dataframe_select_limit_and_join_on():
    from spark_rapids_tpu_torch.plan import from_arrow

    t = pa.table({"a": pa.array([1, 2, 3, 4, 5], pa.int64()),
                  "b": pa.array([10.0, 20.0, 30.0, 40.0, 50.0])})
    df = from_arrow(t, batch_rows=2, device="cpu")
    out = (df.select("a", (PE.col("b") * 2.0).alias("b2"))
           .limit(2, offset=1).collect())
    assert out == [{"a": 2, "b2": 40.0}, {"a": 3, "b2": 60.0}]
    other = from_arrow(pa.table({"a": pa.array([2, 2, 9], pa.int64()),
                                 "c": pa.array(["x", "y", "z"])}),
                       device="cpu")
    j = df.join(other, on="a").to_arrow()
    assert j.column_names == ["a", "b", "a", "c"]
    assert j.column(3).to_pylist() == ["x", "y"]
    assert j.column(1).to_pylist() == [20.0, 20.0]


def test_hash_aggregate_over_no_batches_keeps_source_device():
    schema = _fact(4, 1).schema
    exp = _run_jax(JAgg([], _agg_exprs(JE),
                        JSource([[]], JT.Schema.from_arrow(schema))))
    got = _run_port(PAgg([], _agg_exprs(PE),
                         PSource([[]], PT.Schema.from_arrow(schema),
                                 device="cpu")))
    assert len(got) == 1 and got == exp
    # a source that knows no device does not fall back to the CPU
    with pytest.raises(ValueError, match="no device"):
        _run_port(PAgg([], _agg_exprs(PE),
                       PSource([[]], PT.Schema.from_arrow(schema))))
