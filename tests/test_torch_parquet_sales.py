"""The headline TPC-DS queries (q3/q7/q42/q52/q96) read from Parquet
files (``bench/parquet_sales.py``: the SF 0.01 tables written from the
port's device batches, store_sales clustered by date in 2048-row row
groups and 8192-row files) on both of the port's engines, held against
the JAX package's planner on its CPU engine over the same files (its
plan cache off); the plan shape of each query equal to the reference
planner's at the defaults (the fast path off, dynamic pruning on in
both); q3 pruning row groups dynamically, with the same rows with the
pruning off; nothing left in the pool, the leak sweep or the shuffle
directory after a query.

Tolerance: ``tpcds_queries.check_rows`` (rel 1e-6 on doubles, exact
otherwise, ORDER BY order).
"""

import os

import pytest
import torch

from spark_rapids_tpu.bench import tpcds_queries as JQ
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.plan import read_parquet as jax_read_parquet
from spark_rapids_tpu_torch.bench import parquet_sales as PSales
from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.mem.pool import get_pool
from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SF = 0.01
JAX_CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false",
                  "spark.rapids.tpu.plan.cache.enabled": "false"}
# the reference at its defaults but for the plan memo and fusion (the
# port has neither) and the fast path (off in both: SF 0.01 is under it)
JAX_DEFAULTS = {"spark.rapids.tpu.fastpath.enabled": "false",
                "spark.rapids.tpu.sql.fusion.enabled": "false",
                "spark.rapids.tpu.plan.cache.enabled": "false"}
NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
COUNTS = ("numRowGroups", "numPrunedRowGroups", "numDynPrunedRowGroups")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parquet_sales"))
    paths, stats = PSales.write_tables(PS.tables_for(SF), out, "cpu",
                                       batch_rows=2048, rows_per_file=8192)
    return paths, stats


_EXPECTED = {}


def _jax_rows(q, paths):
    if q not in _EXPECTED:
        conf = JConf(JAX_CPU_ENGINE)
        d = {}
        for name, ps in paths.items():
            d[name] = jax_read_parquet(ps, conf=conf)
            d[name].shuffle_partitions = 1
        _EXPECTED[q] = JQ.QUERIES[q](d).collect()
    return _EXPECTED[q]


def _scans(node):
    out = [node] if isinstance(node, ParquetScanExec) else []
    for c in node.children:
        out.extend(_scans(c))
    return out


def _counts(node):
    return {k: sum(s.metrics[k].value for s in _scans(node)) for k in COUNTS}


def _shuffle_files():
    from spark_rapids_tpu_torch.shuffle.manager import get_manager

    d = get_manager(RapidsConf(NO_FASTPATH))._local_dir
    return sorted(os.listdir(d)) if d and os.path.isdir(d) else []


def test_the_files_are_the_tables(files):
    import pyarrow.parquet as pq

    paths, stats = files
    tables = PS.tables_for(SF)
    for name, t in tables.items():
        back = pq.read_table(paths[name])
        if name == PSales.FACT:
            t = PSales.clustered_fact(t)
        assert back.equals(t.cast(back.schema)), name
        assert stats[name].num_rows == t.num_rows
    assert len(paths["store_sales"]) == 4
    assert PSales.row_groups(paths["store_sales"]) == 15
    assert all(len(paths[n]) == 1 for n in paths if n != PSales.FACT)


@pytest.mark.parametrize("engine", ["device", "cpu"])
@pytest.mark.parametrize("q", PQ.HEADLINE)
def test_headline_over_parquet_matches_the_reference(files, q, engine):
    paths, _ = files
    before = _shuffle_files()
    settings = dict(NO_FASTPATH)
    if engine == "cpu":
        settings["spark.rapids.gpu.sql.enabled"] = "false"
    d = PSales.df_tables(paths, RapidsConf(settings), device="cpu")
    df = PQ.QUERIES[q](d)
    assert ("!" in df.explain()) == (engine == "cpu")
    node = df.physical_plan()
    got = execute_to_arrow(node).to_pylist()
    ok, why = PQ.check_rows(q, got, _jax_rows(q, paths))
    assert ok, why
    # q96 counts 0 at SF 0.01: no store is named 'ese' there
    assert PQ.informative(got) == (q != "q96")
    assert cleaner.sweep() == []
    assert get_pool(device="cpu").used == 0
    assert _shuffle_files() == before
    if engine == "device" and q != "q96":
        assert _counts(node)["numRowGroups"] >= 15


@pytest.mark.parametrize("q", PQ.HEADLINE)
def test_headline_plan_shape_matches_the_reference(files, q):
    from test_torch_partitioned import _dpp_scans, plan_shape

    paths, _ = files
    d = PSales.df_tables(paths, RapidsConf(NO_FASTPATH), device="cpu")
    jconf = JConf(JAX_DEFAULTS)
    jd = {}
    for name, ps in paths.items():
        jd[name] = jax_read_parquet(ps, conf=jconf)
    pplan = PQ.QUERIES[q](d).physical_plan()
    jplan = JQ.QUERIES[q](jd).physical_plan()
    assert plan_shape(pplan) == plan_shape(jplan)
    assert _dpp_scans(pplan) == _dpp_scans(jplan)
    assert any(k[1:] == ("scan", 4) for k in plan_shape(pplan))


@pytest.mark.parametrize("fastpath", [True, False])
def test_q3_prunes_row_groups_dynamically(files, fastpath):
    paths, _ = files
    settings = {} if fastpath else dict(NO_FASTPATH)
    rows, counts = {}, {}
    for dpp in ("true", "false"):
        conf = RapidsConf(dict(settings, **{
            "spark.rapids.gpu.sql.dynamicPartitionPruning.enabled": dpp}))
        node = PQ.QUERIES["q3"](PSales.df_tables(
            paths, conf, device="cpu")).physical_plan()
        rows[dpp] = execute_to_arrow(node).to_pylist()
        counts[dpp] = _counts(node)
        assert cleaner.sweep() == []
    assert rows["true"] == rows["false"]
    assert PQ.check_rows("q3", rows["true"], _jax_rows("q3", paths))[0]
    assert counts["true"]["numDynPrunedRowGroups"] >= 1
    assert counts["false"]["numDynPrunedRowGroups"] == 0
    assert counts["true"]["numRowGroups"] == counts["false"][
        "numRowGroups"]
