"""The lakehouse pass (``bench/lakehouse_sales.py``) at SF 0.01 on the
CPU: the Delta fact table's six versions and item's MERGE, read by q3 at
version 5 (with item at version 1) and at version 3; the Iceberg table
over the Parquet pass's files; the dataframe cache; the ROLLUP through
Expand; the bloom filter; Z-order; the ML handoff. q3's rows equal the
JAX package's CPU engine over the same tables modified by
``pyarrow.compute`` (its plan memo off), and every other step equals its
plain reference. The pass runs once for the module.

Tolerance: ``tpcds_queries.check_rows`` (rel 1e-6 on doubles, exact
otherwise, ORDER BY order); everything else exact.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.columnar.batch as JB
import spark_rapids_tpu.exec.bloom as JBL
from spark_rapids_tpu.bench import tpcds_queries as JQ
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.bench import lakehouse_sales as LH
from spark_rapids_tpu_torch.bench import parquet_sales as PSales
from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.plan import plan_cache

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SF = 0.01
JAX_CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false",
                  "spark.rapids.tpu.plan.cache.enabled": "false"}


@pytest.fixture(scope="module")
def tables():
    return PS.tables_for(SF)


@pytest.fixture(scope="module")
def lake(tables, tmp_path_factory):
    d = tmp_path_factory.mktemp("lakehouse")
    paths, _ = PSales.write_tables(tables, str(d / "parquet"), "cpu",
                                   batch_rows=2048, rows_per_file=8192)
    c0 = plan_cache.counters()
    res = LH.run_pass({n: tables[n] for n in (LH.FACT, LH.DIM, "date_dim")},
                      paths, str(d), device="cpu")
    # the warm repeats of q3 over the Delta tables are served by the memo
    repeats = [PQ.QUERIES["q3"](res["frames_v5"]).collect()
               for _ in range(2)]
    c1 = plan_cache.counters()
    res["memo"] = {k: c1[k] - c0[k] for k in c1}
    res["repeats"] = repeats
    res["paths"] = paths
    return res


def _jax_q3(tables, fact=None, item=None):
    conf = JConf(JAX_CPU_ENGINE)
    t = dict(tables)
    if fact is not None:
        t[LH.FACT] = fact
    if item is not None:
        t[LH.DIM] = item
    d = {n: jax_from_arrow(v, conf) for n, v in t.items()}
    return JQ.QUERIES["q3"](d).collect()


def test_delta_versions_and_snapshots(lake, tables):
    assert lake["versions"] == [0, 1, 2, 3, 4, 5]
    assert lake["item_version"] == 1
    snaps = lake["snapshots"]
    n = tables[LH.FACT].num_rows
    assert [snaps[v]["files"] for v in range(4)] == [1, 2, 3, 4]
    assert snaps[3]["num_records"] == n == lake["rows_read"][3]
    plain = LH.plain_fact(tables[LH.FACT], tables["date_dim"])
    assert snaps[4]["dv_rows"] == n - plain.num_rows > 0
    assert snaps[5]["num_records"] == plain.num_rows == lake["rows_read"][5]
    assert 1 <= lake["files_rewritten"] <= 2
    item = LH.plain_item(tables[LH.DIM], LH.merge_source(tables[LH.DIM]))
    assert lake["item_records"] == item.num_rows == lake["rows_read"]["item"]


def test_q3_over_delta_equals_the_jax_cpu_engine(lake, tables):
    fact = LH.plain_fact(tables[LH.FACT], tables["date_dim"])
    item = LH.plain_item(tables[LH.DIM], LH.merge_source(tables[LH.DIM]))
    exp = _jax_q3(tables, fact, item)
    assert PQ.check_rows("q3", lake["q3_v5"], exp) == (True, "")
    for rows in lake["repeats"]:
        assert PQ.check_rows("q3", rows, exp) == (True, "")
    assert lake["memo"]["plan_cache_hit_total"] >= 2


def test_q3_at_version_3_and_over_iceberg_equal_the_original(lake, tables):
    exp = _jax_q3(tables)
    assert PQ.check_rows("q3", lake["q3_v3"], exp) == (True, "")
    assert PQ.check_rows("q3", lake["q3_iceberg"], exp) == (True, "")
    assert lake["q3_v3"] != lake["q3_v5"]


def test_iceberg_files_and_pruning(lake):
    assert lake["iceberg_files"] == lake["paths"][LH.FACT]
    assert lake["iceberg_scan"] == lake["direct_scan"]
    assert lake["iceberg_scan"]["numPrunedRowGroups"] > 0


def test_the_cache_reads_back_the_uncached_rows(lake):
    c = lake["cache"]
    assert c["equal"] and c["same_relation"] and c["rows"] > 0
    assert 0 < c["bytes"] < c["arrow_bytes"] and c["decode_ns"] > 0


def test_rollup_through_expand_equals_three_group_bys(lake, tables):
    assert lake["rollup"] == LH.plain_rollup(tables[LH.FACT],
                                             tables[LH.DIM])
    assert lake["rollup_rows_in"] == 3 * tables[LH.FACT].num_rows
    assert lake["rollup_partitions"] == 1


def test_bloom_filter_equals_the_reference(lake, tables):
    b = lake["bloom"]
    assert b["false_negatives"] == 0 and b["members"] > 0
    build = LH.bloom_build_keys(tables[LH.DIM])
    probe = tables[LH.FACT].select(["ss_item_sk"])
    jbits = JBL.build_bloom_filter(JB.batch_from_arrow(build, 16), (0,),
                                   b["num_bits"], LH.BLOOM_HASHES)
    assert np.array_equal(b["bits"].numpy(), np.asarray(jbits))
    jmask = np.asarray(JBL.might_contain(JB.batch_from_arrow(probe, 16),
                                         (0,), jbits, b["num_bits"],
                                         LH.BLOOM_HASHES))
    assert np.array_equal(b["mask"].numpy(), jmask[:probe.num_rows])


def test_zorder_orders_are_permutations(lake, tables):
    n = tables[LH.FACT].num_rows
    for k in ("z", "hilbert"):
        assert np.array_equal(np.sort(lake["zorder"][k].numpy()),
                              np.arange(n))
    assert lake["zorder"]["z3"].shape == (n,)


def test_ml_handoff(lake):
    assert lake["ml"]["equal"] and lake["ml"]["device"] == "cpu"
    assert lake["ml"]["shape"][1] == len(LH.FEATURES)
    assert cleaner.sweep() == []
