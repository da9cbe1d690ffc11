"""Dynamic partition pruning in the port (``exec/dpp.DynamicPruningFilter``
attached by the planner to a Parquet probe scan), held against the JAX
package on the same files: the pruned row-group counts and the rows
equal the reference's, no filter on a left join or with the conf off, an
oversized key set disabling the filter, and the filter's range test.

Tolerance: exact (rows compared as Python values).
"""

import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exec import ParquetScanExec as JScan
from spark_rapids_tpu.exec.dpp import DynamicPruningFilter as JFilter
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu.plan import read_parquet as jax_read_parquet
from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec.dpp import DynamicPruningFilter
from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
from spark_rapids_tpu_torch.plan import from_arrow, read_parquet

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

JAX = {"spark.rapids.tpu.plan.cache.enabled": "false"}


def _fact_files(tmp_path, n_files=4, rows_per=100):
    """Each file covers a disjoint key range: prunable by min/max."""
    paths = []
    for i in range(n_files):
        lo = i * 1000
        t = pa.table({
            "k": pa.array(np.arange(lo, lo + rows_per), pa.int64()),
            "v": pa.array(np.arange(rows_per, dtype=np.float64)),
        })
        p = str(tmp_path / f"fact_{i}.parquet")
        pq.write_table(t, p)
        paths.append(p)
    return paths


def _find_scan(node, cls):
    if isinstance(node, cls):
        return node
    for c in node.children:
        s = _find_scan(c, cls)
        if s is not None:
            return s
    return None


def _run(node, to_arrow):
    """Execute a physical tree (``collect`` would plan a fresh one)."""
    rows = []
    for p in range(node.num_partitions()):
        for b in node.execute(p):
            rows.extend(to_arrow(b, node.output_schema).to_pylist())
    return rows


def _jax_to_arrow(b, schema):
    from spark_rapids_tpu.columnar.batch import batch_to_arrow as j

    return j(b, schema)


def _key(r):
    return r["k"]


@pytest.mark.parametrize("fastpath", [True, False])
def test_dpp_prunes_row_groups_and_matches(tmp_path, fastpath):
    paths = _fact_files(tmp_path)
    # the dimension holds keys of file 2 only (2000..2009)
    dims = pa.table({"dk": pa.array(np.arange(2000, 2010), pa.int64()),
                     "name": pa.array([f"n{i}" for i in range(10)])})
    fp = {} if fastpath else {"spark.rapids.gpu.fastpath.enabled": "false"}
    jfp = dict(JAX, **({} if fastpath else
                       {"spark.rapids.tpu.fastpath.enabled": "false"}))
    off = RapidsConf(dict(fp, **{C.DPP_ENABLED.key: "false"}))
    base = (read_parquet(paths, conf=off, device="cpu")
            .join(from_arrow(dims, off, device="cpu"), left_on="k",
                  right_on="dk").collect())
    conf = RapidsConf(fp)
    node = (read_parquet(paths, conf=conf, device="cpu")
            .join(from_arrow(dims, conf, device="cpu"), left_on="k",
                  right_on="dk").physical_plan())
    scan = _find_scan(node, ParquetScanExec)
    assert scan is not None and scan.dynamic_filters
    got = _run(node, batch_to_arrow)
    assert sorted(got, key=_key) == sorted(base, key=_key)
    assert len(got) == 10
    jconf = JConf(jfp)
    jnode = (jax_read_parquet(paths, conf=jconf)
             .join(jax_from_arrow(dims, jconf), left_on="k", right_on="dk")
             .physical_plan())
    jscan = _find_scan(jnode, JScan)
    assert sorted(_run(jnode, _jax_to_arrow), key=_key) == sorted(
        got, key=_key)
    # 3 of 4 files (one row group each) are disjoint from the keys
    for k in ("numRowGroups", "numPrunedRowGroups",
              "numDynPrunedRowGroups"):
        assert scan.metrics[k].value == jscan.metrics[k].value, k
    assert scan.metrics["numDynPrunedRowGroups"].value == 3
    assert scan.dynamic_filters[0].values() == \
        jscan.dynamic_filters[0].values() == list(range(2000, 2010))


@pytest.mark.parametrize("how", ["left", "left_anti", "full"])
def test_dpp_not_attached_where_unmatched_rows_are_kept(tmp_path, how):
    paths = _fact_files(tmp_path, n_files=2)
    dims = pa.table({"dk": pa.array([0, 1], pa.int64()),
                     "name": pa.array(["a", "b"])})
    node = (read_parquet(paths, device="cpu")
            .join(from_arrow(dims, device="cpu"), left_on="k",
                  right_on="dk", how=how).physical_plan())
    scan = _find_scan(node, ParquetScanExec)
    assert scan is not None and not scan.dynamic_filters
    jnode = (jax_read_parquet(paths, conf=JConf(JAX))
             .join(jax_from_arrow(dims, JConf(JAX)), left_on="k",
                   right_on="dk", how=how).physical_plan())
    assert not _find_scan(jnode, JScan).dynamic_filters


def test_dpp_disabled_by_conf(tmp_path):
    paths = _fact_files(tmp_path, n_files=2)
    dims = pa.table({"dk": pa.array([0], pa.int64())})
    conf = RapidsConf({C.DPP_ENABLED.key: "false"})
    node = (read_parquet(paths, conf=conf, device="cpu")
            .join(from_arrow(dims, conf, device="cpu"), left_on="k",
                  right_on="dk").physical_plan())
    scan = _find_scan(node, ParquetScanExec)
    assert scan is not None and not scan.dynamic_filters
    assert len(_run(node, batch_to_arrow)) == 1


def test_dpp_overflow_disables_pruning(tmp_path):
    paths = _fact_files(tmp_path, n_files=2)
    dims = pa.table({"dk": pa.array(np.arange(100), pa.int64())})
    conf = RapidsConf({C.DPP_MAX_KEYS.key: 10})
    node = (read_parquet(paths, conf=conf, device="cpu")
            .join(from_arrow(dims, conf, device="cpu"), left_on="k",
                  right_on="dk").physical_plan())
    scan = _find_scan(node, ParquetScanExec)
    assert scan.dynamic_filters
    got = _run(node, batch_to_arrow)
    assert len(got) == 100  # keys 0..99, all in file 0
    assert scan.metrics["numDynPrunedRowGroups"].value == 0
    assert scan.dynamic_filters[0].values() is None
    assert scan.dynamic_filters[0].describe() == "dpp[k] (disabled)"


def _filter(cls, values):
    f = cls.__new__(cls)
    f._values = values
    f._overflow = False
    f._done = True
    f._lock = threading.Lock()
    return f


def test_dpp_filter_may_match_ranges():
    import datetime

    port, ref = (_filter(DynamicPruningFilter, [5, 17, 40]),
                 _filter(JFilter, [5, 17, 40]))
    for mn, mx, want in ((0, 4, False), (0, 5, True), (6, 16, False),
                         (18, 39, False), (41, 100, False), (17, 17, True),
                         (None, 10, True), (datetime.date(2020, 1, 1),
                                            datetime.date(2021, 1, 1),
                                            True)):
        assert port.may_match(mn, mx) is want, (mn, mx)
        assert ref.may_match(mn, mx) is want, (mn, mx)
