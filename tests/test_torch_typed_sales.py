"""The typed store_sales pass (``bench/typed_sales.py``: T1-T4 and the
partitioned T5) at SF 0.01 on both of the port's engines, held against
the JAX package's planner on its own CPU engine over the same Arrow table,
and T1 against an independent pandas computation.

T5 is T1 and T3 with 4 source splits and 4 shuffle partitions, and the
global sorts, each against one partition: the fast path is turned off so
that the exchanges are really planned (``explain`` names them: hash
exchanges under the aggregates and the join, a range exchange under the
one-key sort, a single-partition one under the two-key sort).

Tolerance: the equivalence bar (``typed_sales.check_rows``): doubles
within relative 1e-6 (float sums in another order), everything else
equal, in ORDER BY order.
"""

import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.bench import typed_sales as TS
from spark_rapids_tpu_torch.config.conf import RapidsConf

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SF = 0.01
JAX_LIB = TS.Lib(JE, JT, JW, JSortOrder, False)
JAX_CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false",
                  "spark.rapids.tpu.plan.cache.enabled": "false"}
ENGINES = {"device": {}, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                        "false"}}
NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
_CACHE = {}


def _tables():
    if "t" not in _CACHE:
        _CACHE["t"] = TS.tables_for(SF)
    return _CACHE["t"]


def _jax(q):
    key = ("jax", q)
    if key not in _CACHE:
        frames = {}
        for k, v in _tables().items():
            frames[k] = jax_from_arrow(v, JC.RapidsConf(JAX_CPU_ENGINE))
            frames[k].shuffle_partitions = 1
        _CACHE[key] = TS.QUERIES[q](frames, JAX_LIB).to_arrow().to_pylist()
    return _CACHE[key]


def _port(q, conf, **kw):
    d = TS.df_tables(_tables(), RapidsConf(conf), device="cpu", **kw)
    df = (TS.QUERIES.get(q) or TS.GLOBAL_SORTS[q])(d)
    return df, df.to_arrow()


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("q", list(TS.QUERIES))
def test_typed_query_matches_jax(q, engine):
    df, got = _port(q, ENGINES[engine])
    plan = df.explain()
    if engine == "device":
        assert "!" not in plan, plan  # wholly on the device path
    got = got.to_pylist()
    assert got and all(v is not None for v in got[0].values())
    assert TS.check_rows(q, got, _jax(q)) == (True, "")


def test_t1_matches_pandas():
    _, got = _port("T1", {})
    assert TS.check_rows("T1", got.to_pylist(),
                         TS.pandas_t1(_tables()["typed_store_sales"])) == (
        True, "")


@pytest.mark.parametrize("q", ["T1", "T3", "GLOBAL_SORT", "GLOBAL_SORT2"])
def test_t5_partitioned_matches_one_partition(q):
    """4 splits and 4 shuffle partitions against one partition."""
    conf = dict(NO_FASTPATH, **{"spark.rapids.gpu.sql.explain": "ALL"})
    rows = _tables()["typed_store_sales"].num_rows
    df, got = _port(q, conf, partitions=4, shuffle_partitions=4,
                    batch_rows=-(-rows // 4))
    plan = df.physical_plan().explain()
    if q == "GLOBAL_SORT":
        assert "RangePartitioner(4)" in plan, plan
    elif q == "GLOBAL_SORT2":
        assert "SinglePartitioner" in plan, plan
    else:
        assert "HashPartitioner(4)" in plan, plan
    _, one = _port(q, {}, partitions=1, shuffle_partitions=1)
    if q in TS.QUERIES:
        assert TS.check_rows(q, got.to_pylist(), one.to_pylist()) == (
            True, "")
    else:
        assert TS.check_sorted(q, got, one) == (True, "")


def test_t3_sorted_hash_path_matches_hash_table_path():
    from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
    from spark_rapids_tpu_torch.plan.overrides import join_paths

    conf = {"spark.rapids.gpu.sql.join.hashTable.enabled": "false"}
    d = TS.df_tables(_tables(), RapidsConf(conf), device="cpu")
    plan = TS.t3(d).physical_plan()
    got = execute_to_arrow(plan).to_pylist()
    assert set(join_paths(plan)) == {"sorted"}
    _, exp = _port("T3", {})
    assert TS.check_rows("T3", got, exp.to_pylist()) == (True, "")
