"""TPC-H Q1/Q3/Q5/Q6 at SF 0.01 through the port's planner
(spark_rapids_tpu_torch.plan.from_arrow on the CPU) against the JAX
package's planner on the same tables: exact keys, counts and ORDER BY
order, doubles within rel 1e-6 (another summation order)."""

import pytest
import torch

from spark_rapids_tpu.bench import tpch as JTPCH
from spark_rapids_tpu_torch.bench import tpch as PTPCH

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

_TABLES = {}
_JAX = {}

ORDER_KEYS = {"q1": ("l_returnflag", "l_linestatus"), "q3": ("l_orderkey",),
              "q5": ("n_name",), "q6": ()}


def _tables():
    if "t" not in _TABLES:
        _TABLES["t"] = PTPCH.tables_for(0.01, seed=7)
    return _TABLES["t"]


def _jax_rows(q):
    """The JAX package's answer, computed once per query per process."""
    if q not in _JAX:
        d = JTPCH.df_tables(_tables(), None, shuffle_partitions=1,
                            partitions=1, batch_rows=1 << 20)
        _JAX[q] = JTPCH.DF_QUERIES[q](d).to_arrow().to_pylist()
    return _JAX[q]


@pytest.mark.parametrize("q", ["q1", "q3", "q5", "q6"])
def test_tpch_query_matches_jax(q):
    # small batches, so every query runs several probe and agg batches
    d = PTPCH.df_tables(_tables(), batch_rows=16384, device="cpu")
    got = PTPCH.DF_QUERIES[q](d).to_arrow().to_pylist()
    exp = _jax_rows(q)
    assert len(got) == len(exp) and len(got) > 0
    assert [list(r) for r in got] == [list(r) for r in exp]  # column names
    assert PTPCH.rows_match(got, exp)
    keys = ORDER_KEYS[q]
    if keys:
        assert ([tuple(r[k] for k in keys) for r in got]
                == [tuple(r[k] for k in keys) for r in exp])
    for r_got, r_exp in zip(got, exp):
        for k, v in r_got.items():
            if not isinstance(v, float):
                assert v == r_exp[k]  # keys and counts exactly


def test_tpch_matches_pandas_reference():
    t = _tables()
    d = PTPCH.df_tables(t, batch_rows=1 << 20, device="cpu")
    cpu = PTPCH.cpu_tpch(*[t[k] for k in ("lineitem", "orders", "customer",
                                          "supplier", "nation", "region")])
    got = PTPCH.DF_QUERIES["q6"](d).to_arrow().to_pylist()
    assert PTPCH.rows_match(got, [{"revenue": cpu["q6"]()}])
    got = PTPCH.DF_QUERIES["q3"](d).to_arrow().to_pylist()
    exp = cpu["q3"]().reset_index(drop=True)
    assert [r["l_orderkey"] for r in got] == exp.l_orderkey.tolist()
