"""TPC-DS q44 and q67 (window ranks over decimal(7,2) money columns) at
SF 0.01 through the port's planner (spark_rapids_tpu_torch.plan.from_arrow
on the CPU), held against the JAX package's planner on the same tables
(one shuffle partition) and against the pandas reference: ``rows_match``
(rel 1e-6 on doubles, exact keys, decimals and counts) and the ORDER BY
columns in order. The port's generated tables equal the reference's."""

import pytest

from spark_rapids_tpu.bench import tpcds_queries as JQ
from spark_rapids_tpu.bench import tpcds_schema as JS
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.bench import tpcds_queries as PQ
from spark_rapids_tpu_torch.bench import tpcds_schema as PS

SF = 0.01
_CACHE = {}


def _tables():
    if "t" not in _CACHE:
        _CACHE["t"] = PS.tables_for(SF)
    return _CACHE["t"]


def _jax_rows(q):
    """The JAX package's answer, once per query per process."""
    key = ("jax", q)
    if key not in _CACHE:
        dfs = {}
        for k, v in _tables().items():
            df = jax_from_arrow(v)
            df.shuffle_partitions = 1
            dfs[k] = df
        _CACHE[key] = JQ.QUERIES[q](dfs).collect()
    return _CACHE[key]


@pytest.mark.parametrize("seed", [0, 5])
def test_generated_tables_equal_the_reference(seed):
    ref = JS.tables_for(SF, seed=seed)
    got = PS.tables_for(SF, seed=seed)
    assert sorted(got) == ["date_dim", "item", "store", "store_sales"]
    for name, t in got.items():
        assert t.equals(ref[name]), name
    assert str(got["store_sales"].schema.field("ss_net_profit").type) == \
        "decimal128(7, 2)"


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
