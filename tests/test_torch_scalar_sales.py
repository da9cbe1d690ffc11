"""The scalar sales pass (``bench/scalar_sales.py``: N1-N7) at SF 0.01 on
both of the port's engines, held against the JAX package's planner on its
own CPU engine over the same Arrow tables; N1 also against its typed twin
and pyarrow's parse, N4 against pyarrow's text; N1 and N3 with 4 source splits and 4 shuffle partitions (the
fast path off, so the aggregates cross hash exchanges) against one
partition.

Tolerance: the equivalence bar (``scalar_sales.check_rows``): doubles
within relative 1e-6 (absolute floor 1e-6; N2's transcendental columns
are far inside it), everything else equal, in ORDER BY order. The
reference's Round of a double (fault 14) and of a decimal (fault 17) are
given their Spark answers as decimal rescales in N5 and N6 (``Lib.port``).
"""

import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.bench import scalar_sales as SS
from spark_rapids_tpu_torch.config.conf import RapidsConf

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SF = 0.01
JAX_LIB = SS.Lib(JE, JT, JW, JSortOrder, False)
JAX_CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false",
                  "spark.rapids.tpu.plan.cache.enabled": "false"}
ENGINES = {"device": {}, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                        "false"}}
NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
_CACHE = {}


def _tables():
    if "tables" not in _CACHE:
        _CACHE["tables"] = SS.tables_for(SF)
    return _CACHE["tables"]


def _jax(q):
    key = ("jax", q)
    if key not in _CACHE:
        frames = {}
        for k, v in _tables().items():
            frames[k] = jax_from_arrow(v, JC.RapidsConf(JAX_CPU_ENGINE))
            frames[k].shuffle_partitions = 1
        _CACHE[key] = SS.QUERIES[q](frames, JAX_LIB).to_arrow().to_pylist()
    return _CACHE[key]


def _port(q, conf, **kw):
    d = SS.df_tables(_tables(), RapidsConf(conf), device="cpu", **kw)
    df = SS.QUERIES[q](d)
    return df, df.to_arrow().to_pylist()


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("q", list(SS.QUERIES))
def test_scalar_query_matches_jax(q, engine):
    df, got = _port(q, ENGINES[engine])
    off = [ln for ln in df.explain().splitlines()
           if ln.lstrip().startswith("!")]
    if engine == "device" and q != "N6":
        assert not off, off  # wholly on the device path
    elif engine == "device":  # N6: its projection alone on the CPU engine
        assert len(off) == 1 and off[0].lstrip().startswith("! Project"), off
        for reason in ("float to string cast not on device",
                       "decimal floor/ceil/round not on device",
                       "decimal division not on device"):
            assert reason in off[0], (reason, off)
    assert SS.check_rows(q, got, _jax(q)) == (True, "")
    assert SS.informative(got)


def test_n1_equals_its_typed_twin_and_pandas():
    _, got = _port("N1", {})
    d = SS.df_tables(_tables(), device="cpu")
    typed = SS.n1(d, typed=True).to_arrow().to_pylist()
    assert SS.check_rows("N1", got, typed) == (True, "")
    assert SS.check_rows("N1", got, SS.pandas_n1(_tables())) == (True, "")


def test_n4_every_string_casts_back_and_equals_arrows_text():
    _, got = _port("N4", {})
    assert sum(r["n"] for r in got) == _tables()["store_sales"].num_rows
    for r in got:
        assert all(r[k] == 0 for k in r if k.startswith("bad_")), r
    assert SS.check_rows("N4", got, SS.arrow_n4(_tables())) == (True, "")


@pytest.mark.parametrize("q", SS.PARTITIONED)
def test_partitioned_matches_one_partition(q):
    rows = _tables()["store_sales"].num_rows
    conf = dict(NO_FASTPATH, **{"spark.rapids.gpu.sql.explain": "ALL"})
    df, got = _port(q, conf, partitions=4, shuffle_partitions=4,
                    batch_rows=-(-rows // 4))
    plan = df.physical_plan().explain()
    assert "HashPartitioner(4)" in plan and "mode=partial" in plan, plan
    _, one = _port(q, {}, partitions=1, shuffle_partitions=1)
    assert SS.check_rows(q, got, one) == (True, "")
