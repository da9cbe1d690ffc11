"""The string sales pass (``bench/string_sales.py``: G1-G6) at SF 0.01 on
both of the port's engines, held against the JAX package's planner on its
own CPU engine over the same Arrow tables; G1 also against pandas and
Python's ``str``; G1 and G2 with 4 source splits and 4 shuffle partitions
(the fast path off, so the aggregates cross hash exchanges) against one
partition.

Tolerance: the equivalence bar (``string_sales.check_rows``): everything
here is an integer or a string, so equal, in ORDER BY order. The
reference's CPU engine does not evaluate RegexpExtract and RegexpReplace:
its G4 leaves them out (``Lib.port``), and the port's G4 is held to the
reference on the other columns.
"""

import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.bench import string_sales as G
from spark_rapids_tpu_torch.config.conf import RapidsConf

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SF = 0.01
JAX_LIB = G.Lib(JE, JT, JW, JSortOrder, False)
JAX_CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false",
                  "spark.rapids.tpu.plan.cache.enabled": "false"}
ENGINES = {"device": {}, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                        "false"}}
NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
# the reasons explain names on the device path
OFF_DEVICE = {"G3R": ("! Filter", ["regex not on device: unknown escape "
                                   "\\1"]),
              "G4": ("! Project", [f"expression {c} not on device" for c in (
                  "Md5", "Sha1", "Sha2", "Crc32", "Levenshtein",
                  "FormatNumber", "StringSpace", "Bin", "Overlay",
                  "RegexpExtract", "RegexpReplace")])}
_CACHE = {}


def _tables():
    if "tables" not in _CACHE:
        _CACHE["tables"] = G.tables_for(SF)
    return _CACHE["tables"]


def _build(q, d, L=None):
    if q == "G4":
        return G.g4(d, L, store=G.first_store(_tables()))
    return G.QUERIES[q](d, L)


def _jax(q):
    key = ("jax", q)
    if key not in _CACHE:
        frames = {}
        for k, v in _tables().items():
            frames[k] = jax_from_arrow(v, JC.RapidsConf(JAX_CPU_ENGINE))
            frames[k].shuffle_partitions = 1
        _CACHE[key] = _build(q, frames, JAX_LIB).to_arrow().to_pylist()
    return _CACHE[key]


def _port(q, conf, **kw):
    d = G.df_tables(_tables(), RapidsConf(conf), device="cpu", **kw)
    df = _build(q, d)
    return df, df.to_arrow().to_pylist()


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("q", list(G.QUERIES))
def test_string_query_matches_jax(q, engine):
    df, got = _port(q, ENGINES[engine])
    off = [ln.strip() for ln in df.explain().splitlines()
           if ln.lstrip().startswith("!")]
    if engine == "device" and q not in OFF_DEVICE:
        assert not off, off  # wholly on the device path
    elif engine == "device":  # one node on the CPU engine, named
        node, reasons = OFF_DEVICE[q]
        assert len(off) == 1 and off[0].startswith(node), off
        for reason in reasons:
            assert reason in off[0], (reason, off)
    exp = _jax(q)
    if q == "G4":  # the reference's CPU engine has no regexp_* columns
        got = [{k: r[k] for k in exp[0]} for r in got]
    assert G.check_rows(q, got, exp) == (True, "")
    assert G.informative(got)


def test_g1_equals_pandas_and_g2_round_trips():
    _, g1 = _port("G1", {})
    assert G.check_rows("G1", g1, G.pandas_g1(_tables())) == (True, "")
    _, g2 = _port("G2", {})
    assert sum(r["n_len"] for r in g2) == sum(
        v is not None for v in _tables()["untyped_store_sales"].column(
            "ss_net_paid").to_pylist())
    assert all(r[b] == 0 for r in g2 for b in G.G2_BAD)


@pytest.mark.parametrize("q", G.PARTITIONED)
def test_partitioned_matches_one_partition(q):
    rows = _tables()["store_sales"].num_rows
    df, got = _port(q, NO_FASTPATH, partitions=4, shuffle_partitions=4,
                    batch_rows=-(-rows // 4))
    plan = df.physical_plan().explain()
    assert "HashPartitioner(4)" in plan and "mode=partial" in plan, plan
    _, one = _port(q, {}, partitions=1, shuffle_partitions=1)
    assert G.check_rows(q, got, one) == (True, "")
