"""The statistics pass (``bench/stat_sales.py``: S1-S5) at SF 0.02 on both
of the port's engines, held against the JAX package's planner on its own
CPU engine over the same Arrow tables; S1 and S2 also against pandas
computations written from the TPC-DS specification's text (S2 at SF 0.25,
where both q39a and q39b have rows: a cov above 1 over a month's four
weekly snapshots is rare under the generators' uniform quantities); the
skewness and kurtosis
windows of ``S4_SKEW`` (the CPU engine's, named by ``explain``) against
numpy frame by frame; S1 and S3 with 4 source splits and 4 shuffle
partitions against one partition (the fast path off, so the partial and
final aggregates cross hash exchanges); and S3 under the least pool its
pinned set fits, whose partials spill to both tiers, against the uncapped
rows.

Tolerance: the equivalence bar (``stat_sales.check_rows``): doubles
within relative 1e-6 (absolute floor 1e-6), everything else equal, in
ORDER BY order. The reference's window variance reads a decimal's
unscaled value and its CPU engine refuses a decimal window variance, so
S4 gives it ss_net_paid as a double (``Lib.port``).
"""

import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config import conf as JC
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch.bench import stat_sales as SS
from spark_rapids_tpu_torch.bench.tpch import rows_match
from spark_rapids_tpu_torch.config import conf as C
from spark_rapids_tpu_torch.config.conf import RapidsConf

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

SF = 0.02
SF_S2 = 0.25
JAX_LIB = SS.Lib(JE, JT, JW, JSortOrder, False)
JAX_CPU_ENGINE = {"spark.rapids.tpu.sql.enabled": "false",
                  "spark.rapids.tpu.plan.cache.enabled": "false"}
ENGINES = {"device": {}, "cpu_engine": {"spark.rapids.gpu.sql.enabled":
                                        "false"}}
NO_FASTPATH = {"spark.rapids.gpu.fastpath.enabled": "false"}
_CACHE = {}


def _tables(sf=SF):
    if sf not in _CACHE:
        _CACHE[sf] = SS.tables_for(sf)
    return _CACHE[sf]


def _jax(q):
    key = ("jax", q)
    if key not in _CACHE:
        frames = {}
        for k, v in _tables().items():
            frames[k] = jax_from_arrow(v, JC.RapidsConf(JAX_CPU_ENGINE))
            frames[k].shuffle_partitions = 1
        _CACHE[key] = SS.QUERIES[q](frames, JAX_LIB).to_arrow().to_pylist()
    return _CACHE[key]


def _port(q, conf, sf=SF, **kw):
    d = SS.df_tables(_tables(sf), RapidsConf(conf), device="cpu", **kw)
    df = SS.QUERIES[q](d)
    return df, df.to_arrow().to_pylist()


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("q", list(SS.QUERIES))
def test_stat_query_matches_jax(q, engine):
    df, got = _port(q, ENGINES[engine])
    lines = [ln for ln in df.explain().splitlines()
             if ln.lstrip().startswith("!")]
    if engine == "device" and q in SS.DEVICE_ONLY:
        assert not lines, lines  # wholly on the device path
    elif engine == "device":  # S5: the aggregate alone on the CPU engine
        assert len(lines) == 1 and "! Aggregate" in lines[0], lines
    assert SS.check_rows(q, got, _jax(q)) == (True, "")
    if q not in ("S2a", "S2b"):  # q39 is empty at this SF
        assert SS.informative(got)


@pytest.mark.parametrize("q", ["S1", "S2a", "S2b"])
def test_s1_s2_match_the_specification(q):
    sf = SF if q == "S1" else SF_S2
    want = SS.PANDAS[q](_tables(sf))
    _, got = _port(q, {}, sf)
    assert SS.check_rows(q, got, want) == (True, "")
    assert SS.informative(got)


def test_s4_skew_runs_on_the_cpu_engine_and_matches_numpy():
    t = _tables()
    store = SS.first_store(t)
    for engine, conf in ENGINES.items():
        d = SS.df_tables(t, RapidsConf(conf), device="cpu")
        df = SS.s4_skew(d, store=store)
        off = [ln for ln in df.explain().splitlines()
               if ln.lstrip().startswith("!")]
        if engine == "device":  # the windows alone on the CPU engine
            assert len(off) == 1 and "! Window" in off[0] and (
                "skewness/kurtosis window functions not on device"
                in off[0]), off
        got = df.to_arrow().to_pylist()
        assert rows_match(got, [SS.exact_skew_rows(t, store)])


@pytest.mark.parametrize("q", ["S1", "S3"])
def test_partitioned_matches_one_partition(q):
    """4 splits and 4 shuffle partitions against one partition; store_sales
    in 4 batches, one a split, so a split's rows are in row order (S3's
    First/Last read map outputs by map index)."""
    rows = _tables()["store_sales"].num_rows
    conf = dict(NO_FASTPATH, **{"spark.rapids.gpu.sql.explain": "ALL"})
    df, got = _port(q, conf, partitions=4, shuffle_partitions=4,
                    batch_rows=-(-rows // 4))
    plan = df.physical_plan().explain()
    assert "HashPartitioner(4)" in plan and "mode=partial" in plan, plan
    _, one = _port(q, {}, partitions=1, shuffle_partitions=1)
    assert SS.check_rows(q, got, one) == (True, "")


def test_capped_s3_spills_its_partials_and_equals_uncapped(tmp_path):
    """S3 in 4,096-row batches under the least pool its uncapped run's
    largest handle and pinned set fit, with a host tier and a
    repartition target of a sixteenth of it: its partials spill to host
    and disk, the aggregate repartitions, and the rows equal the uncapped
    run's."""
    from spark_rapids_tpu_torch.exec import aggregate as AGG
    from spark_rapids_tpu_torch.mem import cleaner
    from spark_rapids_tpu_torch.mem import pool as MP
    from spark_rapids_tpu_torch.mem import spill as MSP

    def fresh(conf):
        pool = MP.HbmPool(MP.pool_limit(conf))
        MP.set_pool(pool)
        MSP.SpillFramework(pool,
                           host_limit_bytes=C.HOST_SPILL_LIMIT.get(conf),
                           spill_dir=str(tmp_path))
        return pool

    try:
        fresh(RapidsConf())
        _, base = _port("S3", {}, batch_rows=4096)
        c0 = MSP.get_framework().counters()
        cap = max(c0["max_handle_bytes"], c0["max_pinned_bytes"])
        settings = {"spark.rapids.gpu.memory.pool.maxBytes": cap,
                    "spark.rapids.gpu.memory.host.spillStorageSize":
                        cap // 16,
                    "spark.rapids.gpu.sql.agg.repartition.targetBytes":
                        cap // 16}
        pool = fresh(RapidsConf(settings))
        s0 = AGG.repartition_snapshot()["total"]
        _, got = _port("S3", settings, batch_rows=4096)
        c = MSP.get_framework().counters()
        assert c["spilled_to_host"] > 0 and c["spilled_to_disk"] > 0, c
        assert AGG.repartition_snapshot()["total"] > s0
        assert SS.check_rows("S3", got, base) == (True, "")
        assert pool.used == 0 and cleaner.sweep() == []
        assert not list(tmp_path.iterdir())
    finally:
        MP.set_pool(None)
        C.set_active(None)
