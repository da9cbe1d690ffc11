"""Adaptive execution of the port (spark_rapids_tpu_torch.shuffle.aqe)
against the JAX package's, on the CPU:

- the planning helpers (``pack_ranges``, ``coalesce_specs``,
  ``split_map_ranges``, ``skew_threshold``) equal the reference's on
  seeded size lists;
- the spec lists: the same seeded input and conf give the port's readers
  the reference's specs (coalesced and skew-split), with the reference's
  device path writing one map at a time;
- coalesced aggregates and range sorts give the rows of AQE off;
- skew joins (inner, left, left_semi, left_anti, right) give the rows of
  AQE off and of the reference, with paired specs that line up, under 1
  and 4 writer threads; a full join is never split;
- switching AQE off leaves a plain exchange, planning writes no exchange,
  and a plan run again reads through its kept specs.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu.shuffle import aqe as JA
from spark_rapids_tpu_torch.bench import tpch as PTPCH
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import window as PW
from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow
from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
from spark_rapids_tpu_torch.shuffle import aqe as PA
from spark_rapids_tpu_torch.shuffle.exchange_exec import ShuffleExchangeExec
from spark_rapids_tpu_torch.shuffle.manager import ShuffleManager

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


def _walk(node):
    yield node
    for c in node.children:
        yield from _walk(c)


def _readers(plan, cls):
    return [n for n in _walk(plan) if isinstance(n, cls)]


def _spec_tuple(s):
    if type(s).__name__ == "CoalescedPartitionSpec":
        return ("coalesced", s.start, s.end)
    return ("partial", s.reducer, s.map_start, s.map_end)


def _canon(rows):
    return sorted(rows, key=lambda r: repr(sorted(
        (k, repr(v)) for k, v in r.items())))


# ---------------------------------------------------------------------------
# planning helpers against the reference
# ---------------------------------------------------------------------------


def _sizes(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    sizes = rng.integers(0, 5000, n)
    sizes[rng.random(n) < 0.2] *= 40  # a few large ones
    return [int(x) for x in sizes]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("helper", ["pack_ranges", "coalesce_specs",
                                    "split_map_ranges", "skew_threshold"])
def test_planning_helpers_equal_the_reference(helper, seed):
    sizes = _sizes(seed)
    rng = np.random.default_rng(100 + seed)
    target = int(rng.integers(1, 30000))
    if helper == "pack_ranges":
        off = int(rng.integers(0, 9))
        assert PA.pack_ranges(sizes, target, off) == JA.pack_ranges(
            sizes, target, off)
    elif helper == "coalesce_specs":
        assert ([_spec_tuple(s) for s in PA.coalesce_specs(sizes, target)]
                == [_spec_tuple(s) for s in JA.coalesce_specs(sizes,
                                                              target)])
    elif helper == "split_map_ranges":
        assert PA.split_map_ranges(sizes, target) == JA.split_map_ranges(
            sizes, target)
    else:
        factor = float(rng.choice([1.0, 1.5, 5.0]))
        assert PA.skew_threshold(sizes, factor, target) == \
            JA.skew_threshold(sizes, factor, target)
        assert PA.skew_threshold(sizes[:2], factor, 0) == \
            JA.skew_threshold(sizes[:2], factor, 0)


# ---------------------------------------------------------------------------
# spec lists against the reference
# ---------------------------------------------------------------------------


def _facts(n, seed, hot=None, hot_share=0.7):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 50, n)
    if hot is not None:
        k = np.where(rng.random(n) < hot_share, hot, k)
    return pa.table({"k": pa.array(k, pa.int64()),
                     "v": pa.array(rng.integers(-999, 999, n), pa.int64()),
                     "x": pa.array(rng.normal(0, 10, n))})


def _dims(n=50, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({"k2": pa.array(np.arange(n), pa.int64()),
                     "w": pa.array(rng.integers(0, 9, n), pa.int64())})


def _even_dims(seed=13):
    rng = np.random.default_rng(seed)
    return pa.table({"k": pa.array(np.arange(0, 120, 2), pa.int64()),
                     "w": pa.array(rng.integers(0, 9, 60), pa.int64())})


def _halves(t, make):
    """A union of the table's two halves: two partitions, as the
    reference's AQE tests build their shuffles."""
    h = t.num_rows // 2
    return make(t.slice(0, h)).union(make(t.slice(h)))


SKEW = {"adaptive.advisoryPartitionSizeBytes": 4096,
        "adaptive.skewJoin.skewedPartitionThresholdBytes": 4096,
        "adaptive.skewJoin.skewedPartitionFactor": 1.5,
        "join.broadcastRowThreshold": 0, "shuffle.writeThreads": 1}
COALESCE = {"adaptive.advisoryPartitionSizeBytes": 1 << 40,
            "shuffle.writeThreads": 1}


def _confs(settings, fastpath=False):
    pk = {f"spark.rapids.gpu.sql.{k}" if not k.startswith("shuffle")
          else f"spark.rapids.gpu.{k}": v for k, v in settings.items()}
    jk = {f"spark.rapids.tpu.sql.{k}" if not k.startswith("shuffle")
          else f"spark.rapids.tpu.{k}": v for k, v in settings.items()}
    pk["spark.rapids.gpu.fastpath.enabled"] = str(fastpath).lower()
    jk["spark.rapids.tpu.fastpath.enabled"] = str(fastpath).lower()
    jk["spark.rapids.tpu.plan.cache.enabled"] = "false"
    return RapidsConf(pk), JConf(jk)


def _both(settings):
    pconf, jconf = _confs(settings)
    return (lambda t: port_from_arrow(t, pconf, device="cpu"),
            lambda t: jax_from_arrow(t, jconf))


@pytest.mark.parametrize("case", ["coalesced_aggregate", "skew_inner",
                                  "skew_left_semi", "coalesced_sort"])
def test_spec_lists_equal_the_reference(case):
    settings = COALESCE if case.startswith("coalesced") else SKEW
    port, jax = _both(settings)
    if case == "coalesced_aggregate":
        t = _facts(3000, 7)

        def build(make, E):
            return _halves(t, make).group_by("k").agg(
                E.Sum(E.col("v")).alias("sv"), E.Count().alias("n"))
    elif case == "coalesced_sort":
        t = _facts(2000, 8)

        def build(make, E):
            return _halves(t, make).sort("v")
    else:
        t, d = _facts(3000, 9, hot=3), _dims()
        how = case[len("skew_"):]

        def build(make, E):
            return _halves(t, make).join(make(d), left_on="k",
                                         right_on="k2", how=how)
    from spark_rapids_tpu.exprs import expr as JE

    pdf, jdf = build(port, PE), build(jax, JE)
    pplan, jplan = pdf.physical_plan(), jdf.physical_plan()
    got = execute_to_arrow(pplan).to_pylist()
    exp = _run_reference(jplan)
    pspecs = [[_spec_tuple(s) for s in r.specs()]
              for r in _readers(pplan, PA.AQEShuffleReadExec)]
    jspecs = [[_spec_tuple(s) for s in r.specs()]
              for r in _readers(jplan, JA.AQEShuffleReadExec)]
    assert pspecs and pspecs == jspecs
    if case.startswith("skew"):
        assert any(s[0] == "partial" for ss in pspecs for s in ss)
    else:
        assert pspecs == [[("coalesced", 0, 4)]]
    if case == "coalesced_sort":
        assert [r["v"] for r in got] == [r["v"] for r in exp]
    assert PTPCH.rows_match(_canon(got), _canon(exp))


def _run_reference(jplan):
    """The rows of a built physical plan of the reference; then its
    shuffles are released."""
    from spark_rapids_tpu.columnar.batch import batch_to_arrow
    from spark_rapids_tpu.shuffle.exchange_exec import (
        ShuffleExchangeExec as JEx)

    schema = jplan.output_schema
    tables = [batch_to_arrow(b, schema) for p in
              range(jplan.num_partitions()) for b in jplan.execute(p)]
    for n in _walk(jplan):
        if isinstance(n, JEx):
            n.cleanup()
    return pa.concat_tables(tables).to_pylist() if tables else []


# ---------------------------------------------------------------------------
# rows against AQE off
# ---------------------------------------------------------------------------


def _port(t, settings, extra=None, **kw):
    pconf, _ = _confs(dict(settings, **(extra or {})))
    return port_from_arrow(t, pconf, device="cpu", **kw)


def test_coalesced_aggregate_and_range_sort_match_aqe_off():
    t = _facts(4000, 11)
    rows = {}
    for name, extra in (("on", {}), ("off", {"adaptive.enabled": "false"})):
        d = _port(t, COALESCE, extra, batch_rows=500, partitions=4)
        agg = d.group_by("k").agg(PE.Sum(PE.col("x")).alias("sx"),
                                  PE.Count().alias("n"))
        srt = d.sort(POrd(PE.col("x"), ascending=False))
        win = d.with_window(PE.Alias(PW.WindowExpression(
            PW.RowNumber(), PW.WindowSpec((PE.col("k"),),
                                          (POrd(PE.col("v")),))), "rn"))
        plans = [q.physical_plan() for q in (agg, srt, win)]
        readers = [r for p in plans
                   for r in _readers(p, PA.AQEShuffleReadExec)]
        assert len(readers) == (3 if name == "on" else 0)
        rows[name] = [execute_to_arrow(p).to_pylist() for p in plans]
        if name == "on":
            assert all(r.specs() == [PA.CoalescedPartitionSpec(0, 4)]
                       for r in readers)
    (agg_on, srt_on, win_on), (agg_off, srt_off, win_off) = (rows["on"],
                                                             rows["off"])
    # a coalesced read changes the float sums' merge layout: rel 1e-6
    assert PTPCH.rows_match(_canon(agg_on), _canon(agg_off))
    assert [r["x"] for r in srt_on] == [r["x"] for r in srt_off]
    assert _canon(srt_on) == _canon(srt_off)
    assert _canon(win_on) == _canon(win_off)


def _skew_sides(how):
    """(left, right): the side a ``how`` join may split holds a hot key
    (70% of its rows); the other side has the even keys only, the hot one
    among them, so every join type keeps some rows and drops others."""
    hot = _facts(3000, 12, hot=4)
    dims = _even_dims()
    if how == "right":
        return dims, hot
    return hot, dims


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("how", ["inner", "left", "left_semi", "left_anti",
                                 "right"])
def test_skew_join_matches_aqe_off_and_the_reference(how, threads):
    left, right = _skew_sides(how)
    settings = dict(SKEW, **{"shuffle.writeThreads": threads})
    rows = {}
    for name, extra in (("on", {}), ("off", {"adaptive.enabled": "false"})):
        make = lambda t: _port(t, settings, extra)  # noqa: E731
        q = _halves(left, make).join(_halves(right, make), on="k", how=how)
        plan = q.physical_plan()
        rows[name] = execute_to_arrow(plan).to_pylist()
        readers = _readers(plan, PA.SkewAwareShuffleReadExec)
        if name == "off":
            assert not readers
            continue
        assert len(readers) == 2
        lspecs, rspecs = readers[0].specs(), readers[1].specs()
        assert len(lspecs) == len(rspecs)
        split_side = rspecs if how == "right" else lspecs
        assert any(isinstance(s, PA.PartialReducerPartitionSpec) and
                   s.map_end - s.map_start < 2 for s in split_side)
        for ls, rs in zip(lspecs, rspecs):
            if isinstance(ls, PA.CoalescedPartitionSpec) and isinstance(
                    rs, PA.CoalescedPartitionSpec):
                assert ls == rs  # a joint coalesced run
            else:  # the chunks of one reducer
                assert ls.reducer == rs.reducer
    assert rows["on"] and _canon(rows["on"]) == _canon(rows["off"])
    if threads == 1:
        _, jconf = _confs(settings)
        jl = _halves(left, lambda t: jax_from_arrow(t, jconf))
        jr = _halves(right, lambda t: jax_from_arrow(t, jconf))
        exp = jl.join(jr, on="k", how=how).collect()
        assert _canon(rows["on"]) == _canon(exp)


def test_a_full_join_is_never_split():
    """The sides an inner join splits (its left) stay whole in a full
    join."""
    left, right = _skew_sides("inner")
    make = lambda t: _port(t, SKEW)  # noqa: E731
    q = _halves(left, make).join(_halves(right, make), on="k", how="full")
    plan = q.physical_plan()
    got = execute_to_arrow(plan).to_pylist()
    readers = _readers(plan, PA.SkewAwareShuffleReadExec)
    assert len(readers) == 2
    assert not any(isinstance(s, PA.PartialReducerPartitionSpec)
                   for r in readers for s in r.specs())
    off = lambda t: _port(t, SKEW, {"adaptive.enabled": "false"})  # noqa
    exp = _halves(left, off).join(_halves(right, off), on="k",
                                  how="full").collect()
    assert got and _canon(got) == _canon(exp)


def test_aqe_off_leaves_a_plain_exchange():
    t = _facts(1000, 15)
    for extra, want in (({"adaptive.enabled": "false"}, 0), ({}, 1)):
        d = _port(t, {}, extra, batch_rows=250, partitions=4)
        plan = d.group_by("k").agg(PE.Count().alias("n")).physical_plan()
        assert len(_readers(plan, PA.AQEShuffleReadExec)) == want
        assert len(_readers(plan, ShuffleExchangeExec)) == 1


def test_planning_writes_no_exchange(monkeypatch):
    """physical_plan() of plans with aggregates, windows, shuffled and
    broadcast joins, a top-k and a union, but no range sort, registers
    no shuffle; their readers stay unplanned until the run."""
    writes = []
    real = ShuffleManager.register

    def counting(self, *a, **kw):
        writes.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(ShuffleManager, "register", counting)
    f, d = _facts(3000, 16, hot=4), _even_dims(17)
    make = lambda t: _port(t, dict(SKEW, **{  # noqa: E731
        "join.broadcastRowThreshold": 40}), batch_rows=300, partitions=4)
    base = make(f).join(make(d), on="k").union(make(f).join(
        make(d).filter(PE.col("w") > 2), on="k", how="left"))
    q = base.group_by("k").agg(PE.Sum(PE.col("v")).alias("sv")).with_window(
        PE.Alias(PW.WindowExpression(PW.Rank(), PW.WindowSpec(
            (PE.col("k"),), (POrd(PE.col("sv")),))), "r")).sort(
        POrd(PE.col("sv")), limit=7)
    plan = q.physical_plan()
    assert writes == []
    readers = _readers(plan, PA.AQEShuffleReadExec)
    assert len(readers) >= 3
    assert all(r.planned_specs() is None for r in readers)
    got = execute_to_arrow(plan).to_pylist()
    assert writes and len(got) == 7
    assert all(r.planned_specs() is not None for r in readers)


def test_a_plan_run_again_reads_through_its_kept_specs():
    left, right = _skew_sides("inner")
    make = lambda t: _port(t, SKEW)  # noqa: E731
    plan = _halves(left, make).join(_halves(right, make), on="k"
                                    ).physical_plan()
    first = execute_to_arrow(plan).to_pylist()
    readers = _readers(plan, PA.SkewAwareShuffleReadExec)
    specs = [r.specs() for r in readers]
    exchanges = _readers(plan, ShuffleExchangeExec)
    assert exchanges and not any(e._written for e in exchanges)
    again = execute_to_arrow(plan).to_pylist()
    assert [r.specs() for r in readers] == specs
    assert _canon(again) == _canon(first) and first
