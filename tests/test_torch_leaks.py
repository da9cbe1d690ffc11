"""What a query leaves behind when it raises or is never run: its shuffles'
files and registrations, and a reused exchange's held partitions.

A partitioned query (4 source splits, 4 shuffle partitions, the fast path
off) whose ANSI string -> INT cast raises on ``'x'``, with the cast above
the aggregate (a CPU-engine root over the device's exchange) and below it
(a device root over an exchange whose map pass raises), leaves the leak
sweep clean and no shuffle file. So does a plan whose range sort sampled
its child at planning and was then dropped unrun, and a reuse entry
dropped while it holds a partition.
"""

import os

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec import reuse as R
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.mem import cleaner
from spark_rapids_tpu_torch.plan import from_arrow
from spark_rapids_tpu_torch.shuffle.manager import get_manager

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

PARTITIONED = {"spark.rapids.gpu.fastpath.enabled": "false"}


def _table(n: int = 4000) -> pa.Table:
    vals = [str(i % 97) for i in range(n)]
    vals[n // 2] = "x"
    return pa.table({"k": pa.array([i % 13 for i in range(n)], pa.int64()),
                     "s": pa.array(vals)})


def _shuffle_files() -> list:
    d = get_manager(RapidsConf(PARTITIONED))._local_dir
    return sorted(os.listdir(d)) if d and os.path.isdir(d) else []


def _frame(conf=PARTITIONED):
    df = from_arrow(_table(), RapidsConf(conf), batch_rows=500,
                    device="cpu", partitions=4)
    df.shuffle_partitions = 4
    return df


def _cast_above(df):
    g = df.group_by("k").agg(PE.Alias(PE.Max(PE.col("s")), "m"))
    return g.select(PE.col("k"), PE.Alias(
        PE.Cast(PE.col("m"), PT.INT, ansi=True), "i"))


def _cast_below(df):
    p = df.select(PE.col("k"), PE.Alias(
        PE.Cast(PE.col("s"), PT.INT, ansi=True), "i"))
    return p.group_by("k").agg(PE.Alias(PE.Sum(PE.col("i")), "t"))


@pytest.mark.parametrize("build, root", [(_cast_above, "cpu"),
                                         (_cast_below, "device")])
def test_a_raising_partitioned_query_leaves_no_shuffle(build, root):
    before = _shuffle_files()
    q = build(_frame())
    plan = q.physical_plan()
    assert type(plan).__name__.startswith("Cpu") == (root == "cpu")
    assert "HashPartitioner(4)" in plan.explain()
    with pytest.raises(ValueError, match="'x'"):
        from spark_rapids_tpu_torch.plan.dataframe import execute_to_arrow
        execute_to_arrow(plan)
    assert cleaner.sweep() == []
    assert _shuffle_files() == before


def test_a_dropped_plan_releases_its_sampled_shuffle():
    """A range sort over an exchange samples its child at planning, which
    writes the exchange; the plan is dropped unrun."""
    before = _shuffle_files()
    q = _frame().group_by("k").agg(PE.Alias(PE.Count(), "n")).sort("k")
    assert "HashPartitioner(4)" in q.physical_plan().explain()
    assert cleaner.sweep() == []
    assert _shuffle_files() == before
    assert [r["n"] for r in q.collect()] == [308] * 9 + [307] * 4
    assert cleaner.sweep() == []


def test_a_dropped_reuse_entry_closes_what_it_holds():
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow

    entry = R.SharedExchangeEntry(RapidsConf(), R.MaterializationCache())
    entry.retain(1)
    batch = batch_from_arrow(pa.table({"a": list(range(64))}),
                             device="cpu")
    assert len(list(entry.read(0, lambda: iter([batch])))) == 1
    assert entry.cached_partitions() == 1
    assert cleaner.sweep() != []  # held until it is released or dropped
    del entry
    assert cleaner.sweep() == []
