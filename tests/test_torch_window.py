"""The port's WindowExec (spark_rapids_tpu_torch.exec.window) held against
the JAX package's on the same seeded tables, split into several batches,
for each supported function and frame (the surface of tests/test_window.py):
row_number, rank, dense_rank, and sum/count/avg/min/max over ROWS and RANGE
frames UNBOUNDED..UNBOUNDED and UNBOUNDED..CURRENT ROW, with null and NaN
order keys, null partition keys, DECIMAL64 inputs and dictionary-string
partition keys. Rows come out partition-sorted on both sides and are
compared row by row in order: everything exactly except float sums and
averages, which agree within 1e-9 relative (another summation order)."""

import decimal
import math

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar import batch as JB
from spark_rapids_tpu.exec import BatchSourceExec as JSource
from spark_rapids_tpu.exec.window import WindowExec as JWindow
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.exprs import window as JW
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar import batch as PB
from spark_rapids_tpu_torch.exec import kernels as PK
from spark_rapids_tpu_torch.exec.base import BatchSourceExec as PSource
from spark_rapids_tpu_torch.exec.window import WindowExec as PWindow
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.exprs import window as PW

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

REL = 1e-9


def _sources(table, rows_per_batch):
    t = JB.dictionary_encode_table(table)
    jcache, pcache = {}, {}
    slices = [t.slice(i, rows_per_batch)
              for i in range(0, max(t.num_rows, 1), rows_per_batch)]
    jb = [JB.batch_from_arrow(s, 16, dict_cache=jcache) for s in slices]
    pb = [PB.batch_from_arrow(s, "cpu", dict_cache=pcache) for s in slices]
    return (JSource([jb], JT.Schema.from_arrow(table.schema)),
            PSource([pb], PT.Schema.from_arrow(table.schema)))


def _rows(node, B):
    out = []
    for b in node.execute(0):
        out.extend(B.batch_to_arrow(b, node.output_schema).to_pylist())
    return out


def _data(n=400, seed=42):
    rng = np.random.default_rng(seed)
    o = rng.integers(0, 25, n).astype(np.float64)
    o[rng.random(n) < 0.08] = np.nan
    v = rng.normal(0, 10, n)
    v[rng.random(n) < 0.05] = np.nan
    cats = np.array(["Books", "Home", "Music", "Shoes", "Sports"])
    return pa.table({
        "g": pa.array(rng.integers(0, 6, n), pa.int64(),
                      mask=rng.random(n) < 0.05),
        "o": pa.array(o, pa.float64(), mask=rng.random(n) < 0.06),
        "io": pa.array(rng.integers(0, 30, n).astype(np.int32), pa.int32(),
                       mask=rng.random(n) < 0.05),
        "v": pa.array(v, pa.float64(), mask=rng.random(n) < 0.08),
        "iv": pa.array(rng.integers(-500, 500, n), pa.int64(),
                       mask=rng.random(n) < 0.08),
        "dv": pa.array([decimal.Decimal(int(x)).scaleb(-2) for x in
                        rng.integers(-10**6, 10**6, n)], pa.decimal128(7, 2),
                       mask=rng.random(n) < 0.08),
        "cat": pa.array(cats[rng.integers(0, len(cats), n)].tolist(),
                        pa.string()),
    })


def _assert_rows_equal(got, exp):
    assert len(got) == len(exp) and len(got) > 0
    assert list(got[0]) == list(exp[0])
    for rg, re_ in zip(got, exp):
        for k, vg in rg.items():
            ve = re_[k]
            if isinstance(vg, float) or isinstance(ve, float):
                assert vg is not None and ve is not None, (k, rg, re_)
                if math.isnan(ve):
                    assert math.isnan(vg), (k, rg, re_)
                else:
                    assert abs(vg - ve) <= REL * max(1.0, abs(ve)), (k, vg, ve)
            else:
                assert vg == ve, (k, rg, re_)


def _functions(M, W):
    """Every supported window function, as (alias, function)."""
    return [("rn", W.RowNumber()), ("rk", W.Rank()), ("dr", W.DenseRank()),
            ("s_v", M.Sum(M.col("v"))), ("s_iv", M.Sum(M.col("iv"))),
            ("s_dv", M.Sum(M.col("dv"))), ("c_v", M.Count(M.col("v"))),
            ("c_all", M.Count()), ("a_v", M.Average(M.col("v"))),
            ("a_iv", M.Average(M.col("iv"))),
            ("a_dv", M.Average(M.col("dv"))),
            ("mn_v", M.Min(M.col("v"))), ("mx_v", M.Max(M.col("v"))),
            ("mn_iv", M.Min(M.col("iv"))), ("mx_io", M.Max(M.col("io"))),
            ("mn_dv", M.Min(M.col("dv"))), ("mx_dv", M.Max(M.col("dv")))]


FRAMES = {
    "rows_unbounded": ("rows", None, None),
    "rows_running": ("rows", None, 0),
    "range_running": ("range", None, 0),
    "range_unbounded": ("range", None, None),
}

SPECS = {
    "g_by_io_desc_nulls_first": (["g"], [("io", False, True), ("o", True,
                                                               False)]),
    "cat_by_dv_desc": (["cat"], [("dv", False, None)]),
    "order_only": ([], [("o", False, None), ("iv", True, None)]),
}


def _orders(M, Sort, spec_name):
    return [Sort(M.col(c), asc, nf) for c, asc, nf in SPECS[spec_name][1]]


def _exprs(M, W, Sort, spec_name):
    """Every function over every frame of one (partition, order) spec, as
    one window group; columns are named ``<function>@<frame>``."""
    out = []
    for frame_name, fr in FRAMES.items():
        frame = W.WindowFrame(*fr)
        spec = W.window_spec(partition_by=SPECS[spec_name][0],
                             order_by=_orders(M, Sort, spec_name),
                             frame=frame)
        out += [W.over(f, spec).alias(f"{a}@{frame_name}")
                for a, f in _functions(M, W)]
    return out


@pytest.mark.parametrize("spec_name", sorted(SPECS))
def test_window_matches_jax(spec_name):
    from spark_rapids_tpu.exec.sort import SortOrder as JOrd
    from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd

    js, ps = _sources(_data(), 128)
    exp = _rows(JWindow(_exprs(JE, JW, JOrd, spec_name), js), JB)
    got = _rows(PWindow(_exprs(PE, PW, POrd, spec_name), ps), PB)
    names = list(_data(1).column_names)
    for frame_name in FRAMES:
        def cols(rows):
            return [{k: v for k, v in r.items()
                     if k in names or k.endswith("@" + frame_name)}
                    for r in rows]

        _assert_rows_equal(cols(got), cols(exp))


def test_default_frames_follow_spark():
    ordered = PW.window_spec(order_by=["o"])
    assert ordered.resolved_frame() == PW.WindowFrame("range", None, 0)
    assert PW.window_spec().resolved_frame() == PW.WindowFrame("rows", None,
                                                               None)


def test_window_without_partition_or_order_matches_jax():
    js, ps = _sources(_data(120, seed=3), 50)
    exp = _rows(JWindow([JW.over(f, JW.window_spec()).alias(a)
                         for a, f in _functions(JE, JW)[3:]], js), JB)
    got = _rows(PWindow([PW.over(f, PW.window_spec()).alias(a)
                         for a, f in _functions(PE, PW)[3:]], ps), PB)
    _assert_rows_equal(got, exp)


def test_window_geometry_goes_through_the_segscan_wrapper(monkeypatch):
    calls = []
    real = PK.segmented_scan_kernel

    def spy(values, is_start, op_name="add"):
        calls.append((values.dtype, op_name))
        return real(values, is_start, op_name)

    monkeypatch.setattr(PK, "segmented_scan_kernel", spy)
    from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd

    _, ps = _sources(_data(), 128)
    spec = PW.window_spec(partition_by=["g"], order_by=[POrd(PE.col("o"))])
    rows = _rows(PWindow([PW.over(PW.Rank(), spec).alias("rk")], ps), PB)
    assert len(rows) == 400
    # segment start/end and peer-run start/end: four int32 max scans
    import torch
    assert calls == [(torch.int32, "max")] * 4


def test_window_over_empty_input():
    from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd

    t = _data(10).slice(0, 0)
    ps = PSource([[PB.batch_from_arrow(t, "cpu")]],
                 PT.Schema.from_arrow(t.schema))
    spec = PW.window_spec(partition_by=["g"], order_by=[POrd(PE.col("o"))])
    node = PWindow([PW.over(PW.Rank(), spec).alias("rk"),
                    PW.over(PE.Sum(PE.col("dv")), spec).alias("s")], ps)
    assert _rows(node, PB) == []
    assert node.output_schema.names()[-2:] == ["rk", "s"]


@pytest.mark.parametrize("what", ["bounded_range", "range_descending",
                                  "range_two_keys", "wide_decimal",
                                  "string_agg", "string_first"])
def test_window_outside_the_port_raises(what):
    """What the port's window still refuses, as the reference does: a
    bounded RANGE frame over anything but one ascending integral or date
    order key, Min/Max over DECIMAL128 and aggregates over strings (but
    Count)."""
    from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd

    t = _data(50).append_column(
        "wide", pa.array([decimal.Decimal(1)] * 50, pa.decimal128(22, 2)))
    ps = PSource([[PB.batch_from_arrow(t, "cpu")]],
                 PT.Schema.from_arrow(t.schema))
    spec = PW.window_spec(partition_by=["g"], order_by=[POrd(PE.col("o"))])
    f = {"bounded_range": lambda: PE.Sum(PE.col("v")),
         "range_descending": lambda: PE.Sum(PE.col("v")),
         "range_two_keys": lambda: PE.Count(PE.col("v")),
         # a DECIMAL128 window Sum/Average is in the port, Min/Max not
         "wide_decimal": lambda: PE.Max(PE.col("wide")),
         "string_agg": lambda: PE.Min(PE.col("cat")),
         "string_first": lambda: PE.First(PE.col("cat"))}[what]()
    if what == "bounded_range":  # a double order key
        spec = PW.window_spec(["g"], [POrd(PE.col("o"))],
                              PW.WindowFrame("range", None, 3))
    elif what == "range_descending":
        spec = PW.window_spec(["g"], [POrd(PE.col("io"), False)],
                              PW.WindowFrame("range", -2, 2))
    elif what == "range_two_keys":
        spec = PW.window_spec(["g"], [POrd(PE.col("io")), POrd(PE.col("iv"))],
                              PW.WindowFrame("range", 0, 2))
    with pytest.raises(NotImplementedError):
        node = PWindow([PW.over(f, spec).alias("w")], ps)
        list(node.execute(0))


@pytest.mark.parametrize("frame", ["unbounded", "running_rows",
                                   "running_range"])
def test_cpu_engine_window_matches_device(frame):
    """The CPU engine's window operator (``plan/cpu_window.py``) against
    the device's WindowExec: ranks, and Sum/Count/Average/Min/Max of
    doubles (NaN and nulls), integers and decimals, over nullable
    partition and order keys (a double order key with NaN)."""
    from spark_rapids_tpu_torch.config.conf import RapidsConf
    from spark_rapids_tpu_torch.exec.sort import SortOrder as POrd
    from spark_rapids_tpu_torch.plan import from_arrow

    fr = {"unbounded": PW.WindowFrame("rows", None, None),
          "running_rows": PW.WindowFrame("rows", None, 0),
          "running_range": PW.WindowFrame("range", None, 0)}[frame]
    t = _data(300, seed=7)

    def q(conf):
        df = from_arrow(t, RapidsConf(conf), batch_rows=128, device="cpu")
        spec = PW.window_spec(["g"], [POrd(PE.col("o")),
                                      POrd(PE.col("io"), False)], fr)
        ws = [PW.over(f, spec).alias(n) for n, f in (
            ("rk", PW.Rank()), ("drk", PW.DenseRank()),
            ("sv", PE.Sum(PE.col("v"))), ("siv", PE.Sum(PE.col("iv"))),
            ("sdv", PE.Sum(PE.col("dv"))), ("adv", PE.Average(PE.col("dv"))),
            ("av", PE.Average(PE.col("iv"))), ("n", PE.Count(PE.col("v"))),
            ("nall", PE.Count()), ("mn", PE.Min(PE.col("v"))),
            ("mx", PE.Max(PE.col("dv"))), ("mxi", PE.Max(PE.col("io"))))]
        if frame == "running_rows":  # rows ties keep the input's order
            ws.append(PW.over(PW.RowNumber(), spec).alias("rn"))
        out = df.with_window(*ws)
        return out.explain(), out.collect()

    dev_plan, dev = q({})
    cpu_plan, cpu = q({"spark.rapids.gpu.sql.enabled": "false"})
    assert "!" not in dev_plan and "! Window" in cpu_plan
    _assert_rows_equal(cpu, dev)
