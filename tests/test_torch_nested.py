"""The nested types (STRUCT, MAP, ARRAY) in the port, held against the JAX
package on the CPU: every nested class on the port's device path against
the reference's device path and on the port's CPU engine against the
reference's CPU engine; nested columns carried through filter, project,
join, union, limit and the concatenation of batches; upload and download;
placement and its reasons as the reference's (``explain``).

Tolerance: exact (rows compared as Python values).
"""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import (
    ELEMENT_NULLS, batch_from_arrow, batch_to_arrow)
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.exec import kernels as K
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.plan import from_arrow as port_from_arrow

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)

STRUCT = pa.struct([("a", pa.int64()), ("b", pa.string()),
                    ("d", pa.float64())])


def table(seed: int = 17, n: int = 40) -> pa.Table:
    """Seeded rows: a struct with a null row and null fields, a map with
    null rows, empty maps and null values, an array with null rows and
    empty arrays, and two integer columns."""
    rng = np.random.default_rng(seed)
    s = [None if rng.random() < .1 else {
        "a": None if rng.random() < .15 else int(rng.integers(0, 9)),
        "b": None if rng.random() < .15 else "x" * int(rng.integers(0, 4)),
        "d": float(rng.integers(-40, 40)) / 4} for _ in range(n)]
    m = [None if rng.random() < .1 else [
        (int(k), None if rng.random() < .1 else float(rng.integers(0, 99)))
        for k in sorted(set(rng.integers(0, 7, rng.integers(0, 4))
                            .tolist()))] for _ in range(n)]
    arr = [None if rng.random() < .1 else rng.integers(
        0, 9, rng.integers(0, 5)).tolist() for _ in range(n)]
    return pa.table({
        "s": pa.array(s, STRUCT),
        "m": pa.array(m, pa.map_(pa.int64(), pa.float64())),
        "arr": pa.array(arr, pa.list_(pa.int64())),
        "k": pa.array(rng.integers(0, 7, n), pa.int64()),
        "v": pa.array(np.arange(n) * 10, pa.int64())})


def device_exprs(M):
    """(name, expression) of every device class (one projection)."""
    c, lit = M.col, M.lit
    st = M.CreateNamedStruct(("x", "y"), c("k"),
                             M.GetStructField(c("s"), "d"))
    return [
        ("a", M.GetStructField(c("s"), "a")),
        ("b", M.GetStructField(c("s"), "b")),
        ("st", st), ("y", M.GetStructField(st, "y")),
        ("mk", M.MapKeys(c("m"))),
        ("msz", M.Size(c("m"))), ("asz", M.Size(c("arr"), False)),
        ("m1", M.ElementAt(c("m"), lit(1))),
        ("mkk", M.ElementAt(c("m"), c("k"))),
        ("a2", M.ElementAt(c("arr"), lit(2))),
        ("alast", M.ElementAt(c("arr"), lit(-1))),
        ("c2", M.ArrayContains(c("arr"), lit(2))),
        ("ck", M.ArrayContains(c("arr"), c("k"))),
        ("sn", M.IsNull(c("s"))), ("mn", M.IsNotNull(c("m"))),
        ("s", c("s")), ("m", c("m")), ("arr", c("arr"))]


_JAX = {}


def _jax(build, device: bool, t=None):
    key = (build.__name__, device)
    if t is not None or key not in _JAX:
        conf = None if device else JConf({"spark.rapids.tpu.sql.enabled":
                                          "false"})
        df = jax_from_arrow(table() if t is None else t, conf)
        df.shuffle_partitions = 1
        got = build(df, JE).to_arrow().to_pylist()
        if t is not None:
            return got
        _JAX[key] = got
    return _JAX[key]


def _port(build, device: bool, t=None, batch_rows=1 << 20):
    conf = None if device else RapidsConf({"spark.rapids.gpu.sql.enabled":
                                           "false"})
    return build(port_from_arrow(table() if t is None else t, conf,
                                 device="cpu", batch_rows=batch_rows), PE)


def _cpu_nodes(df):
    return [ln.strip() for ln in df.explain().splitlines()
            if ln.lstrip().startswith("!")]


def projection(df, M):
    return df.select(*[e.alias(n) for n, e in device_exprs(M)])


@pytest.mark.parametrize("device", [True, False], ids=["device", "cpu"])
def test_nested_classes_match_the_reference(device):
    q = _port(projection, device)
    if device:
        assert _cpu_nodes(q) == []
    got, exp = q.to_arrow().to_pylist(), _jax(projection, device)
    for name, _ in device_exprs(PE):
        assert [r[name] for r in got] == [r[name] for r in exp], name


def test_the_two_engines_agree():
    dev = _port(projection, True).to_arrow()
    cpu = _port(projection, False).to_arrow()
    assert dev.equals(cpu)


def test_upload_and_download_round_trip_every_nested_type():
    t = table()
    b = batch_from_arrow(t, "cpu")
    assert batch_to_arrow(b, PT.Schema.from_arrow(t.schema)).equals(t)
    idx = torch.tensor([5, 0, 0, 39, 7])
    g = K.gather_batch(b, idx)
    assert batch_to_arrow(g, PT.Schema.from_arrow(t.schema)).equals(
        t.take(pa.array(idx.numpy())))
    c = K.concat_device([K.slice_batch(b, 30, 40), g])
    assert batch_to_arrow(c, PT.Schema.from_arrow(t.schema)).to_pylist() \
        == t.slice(30, 10).to_pylist() + g_rows(t, idx)


def g_rows(t, idx):
    return t.take(pa.array(idx.numpy())).to_pylist()


def test_array_with_element_nulls_raises_and_runs_on_the_cpu_engine():
    t = pa.table({"arr": pa.array([[1, None], [2]], pa.list_(pa.int64())),
                  "v": pa.array([1, 2], pa.int64())})
    with pytest.raises(NotImplementedError, match=ELEMENT_NULLS):
        batch_from_arrow(t, "cpu")
    df = port_from_arrow(t, device="cpu").select(
        PE.Size(PE.col("arr")).alias("n"), PE.col("v"))
    assert any(ELEMENT_NULLS in ln for ln in _cpu_nodes(df))
    assert df.to_arrow().to_pylist() == [{"n": 2, "v": 1}, {"n": 1, "v": 2}]


def carried(df, M):
    """Filter, project, union and limit carrying nested columns."""
    c = M.col
    f = df.filter(M.GreaterThan(c("v"), M.lit(95))).select(
        c("s"), c("m"), c("arr"), c("v"))
    return f.union(f.filter(M.LessThan(c("v"), M.lit(200)))).limit(30)


@pytest.mark.parametrize("batch_rows", [1 << 20, 7])
def test_nested_columns_carried_through_operators(batch_rows):
    q = _port(carried, True, batch_rows=batch_rows)
    assert _cpu_nodes(q) == []
    got = q.to_arrow().to_pylist()
    assert got == _jax(carried, True)
    assert got == _port(carried, False).to_arrow().to_pylist()


def joined(df, M):
    c = M.col
    right = df.select(M.Alias(c("k"), "k2"), M.Alias(c("m"), "m2"),
                      M.Alias(c("arr"), "arr2"))
    return df.select(c("k"), c("v"), c("m"), c("arr")).join(
        right, left_on="k", right_on="k2")


def _by_v(rows):
    return sorted(rows, key=lambda r: (r["v"], repr(r)))


def test_nested_columns_carried_through_a_join():
    q = _port(joined, True)
    assert _cpu_nodes(q) == []
    got = _by_v(q.to_arrow().to_pylist())
    assert got == _by_v(_jax(joined, False))
    assert got == _by_v(_port(joined, False).to_arrow().to_pylist())


def _reasons(lines):
    out = set()
    for ln in lines:
        if "because " in ln:
            out.update(r.strip() for r in ln.split("because ", 1)[1]
                       .split("  [")[0].split(";"))
    return out


def _jax_reasons(df):
    return _reasons(ln for ln in df.explain().splitlines()
                    if ln.lstrip().startswith("!"))


PLACEMENT = {
    "map_values": lambda df, M: df.select(
        M.MapValues(M.col("m")).alias("x")),
    "group_key": lambda df, M: df.group_by("s").agg(
        M.Sum(M.col("v")).alias("sv")),
    "first_struct": lambda df, M: df.group_by("k").agg(
        M.First(M.col("s")).alias("fs")),
    "if_struct": lambda df, M: df.select(M.If(
        M.GreaterThan(M.col("v"), M.lit(50)), M.col("s"), M.col("s"))
        .alias("i")),
    "string_keys": lambda df, M: df.select(
        M.MapKeys(M.col("sm")).alias("x"),
        M.ElementAt(M.col("sv"), M.lit(1)).alias("y")),
    "wide_keys": lambda df, M: df.select(M.MapKeys(M.col("wm")).alias("x")),
    "contains_double": lambda df, M: df.select(
        M.ArrayContains(M.col("da"), M.lit(decimal.Decimal(10) ** 20))
        .alias("x")),
    "join_struct_strings": lambda df, M: df.select(M.col("k"), M.col("s"))
    .join(df.select(M.Alias(M.col("k"), "k2")), left_on="k",
          right_on="k2"),
}


def placement_table():
    t = table()
    n = t.num_rows
    return t.append_column("sm", pa.array(
        [[("a", 1)]] * n, pa.map_(pa.string(), pa.int64()))).append_column(
        "sv", pa.array([[(1, "x")]] * n, pa.map_(pa.int64(), pa.string())))\
        .append_column("wm", pa.array(
            [[(decimal.Decimal(10) ** 20, 1)]] * n,
            pa.map_(pa.decimal128(22, 0), pa.int64()))).append_column(
        "da", pa.array([[1.5, 2.0]] * n, pa.list_(pa.float64())))


@pytest.mark.parametrize("case", sorted(PLACEMENT))
def test_placement_and_reasons_equal_the_reference(case):
    t = placement_table()
    build = PLACEMENT[case]
    port = build(port_from_arrow(t, device="cpu"), PE)
    ref = build(jax_from_arrow(t, JConf({})), JE)
    assert _reasons(_cpu_nodes(port)) == _jax_reasons(ref)
    assert _reasons(_cpu_nodes(port))
    if case in ("map_values", "group_key", "first_struct", "if_struct"):
        rows = port.to_arrow().to_pylist()
        exp = ref.to_arrow().to_pylist()
        assert sorted(map(repr, rows)) == sorted(map(repr, exp))


def collect_table(seed: int = 5, n: int = 60) -> pa.Table:
    """Seeded rows for collect_list/collect_set: five groups with null,
    duplicate and repeated int and string values, and a sixth group
    whose values are all null."""
    rng = np.random.default_rng(seed)
    i = [None if rng.random() < .2 else int(rng.integers(-3, 6))
         for _ in range(n)]
    s = [None if rng.random() < .2 else
         "bca"[int(rng.integers(0, 3))] * int(rng.integers(1, 3))
         for _ in range(n)]
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n).tolist() + [9, 9], pa.int64()),
        "i": pa.array(i + [None, None], pa.int64()),
        "s": pa.array(s + [None, None], pa.string())})


COLLECT = {
    "grouped": lambda df, M: df.group_by("k").agg(
        M.CollectList(M.col("i")).alias("li"),
        M.CollectSet(M.col("i")).alias("si"),
        M.CollectList(M.col("s")).alias("ls"),
        M.CollectSet(M.col("s")).alias("ss")),
    "global": lambda df, M: df.agg(
        M.CollectList(M.col("s")).alias("ls"),
        M.CollectSet(M.col("i")).alias("si")),
}


@pytest.mark.parametrize("case", sorted(COLLECT))
@pytest.mark.parametrize("engine", ["default", "cpu"])
def test_collect_list_and_set_equal_the_reference(case, engine):
    """collect_list and collect_set over int and string values on the
    port's default planner (the aggregate on its CPU engine, named with
    the reference's reasons) and on its CPU engine alone, against the
    reference's CPU engine: each list in row order, each set sorted."""
    t = collect_table()
    build = COLLECT[case]
    conf = RapidsConf({"spark.rapids.gpu.sql.enabled": "false"}) \
        if engine == "cpu" else None
    port = build(port_from_arrow(t, conf, device="cpu", batch_rows=7), PE)
    ref = build(jax_from_arrow(t, JConf({"spark.rapids.tpu.sql.enabled":
                                         "false"})), JE)
    if engine == "default":
        assert _reasons(_cpu_nodes(port)) == _jax_reasons(
            build(jax_from_arrow(t, JConf({})), JE))
        assert "expression CollectList not on device" in _reasons(
            _cpu_nodes(port))
    got = port.to_arrow().to_pylist()
    exp = ref.to_arrow().to_pylist()
    key = (lambda r: r["k"]) if case == "grouped" else None
    assert sorted(got, key=key) == sorted(exp, key=key)
    if case == "grouped":
        assert {r["k"]: r["ls"] for r in got}[9] == []


def test_nested_sort_and_join_keys_stay_on_the_cpu_engine():
    t = table()
    srt = port_from_arrow(t, device="cpu").sort(PE.col("arr"))
    assert "nested sort key not on device" in _reasons(_cpu_nodes(srt))
    j = port_from_arrow(t, device="cpu").join(
        port_from_arrow(t, device="cpu").select(PE.Alias(PE.col("s"),
                                                         "s2")),
        left_on="s", right_on="s2")
    assert "nested join key not on device" in _reasons(_cpu_nodes(j))


def test_nested_types_are_equal_by_name():
    a = PT.ArrayType(PT.INT)
    assert a == PT.ArrayType(PT.INT) and a != PT.ArrayType(PT.LONG)
    s = PT.StructType([("a", PT.INT)])
    assert s == PT.StructType([("a", PT.INT)]) and s.field_index("a") == 0
    assert PT.MapType(PT.INT, PT.STRING).name == "map<int,string>"
    assert PT.from_arrow_type(STRUCT).name == JT.from_arrow_type(
        STRUCT).name
