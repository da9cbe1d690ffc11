"""Delta tables on the port against the JAX package: the eight Delta cases
of ``tests/test_integrations.py`` (create/append/read, DELETE through
deletion vectors, a DELETE that empties a file, UPDATE, MERGE, a fully
deleted table, time travel to a version never committed, an empty
table's types), each run on both packages in directories of their own,
with equal versions, snapshots, record counts, deletion-vector row sets
and rows, and equal log actions apart from timestamps, uuids and file
names. The sidecar's bytes are the reference's. MERGE with a null key
and with a key two source rows match follows Spark, where the reference
does not: both answers are held (ROADMAP queue 3).
"""

import decimal
import json
import os

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.delta import DeltaTable as JDeltaTable
from spark_rapids_tpu.delta import log as JLog
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu_torch.delta import DeltaTable as PDeltaTable
from spark_rapids_tpu_torch.delta import log as PLog
from spark_rapids_tpu_torch.exprs import expr as PE

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


class _Impl:
    """One package's Delta surface: ``create``, its expressions and its
    sidecar reader."""

    def __init__(self, name):
        self.name = name
        self.E = JE if name == "jax" else PE
        self.log = JLog if name == "jax" else PLog

    def create(self, path, table):
        if self.name == "jax":
            return JDeltaTable.create(path, table)
        return PDeltaTable.create(path, table, device="cpu")


JAX, PORT = _Impl("jax"), _Impl("port")


def _tab(rng, n=100, key_start=0):
    return pa.table({
        "k": pa.array(range(key_start, key_start + n), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "s": pa.array([f"r{i % 13}" for i in range(n)], pa.string()),
    })


def _state(impl, dt) -> dict:
    """What a Delta table shows: its snapshot and its rows."""
    snap = dt.log.snapshot()
    files = sorted(
        (f.num_records,
         None if f.deletion_vector is None else
         impl.log.read_dv(dt.path, f.deletion_vector).tolist())
        for f in snap.files)
    return {"version": snap.version, "versions": dt.log.versions(),
            "num_records": snap.num_records, "files": files,
            "rows": sorted(dt.to_arrow().to_pylist(), key=repr)}


def _actions(path) -> list:
    """Every commit's actions, without timestamps, uuids and file names
    (each name replaced by its order of first appearance)."""
    names: dict = {}

    def name(p):
        return names.setdefault(p, f"file{len(names)}")

    out = []
    log_dir = os.path.join(path, "_delta_log")
    for f in sorted(os.listdir(log_dir)):
        acts = []
        for line in open(os.path.join(log_dir, f)):
            if not line.strip():
                continue
            a = json.loads(line)
            if "commitInfo" in a:
                a["commitInfo"].pop("timestamp")
                a["commitInfo"].pop("txnId")
            elif "metaData" in a:
                a["metaData"].pop("id")
            elif "add" in a:
                a["add"].pop("modificationTime")
                a["add"]["path"] = name(a["add"]["path"])
                dv = a["add"].get("deletionVector")
                if dv:
                    dv["pathOrInlineDv"] = name(dv["pathOrInlineDv"])
            elif "remove" in a:
                a["remove"].pop("deletionTimestamp")
                a["remove"]["path"] = name(a["remove"]["path"])
            acts.append(a)
        out.append((f, acts))
    return out


def _both(tmp_path, scenario):
    """Run ``scenario(impl, path, rng)`` on each package in a directory
    of its own; each returns its observations, which must be equal, as
    must the two logs."""
    got = {}
    for impl in (JAX, PORT):
        path = str(tmp_path / impl.name / "tbl")
        got[impl.name] = (scenario(impl, path, np.random.default_rng(1234)),
                          _actions(path))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    return got["port"][0]


def test_delta_create_append_read(tmp_path):
    def run(impl, path, rng):
        dt = impl.create(path, _tab(rng, 50))
        v = dt.append(_tab(rng, 30, key_start=50))
        return {"append": v, **_state(impl, dt)}

    st = _both(tmp_path, run)
    assert st["num_records"] == 80 and st["versions"] == [0, 1]
    assert sorted(r["k"] for r in st["rows"]) == list(range(80))


def test_delta_delete_with_deletion_vectors(tmp_path):
    def run(impl, path, rng):
        E = impl.E
        dt = impl.create(path, _tab(rng, 100))
        out = {"v1": dt.delete(E.LessThan(E.col("k"), E.lit(30)))}
        out["after_first"] = _state(impl, dt)
        out["v2"] = dt.delete(E.GreaterThanOrEqual(E.col("k"), E.lit(90)))
        out["after_second"] = _state(impl, dt)
        out["v0_rows"] = dt.to_arrow(version=0).num_rows
        return out

    st = _both(tmp_path, run)
    assert st["v1"] == 1
    first = st["after_first"]
    assert len(first["files"]) == 1 and first["files"][0][1] == list(
        range(30))
    assert sorted(r["k"] for r in st["after_second"]["rows"]) == list(
        range(30, 90))
    assert st["v0_rows"] == 100


def test_delta_delete_everything_drops_file(tmp_path):
    def run(impl, path, rng):
        E = impl.E
        dt = impl.create(path, _tab(rng, 20))
        dt.append(_tab(rng, 20, key_start=100))
        dt.delete(E.LessThan(E.col("k"), E.lit(50)))
        return _state(impl, dt)

    st = _both(tmp_path, run)
    assert len(st["files"]) == 1
    assert sorted(r["k"] for r in st["rows"]) == list(range(100, 120))


def test_delta_update(tmp_path):
    def run(impl, path, rng):
        E = impl.E
        t = _tab(rng, 60)
        dt = impl.create(path, t)
        v = dt.update(E.GreaterThanOrEqual(E.col("k"), E.lit(40)),
                      {"v": E.Multiply(E.col("v"), E.lit(0))})
        return {"update": v, "orig": t.column("v").to_pylist(),
                **_state(impl, dt)}

    st = _both(tmp_path, run)
    for r in st["rows"]:
        assert r["v"] == (0 if r["k"] >= 40 else st["orig"][r["k"]])


def test_delta_merge(tmp_path):
    src = pa.table({"k": pa.array([10, 20, 100, 101], pa.int64()),
                    "v": pa.array([-1, -2, -3, -4], pa.int64()),
                    "s": pa.array(["m", "m", "m", "m"], pa.string())})

    def run(impl, path, rng):
        t = _tab(rng, 40)
        dt = impl.create(path, t)
        v = dt.merge(src, on_target="k", on_source="k",
                     when_matched_update={"v": "v"},
                     when_not_matched_insert=True)
        return {"merge": v, "v5": t.column("v")[5].as_py(),
                **_state(impl, dt)}

    st = _both(tmp_path, run)
    back = {r["k"]: r for r in st["rows"]}
    assert len(back) == 42
    assert back[10]["v"] == -1 and back[20]["v"] == -2
    assert back[100]["v"] == -3 and back[101]["v"] == -4
    assert back[5]["v"] == st["v5"]


def test_delta_read_fully_deleted_table(tmp_path):
    def run(impl, path, rng):
        dt = impl.create(path, _tab(rng, 20))
        dt.delete(impl.E.lit(True))
        out = dt.to_arrow()
        return {"n_rows": out.num_rows, "names": out.schema.names,
                **_state(impl, dt)}

    st = _both(tmp_path, run)
    assert st["n_rows"] == 0 and "k" in st["names"] and st["files"] == []


def test_delta_snapshot_missing_version_raises(tmp_path):
    def run(impl, path, rng):
        dt = impl.create(path, _tab(rng, 10))
        with pytest.raises(ValueError, match="does not exist"):
            dt.log.snapshot(version=10)
        return _state(impl, dt)

    _both(tmp_path, run)


def test_delta_empty_table_preserves_types(tmp_path):
    t = pa.table({
        "ts": pa.array([1000, 2000], pa.timestamp("us", "UTC")),
        "d": pa.array([1, 1], pa.int16()),
        "m": pa.array([decimal.Decimal("123.45"), decimal.Decimal("-0.07")],
                      pa.decimal128(9, 2)),
    })

    def run(impl, path, rng):
        dt = impl.create(path, t)
        dt.delete(impl.E.lit(True))
        out = dt.to_arrow()
        return {"rows": out.num_rows, "schema": str(out.schema)}

    got = {}
    for impl in (JAX, PORT):
        path = str(tmp_path / impl.name / "tbl")
        got[impl.name] = run(impl, path, None)
    assert got["port"] == got["jax"]
    assert got["port"]["rows"] == 0
    assert "ts: timestamp[us, tz=UTC]" in got["port"]["schema"]
    assert "d: int16" in got["port"]["schema"]


def test_deletion_vector_sidecar_bytes_equal_the_reference(tmp_path):
    rows = np.array([7, 3, 11, 0, 5])
    jd, pd = tmp_path / "j", tmp_path / "p"
    jd.mkdir()
    pd.mkdir()
    jn = JLog.write_dv(str(jd), rows)
    pn = PLog.write_dv(str(pd), rows)
    assert (jd / jn).read_bytes() == (pd / pn).read_bytes()
    assert PLog.read_dv(str(jd), jn).tolist() == [0, 3, 5, 7, 11]


def test_a_decimal_table_reads_back_the_same_rows_as_the_reference(tmp_path):
    """The port stores decimals of precision up to 18 as integers (the
    reference: byte arrays): the files differ, the rows do not."""
    import pyarrow.parquet as pq

    t = pa.table({"k": pa.array(range(6), pa.int64()),
                  "p": pa.array([decimal.Decimal(f"{i}.2{i}") if i != 3
                                 else None for i in range(6)],
                                pa.decimal128(7, 2))})
    j = JDeltaTable.create(str(tmp_path / "j"), t)
    p = PDeltaTable.create(str(tmp_path / "p"), t, device="cpu")
    assert p.to_arrow().equals(j.to_arrow())
    ptype = pq.ParquetFile(os.path.join(
        p.path, p.log.snapshot().files[0].path)).schema.column(1)
    jtype = pq.ParquetFile(os.path.join(
        j.path, j.log.snapshot().files[0].path)).schema.column(1)
    assert ptype.physical_type == "INT32"
    assert jtype.physical_type == "FIXED_LEN_BYTE_ARRAY"


def _merge_case(impl, path, target_keys, source_keys):
    n = len(target_keys)
    t = pa.table({"k": pa.array(target_keys, pa.int64()),
                  "v": pa.array(range(n), pa.int64())})
    src = pa.table({"k": pa.array(source_keys, pa.int64()),
                    "v": pa.array([-(i + 1) for i in range(len(source_keys))],
                                  pa.int64())})
    dt = impl.create(path, t)
    dt.merge(src, "k", "k", when_matched_update={"v": "v"})
    return sorted(dt.to_arrow().to_pylist(), key=repr)


def test_merge_null_keys_match_nothing_as_in_spark(tmp_path):
    """Reference fault: the reference keys a dict by the source value, so
    a null source key matches a null target key, updates it and is not
    inserted. In Spark ``t.k = s.k`` is never true for a null: the null
    target row stays, the null source row is inserted."""
    tk, sk = [1, None, 3], [None, 3, 4]
    ref = _merge_case(JAX, str(tmp_path / "j"), tk, sk)
    got = _merge_case(PORT, str(tmp_path / "p"), tk, sk)
    assert ref == sorted([{"k": 1, "v": 0}, {"k": None, "v": -1},
                          {"k": 3, "v": -2}, {"k": 4, "v": -3}], key=repr)
    assert got == sorted([{"k": 1, "v": 0}, {"k": None, "v": 1},
                          {"k": 3, "v": -2}, {"k": None, "v": -1},
                          {"k": 4, "v": -3}], key=repr)


def test_merge_with_two_source_rows_for_a_target_row_raises(tmp_path):
    """Reference fault: the reference keeps the last of the source rows
    that match one target row; Delta refuses such a MERGE. Duplicate
    source keys that match nothing are inserted, as in both."""
    tk, sk = [1, 2, 3], [2, 2, 4]
    ref = _merge_case(JAX, str(tmp_path / "j"), tk, sk)
    assert ref == sorted([{"k": 1, "v": 0}, {"k": 2, "v": -2},
                          {"k": 3, "v": 2}, {"k": 4, "v": -3}], key=repr)
    with pytest.raises(ValueError, match="more than one source row"):
        _merge_case(PORT, str(tmp_path / "p"), tk, sk)
    got = _merge_case(PORT, str(tmp_path / "q"), tk, [5, 5, 3])
    assert got == sorted([{"k": 1, "v": 0}, {"k": 2, "v": 1},
                          {"k": 3, "v": -3}, {"k": 5, "v": -1},
                          {"k": 5, "v": -2}], key=repr)
