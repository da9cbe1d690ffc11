"""The port's I/O layer (``spark_rapids_tpu_torch/io``) held against the
JAX package's on the same files, made from a numpy seed: the CSV, JSON,
ORC, Avro and Hive text scans, the columnar writers (plain, several
batches, partitioned, CSV), the async output stream and its throttle, the
file range cache, the path replacement rules (alone and in a plan), the
Spark-exact CSV/JSON parsing and get_json_object over a scan's rows.

Tolerance: exact (rows compared as Python values).
"""

import glob
import json
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import spark_rapids_tpu.io as JIO
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import batch_from_arrow as jax_upload
from spark_rapids_tpu.columnar.batch import batch_to_arrow as jax_download
from spark_rapids_tpu.config.conf import RapidsConf as JConf
from spark_rapids_tpu.io.avro import read_avro as jax_read_avro
from spark_rapids_tpu.io.avro import write_avro as jax_write_avro
from spark_rapids_tpu_torch import io as PIO
from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.batch import (
    batch_from_arrow, batch_to_arrow)
from spark_rapids_tpu_torch.config.conf import RapidsConf
from spark_rapids_tpu_torch.io.avro import read_avro, write_avro

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


def collect(node):
    out = []
    for b in node.execute_all():
        out.extend(batch_to_arrow(b, node.output_schema).to_pylist())
    return out


def jax_collect(node):
    out = []
    for b in node.execute_all():
        out.extend(jax_download(b, node.output_schema).to_pylist())
    return out


def _canon(rows):
    return sorted(rows, key=repr)


@pytest.fixture
def sample_table():
    rng = np.random.default_rng(1234)
    n = 500
    return pa.table({
        "i": pa.array([int(x) if x % 10 else None
                       for x in rng.integers(0, 10**6, n)], pa.int64()),
        "f": pa.array(rng.normal(size=n), pa.float64()),
        "s": pa.array([f"name_{int(x)}" if x % 7 else None
                       for x in rng.integers(0, 50, n)], pa.string()),
    })


def test_csv_scan(tmp_path, sample_table):
    import pyarrow.csv as pacsv

    paths = []
    for i in range(3):
        p = str(tmp_path / f"f{i}.csv")
        pacsv.write_csv(sample_table.slice(i * 100, 100), p)
        paths.append(p)
    got = collect(PIO.CsvScanExec(paths, schema=sample_table.schema,
                                  reader_threads=2, device="cpu"))
    exp = jax_collect(JIO.CsvScanExec(paths, schema=sample_table.schema,
                                      reader_threads=2))
    assert got == exp
    assert _canon(got) == _canon(sample_table.slice(0, 300).to_pylist())


def test_json_scan(tmp_path, sample_table):
    p = str(tmp_path / "f.json")
    with open(p, "w") as f:
        for r in sample_table.slice(0, 200).to_pylist():
            f.write(json.dumps(r) + "\n")
    got = collect(PIO.JsonScanExec([p], schema=sample_table.schema,
                                   device="cpu"))
    assert got == jax_collect(JIO.JsonScanExec([p],
                                               schema=sample_table.schema))
    assert _canon(got) == _canon(sample_table.slice(0, 200).to_pylist())


def test_orc_scan(tmp_path, sample_table):
    import pyarrow.orc as paorc

    p = str(tmp_path / "f.orc")
    paorc.write_table(sample_table, p)
    got = collect(PIO.OrcScanExec([p], columns=["i", "s"], device="cpu"))
    assert got == jax_collect(JIO.OrcScanExec([p], columns=["i", "s"]))
    assert _canon(got) == _canon(sample_table.select(["i", "s"]).to_pylist())


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_roundtrip_and_scan(tmp_path, sample_table, codec):
    p, jp = str(tmp_path / "f.avro"), str(tmp_path / "j.avro")
    write_avro(p, sample_table, codec=codec)
    jax_write_avro(jp, sample_table, codec=codec)
    with open(p, "rb") as a, open(jp, "rb") as b:
        assert a.read() == b.read()
    assert read_avro(p) == jax_read_avro(p)
    assert read_avro(p).to_pylist() == sample_table.to_pylist()
    got = collect(PIO.AvroScanExec([p], columns=["i", "f"], device="cpu"))
    assert got == jax_collect(JIO.AvroScanExec([p], columns=["i", "f"]))


def _written(out_dir, suffix=".parquet"):
    return sorted(glob.glob(os.path.join(out_dir, "**", "*" + suffix),
                            recursive=True))


def _both_write(tmp_path, table, slices, **kw):
    """Write ``table`` cut at ``slices`` rows from the port's and the
    reference's device batches; (port stats, its files, reference stats,
    its files)."""
    pschema = PT.Schema.from_arrow(table.schema)
    jschema = JT.Schema.from_arrow(table.schema)
    pb = [batch_from_arrow(table.slice(i, slices), device="cpu")
          for i in range(0, table.num_rows, slices)]
    jb = [jax_upload(table.slice(i, slices), 16)
          for i in range(0, table.num_rows, slices)]
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "ref")
    ps = PIO.write_columnar(iter(pb), pschema, pdir, **kw)
    js = JIO.write_columnar(iter(jb), jschema, jdir, **kw)
    return ps, pdir, js, jdir


def _stats(s):
    return (s.num_files, s.num_rows, s.num_partitions)


def test_write_columnar_plain(tmp_path, sample_table):
    ps, pdir, js, jdir = _both_write(tmp_path, sample_table, 500)
    assert _stats(ps) == _stats(js) == (1, 500, 0)
    assert ps.num_bytes > 0
    back = pq.read_table(_written(pdir)[0])
    assert back.to_pylist() == sample_table.to_pylist()
    assert back.equals(pq.read_table(_written(jdir)[0]))


def test_write_columnar_multiple_batches(tmp_path, sample_table):
    ps, pdir, js, jdir = _both_write(tmp_path, sample_table, 100)
    files = _written(pdir)
    assert ps.num_files == len(files) == js.num_files == 1
    back = pq.read_table(files[0])
    assert back.to_pylist() == sample_table.to_pylist()
    assert pq.ParquetFile(files[0]).metadata.num_row_groups == 5


def test_csv_headerless_no_schema(tmp_path):
    p = str(tmp_path / "h.csv")
    with open(p, "w") as f:
        f.write("1,2\n3,4\n")
    got = collect(PIO.CsvScanExec([p], header=False, device="cpu"))
    assert got == jax_collect(JIO.CsvScanExec([p], header=False))
    assert sorted(v for r in got for v in r.values()) == [1, 2, 3, 4]


def test_write_columnar_partitioned(tmp_path):
    rng = np.random.default_rng(1234)
    n = 300
    t = pa.table({
        "k": pa.array([f"g{int(x)}" for x in rng.integers(0, 4, n)]),
        "v": pa.array(rng.integers(0, 100, n), pa.int64()),
    })
    ps, pdir, js, jdir = _both_write(tmp_path, t, 64, partition_by=["k"],
                                     max_open_writers=2)
    assert _stats(ps) == _stats(js)
    assert ps.num_partitions == 4 and ps.num_rows == n
    prel = [os.path.relpath(f, pdir) for f in _written(pdir)]
    assert prel == [os.path.relpath(f, jdir) for f in _written(jdir)]
    df = t.to_pandas()
    for key, grp in df.groupby("k"):
        files = _written(os.path.join(pdir, f"k={key}"))
        assert files
        got = pa.concat_tables(pq.read_table(f) for f in files)
        assert sorted(got.column("v").to_pylist()) == sorted(grp.v.tolist())
        jgot = pa.concat_tables(pq.read_table(f) for f in _written(
            os.path.join(jdir, f"k={key}")))
        assert got.to_pylist() == jgot.to_pylist()


def test_csv_writer_roundtrip(tmp_path, sample_table):
    ps, pdir, js, jdir = _both_write(tmp_path, sample_table, 500,
                                     file_format="csv")
    assert ps.num_files == js.num_files == 1
    files = _written(pdir, ".csv")
    with open(files[0]) as a, open(_written(jdir, ".csv")[0]) as b:
        assert a.read() == b.read()
    got = collect(PIO.CsvScanExec(files, schema=sample_table.schema,
                                  device="cpu"))
    # CSV does not tell an empty string from a null: the other columns
    assert [r["i"] for r in got] == [r["i"] for r in
                                     sample_table.to_pylist()]


def test_async_output_stream_throttle():
    written = []

    def sink(buf):
        time.sleep(0.01)
        written.append(bytes(buf))

    throttle = PIO.HostMemoryThrottle(100)
    s = PIO.AsyncOutputStream(sink, throttle)
    for i in range(10):
        s.write(bytes([i]) * 60)  # 60 bytes each, a cap of 100: ~1 queued
    s.flush()
    assert len(written) == 10
    s.close()
    assert b"".join(written) == b"".join(bytes([i]) * 60 for i in range(10))
    assert throttle.in_flight == 0
    ref = JIO.TrafficController(1 << 10)
    assert ref.throttle.max_in_flight == PIO.TrafficController(
        1 << 10).throttle.max_in_flight


def test_async_output_stream_error_propagates():
    def sink(buf):
        raise IOError("disk full")

    s = PIO.AsyncOutputStream(sink, PIO.HostMemoryThrottle(1 << 20))
    s.write(b"x")
    with pytest.raises(IOError):
        s.flush()
        s.close()


def test_filecache(tmp_path):
    src = tmp_path / "data.bin"
    payload = np.random.default_rng(3).bytes(10000)
    src.write_bytes(payload)
    caches = [PIO.FileCache(str(tmp_path / "pcache"), max_bytes=6000),
              JIO.FileCache(str(tmp_path / "jcache"), max_bytes=6000)]
    seen = []
    for fc in caches:
        assert fc.get_range(str(src), 100, 500) == payload[100:600]
        assert fc.misses == 1 and fc.hits == 0
        assert fc.get_range(str(src), 100, 500) == payload[100:600]
        assert fc.hits == 1
        for off in range(0, 9000, 3000):  # beyond max_bytes: evictions
            fc.get_range(str(src), off, 3000)
        assert fc.cached_bytes <= 6000
        seen.append((fc.hits, fc.misses, fc.hit_bytes, fc.miss_bytes,
                     fc.cached_bytes))
    assert seen[0] == seen[1]


def _write_hive_file(path, rows, delim="\x01"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(delim.join("\\N" if v is None else str(v)
                               for v in r) + "\n")


def test_hive_text_scan_basic(tmp_path):
    root = str(tmp_path / "tbl")
    _write_hive_file(os.path.join(root, "000000_0"),
                     [(1, "a", 1.5), (2, None, 2.5), (3, "c", None)])
    schema = pa.schema([("id", pa.int64()), ("s", pa.string()),
                        ("v", pa.float64())])
    got = collect(PIO.HiveTextScanExec(root, schema, device="cpu"))
    assert got == jax_collect(JIO.HiveTextScanExec(root, schema))
    assert got == [{"id": 1, "s": "a", "v": 1.5},
                   {"id": 2, "s": None, "v": 2.5},
                   {"id": 3, "s": "c", "v": None}]


def test_hive_text_scan_partitioned(tmp_path):
    root = str(tmp_path / "tbl")
    _write_hive_file(os.path.join(root, "dt=2024-01-01", "000000_0"),
                     [(1, 10), (2, 20)])
    _write_hive_file(os.path.join(root, "dt=__HIVE_DEFAULT_PARTITION__",
                                  "000000_0"), [(3, 30)])
    schema = pa.schema([("id", pa.int64()), ("v", pa.int64())])
    pschema = pa.schema([("dt", pa.string())])
    got = collect(PIO.HiveTextScanExec(root, schema,
                                       partition_schema=pschema,
                                       device="cpu"))
    assert got == jax_collect(JIO.HiveTextScanExec(
        root, schema, partition_schema=pschema))
    got.sort(key=lambda r: r["id"])
    assert [r["dt"] for r in got] == ["2024-01-01", "2024-01-01", None]
    assert [r["v"] for r in got] == [10, 20, 30]


def test_hive_partition_pruning(tmp_path):
    root = str(tmp_path / "tbl")
    _write_hive_file(os.path.join(root, "y=2023", "f"), [(1,)])
    _write_hive_file(os.path.join(root, "y=2024", "f"), [(2,)])
    _write_hive_file(os.path.join(root, "_tmp", "f"), [(3,)])
    _write_hive_file(os.path.join(root, "_y=2025", "f"), [(4,)])
    files = PIO.discover_partitions(root)
    assert files == JIO.discover_partitions(root)
    assert len(files) == 3
    keep = lambda pv: pv.get("y") == "2024"  # noqa: E731
    kept = PIO.prune_partitions(files, root, keep)
    assert kept == JIO.prune_partitions(files, root, keep)
    assert len(kept) == 1 and "y=2024" in kept[0]
    assert PIO.parse_partition_values(kept[0], root) == {"y": "2024"}


def test_path_replacement_rules():
    from spark_rapids_tpu.io.paths import PATHS_TO_REPLACE as JKEY
    from spark_rapids_tpu_torch.io.paths import PATHS_TO_REPLACE

    spec = "s3://bucket->/mnt/cache, gs://b2->/mnt/g, s3://bucket/deep->/d"
    paths = ["s3://bucket/a.parquet", "gs://b2/x", "/local/y",
             "s3://bucket/deep/z"]
    got = PIO.replace_paths(paths, RapidsConf({PATHS_TO_REPLACE.key: spec}))
    assert got == JIO.replace_paths(paths, JConf({JKEY.key: spec}))
    assert got == ["/mnt/cache/a.parquet", "/mnt/g/x", "/local/y", "/d/z"]
    with pytest.raises(ValueError, match="src->dst"):
        PIO.replace_paths(paths, RapidsConf({PATHS_TO_REPLACE.key: "nope"}))


def test_path_replacement_in_plan(tmp_path):
    from spark_rapids_tpu.io.paths import PATHS_TO_REPLACE as JKEY
    from spark_rapids_tpu.plan import read_parquet as jax_read_parquet
    from spark_rapids_tpu_torch.io.paths import PATHS_TO_REPLACE
    from spark_rapids_tpu_torch.plan import read_parquet

    real = tmp_path / "real"
    real.mkdir()
    pq.write_table(pa.table({"x": pa.array([1, 2, 3], pa.int64())}),
                   real / "f.parquet")
    df = read_parquet("fake://tbl/f.parquet", conf=RapidsConf(
        {PATHS_TO_REPLACE.key: f"fake://tbl->{real}"}), device="cpu")
    got = [r["x"] for r in df.collect()]
    assert got == [1, 2, 3]
    # the logical plan keeps its own paths: a plan under another conf
    # rewrites from them again
    assert df.plan.paths == ["fake://tbl/f.parquet"]
    assert got == [r["x"] for r in jax_read_parquet(
        "fake://tbl/f.parquet", conf=JConf(
            {JKEY.key: f"fake://tbl->{real}",
             "spark.rapids.tpu.plan.cache.enabled": "false"})).collect()]


def test_csv_spark_exact_permissive(tmp_path):
    import datetime
    import decimal
    import math

    p = tmp_path / "t.csv"
    p.write_text(
        "i,f,b,d,dec\n"
        "42,1.5e2,true,2024-02-29,12.345\n"
        "xx,NaN,TRUE,2024-13-01,99999\n"
        "-129,Inf,false,1999-01-01,-0.005\n"
        ",  1.5,yes,2024-01-01,1\n")
    schema = pa.schema([("i", pa.int32()), ("f", pa.float64()),
                        ("b", pa.bool_()), ("d", pa.date32()),
                        ("dec", pa.decimal128(4, 2))])
    rows = PIO.CsvScanExec([str(p)], schema=schema,
                           device="cpu")._read_path(str(p)).to_pylist()
    exp = JIO.CsvScanExec([str(p)], schema=schema)._read_path(
        str(p)).to_pylist()
    assert repr(rows) == repr(exp)
    assert rows[0] == {"i": 42, "f": 150.0, "b": True,
                       "d": datetime.date(2024, 2, 29),
                       "dec": decimal.Decimal("12.35")}  # HALF_UP
    assert rows[1]["i"] is None and rows[1]["d"] is None
    assert math.isnan(rows[1]["f"])
    assert rows[2]["dec"] == decimal.Decimal("-0.01")
    assert rows[3]["b"] is None  # "yes" is not a Spark boolean
    # through the scan: the same rows on the port's batches
    got = collect(PIO.CsvScanExec([str(p)], schema=schema, device="cpu"))
    assert repr(got) == repr(jax_collect(JIO.CsvScanExec([str(p)],
                                                         schema=schema)))


def test_csv_modes_and_corrupt_record(tmp_path):
    p = tmp_path / "m.csv"
    p.write_text("i,s\n1,a\nbad,b\n3,c\n")
    schema = pa.schema([("i", pa.int64()), ("s", pa.string())])
    for mod in (PIO, JIO):
        kw = {"device": "cpu"} if mod is PIO else {}
        perm = mod.CsvScanExec([str(p)], schema=schema,
                               corrupt_column="_corrupt",
                               **kw)._read_path(str(p))
        assert perm.column("_corrupt").to_pylist() == [None, "bad,b", None]
        drop = mod.CsvScanExec([str(p)], schema=schema,
                               mode="DROPMALFORMED", **kw)._read_path(str(p))
        assert drop.column("i").to_pylist() == [1, 3]
        with pytest.raises(ValueError):
            mod.CsvScanExec([str(p)], schema=schema, mode="FAILFAST",
                            **kw)._read_path(str(p))


def test_json_spark_exact(tmp_path):
    p = tmp_path / "t.jsonl"
    p.write_text(
        '{"a": 1, "s": "x", "f": 2.5}\n'
        '{"a": "not_int", "s": 7, "f": true}\n'
        'not json at all\n'
        '{"a": 3}\n')
    schema = pa.schema([("a", pa.int64()), ("s", pa.string()),
                        ("f", pa.float64())])
    rows = PIO.JsonScanExec([str(p)], schema=schema, corrupt_column="_c",
                            device="cpu")._read_path(str(p)).to_pylist()
    assert rows == JIO.JsonScanExec([str(p)], schema=schema,
                                    corrupt_column="_c")._read_path(
        str(p)).to_pylist()
    assert rows[0] == {"a": 1, "s": "x", "f": 2.5, "_c": None}
    assert rows[1]["a"] is None and rows[1]["s"] == "7"
    assert rows[2]["_c"] == "not json at all"
    assert rows[3] == {"a": 3, "s": None, "f": None, "_c": None}


def test_get_json_object_over_a_json_scan(tmp_path):
    """get_json_object over the raw lines of a file read by the JSON
    scan (one string column), on the port's device path and the
    reference's."""
    from spark_rapids_tpu.exprs import expr as JE
    from spark_rapids_tpu.plan import from_arrow as jax_from_arrow
    from spark_rapids_tpu_torch.exprs import expr as PE
    from spark_rapids_tpu_torch.plan import from_arrow

    p = tmp_path / "raw.jsonl"
    docs = ['{"a": {"b": [10, 20]}, "s": "hi", "n": null}', '{"a": 1}',
            'broken{', None]
    with open(p, "w") as f:
        for d in docs:
            f.write(json.dumps({"j": d}) + "\n")
    schema = pa.schema([("j", pa.string())])
    t = pa.Table.from_pylist(collect(PIO.JsonScanExec(
        [str(p)], schema=schema, device="cpu")), schema)

    def q(M, df):
        return df.select(
            M.Alias(M.GetJsonObject(M.col("j"), "$.a.b[1]"), "x"),
            M.Alias(M.GetJsonObject(M.col("j"), "$.s"), "s"),
            M.Alias(M.GetJsonObject(M.col("j"), "$.a"), "obj"),
            M.Alias(M.GetJsonObject(M.col("j"), "$.missing"), "m"))

    rows = q(PE, from_arrow(t, RapidsConf(), device="cpu")).collect()
    assert rows == q(JE, jax_from_arrow(t, JConf({}))).collect()
    assert rows[0] == {"x": "20", "s": "hi", "obj": '{"b":[10,20]}',
                       "m": None}
    assert rows[1]["x"] is None and rows[2]["s"] is None


def test_scans_raise_without_a_card(monkeypatch, tmp_path, sample_table):
    import pyarrow.csv as pacsv

    p = str(tmp_path / "f.csv")
    pacsv.write_csv(sample_table, p)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PIO.CsvScanExec([p], schema=sample_table.schema)
    assert threading.active_count() >= 1
