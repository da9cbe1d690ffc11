"""Iceberg reads on the port against the JAX package: the four Iceberg
cases of ``tests/test_integrations.py`` (JSON manifests, Avro manifests
written with the port's ``write_avro``, an unknown snapshot, metadata
files in numeric order), on the same table directory, with equal data
files and rows; a scan's predicate prunes the reference's row groups.
"""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.columnar.batch import batch_to_arrow as jbatch_to_arrow
from spark_rapids_tpu.exprs import expr as JE
from spark_rapids_tpu.iceberg import IcebergTable as JIcebergTable
from spark_rapids_tpu_torch.columnar.batch import batch_to_arrow
from spark_rapids_tpu_torch.exprs import expr as PE
from spark_rapids_tpu_torch.iceberg import IcebergTable
from spark_rapids_tpu_torch.io.avro import write_avro

# one intra-op thread: the test workers share the machine's cores
torch.set_num_threads(1)


def _tab(rng, n=100, key_start=0):
    return pa.table({
        "k": pa.array(range(key_start, key_start + n), pa.int64()),
        "v": pa.array(rng.integers(0, 1000, n), pa.int64()),
        "s": pa.array([f"r{i % 13}" for i in range(n)], pa.string()),
    })


def _rows(node, to_arrow):
    return sorted((r for b in node.execute_all()
                   for r in to_arrow(b, node.output_schema).to_pylist()),
                  key=repr)


def test_iceberg_read(tmp_path):
    rng = np.random.default_rng(1234)
    root = tmp_path / "ice"
    (root / "metadata").mkdir(parents=True)
    (root / "data").mkdir()
    pq.write_table(_tab(rng, 40), root / "data" / "f1.parquet")
    pq.write_table(_tab(rng, 25, key_start=40), root / "data" / "f2.parquet")
    with open(root / "metadata" / "m1.json", "w") as f:
        json.dump([{"file_path": str(root / "data" / "f1.parquet")},
                   {"file_path": str(root / "data" / "f2.parquet")}], f)
    md = {"format-version": 1, "current-snapshot-id": 7,
          "snapshots": [{"snapshot-id": 7,
                         "manifests": [str(root / "metadata" / "m1.json")]}]}
    with open(root / "metadata" / "v1.metadata.json", "w") as f:
        json.dump(md, f)
    with open(root / "metadata" / "version-hint.text", "w") as f:
        f.write("1")
    node = IcebergTable(str(root)).scan_exec(columns=["k", "v"],
                                             device="cpu")
    got = _rows(node, batch_to_arrow)
    assert sorted(r["k"] for r in got) == list(range(65))
    jnode = JIcebergTable(str(root)).scan_exec(columns=["k", "v"])
    assert got == _rows(jnode, jbatch_to_arrow)


def test_iceberg_avro_manifests(tmp_path):
    rng = np.random.default_rng(1234)
    root = tmp_path / "ice"
    (root / "metadata").mkdir(parents=True)
    (root / "data").mkdir()
    pq.write_table(_tab(rng, 30), root / "data" / "f1.parquet",
                   row_group_size=10)
    write_avro(str(root / "metadata" / "m1.avro"),
               pa.table({"file_path": pa.array(
                   [str(root / "data" / "f1.parquet")], pa.string()),
                   "status": pa.array([1], pa.int32())}))
    write_avro(str(root / "metadata" / "snap-7.avro"),
               pa.table({"manifest_path": pa.array(
                   [str(root / "metadata" / "m1.avro")], pa.string())}))
    md = {"format-version": 1, "current-snapshot-id": 7,
          "snapshots": [{"snapshot-id": 7, "manifest-list":
                         str(root / "metadata" / "snap-7.avro")}]}
    with open(root / "metadata" / "v1.metadata.json", "w") as f:
        json.dump(md, f)
    table = IcebergTable(str(root))
    assert table.data_files() == JIcebergTable(str(root)).data_files()
    node = table.scan_exec(device="cpu")
    assert sum(b.num_rows for b in node.execute_all()) == 30
    # the predicate prunes row groups by their statistics, as the
    # reference's scan does; the rows of a kept group all come back
    pred = PE.LessThan(PE.col("k"), PE.lit(10))
    node = table.scan_exec(predicate=pred, device="cpu")
    assert sum(b.num_rows for b in node.execute_all()) == 10
    jnode = JIcebergTable(str(root)).scan_exec(
        predicate=JE.LessThan(JE.col("k"), JE.lit(10)))
    list(jnode.execute_all())
    for k in ("numRowGroups", "numPrunedRowGroups"):
        assert node.metrics[k].value == jnode.metrics[k].value
    assert node.metrics["numPrunedRowGroups"].value == 2


def test_iceberg_unknown_snapshot_raises(tmp_path):
    root = tmp_path / "ice"
    (root / "metadata").mkdir(parents=True)
    md = {"format-version": 1, "current-snapshot-id": 7,
          "snapshots": [{"snapshot-id": 7, "manifests": []}]}
    with open(root / "metadata" / "v1.metadata.json", "w") as f:
        json.dump(md, f)
    for cls in (IcebergTable, JIcebergTable):
        with pytest.raises(ValueError, match="not found"):
            cls(str(root)).data_files(snapshot_id=999)
    assert IcebergTable(str(root)).data_files() == []
    with pytest.raises(ValueError, match="no data files"):
        IcebergTable(str(root)).scan_exec(device="cpu")


def test_iceberg_metadata_version_numeric_order(tmp_path):
    rng = np.random.default_rng(1234)
    root = tmp_path / "ice"
    (root / "metadata").mkdir(parents=True)
    (root / "data").mkdir()
    pq.write_table(_tab(rng, 10), root / "data" / "f1.parquet")
    with open(root / "metadata" / "m1.json", "w") as f:
        json.dump([{"file_path": str(root / "data" / "f1.parquet")}], f)
    # v2..v10: only v10 names the manifest; by text, v9 would be current
    for v in range(2, 11):
        md = {"format-version": 1, "current-snapshot-id": v,
              "snapshots": ([{"snapshot-id": 10, "manifests":
                              [str(root / "metadata" / "m1.json")]}]
                            if v == 10 else [])}
        with open(root / "metadata" / f"v{v}.metadata.json", "w") as f:
            json.dump(md, f)
    exp = [str(root / "data" / "f1.parquet")]
    assert IcebergTable(str(root)).data_files() == exp
    assert JIcebergTable(str(root)).data_files() == exp
