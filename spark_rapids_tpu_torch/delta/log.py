"""The Delta transaction log: JSON actions, snapshots, optimistic commits
(the port's copy of spark_rapids_tpu/delta/log.py; the reference plugin's
GpuOptimisticTransactionBase and Delta's log replay).

The log is the open Delta protocol's layout: ``_delta_log/N.json`` files
of newline-delimited actions (``metaData``, ``add``, ``remove``,
``commitInfo``). A deletion vector rides on its add action
(``deletionVector`` naming a sidecar file); the sidecar is a compact list
of row indexes (``DVL1``, byte for byte the reference's), where Delta
writes roaring bitmaps: the same rows, a simpler encoding.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class AddFile:
    path: str
    size: int
    num_records: int
    partition_values: Dict[str, str]
    deletion_vector: Optional[str] = None  # the sidecar's relative path

    def action(self) -> Dict:
        a = {"path": self.path, "size": self.size,
             "stats": json.dumps({"numRecords": self.num_records}),
             "partitionValues": self.partition_values,
             "dataChange": True,
             "modificationTime": int(time.time() * 1000)}
        if self.deletion_vector:
            a["deletionVector"] = {"storageType": "u",
                                   "pathOrInlineDv": self.deletion_vector}
        return {"add": a}


@dataclasses.dataclass
class DeltaSnapshot:
    version: int
    schema_json: Optional[str]
    files: List[AddFile]

    @property
    def num_records(self) -> int:
        return sum(f.num_records for f in self.files)


class DeltaLog:
    """Reads and commits ``_delta_log/N.json``."""

    def __init__(self, table_path: str):
        self.table_path = table_path
        self.log_path = os.path.join(table_path, "_delta_log")

    # -- read --------------------------------------------------------------
    def versions(self) -> List[int]:
        if not os.path.isdir(self.log_path):
            return []
        out = []
        for f in os.listdir(self.log_path):
            if f.endswith(".json"):
                try:
                    out.append(int(f[:-5]))
                except ValueError:
                    pass
        return sorted(out)

    def snapshot(self, version: Optional[int] = None) -> DeltaSnapshot:
        """The table at ``version`` (the latest when None): the log
        replayed up to it. A version never committed raises ValueError
        (time travel never falls back to an earlier state)."""
        vs = self.versions()
        if not vs:
            return DeltaSnapshot(-1, None, [])
        if version is None:
            version = vs[-1]
        elif version not in vs:
            raise ValueError(f"delta version {version} does not exist "
                             f"(have {vs[0]}..{vs[-1]})")
        files: Dict[str, AddFile] = {}
        schema_json = None
        for v in vs:
            if v > version:
                break
            with open(os.path.join(self.log_path, f"{v:020d}.json")) as f:
                for line in f:
                    if not line.strip():
                        continue
                    action = json.loads(line)
                    if "metaData" in action:
                        schema_json = action["metaData"].get("schemaString")
                    elif "add" in action:
                        a = action["add"]
                        stats = json.loads(a.get("stats") or "{}")
                        dv = a.get("deletionVector")
                        files[a["path"]] = AddFile(
                            a["path"], a.get("size", 0),
                            int(stats.get("numRecords", -1)),
                            a.get("partitionValues", {}),
                            dv.get("pathOrInlineDv") if dv else None)
                    elif "remove" in action:
                        files.pop(action["remove"]["path"], None)
        return DeltaSnapshot(version, schema_json, list(files.values()))

    # -- write -------------------------------------------------------------
    def commit(self, adds: List[AddFile], removes: List[str],
               operation: str, schema_json: Optional[str] = None) -> int:
        """Commit the next version: last + 1, created with ``O_EXCL``
        (the put-if-absent the protocol needs); a writer that loses the
        race takes the next number."""
        os.makedirs(self.log_path, exist_ok=True)
        while True:
            vs = self.versions()
            version = (vs[-1] + 1) if vs else 0
            path = os.path.join(self.log_path, f"{version:020d}.json")
            lines = [json.dumps({"commitInfo": {
                "timestamp": int(time.time() * 1000),
                "operation": operation,
                "txnId": uuid.uuid4().hex}})]
            if version == 0 or schema_json is not None:
                lines.append(json.dumps({"metaData": {
                    "id": uuid.uuid4().hex,
                    "schemaString": schema_json,
                    "format": {"provider": "parquet"},
                    "partitionColumns": []}}))
            for r in removes:
                lines.append(json.dumps({"remove": {
                    "path": r, "dataChange": True,
                    "deletionTimestamp": int(time.time() * 1000)}}))
            for a in adds:
                lines.append(json.dumps(a.action()))
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            with os.fdopen(fd, "w") as f:
                f.write("\n".join(lines) + "\n")
            return version


# -- deletion-vector sidecars ----------------------------------------------


def write_dv(table_path: str, deleted_rows: np.ndarray) -> str:
    """Write the sorted deleted row indexes; returns the relative path."""
    name = f"deletion_vector_{uuid.uuid4().hex}.bin"
    arr = np.asarray(sorted(int(i) for i in deleted_rows), dtype=np.int64)
    with open(os.path.join(table_path, name), "wb") as f:
        f.write(b"DVL1")
        f.write(np.int64(len(arr)).tobytes())
        f.write(arr.tobytes())
    return name


def read_dv(table_path: str, rel_path: str) -> np.ndarray:
    with open(os.path.join(table_path, rel_path), "rb") as f:
        if f.read(4) != b"DVL1":
            raise ValueError(f"{rel_path}: not a deletion vector sidecar")
        (n,) = np.frombuffer(f.read(8), np.int64)
        return np.frombuffer(f.read(8 * int(n)), np.int64)
