"""Iceberg table reads (the port's counterpart of
spark_rapids_tpu/iceberg.py; the reference plugin's GpuSparkBatchQueryScan
over Iceberg's file scan tasks).

The metadata is Iceberg's layout: ``metadata/version-hint.text`` names the
current ``vN.metadata.json`` (else the metadata files are taken in numeric
order, the last one current), whose snapshot (by id, or the current one)
names a manifest list and its manifests, as Avro (decoded by the port's
``io/avro.py``) or as JSON. The data files go to the port's
``ParquetScanExec``, with its column pruning and row-group pruning.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Optional

from spark_rapids_tpu_torch.columnar.batch import resolve_device
from spark_rapids_tpu_torch.exec.scan import ParquetScanExec
from spark_rapids_tpu_torch.exprs import expr as E


class IcebergTable:
    def __init__(self, path: str):
        self.path = path
        self.meta_dir = os.path.join(path, "metadata")

    def _current_metadata(self) -> dict:
        hint = os.path.join(self.meta_dir, "version-hint.text")
        if os.path.exists(hint):
            with open(hint) as f:
                v = f.read().strip()
            cand = os.path.join(self.meta_dir, f"v{v}.metadata.json")
            if os.path.exists(cand):
                with open(cand) as f:
                    return json.load(f)

        def _version_num(name: str):
            # "v12.metadata.json" or "00012-<uuid>.metadata.json", by
            # number: by text v9 would come after v10
            m = re.match(r"^v?(\d+)", name)
            return (int(m.group(1)) if m else -1, name)

        versions = sorted(
            (f for f in os.listdir(self.meta_dir)
             if f.endswith(".metadata.json")), key=_version_num)
        if not versions:
            raise FileNotFoundError(f"no iceberg metadata in {self.meta_dir}")
        with open(os.path.join(self.meta_dir, versions[-1])) as f:
            return json.load(f)

    def _resolve(self, p: str) -> str:
        """A location as the metadata records it, absolute or under the
        table's directory name, as a path that exists here."""
        if os.path.isabs(p) and os.path.exists(p):
            return p
        tail = p.split(self.path.rstrip("/").split("/")[-1] + "/")[-1]
        cand = os.path.join(self.path, tail)
        return cand if os.path.exists(cand) else p

    def data_files(self, snapshot_id: Optional[int] = None) -> List[str]:
        """The data files of snapshot ``snapshot_id`` (the current one
        when None); an unknown id raises ValueError."""
        md = self._current_metadata()
        snaps = md.get("snapshots", [])
        if not snaps:
            return []
        sid = (snapshot_id if snapshot_id is not None
               else md.get("current-snapshot-id"))
        snap = next((s for s in snaps if s.get("snapshot-id") == sid), None)
        if snap is None:
            if snapshot_id is not None:
                raise ValueError(f"snapshot {snapshot_id} not found")
            snap = snaps[-1]
        out: List[str] = []
        mlist = snap.get("manifest-list")
        if mlist:
            for m in self._read_manifest_list(self._resolve(mlist)):
                out.extend(self._read_manifest(self._resolve(m)))
        else:
            for m in snap.get("manifests", []):
                out.extend(self._read_manifest(self._resolve(m)))
        return out

    def _read_manifest_list(self, path: str) -> List[str]:
        if path.endswith(".json"):
            with open(path) as f:
                return [e["manifest_path"] for e in json.load(f)]
        from spark_rapids_tpu_torch.io.avro import read_avro

        return read_avro(path).column("manifest_path").to_pylist()

    def _read_manifest(self, path: str) -> List[str]:
        if path.endswith(".json"):
            with open(path) as f:
                return [e["file_path"] for e in json.load(f)]
        from spark_rapids_tpu_torch.io.avro import read_avro

        return read_avro(path).column("file_path").to_pylist()

    def scan_exec(self, columns: Optional[List[str]] = None,
                  predicate: Optional[E.Expression] = None,
                  device=None, **kw) -> ParquetScanExec:
        """The current snapshot's data files as a Parquet scan onto
        ``device`` (``cuda`` unless named; without a card it raises)."""
        device = resolve_device(device)
        files = [self._resolve(p) for p in self.data_files()]
        if not files:
            raise ValueError("iceberg table has no data files")
        return ParquetScanExec(files, columns=columns, predicate=predicate,
                               device=device, **kw)
