"""Hive text table scan: LazySimpleSerDe delimited files + partition dirs.

The port's copy of spark_rapids_tpu/io/hive.py.

Reference: org/apache/spark/sql/hive/rapids/ — GpuHiveTableScanExec (text
table scan with partition-directory discovery and partition-value columns)
and GpuHiveTextFileFormat's read side. Hive text defaults differ from CSV:
field delimiter is Ctrl-A (\\x01), nulls are the literal ``\\N``, there is
no header row and no quoting/escaping.

Partitioned tables lay files out as ``table/col=val/.../file``; the scan
appends each file's partition values as constant columns (Spark's partition
column semantics), with ``__HIVE_DEFAULT_PARTITION__`` decoding to null.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence
from urllib.parse import unquote

import pyarrow as pa
import pyarrow.csv as pacsv

from spark_rapids_tpu_torch.exec.scan import FileScanBase

HIVE_DEFAULT_PARTITION = "__HIVE_DEFAULT_PARTITION__"


def parse_partition_values(path: str, table_root: str) -> Dict[str, str]:
    """Extract k=v partition-directory components between root and file."""
    rel = os.path.relpath(os.path.dirname(path), table_root)
    out: Dict[str, str] = {}
    if rel in (".", ""):
        return out
    for comp in rel.split(os.sep):
        if "=" in comp:
            k, v = comp.split("=", 1)
            out[k] = unquote(v)
    return out


def discover_partitions(table_root: str) -> List[str]:
    """All data files under the table root (sorted for determinism)."""
    files = []
    for dirpath, dirs, names in os.walk(table_root):
        # skip hidden/temp trees entirely (_temporary, .hive-staging,
        # _delta_log) — but keep '_'-prefixed PARTITION dirs ('=' in name),
        # e.g. _year=2024, like Spark's shouldFilterOutPathName
        dirs[:] = [d for d in dirs
                   if not (d.startswith(".")
                           or (d.startswith("_") and "=" not in d))]
        for n in names:
            if not n.startswith((".", "_")):
                files.append(os.path.join(dirpath, n))
    return sorted(files)


class HiveTextScanExec(FileScanBase):
    """Scan Hive-layout delimited text into device batches
    (GpuHiveTableScanExec analog).

    ``schema`` types the data columns (positional, LazySimpleSerDe has no
    header); ``partition_schema`` types the directory-derived columns, which
    are appended after the data columns like Spark does.
    """

    def __init__(self, table_root: str, schema: pa.Schema,
                 partition_schema: Optional[pa.Schema] = None,
                 field_delim: str = "\x01", null_value: str = "\\N",
                 paths: Optional[Sequence[str]] = None, **kw):
        files = list(paths) if paths is not None \
            else discover_partitions(table_root)
        super().__init__(files, None, **kw)
        self.table_root = table_root
        self.data_schema = schema
        self.partition_schema = partition_schema or pa.schema([])
        self.field_delim = field_delim
        self.null_value = null_value

    def node_description(self) -> str:
        nparts = len(self.partition_schema)
        return (f"TpuHiveTextScan [{len(self.paths)} files, "
                f"{nparts} partition cols]")

    def _read_schema(self) -> pa.Schema:
        return pa.schema(list(self.data_schema)
                         + list(self.partition_schema))

    def _partition_value(self, field: pa.Field, raw: Optional[str]):
        if raw is None or raw == HIVE_DEFAULT_PARTITION:
            return None
        return pa.scalar(raw, pa.string()).cast(field.type).as_py()

    def _read_path(self, path: str) -> pa.Table:
        t = pacsv.read_csv(
            path,
            read_options=pacsv.ReadOptions(
                column_names=[f.name for f in self.data_schema]),
            parse_options=pacsv.ParseOptions(
                delimiter=self.field_delim, quote_char=False,
                escape_char=False),
            convert_options=pacsv.ConvertOptions(
                column_types={f.name: f.type for f in self.data_schema},
                null_values=[self.null_value], strings_can_be_null=True),
        )
        pvals = parse_partition_values(path, self.table_root)
        for f in self.partition_schema:
            v = self._partition_value(f, pvals.get(f.name))
            t = t.append_column(
                f, pa.array([v] * t.num_rows, f.type))
        return t


def prune_partitions(files: Sequence[str], table_root: str,
                     predicate) -> List[str]:
    """Static partition pruning: keep files whose partition values satisfy
    ``predicate(values_dict) -> bool`` (GpuHiveTableScanExec prunes via
    Spark's catalog; standalone takes a caller predicate)."""
    return [f for f in files
            if predicate(parse_partition_values(f, table_root))]
