"""Columnar output writers: parquet/orc/csv, dynamic partitioning, stats.

The port's copy of spark_rapids_tpu/io/writer.py.

Reference surface (SURVEY.md §2.4 Writers): ColumnarOutputWriter:73
(writeSpillableAndClose), GpuParquetFileFormat / GpuOrcFileFormat /
GpuHiveTextFileFormat, and GpuFileFormatDataWriter.scala:228,300,684 —
the single writer (inputs sorted by partition key, one open file) and the
concurrent writer (one open file per live partition key up to a cap, then
fall back to sort); BasicColumnarWriteStatsTracker collects file/row/byte
stats.

Batches are downloaded once to Arrow on the host and encoded by
Arrow C++ writers on CPU threads; partition directories use the Hive
``key=value`` layout Spark expects. Writes can be wrapped with
io.async_write for throttled async flushing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.csv as pacsv
import pyarrow.orc as paorc
import pyarrow.parquet as pq

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, batch_to_arrow


@dataclasses.dataclass
class WriteStats:
    """BasicColumnarWriteStatsTracker analog."""

    num_files: int = 0
    num_rows: int = 0
    num_bytes: int = 0
    num_partitions: int = 0

    def file_written(self, path: str, rows: int):
        self.num_files += 1
        self.num_rows += rows
        try:
            self.num_bytes += os.path.getsize(path)
        except OSError:
            pass


class _FormatWriter:
    """One output file of a given format."""

    suffix = ""

    def __init__(self, path: str, schema: pa.Schema):
        self.path = path
        self.schema = schema
        self.rows = 0

    def write(self, t: pa.Table):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class ParquetWriter(_FormatWriter):
    """Decimals of precision up to 18 are stored as INT32/INT64, as Spark
    writes them (``spark.sql.parquet.writeLegacyFormat`` false); the
    reference's writer stores them as fixed-length byte arrays, which
    pyarrow decodes about four times slower. The values read back are
    the same."""

    suffix = ".parquet"

    def __init__(self, path: str, schema: pa.Schema,
                 compression: str = "snappy"):
        super().__init__(path, schema)
        self._w = pq.ParquetWriter(path, schema, compression=compression,
                                   store_decimal_as_integer=True)

    def write(self, t: pa.Table):
        self._w.write_table(t)
        self.rows += t.num_rows

    def close(self):
        self._w.close()


class OrcWriter(_FormatWriter):
    suffix = ".orc"

    def __init__(self, path: str, schema: pa.Schema):
        super().__init__(path, schema)
        self._w = paorc.ORCWriter(path)

    def write(self, t: pa.Table):
        self._w.write(t)
        self.rows += t.num_rows

    def close(self):
        self._w.close()


class CsvWriter(_FormatWriter):
    suffix = ".csv"

    def __init__(self, path: str, schema: pa.Schema, header: bool = True):
        super().__init__(path, schema)
        self._f = open(path, "wb")
        self._w = pacsv.CSVWriter(
            self._f, schema,
            write_options=pacsv.WriteOptions(include_header=header))

    def write(self, t: pa.Table):
        self._w.write(t)
        self.rows += t.num_rows

    def close(self):
        self._w.close()
        self._f.close()


_WRITERS = {"parquet": ParquetWriter, "orc": OrcWriter, "csv": CsvWriter}


def _part_dir(schema_names: Sequence[str], key: Tuple) -> str:
    return "/".join(f"{n}={'__HIVE_DEFAULT_PARTITION__' if v is None else v}"
                    for n, v in zip(schema_names, key))


def write_columnar(
    batches: Iterator[ColumnarBatch],
    schema: T.Schema,
    out_dir: str,
    file_format: str = "parquet",
    partition_by: Optional[Sequence[str]] = None,
    max_open_writers: int = 20,
    rows_per_file: int = 1 << 24,
    task_id: int = 0,
    **fmt_kw,
) -> WriteStats:
    """Write device batches to files; returns write stats.

    Without ``partition_by`` this is the plain ColumnarOutputWriter path.
    With it, the CONCURRENT writer strategy keeps one open file per live
    partition key; when more than ``max_open_writers`` keys are live, the
    largest writers are closed first (the reference falls back to sorting —
    here closing/reopening files gives the same bounded-memory property).
    """
    os.makedirs(out_dir, exist_ok=True)
    stats = WriteStats()
    wcls = _WRITERS[file_format]
    part_idx = [schema.index_of(c) for c in (partition_by or [])]
    data_fields = [f for i, f in enumerate(schema) if i not in part_idx]
    data_schema = T.Schema(data_fields).to_arrow()
    open_writers: Dict[Tuple, _FormatWriter] = {}
    seq = [0]
    seen_parts = set()

    def new_writer(key: Tuple) -> _FormatWriter:
        if key:
            d = os.path.join(out_dir, _part_dir(partition_by, key))
            os.makedirs(d, exist_ok=True)
        else:
            d = out_dir
        path = os.path.join(
            d, f"part-{task_id:05d}-{seq[0]:04d}{wcls.suffix}")
        seq[0] += 1
        return wcls(path, data_schema, **fmt_kw)

    def close_writer(w: _FormatWriter):
        w.close()
        stats.file_written(w.path, w.rows)

    for batch in batches:
        t = batch_to_arrow(batch, schema)
        if not part_idx:
            w = open_writers.get(())
            if w is None:
                w = open_writers[()] = new_writer(())
            w.write(t)
            if w.rows >= rows_per_file:
                close_writer(open_writers.pop(()))
            continue
        # split by partition key on host (download already done)
        keys = list(zip(*[t.column(schema[i].name).to_pylist()
                          for i in part_idx]))
        order = np.argsort(np.array([repr(k) for k in keys]))
        t_data = t.select([f.name for f in data_fields])
        # group ranges of equal keys
        i = 0
        while i < len(order):
            j = i
            while j < len(order) and keys[order[j]] == keys[order[i]]:
                j += 1
            key = keys[order[i]]
            seen_parts.add(key)
            sub = t_data.take(pa.array(order[i:j], pa.int64()))
            if key not in open_writers:
                if len(open_writers) >= max_open_writers:
                    # close the biggest writer (bounded open-file memory)
                    victim = max(open_writers, key=lambda k:
                                 open_writers[k].rows)
                    close_writer(open_writers.pop(victim))
                open_writers[key] = new_writer(key)
            open_writers[key].write(sub)
            i = j
    for w in open_writers.values():
        close_writer(w)
    stats.num_partitions = len(seen_parts)
    return stats
