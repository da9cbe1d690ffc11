"""The headline TPC-DS queries read from Parquet files: ``tpcds_schema``'s
tables written with the port's columnar writer (``io/writer.
write_columnar``) from device batches, then read back through
``read_parquet`` for ``tpcds_queries``' q3/q7/q42/q52/q96, unchanged.

``write_tables(tables, out_dir, device=...)``:

- each dimension (the seven other tables of ``tpcds_schema.BASE_TABLES``)
  is one file of one row group per ``batch_rows`` rows;
- store_sales is sorted by ``ss_sold_date_sk`` (nulls last), as a fact
  table is clustered by date, uploaded in ``batch_rows`` batches (2^17:
  each batch one row group) and cut into files of ``rows_per_file`` rows
  (786,432: six row groups). At SF1 (2,880,000 rows) that is 4 files and
  22 row groups of about 83 days each, so q3's join with the November
  dates prunes row groups dynamically, and four files plan four scan
  partitions.

It returns ``{table: [paths]}`` and the writes' ``WriteStats``.
``df_tables(paths, ...)`` makes one ``read_parquet`` DataFrame a table.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (
    batch_from_arrow, dictionary_encode_table, resolve_device)
from spark_rapids_tpu_torch.io.writer import WriteStats, write_columnar

FACT = "store_sales"
BATCH_ROWS = 1 << 17
ROWS_PER_FILE = 786_432


def _device_batches(table: pa.Table, batch_rows: int, device):
    """The table uploaded ``batch_rows`` rows at a time, strings sharing
    one sorted dictionary."""
    t = dictionary_encode_table(table)
    cache: dict = {}
    for i in range(0, t.num_rows, batch_rows):
        yield batch_from_arrow(t.slice(i, batch_rows), device,
                               dict_cache=cache)


def clustered_fact(table: pa.Table) -> pa.Table:
    """store_sales sorted by its sale date key, nulls last."""
    key = table.column("ss_sold_date_sk")
    filled = np.asarray(pc.fill_null(key, np.iinfo(np.int64).max).cast(
        pa.int64()))
    return table.take(pa.array(np.argsort(filled, kind="stable")))


def write_tables(tables: Dict[str, pa.Table], out_dir: str, device=None,
                 batch_rows: int = BATCH_ROWS,
                 rows_per_file: int = ROWS_PER_FILE
                 ) -> Tuple[Dict[str, List[str]], Dict[str, WriteStats]]:
    """Write each table from device batches under ``out_dir/<table>/``
    (see the module docstring); ``({table: paths}, {table: stats})``."""
    dev = resolve_device(device)
    paths: Dict[str, List[str]] = {}
    stats: Dict[str, WriteStats] = {}
    for name, t in tables.items():
        if name == FACT:
            t = clustered_fact(t)
        d = os.path.join(out_dir, name)
        st = write_columnar(
            _device_batches(t, batch_rows, dev),
            T.Schema.from_arrow(t.schema), d,
            rows_per_file=rows_per_file if name == FACT else 1 << 24)
        stats[name] = st
        paths[name] = sorted(os.path.join(d, f) for f in os.listdir(d)
                             if f.endswith(".parquet"))
    return paths, stats


def df_tables(paths: Dict[str, List[str]], conf=None, device=None,
              shuffle_partitions: int = 4) -> Dict[str, object]:
    """One ``read_parquet`` DataFrame per table, on ``device`` (``cuda``
    by default), planned with ``shuffle_partitions`` reduce partitions."""
    from spark_rapids_tpu_torch.plan import read_parquet

    out = {}
    for name, ps in paths.items():
        df = read_parquet(ps, conf=conf, device=device)
        df.shuffle_partitions = shuffle_partitions
        out[name] = df
    return out


def row_groups(paths: List[str]) -> int:
    """The row groups of a table's files."""
    import pyarrow.parquet as pq

    return sum(pq.ParquetFile(p).metadata.num_row_groups for p in paths)
