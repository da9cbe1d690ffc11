"""CSV scan with Spark-compatible parsing options.

The port's copy of spark_rapids_tpu/io/csv.py.

Reference: GpuCSVScan.scala (439 LoC) + GpuTextBasedPartitionReader — cudf
CSV decode with custom Spark timestamp/date handling. Here Arrow C++ does
the host decode; Spark option names (sep, header, nullValue, comment,
quote, escape) map onto Arrow parse/convert options, and an explicit schema
gives Spark's permissive-mode column typing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import pyarrow as pa
import pyarrow.csv as pacsv

from spark_rapids_tpu_torch.exec.scan import FileScanBase


class CsvScanExec(FileScanBase):
    def __init__(self, paths: Sequence[str],
                 schema: Optional[pa.Schema] = None,
                 columns: Optional[Sequence[str]] = None,
                 sep: str = ",", header: bool = True,
                 null_value: str = "", comment: str = "",
                 quote: str = '"', escape: str = "\\",
                 timestamp_format: Optional[str] = None,
                 date_format: str = "yyyy-MM-dd",
                 mode: str = "PERMISSIVE",
                 corrupt_column: Optional[str] = None,
                 spark_exact: Optional[bool] = None,
                 **kw):
        super().__init__(paths, columns, **kw)
        self.user_schema = schema
        self.sep = sep
        self.header = header
        self.null_value = null_value
        self.comment = comment
        self.quote = quote
        self.escape = escape
        self.timestamp_format = timestamp_format
        self.date_format = date_format
        self.mode = mode
        self.corrupt_column = corrupt_column
        # Spark-exact conversion (GpuTextBasedPartitionReader discipline):
        # decode every cell as a string, then apply Spark's own parsers —
        # the default whenever a schema pins the types
        self.spark_exact = (schema is not None if spark_exact is None
                            else spark_exact)

    def _parse_opts(self):
        return pacsv.ParseOptions(
            delimiter=self.sep,
            quote_char=self.quote,
            escape_char=self.escape if self.escape else False,
        )

    def _read_opts(self):
        if self.header:
            return pacsv.ReadOptions()
        if self.user_schema is None:
            # headerless + no schema: synthesize names, don't eat row 1
            return pacsv.ReadOptions(autogenerate_column_names=True)
        return pacsv.ReadOptions(column_names=[f.name for f in
                                               self.user_schema])

    def _convert_opts(self):
        kw = dict(null_values=[self.null_value],
                  strings_can_be_null=True,
                  quoted_strings_can_be_null=True)
        if self.user_schema is not None:
            kw["column_types"] = {f.name: f.type for f in self.user_schema}
        if self.timestamp_format:
            kw["timestamp_parsers"] = [self.timestamp_format]
        return pacsv.ConvertOptions(**kw)

    def _read_schema(self) -> pa.Schema:
        if self.user_schema is not None:
            return self.user_schema
        t = self._read_path(self.paths[0])
        self._cache_inferred(self.paths[0], t)
        return t.schema

    def _read_path(self, path: str) -> pa.Table:
        if self.spark_exact and self.user_schema is not None:
            from spark_rapids_tpu_torch import types as T
            from spark_rapids_tpu_torch.io.text_parse import (CsvOptions,
                                                        convert_string_table)

            names = [f.name for f in self.user_schema]
            ropts = (pacsv.ReadOptions() if self.header
                     else pacsv.ReadOptions(column_names=names))
            raw = pacsv.read_csv(
                path, read_options=ropts,
                parse_options=self._parse_opts(),
                convert_options=pacsv.ConvertOptions(
                    column_types={n: pa.string() for n in names}))
            raw = raw.select([n for n in names if n in raw.column_names])
            schema = T.Schema.from_arrow(self.user_schema)
            opts = CsvOptions(null_value=self.null_value,
                              date_format=self.date_format,
                              timestamp_format=self.timestamp_format,
                              mode=self.mode,
                              corrupt_column=self.corrupt_column)
            raw_lines = None
            if self.corrupt_column:
                n_rows, header = raw.num_rows, self.header

                def raw_lines(path=path, n_rows=n_rows, header=header):
                    # original record text for columnNameOfCorruptRecord
                    # (resolved only when a bad row exists; only safe when
                    # physical lines == records, i.e. no embedded newlines
                    # in quoted fields — otherwise reconstruct)
                    with open(path, "r", encoding="utf-8",
                              errors="replace") as fh:
                        lines = fh.read().splitlines()
                    if header:
                        lines = lines[1:]
                    return lines if len(lines) == n_rows else None
            return convert_string_table(raw, schema, opts, raw_lines)
        return pacsv.read_csv(
            path,
            read_options=self._read_opts(),
            parse_options=self._parse_opts(),
            convert_options=self._convert_opts(),
        )
