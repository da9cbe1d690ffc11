"""JSON-lines scan.

The port's copy of spark_rapids_tpu/io/json.py.

Reference: GpuJsonScan / GpuJsonReadCommon (via jni JSONUtils). Arrow C++
does the host decode of newline-delimited JSON; an explicit schema pins
column types (Spark's from_json/read.json with schema), otherwise types are
inferred from the first file.
"""

from __future__ import annotations

from typing import Optional, Sequence

import pyarrow as pa
import pyarrow.json as pajson

from spark_rapids_tpu_torch.exec.scan import FileScanBase


class JsonScanExec(FileScanBase):
    def __init__(self, paths: Sequence[str],
                 schema: Optional[pa.Schema] = None,
                 columns: Optional[Sequence[str]] = None,
                 mode: str = "PERMISSIVE",
                 corrupt_column: Optional[str] = None,
                 spark_exact: Optional[bool] = None,
                 **kw):
        super().__init__(paths, columns, **kw)
        self.user_schema = schema
        self.mode = mode
        self.corrupt_column = corrupt_column
        # Spark JacksonParser semantics (permissive/corrupt-record) when a
        # schema pins the types; arrow's reader otherwise
        self.spark_exact = (schema is not None if spark_exact is None
                            else spark_exact)

    def _read_schema(self) -> pa.Schema:
        if self.user_schema is not None:
            return self.user_schema
        t = self._read_path(self.paths[0])
        self._cache_inferred(self.paths[0], t)
        return t.schema

    def _read_path(self, path: str) -> pa.Table:
        if self.spark_exact and self.user_schema is not None:
            from spark_rapids_tpu_torch import types as T
            from spark_rapids_tpu_torch.io.text_parse import parse_json_lines

            with open(path, "r", encoding="utf-8", errors="replace") as f:
                lines = f.readlines()
            return parse_json_lines(
                lines, T.Schema.from_arrow(self.user_schema),
                mode=self.mode, corrupt_column=self.corrupt_column)
        opts = None
        if self.user_schema is not None:
            opts = pajson.ParseOptions(explicit_schema=self.user_schema)
        return pajson.read_json(path, parse_options=opts)
