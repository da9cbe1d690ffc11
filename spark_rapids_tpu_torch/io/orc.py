"""ORC scan.

The port's copy of spark_rapids_tpu/io/orc.py.

Reference: GpuOrcScan.scala (2928 LoC) — cudf ORC decode with stripe-level
multithreading. Arrow C++ decodes stripes on the host here; column pruning
pushes down into the ORC reader.
"""

from __future__ import annotations

import pyarrow as pa
import pyarrow.orc as paorc

from spark_rapids_tpu_torch.exec.scan import FileScanBase


class OrcScanExec(FileScanBase):
    def _read_schema(self) -> pa.Schema:
        return paorc.ORCFile(self.paths[0]).schema

    def _read_path(self, path: str) -> pa.Table:
        return paorc.ORCFile(path).read(columns=self.columns)
