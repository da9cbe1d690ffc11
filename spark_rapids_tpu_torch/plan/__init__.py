"""Plan layer: logical nodes, the physical converter and the DataFrame."""

from spark_rapids_tpu_torch.plan.dataframe import (
    DataFrame, from_arrow, read_parquet)

__all__ = ["DataFrame", "from_arrow", "read_parquet"]
