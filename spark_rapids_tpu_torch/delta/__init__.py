"""Delta Lake tables (the port's counterpart of spark_rapids_tpu/delta/;
the reference plugin's delta-lake/ module): a JSON-action ``_delta_log``
in the open Delta protocol's format (metaData, add, remove, commitInfo),
deletion-vector sidecars for DELETE and copy-on-write rewrites for UPDATE
and MERGE, with the predicates and projections on the device.
"""

from spark_rapids_tpu_torch.delta.log import DeltaLog, DeltaSnapshot  # noqa: F401
from spark_rapids_tpu_torch.delta.table import DeltaTable  # noqa: F401
