"""I/O layer (counterpart of spark_rapids_tpu/io/): file-format scans
beyond parquet, columnar writers with dynamic partitioning, async write
throttling, and a local range file cache.

All decode and encode work is on the host (CPU thread pools); the device is
touched only by each scan's upload and each writer's download.
"""

from spark_rapids_tpu_torch.io.csv import CsvScanExec  # noqa: F401
from spark_rapids_tpu_torch.io.json import JsonScanExec  # noqa: F401
from spark_rapids_tpu_torch.io.orc import OrcScanExec  # noqa: F401
from spark_rapids_tpu_torch.io.avro import AvroScanExec  # noqa: F401
from spark_rapids_tpu_torch.io.writer import (  # noqa: F401
    CsvWriter,
    OrcWriter,
    ParquetWriter,
    WriteStats,
    write_columnar,
)
from spark_rapids_tpu_torch.io.async_write import (  # noqa: F401
    AsyncOutputStream,
    HostMemoryThrottle,
    TrafficController,
)
from spark_rapids_tpu_torch.io.filecache import FileCache  # noqa: F401
from spark_rapids_tpu_torch.io.hive import (  # noqa: F401
    HiveTextScanExec,
    discover_partitions,
    parse_partition_values,
    prune_partitions,
)
from spark_rapids_tpu_torch.io.paths import replace_paths  # noqa: F401
