"""The memory runtime (counterpart of spark_rapids_tpu/mem/): an accounting
pool over the framework's logical device footprint (``pool``), spillable
batch handles that move device -> host -> disk (``spill``), the OOM retry
and split-and-retry loop (``retry``), the task semaphore (``semaphore``)
and the end-of-run leak sweep (``cleaner``).

The pool does not wrap the CUDA caching allocator: like the reference's,
it accounts what operators register (spillable handles, prefetched
batches), spills handles when a registration would pass its limit, and
then raises ``RetryOOM``, which ``retry.with_retry`` recovers.
"""

from spark_rapids_tpu_torch.mem.pool import (  # noqa: F401
    HbmPool,
    RetryOOM,
    SplitAndRetryOOM,
    get_pool,
    set_pool,
)
from spark_rapids_tpu_torch.mem.spill import (  # noqa: F401
    SpillableBatch,
    SpillFramework,
)
from spark_rapids_tpu_torch.mem.retry import (  # noqa: F401
    with_retry,
    with_retry_no_split,
)
from spark_rapids_tpu_torch.mem.semaphore import TaskSemaphore  # noqa: F401
