"""Typed configuration registry (counterpart of spark_rapids_tpu/config/conf.py).

Keys live under ``spark.rapids.gpu.``; each entry the port reads carries the
reference's default.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional

_REGISTRY: "Dict[str, ConfEntry]" = {}
_REG_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[Any], Any]

    def get(self, conf: "RapidsConf"):
        return conf.get(self.key)


def _to_bool(s):
    if isinstance(s, bool):
        return s
    return str(s).strip().lower() in ("true", "1", "yes")


def conf(key: str, *, default, doc: str) -> ConfEntry:
    """Declare a config entry; its type is inferred from the default."""
    if isinstance(default, bool):
        conv: Callable[[Any], Any] = _to_bool
    elif isinstance(default, int):
        conv = int
    elif isinstance(default, float):
        conv = float
    else:
        conv = str
    entry = ConfEntry(key, default, doc, conv)
    with _REG_LOCK:
        if key in _REGISTRY:
            raise ValueError(f"duplicate conf key {key}")
        _REGISTRY[key] = entry
    return entry


SQL_ENABLED = conf(
    "spark.rapids.gpu.sql.enabled", default=True,
    doc="Enable plan rewrite onto GPU operators. When false all operators run "
        "on the CPU fallback engine.")

EXPLAIN = conf(
    "spark.rapids.gpu.sql.explain", default="NONE",
    doc="Explain why parts of a plan did or did not run on GPU: NONE, "
        "NOT_ON_GPU, ALL. (reference: spark.rapids.sql.explain)")

CPU_FALLBACK_ENABLED = conf(
    "spark.rapids.gpu.sql.fallback.enabled", default=True,
    doc="Allow per-operator CPU fallback. When false an unsupported operator "
        "raises instead.")

JOIN_MAX_OUTPUT_ROWS = conf(
    "spark.rapids.gpu.sql.join.maxCandidateRowsPerBatch", default=1 << 27,
    doc="Hard cap on candidate join pairs produced by one probe batch; a "
        "join that explodes past it raises instead of exhausting memory.")

JOIN_HASHTBL_ENABLED = conf(
    "spark.rapids.gpu.sql.join.hashTable.enabled", default=True,
    doc="Join duplicate-key build sides through the open-addressing device "
        "hash table (the probe kernel). When false every join takes the "
        "sorted-hash path (build hashes sorted, candidates by binary "
        "search), which is also the fallback when every seeded table build "
        "overflows its probe bound.")

JOIN_CHUNK_TARGET_ROWS = conf(
    "spark.rapids.gpu.sql.join.gatherChunkTargetRows", default=1 << 22,
    doc="Candidate-pair budget per output chunk of the hash-table join: a "
        "probe batch with more candidates is emitted as several bounded "
        "batches.")


JOIN_BROADCAST_ROWS = conf(
    "spark.rapids.gpu.sql.join.broadcastRowThreshold", default=500_000,
    doc="Estimated build-side row count at or below which a multi-partition "
        "hash join uses a broadcast build instead of co-partitioning both "
        "sides (reference: spark.sql.autoBroadcastJoinThreshold).")

SHUFFLE_TARGET_BATCH_ROWS = conf(
    "spark.rapids.gpu.shuffle.targetBatchRows", default=1 << 20,
    doc="Rows per device batch a shuffle read uploads (reference: "
        "GpuShuffleCoalesceExec target size).")

SHUFFLE_WRITE_THREADS = conf(
    "spark.rapids.gpu.shuffle.writeThreads", default=4,
    doc="Map outputs a shuffle exchange serializes and writes concurrently. "
        "Each map's device pass runs on the calling thread, in map order; "
        "1 restores the fully serial write.")

SHUFFLE_MODE = conf(
    "spark.rapids.gpu.shuffle.mode", default="MULTITHREADED",
    doc="Shuffle manager mode: MULTITHREADED (serialized blocks in one host "
        "file per map output) or CACHE_ONLY (serialized blocks kept in "
        "memory). Reference: RapidsConf.scala RapidsShuffleManagerMode.")

SHUFFLE_COMPRESS = conf(
    "spark.rapids.gpu.shuffle.compression.codec", default="none",
    doc="Codec for serialized shuffle blocks: none, zlib, lz4, zstd.")

SHUFFLE_INTEGRITY = conf(
    "spark.rapids.gpu.shuffle.integrity.enabled", default=True,
    doc="Append a per-block CRC trailer to serialized shuffle blocks and "
        "verify it on read; a mismatch raises BlockCorruption.")

FASTPATH_ENABLED = conf(
    "spark.rapids.gpu.fastpath.enabled", default=True,
    doc="Plan one partition (no shuffle) when every scan leaf's rows and "
        "bytes sit below fastpath.maxRows/maxBytes: the per-query fixed "
        "costs dominate such queries, not the data.")

FASTPATH_MAX_ROWS = conf(
    "spark.rapids.gpu.fastpath.maxRows", default=100_000,
    doc="Row ceiling (summed over scan leaves) of the small-query fast "
        "path.")

FASTPATH_MAX_BYTES = conf(
    "spark.rapids.gpu.fastpath.maxBytes", default=32 << 20,
    doc="Byte ceiling (summed over scan leaves) of the small-query fast "
        "path.")


AQE_ENABLED = conf(
    "spark.rapids.gpu.sql.adaptive.enabled", default=True,
    doc="Adaptive query execution: once a shuffle stage is written, plan "
        "the downstream read from its partitions' real sizes, coalescing "
        "small partitions and splitting skewed join partitions (reference: "
        "GpuCustomShuffleReaderExec, shuffle/aqe.py).")

AQE_TARGET_PARTITION_BYTES = conf(
    "spark.rapids.gpu.sql.adaptive.advisoryPartitionSizeBytes",
    default=64 << 20,
    doc="Advisory serialized size of a post-shuffle partition: adjacent "
        "partitions below it are read by one task (Spark's "
        "spark.sql.adaptive.advisoryPartitionSizeInBytes).")

AQE_SKEW_ENABLED = conf(
    "spark.rapids.gpu.sql.adaptive.skewJoin.enabled", default=True,
    doc="Split skewed shuffled-join partitions into map-output ranges "
        "(Spark's spark.sql.adaptive.skewJoin.enabled).")

AQE_SKEW_FACTOR = conf(
    "spark.rapids.gpu.sql.adaptive.skewJoin.skewedPartitionFactor",
    default=5.0,
    doc="A join partition is skewed when its size exceeds this multiple of "
        "the median partition size and the threshold below.")

AQE_SKEW_THRESHOLD_BYTES = conf(
    "spark.rapids.gpu.sql.adaptive.skewJoin.skewedPartitionThresholdBytes",
    default=256 << 20,
    doc="Minimum serialized size of a join partition considered skewed.")

REUSE_ENABLED = conf(
    "spark.rapids.gpu.sql.exchange.reuse.enabled", default=True,
    doc="Collapse equal exchange and broadcast subtrees of a physical plan "
        "into ReusedExchange/ReusedBroadcast aliases of one surviving "
        "materialization (Spark's ReuseExchangeAndSubquery, plan/reuse.py).")

REUSE_CACHE_MAX_BYTES = conf(
    "spark.rapids.gpu.sql.exchange.reuse.cache.maxBytes", default=2 << 30,
    doc="Bytes of reduce-side device batches the reuse cache may hold over "
        "all shared exchanges. An entry denied admission re-reads the "
        "shuffle manager (still one map-side write): the cap bounds memory, "
        "never correctness.")

REUSE_CACHE_MAX_ENTRIES = conf(
    "spark.rapids.gpu.sql.exchange.reuse.cache.maxEntries", default=64,
    doc="Shared-exchange entries the reuse cache admits at once.")

REUSE_EVICT_ENABLED = conf(
    "spark.rapids.gpu.sql.exchange.reuse.eviction.enabled", default=True,
    doc="When the reuse cache is full, evict idle entries (no reader "
        "replaying) by ascending retention score instead of denying the "
        "new entry; the score weighs cached bytes and recency.")

PREFETCH_ENABLED = conf(
    "spark.rapids.gpu.sql.prefetch.enabled", default=True,
    doc="Run batch iterators ahead of their consumer at pipeline-breaking "
        "boundaries (exchanges, AQE readers, CPU-to-device transitions) on "
        "a background thread, and read the next reduce partition of an "
        "exchange ahead (exec/pipeline.py).")

PREFETCH_DEPTH = conf(
    "spark.rapids.gpu.sql.prefetch.depth", default=2,
    doc="Batches a prefetch boundary may hold ready ahead of its consumer.")

CONCURRENT_TASKS = conf(
    "spark.rapids.gpu.sql.concurrentGpuTasks", default=2,
    doc="Tasks that may hold the GPU at once: each output partition's "
        "drain holds a permit of the process's task semaphore "
        "(reference: spark.rapids.sql.concurrentGpuTasks / GpuSemaphore).")

POOL_FRACTION = conf(
    "spark.rapids.gpu.memory.pool.fraction", default=0.85,
    doc="Fraction of the device's memory the accounting pool may hold "
        "before an allocation spills and then raises a retryable OOM "
        "(reference: spark.rapids.memory.gpu.allocFraction).")

POOL_MAX_BYTES = conf(
    "spark.rapids.gpu.memory.pool.maxBytes", default=0,
    doc="Absolute cap in bytes of the accounting pool; 0 derives it from "
        "pool.fraction times the device's memory (16 GiB on the CPU). Read "
        "when the process's pool is made (mem/pool.get_pool).")

HOST_SPILL_LIMIT = conf(
    "spark.rapids.gpu.memory.host.spillStorageSize", default=8 << 30,
    doc="Bytes of host memory spilled device batches may hold before the "
        "oldest cascade to disk (reference: "
        "spark.rapids.memory.host.spillStorageSize).")

SPILL_DIR = conf(
    "spark.rapids.gpu.memory.spillDir", default="",
    doc="Directory for disk-tier spill files; empty means srgpu_spill "
        "under the process's temporary directory.")

SPILL_CHUNK_BYTES = conf(
    "spark.rapids.gpu.memory.spill.chunkBytes", default=8 << 20,
    doc="Fixed size of the CRC-guarded chunks a spilled batch is cut into "
        "on the host and disk tiers (reference: GpuDeviceManager bounce "
        "buffer pools).")

SPILL_CODEC = conf(
    "spark.rapids.gpu.memory.spill.codec", default="none",
    doc="Codec of each spill chunk: none, zlib, lz4, zstd. lz4 and zstd "
        "need their python modules; a missing one fails when the spill "
        "framework is made.")

AGG_REPARTITION_ENABLED = conf(
    "spark.rapids.gpu.sql.agg.repartition.enabled", default=True,
    doc="When a hash aggregate's merge state outgrows the target (or the "
        "pool refuses the merge), hash-repartition the partial buffers "
        "into spillable buckets, recursively, and merge each bucket alone "
        "(reference: GpuAggregateExec's repartition fallback).")

AGG_REPARTITION_TARGET_BYTES = conf(
    "spark.rapids.gpu.sql.agg.repartition.targetBytes", default=0,
    doc="Merge-state bytes above which the aggregate repartitions; 0 "
        "derives a quarter of the pool's limit.")

AGG_REPARTITION_NUM_BUCKETS = conf(
    "spark.rapids.gpu.sql.agg.repartition.numBuckets", default=16,
    doc="Hash buckets per repartition level; each level re-seeds the "
        "bucket hash, so a skewed bucket splits on another boundary.")

AGG_REPARTITION_MAX_DEPTH = conf(
    "spark.rapids.gpu.sql.agg.repartition.maxDepth", default=3,
    doc="Deepest repartition level; past it a bucket merges piece by piece "
        "under split-retry.")

RETRY_BACKOFF_MS = conf(
    "spark.rapids.gpu.memory.retry.backoffMs", default=0.0,
    doc="Base of the jittered exponential pause between OOM retries "
        "(capped at 32x); 0 retries at once.")

RETRY_MAX_ATTEMPTS = conf(
    "spark.rapids.gpu.memory.retry.maxAttempts", default=32,
    doc="OOM retries of one input before the failure surfaces.")

WINDOW_STREAMING_ENABLED = conf(
    "spark.rapids.gpu.sql.window.streaming.enabled", default=True,
    doc="Stream a window group across batches (a running carry, or a "
        "bounded neighbour context) behind an out-of-core sort instead of "
        "coalescing each partition into one batch (reference: "
        "GpuRunningWindowExec / GpuBatchedBoundedWindowExec).")

WINDOW_MAX_BOUNDED_CONTEXT = conf(
    "spark.rapids.gpu.sql.window.streaming.maxContextRows", default=1024,
    doc="Largest bounded-frame extent or lead/lag offset the streaming "
        "window carries; larger ones coalesce to one batch.")

SORT_OOC_TARGET_ROWS = conf(
    "spark.rapids.gpu.sql.sort.outOfCore.targetRows", default=1 << 17,
    doc="Rows per output batch of the out-of-core sort's merge "
        "(reference: GpuSortExec targetSize).")

SORT_OOC_MAX_MERGE_RUNS = conf(
    "spark.rapids.gpu.sql.sort.outOfCore.maxMergeRuns", default=16,
    doc="Most sorted runs the out-of-core sort merges per output batch; "
        "runs past it are pre-merged into combined spillable runs.")

SORT_MERGE_PATH_ENABLED = conf(
    "spark.rapids.gpu.sql.sort.outOfCore.mergePath", default=True,
    doc="The reference's binary-search merge of a one-key out-of-core "
        "merge set. Accepted and without effect: the port merges every "
        "set by a stable sort, which gives the same rows in the same "
        "order.")

REGEX_MAX_DFA_STATES = conf(
    "spark.rapids.gpu.sql.regex.maxDfaStates", default=96,
    doc="DFA state budget of an RLIKE pattern on the device; a pattern "
        "whose automaton needs more runs on the CPU engine (reference: "
        "spark.rapids.tpu.sql.regex.maxDfaStates).")

PATHS_TO_REPLACE = conf(
    "spark.rapids.gpu.alluxio.pathsToReplace", default="",
    doc="Comma-separated 'src->dst' prefix rules applied to scan paths "
        "before reading, e.g. 's3://bucket->/mnt/cache/bucket' "
        "(reference: spark.rapids.alluxio.pathsToReplace, AlluxioUtils).")

DPP_ENABLED = conf(
    "spark.rapids.gpu.sql.dynamicPartitionPruning.enabled", default=True,
    doc="Dynamic partition pruning: collect a join's build-side key values "
        "and prune the probe scan's parquet row groups whose statistics "
        "prove no key can match (reference: GpuDynamicPruningExpression / "
        "GpuSubqueryBroadcastExec).")

DPP_MAX_KEYS = conf(
    "spark.rapids.gpu.sql.dynamicPartitionPruning.maxKeys", default=1 << 16,
    doc="Disable dynamic pruning when the build side has more distinct keys "
        "than this (broadcast-threshold analog).")

SCAN_ROW_GROUP_PRUNING = conf(
    "spark.rapids.gpu.sql.parquet.rowGroupPruning.enabled", default=True,
    doc="Prune parquet row groups with min/max statistics against pushed "
        "predicates (reference: GpuParquetScan predicate pushdown).")

SCAN_COMBINE_WINDOW = conf(
    "spark.rapids.gpu.sql.parquet.reader.combineWindow", default=4,
    doc="Files decoded per threadpool window in the multithreaded parquet "
        "reader before device upload (reference: MULTITHREADED reader "
        "combine settings).")

SCAN_METADATA_THREADS = conf(
    "spark.rapids.gpu.sql.scan.metadataThreads", default=4,
    doc="Threads reading parquet footers and row-group metadata ahead of "
        "the decode pool (reference: MULTITHREADED reader footer threads).")

FILECACHE_MAX_BYTES = conf(
    "spark.rapids.gpu.filecache.maxBytes", default=8 << 30,
    doc="Local disk budget for the file range cache.")

WRITER_ASYNC_MAX_IN_FLIGHT = conf(
    "spark.rapids.gpu.sql.write.async.maxInFlightBytes", default=256 << 20,
    doc="Host bytes allowed in flight for async writes before producers "
        "block (reference: HostMemoryThrottle).")

PLAN_CACHE_ENABLED = conf(
    "spark.rapids.gpu.plan.cache.enabled", default=True,
    doc="Memoize Overrides.apply: a repeat of a rename-equal logical plan "
        "under the same configuration is served the physical plan built "
        "the first time (plan/plan_cache.py; reference: "
        "spark.rapids.tpu.plan.cache.enabled).")

PLAN_CACHE_MAX_ENTRIES = conf(
    "spark.rapids.gpu.plan.cache.maxEntries", default=128,
    doc="Physical plans the plan memo holds; the least recently used goes "
        "past the cap (at least 1).")

BLOOM_JOIN_BITS = conf(
    "spark.rapids.gpu.sql.join.bloomFilter.bits", default=1 << 23,
    doc="Bloom filter size in bits for runtime join filters (read by "
        "exec/bloom.default_bits outside any hot loop).")

PARQUET_READER_TYPES = ("PERFILE", "MULTITHREADED", "COALESCING")
EXPLAIN_MODES = ("NONE", "NOT_ON_GPU", "ALL")
SHUFFLE_MODES = ("MULTITHREADED", "CACHE_ONLY")
SHUFFLE_CODECS = ("none", "zlib", "lz4", "zstd")


class RapidsConf:
    """Immutable bag of settings; unknown keys are rejected."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = {}
        for k, v in (settings or {}).items():
            entry = _REGISTRY.get(k)
            if entry is None:
                raise KeyError(f"unknown conf key {k}")
            self._values[k] = entry.conv(v)
        explain = self.get(EXPLAIN.key)
        if explain not in EXPLAIN_MODES:
            raise ValueError(f"{EXPLAIN.key} must be one of {EXPLAIN_MODES}, "
                             f"not {explain!r}")
        for entry, allowed in ((SHUFFLE_MODE, SHUFFLE_MODES),
                               (SHUFFLE_COMPRESS, SHUFFLE_CODECS),
                (SPILL_CODEC, SHUFFLE_CODECS)):
            if self[entry] not in allowed:
                raise ValueError(f"{entry.key} must be one of {allowed}, "
                                 f"not {self[entry]!r}")
        for entry, ok, rule in (
                (SHUFFLE_WRITE_THREADS, lambda v: v >= 1, ">= 1"),
                (PREFETCH_DEPTH, lambda v: v >= 1, ">= 1"),
                (REUSE_CACHE_MAX_BYTES, lambda v: v >= 0, ">= 0"),
                (REUSE_CACHE_MAX_ENTRIES, lambda v: v >= 1, ">= 1"),
                (PLAN_CACHE_MAX_ENTRIES, lambda v: v >= 1, ">= 1"),
                (CONCURRENT_TASKS, lambda v: v >= 1, ">= 1"),
                (POOL_MAX_BYTES, lambda v: v >= 0, ">= 0"),
                (SPILL_CHUNK_BYTES, lambda v: v >= 4096, ">= 4096"),
                (AGG_REPARTITION_TARGET_BYTES, lambda v: v >= 0, ">= 0"),
                (AGG_REPARTITION_NUM_BUCKETS, lambda v: v >= 2, ">= 2"),
                (AGG_REPARTITION_MAX_DEPTH, lambda v: v >= 1, ">= 1"),
                (RETRY_MAX_ATTEMPTS, lambda v: v >= 1, ">= 1"),
                (SORT_OOC_TARGET_ROWS, lambda v: v >= 1, ">= 1"),
                (SORT_OOC_MAX_MERGE_RUNS, lambda v: v >= 2, ">= 2"),
                (SCAN_METADATA_THREADS, lambda v: v >= 1, ">= 1")):
            if not ok(self[entry]):
                raise ValueError(f"{entry.key} must be {rule}")

    def get(self, key: str):
        if key in self._values:
            return self._values[key]
        return _REGISTRY[key].default

    def __getitem__(self, entry: ConfEntry):
        return self.get(entry.key)


_active_lock = threading.Lock()
_active: RapidsConf = RapidsConf()


def set_active(conf_obj: Optional[RapidsConf]) -> None:
    global _active
    with _active_lock:
        _active = conf_obj if conf_obj is not None else RapidsConf()


def get_active() -> RapidsConf:
    with _active_lock:
        return _active
