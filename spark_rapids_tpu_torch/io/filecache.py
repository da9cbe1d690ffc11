"""Local range cache for remote file reads.

The port's copy of spark_rapids_tpu/io/filecache.py.

Reference: the FileCache lives in the closed-source rapids-4-spark-private
artifact (SURVEY.md §2.7) — behavior reimplemented from its surface: a
local-disk cache of (path, offset, length) byte ranges (parquet footers and
column chunks) with LRU eviction by total size and hit/miss metrics
(GpuMetric:84-95 filecache hit/miss counters).
"""

from __future__ import annotations

import collections
import hashlib
import os
import threading


class FileCache:
    """LRU byte-range cache backed by a local directory."""

    def __init__(self, cache_dir: str, max_bytes: int = None):
        if max_bytes is None:
            from spark_rapids_tpu_torch.config import conf as _C
            max_bytes = _C.FILECACHE_MAX_BYTES.get(_C.get_active())
        self.cache_dir = cache_dir
        self.max_bytes = max_bytes
        os.makedirs(cache_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, int]" = \
            collections.OrderedDict()  # key -> size, in LRU order
        self._total = 0
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.miss_bytes = 0

    @staticmethod
    def _key(path: str, offset: int, length: int) -> str:
        h = hashlib.sha1(f"{path}:{offset}:{length}".encode()).hexdigest()
        return h

    def _local(self, key: str) -> str:
        return os.path.join(self.cache_dir, key)

    def get_range(self, path: str, offset: int, length: int) -> bytes:
        """Read [offset, offset+length) of path through the cache."""
        key = self._key(path, offset, length)
        with self._lock:
            cached = key in self._entries
            if cached:
                self._entries.move_to_end(key)
        if cached:
            try:
                with open(self._local(key), "rb") as f:
                    data = f.read()
                with self._lock:
                    self.hits += 1
                    self.hit_bytes += len(data)
                return data
            except OSError:
                with self._lock:
                    self._drop(key)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        self._put(key, data)
        with self._lock:
            self.misses += 1
            self.miss_bytes += len(data)
        return data

    def _put(self, key: str, data: bytes):
        tmp = self._local(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._local(key))
        with self._lock:
            # concurrent misses can race to _put the same key: account the
            # delta, not the full size, so _total never drifts
            self._total += len(data) - self._entries.get(key, 0)
            self._entries[key] = len(data)
            self._entries.move_to_end(key)
            while self._total > self.max_bytes and len(self._entries) > 1:
                old, _ = next(iter(self._entries.items()))
                self._drop(old)

    def _drop(self, key: str):
        size = self._entries.pop(key, 0)
        self._total -= size
        try:
            os.unlink(self._local(key))
        except OSError:
            pass

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._total
