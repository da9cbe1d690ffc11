"""Spill framework: device -> host -> disk over batch handles, moved in
fixed-size CRC-guarded chunks (counterpart of spark_rapids_tpu/mem/spill.py;
the reference plugin's SpillFramework and SpillableColumnarBatch).

A ``SpillableBatch`` registers its bytes with the pool when it is made.
While nobody has it pinned (``get`` pins it until ``unpin``; the context
manager does both) the framework may spill it: its tensors are copied
into pinned host buffers on a copy stream of their device, which first
waits on an event recorded where the tensors were made (a prefetch
worker's stream, say), and the device copies are dropped once that copy
has finished. The host bytes are cut into chunks of
``spark.rapids.gpu.memory.spill.chunkBytes`` through a small pool of
reusable staging buffers (``BounceBufferPool``), each chunk compressed by
the codec (none, zlib, lz4, zstd) and sealed with a CRC-32. Past the host
tier's cap (``memory.host.spillStorageSize``) the oldest host handles
move their chunks to one file each under ``memory.spillDir`` (by default
a directory of the process's own, removed at exit). ``get``
streams the chunks back one at a time, verifies each CRC
(``SpillCorruptionError`` on a mismatch) and uploads the columns on the
caller's current stream. Values come back bit-equal: numbers, DECIMAL128
limbs, string bytes and offsets, dictionary codes.

A dictionary column's dictionary is not spilled: it belongs to the table
it was encoded from (every batch of a table shares it, and batches
concatenate by code only while they share the object), so a handle keeps
a reference to it, and neither its accounted nor its spilled bytes count
it.

``get_framework`` is the one door every operator sheds state through (join
builds and output chunks, aggregate repartition buckets, out-of-core sort
runs, the reuse cache), so pool pressure picks victims across all of them,
oldest first. One lock guards the framework's state and each handle has
its own for pinning and spilling; no thread takes a handle's lock while
it holds the framework's.

``spillable`` registers batches under the OOM retry (``mem/retry.py``): a
refused registration is retried after the pool spilled, and a
split-and-retry registers the batch's halves.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
import threading
import uuid
import zlib
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.mem.pool import (
    HbmPool, RetryOOM, SplitAndRetryOOM)

DEVICE, HOST, DISK, CLOSED = "DEVICE", "HOST", "DISK", "CLOSED"


class SpillCorruptionError(RuntimeError):
    """A spill chunk failed its CRC (or its length) on read-back: the
    host or disk copy no longer matches what was written."""


def _codec_fns(name: str):
    """(compress, decompress) of a codec name, None for ``none``; lz4 and
    zstd need their modules, and a missing one raises here."""
    if name == "none":
        return None
    if name == "zlib":
        return (lambda b: zlib.compress(b, 1), zlib.decompress)
    if name == "lz4":
        try:
            import lz4.frame as _lz4
        except ImportError as e:
            raise ValueError(
                "spill codec 'lz4' requires the lz4 python module, which is "
                f"not importable here; use 'zlib' or 'none' ({e})") from e
        return (_lz4.compress, _lz4.decompress)
    if name == "zstd":
        try:
            import zstandard as _zstd
        except ImportError as e:
            raise ValueError(
                "spill codec 'zstd' requires the zstandard python module, "
                f"which is not importable here; use 'zlib' or 'none' ({e})"
            ) from e
        return (_zstd.ZstdCompressor().compress,
                _zstd.ZstdDecompressor().decompress)
    raise ValueError(f"unknown spill codec {name!r} "
                     "(expected none, zlib, lz4 or zstd)")


class BounceBufferPool:
    """A few reusable fixed-size host staging buffers: chunking fills a
    leased buffer instead of allocating one per chunk."""

    def __init__(self, buf_bytes: int, max_buffers: int = 4):
        self.buf_bytes = buf_bytes
        self.max_buffers = max_buffers
        self._free: List[bytearray] = []
        self._lock = threading.Lock()
        self.leases = 0
        self.reuses = 0

    def acquire(self) -> bytearray:
        with self._lock:
            self.leases += 1
            if self._free:
                self.reuses += 1
                return self._free.pop()
        return bytearray(self.buf_bytes)

    def release(self, buf: bytearray) -> None:
        with self._lock:
            if len(self._free) < self.max_buffers:
                self._free.append(buf)


class _Chunk:
    """One fixed-size piece of a spilled batch's byte stream."""

    __slots__ = ("seq", "raw_len", "crc", "payload", "disk_off", "disk_len")

    def __init__(self, seq: int, raw_len: int, crc: int,
                 payload: Optional[bytes]):
        self.seq = seq
        self.raw_len = raw_len  # bytes before the codec
        self.crc = crc          # crc32 of the stored payload
        self.payload = payload  # None once the chunk is on disk
        self.disk_off = 0
        self.disk_len = 0


def _batch_tensors(batch: ColumnarBatch):
    """(layout, tensors): the tensors a spill moves, in order, and per
    column the slots to rebuild it (its dictionary kept by reference)."""
    tensors: List[torch.Tensor] = []

    def slots_of(c: DeviceColumn) -> dict:
        slots = {"dtype": c.dtype, "data": len(tensors)}
        tensors.append(c.data)
        slots["valid"] = len(tensors)
        tensors.append(c.validity)
        if c.offsets is not None:
            slots["offsets"] = len(tensors)
            tensors.append(c.offsets)
        slots["dictionary"] = c.dictionary
        if c.children is not None:  # nested: the children's tensors too
            slots["children"] = [slots_of(k) for k in c.children]
        return slots

    cols = [slots_of(c) for c in batch.columns]
    return {"num_rows": batch.num_rows, "cols": cols}, tensors


def batch_nbytes(batch: ColumnarBatch) -> int:
    """The bytes a handle accounts and spills: every column's data,
    validity and offsets (dictionaries excluded, see the module
    docstring)."""
    total = 0
    stack = list(batch.columns)
    while stack:
        c = stack.pop()
        for t in (c.data, c.validity, c.offsets):
            if t is not None:
                total += t.numel() * t.element_size()
        stack.extend(c.children or ())
    return total


def _batch_device(batch: ColumnarBatch) -> Optional[torch.device]:
    return batch.columns[0].device if batch.columns else None


_fw_lock = threading.Lock()
_copy_streams: dict = {}
_copy_lock = threading.Lock()


def _copy_stream(device: torch.device):
    """One side stream per CUDA device for device -> host spill copies."""
    key = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _copy_lock:
        s = _copy_streams.get(key)
        if s is None:
            s = _copy_streams[key] = torch.cuda.Stream(device=key)
        return s


def _ready_event(device: Optional[torch.device]):
    """An event on the calling thread's current stream of a CUDA device
    (where a batch's tensors were just made), None elsewhere."""
    if device is None or device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _to_host(tensors: List[torch.Tensor], device, ready) -> List[np.ndarray]:
    """Host copies of ``tensors``: on a CUDA device into pinned buffers on
    the copy stream after ``ready``; the call returns when the copies have
    landed, so the device tensors may be dropped."""
    if device is None or device.type != "cuda":
        return [t.contiguous().numpy() for t in tensors]
    stream = _copy_stream(device)
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in tensors]
    with torch.cuda.stream(stream):
        if ready is not None:
            stream.wait_event(ready)
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return [h.numpy() for h in hosts]


class SpillableBatch:
    """A batch that can move between the device, host and disk tiers
    (reference: SpillableColumnarBatch). ``get`` materializes it on the
    device (registering its bytes again) and pins it until ``unpin``;
    ``close`` releases everything and is idempotent."""

    def __init__(self, batch: ColumnarBatch, framework: "SpillFramework"):
        self._fw = framework
        self._state = DEVICE
        self._device_batch: Optional[ColumnarBatch] = batch
        self._device = _batch_device(batch)
        self._layout = None
        self._chunks: Optional[List[_Chunk]] = None
        self._descs: Optional[List[Tuple[str, tuple]]] = None
        self._disk_path: Optional[str] = None
        self._nbytes = batch_nbytes(batch)
        self._num_rows = batch.num_rows
        self._ready = _ready_event(self._device)
        self._pins = 0
        self._pin_counted = False  # in the framework's pinned bytes
        self._closed = False
        self._lock = threading.RLock()
        self._mat_lock = threading.Lock()  # one unspill at a time
        self._mem_tag = framework._register(self)

    @property
    def nbytes(self) -> int:
        return self._nbytes

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def state(self) -> str:
        return CLOSED if self._closed else self._state

    def spillable(self) -> bool:
        with self._lock:
            return (self._state == DEVICE and self._pins == 0
                    and not self._closed)

    def get(self) -> ColumnarBatch:
        """The batch on the device, pinned until ``unpin``."""
        with self._lock:
            if self._closed:
                raise RuntimeError("get() of a closed SpillableBatch")
            self._pins += 1
            if self._state == DEVICE:
                return self._pinned_batch()
        # unspill outside the handle's lock (I/O and pool accounting); a
        # failure (a RetryOOM from the pool, say) must drop the pin
        try:
            self._fw._unspill(self)
        except BaseException:
            self.unpin()
            raise
        with self._lock:
            return self._pinned_batch()

    def _pinned_batch(self) -> ColumnarBatch:
        """The device batch of a pinned handle (under its lock), its bytes
        counted once in the framework's pinned bytes."""
        if not self._pin_counted:
            self._pin_counted = True
            self._fw._note_pinned(self._nbytes)
        return self._device_batch

    def unpin(self) -> None:
        with self._lock:
            if self._pins <= 0:
                raise AssertionError("unpin() without a matching get()")
            self._pins -= 1
            if self._pins == 0 and self._pin_counted:
                self._pin_counted = False
                self._fw._note_pinned(-self._nbytes)

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._pin_counted:
                self._pin_counted = False
                self._fw._note_pinned(-self._nbytes)
            state = self._state
            self._device_batch = None
            self._chunks = None
            path, self._disk_path = self._disk_path, None
        self._fw._deregister(self, state)
        if path and os.path.exists(path):
            os.unlink(path)

    def __enter__(self) -> ColumnarBatch:
        return self.get()

    def __exit__(self, *exc) -> bool:
        self.unpin()
        return False


class SpillFramework:
    """The tier stores and the pool's spill callback (see the module
    docstring). Counters: handles registered and the largest one's bytes,
    spills to host and to disk (count and bytes), unspills, chunks and
    their stored bytes, and the most bytes pinned at once."""

    def __init__(self, pool: HbmPool, host_limit_bytes: int = 8 << 30,
                 spill_dir: str = "", chunk_bytes: int = 0,
                 codec: str = ""):
        from spark_rapids_tpu_torch.config import conf as C
        from spark_rapids_tpu_torch.mem import cleaner

        cfg = C.get_active()
        self.pool = pool
        self.host_limit = int(host_limit_bytes)
        self.host_used = 0
        self.spill_dir = spill_dir or default_spill_dir()
        self.chunk_bytes = int(chunk_bytes or C.SPILL_CHUNK_BYTES.get(cfg))
        self.codec = codec or C.SPILL_CODEC.get(cfg)
        self._codec_fns = _codec_fns(self.codec)  # a missing codec fails
        self.bounce = BounceBufferPool(self.chunk_bytes)
        self._handles: List[SpillableBatch] = []
        self._lock = threading.Lock()
        self.registered_count = 0
        self.max_handle_bytes = 0
        self.spilled_to_host_count = 0
        self.spilled_to_host_bytes = 0
        self.spilled_to_disk_count = 0
        self.spilled_to_disk_bytes = 0
        self.unspilled_count = 0
        self.unspilled_bytes = 0
        self.pinned_bytes = 0
        self.max_pinned_bytes = 0
        self.chunks_written_count = 0
        self.chunk_bytes_written = 0
        cleaner.register_framework(self)
        pool.set_spill_fn(self.spill_device_bytes)

    def counters(self) -> dict:
        with self._lock:
            return {
                "registered": self.registered_count,
                "live_handles": len(self._handles),
                "max_handle_bytes": self.max_handle_bytes,
                "spilled_to_host": self.spilled_to_host_count,
                "spilled_to_host_bytes": self.spilled_to_host_bytes,
                "spilled_to_disk": self.spilled_to_disk_count,
                "spilled_to_disk_bytes": self.spilled_to_disk_bytes,
                "unspilled": self.unspilled_count,
                "unspilled_bytes": self.unspilled_bytes,
                "max_pinned_bytes": self.max_pinned_bytes,
                "chunks_written": self.chunks_written_count,
                "chunk_bytes_written": self.chunk_bytes_written,
                "host_used": self.host_used,
            }

    # -- registration --------------------------------------------------------
    def _register(self, h: SpillableBatch):
        tag = self.pool.allocate(h.nbytes)
        with self._lock:
            self._handles.append(h)
            self.registered_count += 1
            self.max_handle_bytes = max(self.max_handle_bytes, h.nbytes)
        return tag

    def _deregister(self, h: SpillableBatch, state: str) -> None:
        with self._lock:
            if h in self._handles:
                self._handles.remove(h)
            if state == HOST:
                self.host_used -= h.nbytes
        if state == DEVICE:
            self.pool.release(h.nbytes, tag=h._mem_tag)

    def _note_pinned(self, delta: int) -> None:
        """A handle's bytes pinned on the device (positive) or no longer
        (negative); the high-water mark is the least pool that holds every
        set of handles an operator pins at once."""
        with self._lock:
            self.pinned_bytes += delta
            self.max_pinned_bytes = max(self.max_pinned_bytes,
                                        self.pinned_bytes)

    def handles(self) -> List[SpillableBatch]:
        with self._lock:
            return list(self._handles)

    # -- chunks --------------------------------------------------------------
    def _chunk_arrays(self, arrays: List[np.ndarray]) -> List[_Chunk]:
        """Cut the arrays' bytes, in order, into fixed-size chunks through
        a leased staging buffer, each through the codec and sealed with
        its CRC."""
        compress = self._codec_fns[0] if self._codec_fns else None
        chunks: List[_Chunk] = []
        buf = self.bounce.acquire()
        fill = 0

        def flush():
            nonlocal fill
            if fill == 0:
                return
            raw = bytes(buf[:fill])
            payload = compress(raw) if compress else raw
            chunks.append(_Chunk(len(chunks), fill, zlib.crc32(payload),
                                 payload))
            fill = 0

        try:
            for a in arrays:
                mv = memoryview(np.ascontiguousarray(a)).cast("B")
                off = 0
                while off < len(mv):
                    take = min(self.chunk_bytes - fill, len(mv) - off)
                    buf[fill:fill + take] = mv[off:off + take]
                    fill += take
                    off += take
                    if fill == self.chunk_bytes:
                        flush()
            flush()
        finally:
            self.bounce.release(buf)
        return chunks

    def _iter_payloads(self, h: SpillableBatch) -> Iterator[bytes]:
        """The raw bytes of each chunk in order, read from the host list
        or the disk file one chunk at a time; a CRC or length mismatch
        raises ``SpillCorruptionError``."""
        decompress = self._codec_fns[1] if self._codec_fns else None
        f = open(h._disk_path, "rb") if h._state == DISK else None
        try:
            for ch in h._chunks:
                if ch.payload is not None:
                    payload = ch.payload
                else:
                    f.seek(ch.disk_off)
                    payload = f.read(ch.disk_len)
                if zlib.crc32(payload) != ch.crc:
                    raise SpillCorruptionError(
                        f"spill chunk {ch.seq} failed its CRC (codec "
                        f"{self.codec}, {len(payload)} stored bytes for "
                        f"{ch.raw_len} raw)")
                raw = decompress(payload) if decompress else payload
                if len(raw) != ch.raw_len:
                    raise SpillCorruptionError(
                        f"spill chunk {ch.seq} decompressed to {len(raw)} "
                        f"bytes, expected {ch.raw_len}")
                yield raw
        finally:
            if f is not None:
                f.close()

    def _arrays_from_chunks(self, h: SpillableBatch) -> List[np.ndarray]:
        """The spilled arrays, rebuilt by streaming the chunks into
        arrays of the recorded dtypes and shapes."""
        arrays = [np.empty(shape, dtype=np.dtype(ds))
                  for ds, shape in h._descs]
        views = [memoryview(a).cast("B") for a in arrays]
        ai, aoff = 0, 0
        for raw in self._iter_payloads(h):
            roff = 0
            while roff < len(raw):
                while ai < len(views) and aoff == len(views[ai]):
                    ai, aoff = ai + 1, 0
                if ai >= len(views):
                    raise SpillCorruptionError(
                        "spill stream longer than its recorded layout")
                take = min(len(views[ai]) - aoff, len(raw) - roff)
                views[ai][aoff:aoff + take] = raw[roff:roff + take]
                aoff += take
                roff += take
        while ai < len(views) and aoff == len(views[ai]):
            ai, aoff = ai + 1, 0
        if ai < len(views):
            raise SpillCorruptionError(
                "spill stream shorter than its recorded layout")
        return arrays

    # -- the spill cascade ---------------------------------------------------
    def spill_device_bytes(self, needed: int) -> int:
        """The pool's callback: spill the oldest unpinned device handles
        until ``needed`` accounted bytes are freed; the bytes freed."""
        freed = 0
        while freed < needed:
            victim = next((h for h in self.handles() if h.spillable()),
                          None)
            if victim is None:
                break
            freed += self._spill_one(victim)
        return freed

    def _spill_one(self, h: SpillableBatch) -> int:
        with h._lock:
            if not h.spillable():
                return 0
            layout, tensors = _batch_tensors(h._device_batch)
            arrays = _to_host(tensors, h._device, h._ready)
            chunks = self._chunk_arrays(arrays)
            h._layout = layout
            h._descs = [(a.dtype.str, a.shape) for a in arrays]
            h._chunks = chunks
            h._device_batch = None
            h._ready = None
            h._state = HOST
        self.pool.release(h.nbytes, tag=h._mem_tag)
        with self._lock:
            self.spilled_to_host_count += 1
            self.spilled_to_host_bytes += h.nbytes
            self.chunks_written_count += len(chunks)
            self.chunk_bytes_written += sum(len(c.payload) for c in chunks)
            self.host_used += h.nbytes
            over = self.host_used - self.host_limit
        if over > 0:
            self._cascade_to_disk(over)
        return h.nbytes

    def _cascade_to_disk(self, needed: int) -> None:
        freed = 0
        while freed < needed:
            # a pinned handle is being read back: its host copy stays
            victim = next((h for h in self.handles()
                           if h._state == HOST and h._pins == 0), None)
            if victim is None:
                return
            freed += self._host_to_disk(victim)

    def _host_to_disk(self, h: SpillableBatch) -> int:
        with h._lock:
            if h._state != HOST or h._pins > 0 or h._closed:
                return 0
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir,
                                f"{uuid.uuid4().hex}.spill.chunks")
            off = 0
            with open(path, "wb") as f:
                for ch in h._chunks:
                    ch.disk_off = off
                    ch.disk_len = len(ch.payload)
                    f.write(ch.payload)
                    off += ch.disk_len
                    ch.payload = None  # the host bytes go, the index stays
            h._disk_path = path
            h._state = DISK
        with self._lock:
            self.spilled_to_disk_count += 1
            self.spilled_to_disk_bytes += h.nbytes
            self.host_used -= h.nbytes
        return h.nbytes

    # -- unspill -------------------------------------------------------------
    def _unspill(self, h: SpillableBatch) -> None:
        with h._mat_lock:  # a concurrent get() may have done it already
            with h._lock:
                if h._state == DEVICE:
                    return
                from_disk = h._state == DISK
            # account before materializing (it may spill others; the
            # handle is pinned, so it is not its own victim)
            tag = self.pool.allocate(h.nbytes, tag=h._mem_tag)
            try:
                arrays = self._arrays_from_chunks(h)
            except BaseException:
                # nothing materialized: give the reservation back
                self.pool.release(h.nbytes, tag=tag)
                raise
            batch = _rebuild(h._layout, arrays, h._device)
            with h._lock:
                h._device_batch = batch
                h._chunks = None
                h._state = DEVICE
                h._ready = _ready_event(h._device)
                path, h._disk_path = h._disk_path, None
            with self._lock:
                if not from_disk:
                    self.host_used -= h.nbytes
                self.unspilled_count += 1
                self.unspilled_bytes += h.nbytes
            if from_disk and path and os.path.exists(path):
                os.unlink(path)


def _rebuild(layout: dict, arrays: List[np.ndarray],
             device: Optional[torch.device]) -> ColumnarBatch:
    """A device batch from a spill's layout and host arrays, uploaded on
    the calling thread's current stream."""
    def up(i):
        t = torch.from_numpy(arrays[i])
        return t.to(device) if device is not None else t

    def column(slots: dict) -> DeviceColumn:
        kids = slots.get("children")
        return DeviceColumn(
            slots["dtype"], up(slots["data"]), up(slots["valid"]),
            up(slots["offsets"]) if "offsets" in slots else None,
            slots["dictionary"],
            None if kids is None else tuple(column(k) for k in kids))

    return ColumnarBatch([column(s) for s in layout["cols"]],
                         layout["num_rows"])


_default_dir: Optional[str] = None


def default_spill_dir() -> str:
    """The process's own spill directory under the temporary directory
    (``srgpu_spill_<pid>``), removed at exit."""
    global _default_dir
    with _copy_lock:
        if _default_dir is None:
            _default_dir = os.path.join(tempfile.gettempdir(),
                                        f"srgpu_spill_{os.getpid()}")
            atexit.register(shutil.rmtree, _default_dir, True)
        return _default_dir


# ---------------------------------------------------------------------------
# the one door
# ---------------------------------------------------------------------------


def get_framework() -> SpillFramework:
    """The spill framework over the process's pool: the one a previous
    call made for that pool, else a new one sized from the active conf
    (a second framework over one pool would take over its spill
    callback)."""
    from spark_rapids_tpu_torch.config import conf as C
    from spark_rapids_tpu_torch.mem import cleaner
    from spark_rapids_tpu_torch.mem.pool import get_pool

    pool = get_pool()
    with _fw_lock:
        for fw in cleaner.frameworks():
            if getattr(fw, "pool", None) is pool:
                return fw
        cfg = C.get_active()
        return SpillFramework(pool,
                              host_limit_bytes=C.HOST_SPILL_LIMIT.get(cfg),
                              spill_dir=C.SPILL_DIR.get(cfg))


def spillable(batches: Iterable[ColumnarBatch],
              framework: Optional[SpillFramework] = None
              ) -> Iterator[SpillableBatch]:
    """Register each batch as a handle under the OOM retry: a refused
    registration is retried once the pool has spilled, and a
    split-and-retry registers the batch's halves instead."""
    from spark_rapids_tpu_torch.mem.retry import with_retry

    fw = framework or get_framework()
    return with_retry(batches, lambda b: SpillableBatch(b, fw))


def try_spillable(batch: ColumnarBatch,
                  framework: Optional[SpillFramework] = None
                  ) -> Optional[SpillableBatch]:
    """A handle for ``batch``, or None when the pool refuses it even after
    spilling (a cache then passes the batch through unheld)."""
    fw = framework or get_framework()
    try:
        return SpillableBatch(batch, fw)
    except (RetryOOM, SplitAndRetryOOM):
        return None
