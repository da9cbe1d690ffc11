"""Per-block integrity trailer of the shuffle wire format (counterpart of
spark_rapids_tpu/shuffle/integrity.py, byte-equal to it).

The manager appends the trailer after serialization and strips it before
the merge, outside the wire frame, so frames stay pristine for the
positional merge. Layout (little-endian, 9 bytes): magic u32 "SRFC" |
algo u8 | checksum u32. Algo 1 is CRC32C when a ``crc32c`` module is
importable, algo 0 zlib's CRC-32; the algo byte travels in the trailer,
so reader and writer need not agree up front.
"""

from __future__ import annotations

import struct
import zlib

_TRAILER = struct.Struct("<IBI")
MAGIC = 0x43465253  # "SRFC"
ALGO_CRC32 = 0
ALGO_CRC32C = 1
TRAILER_BYTES = _TRAILER.size

try:  # pragma: no cover - depends on the installation
    from crc32c import crc32c as _crc32c  # type: ignore
except ImportError:
    _crc32c = None


class BlockCorruption(RuntimeError):
    """A shuffle block failed its integrity check on read."""


def _checksum(data: bytes, algo: int) -> int:
    if algo == ALGO_CRC32C:
        if _crc32c is None:
            raise BlockCorruption("block sealed with CRC32C but no crc32c "
                                  "implementation is available")
        return _crc32c(data) & 0xFFFFFFFF
    return zlib.crc32(data) & 0xFFFFFFFF


def seal(blob: bytes) -> bytes:
    """The block with its integrity trailer appended."""
    algo = ALGO_CRC32 if _crc32c is None else ALGO_CRC32C
    return blob + _TRAILER.pack(MAGIC, algo, _checksum(blob, algo))


def unseal(blob: bytes) -> bytes:
    """The block without its trailer, verified: raises BlockCorruption on a
    missing trailer or a checksum mismatch."""
    if len(blob) < TRAILER_BYTES:
        raise BlockCorruption(
            f"block too short for integrity trailer ({len(blob)} bytes)")
    magic, algo, crc = _TRAILER.unpack_from(blob, len(blob) - TRAILER_BYTES)
    if magic != MAGIC:
        raise BlockCorruption("integrity trailer missing or overwritten")
    if algo not in (ALGO_CRC32, ALGO_CRC32C):
        raise BlockCorruption(f"unknown integrity algo {algo} (corrupt "
                              f"trailer)")
    body = blob[:-TRAILER_BYTES]
    if _checksum(body, algo) != crc:
        raise BlockCorruption(
            f"block checksum mismatch ({len(body)} bytes, algo {algo})")
    return body
