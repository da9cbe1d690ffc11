"""Time-zone transition tables for timestamp conversion (the port's copy of
spark_rapids_tpu/utils/tzdb.py).

The reference's jni ``GpuTimeZoneDB`` loads the JVM's zone rules into a
transition table on the card and converts timestamps with a binary search
per row. Here a zone's table is built once on the host from ``zoneinfo``
(the machine's zone database; nothing is downloaded) and becomes a (sorted
starts, offsets) pair that ``torch.searchsorted`` reads on the device and
``np.searchsorted`` on the CPU engine: one vectorised lookup per batch.

Tables are cached per zone id; a zone without DST has one entry.
Transitions are taken between 1900 and 2100, and the offsets at those ends
hold before and after them. A local time in a DST overlap resolves to the
EARLIER offset, as java.time's ``ZonedDateTime.of`` that Spark uses. A zone
the machine's database lacks raises ``zoneinfo.ZoneInfoNotFoundError``
naming it.
"""

from __future__ import annotations

import datetime
import functools
from typing import Tuple

import numpy as np

_US = 1_000_000
_UTC = datetime.timezone.utc
_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=_UTC)
_LO = int((datetime.datetime(1900, 1, 1, tzinfo=_UTC) - _EPOCH)
          .total_seconds()) * _US
_HI = int((datetime.datetime(2100, 1, 1, tzinfo=_UTC) - _EPOCH)
          .total_seconds()) * _US
_DAY = 86_400 * _US


def _offset_us(zone, utc_us: int) -> int:
    dt = _EPOCH + datetime.timedelta(microseconds=utc_us)
    return int(dt.astimezone(zone).utcoffset().total_seconds()) * _US


@functools.lru_cache(maxsize=None)
def utc_transitions(tz: str) -> Tuple[np.ndarray, np.ndarray]:
    """(starts_us, offsets_us), both int64 and sorted: ``offsets[i]``
    applies to the UTC instants in ``[starts[i], starts[i+1])``;
    ``starts[0]`` is a -inf sentinel, so every instant has an offset."""
    from zoneinfo import ZoneInfo

    zone = ZoneInfo(tz)
    starts = [np.iinfo(np.int64).min]
    offsets = [_offset_us(zone, _LO)]
    t = _LO
    cur = offsets[0]
    while t < _HI:
        nxt = t + _DAY
        o = _offset_us(zone, nxt)
        if o != cur:
            # bisect the day down to the transition's second
            lo, hi = t, nxt
            while hi - lo > _US:
                mid = (lo + hi) // 2 // _US * _US
                if mid <= lo:
                    mid = lo + _US
                if _offset_us(zone, mid) == cur:
                    lo = mid
                else:
                    hi = mid
            starts.append(hi)
            offsets.append(o)
            cur = o
        t = nxt
    return (np.asarray(starts, np.int64), np.asarray(offsets, np.int64))


@functools.lru_cache(maxsize=None)
def local_transitions(tz: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(local_starts_us, offsets_us, prev_offsets_us) for the lookup of a
    LOCAL wall time (the to-UTC direction): entry i applies from the wall
    time at which transition i takes effect, and ``prev_offsets[i]`` is
    the offset before it, which resolves a fall-back overlap to the
    earlier offset."""
    starts, offsets = utc_transitions(tz)
    local_starts = starts.copy()
    local_starts[1:] = starts[1:] + offsets[1:]
    prev = np.concatenate([offsets[:1], offsets[:-1]])
    return local_starts, offsets, prev
