"""Bloom filter build and probe on the device, for runtime join filters
(counterpart of spark_rapids_tpu/exec/bloom.py; Spark's
BloomFilterAggregate and BloomFilterMightContain).

Spark's InjectRuntimeFilter builds a bloom filter over a join's build-side
keys and pushes a might-contain filter into the probe side. The filter is
one bool a bit, as the reference's (so the two compare bit for bit):
the build sets k positions a row (one idempotent scatter a hash), the
probe gathers them. Positions come from the engine's 64-bit key hash
(``kernels.hash_keys``, the reference's bit for bit) by Spark's double
hashing, h1 + i * h2 modulo the bits; h1 and h2 are below 2^32 and i below
8, so the sum stays below 2^36 and signed int64 arithmetic is exact. Both
run where their batch lives.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec import kernels as K


def optimal_params(expected_items: int, fpp: float = 0.03):
    """Bits and hashes for ``expected_items`` at false-positive rate
    ``fpp`` (Spark's BloomFilter.optimalNumOfBits and optimalNumOfHashFunctions;
    at most 8 hashes, as the reference)."""
    m = max(64, int(-expected_items * math.log(fpp) / (math.log(2) ** 2)))
    k = max(1, round(m / max(expected_items, 1) * math.log(2)))
    return m, min(k, 8)


def _positions(h: torch.Tensor, num_bits: int,
               num_hashes: int) -> List[torch.Tensor]:
    """The k positions of each row's hash (int64 bit patterns): h1 + i *
    h2 modulo ``num_bits``, h1 the low 32 bits, h2 the high 32 bits with
    the lowest set."""
    h1 = h & 0xFFFFFFFF
    h2 = K._lsr(h, 32) | 1
    return [(h1 + i * h2) % num_bits for i in range(num_hashes)]


def default_bits() -> int:
    """The session's bloom size (``spark.rapids.gpu.sql.join.bloomFilter.
    bits``). Read it once, outside any loop over batches."""
    from spark_rapids_tpu_torch.config import conf as C

    return C.BLOOM_JOIN_BITS.get(C.get_active())


def build_bloom_filter(batch: ColumnarBatch, key_cols: Sequence[int],
                       num_bits: int, num_hashes: int = 3) -> torch.Tensor:
    """Set k bits a row; filters of several batches merge by OR."""
    h = K.hash_keys(batch, list(key_cols))
    bits = torch.zeros(num_bits, dtype=torch.bool, device=h.device)
    for pos in _positions(h, num_bits, num_hashes):
        bits[pos] = True
    return bits


def might_contain(batch: ColumnarBatch, key_cols: Sequence[int],
                  bits: torch.Tensor, num_bits: int,
                  num_hashes: int) -> torch.Tensor:
    """True where every one of a row's k bits is set: never false for a
    key the filter was built from."""
    h = K.hash_keys(batch, list(key_cols))
    out = torch.ones(batch.num_rows, dtype=torch.bool, device=h.device)
    for pos in _positions(h, num_bits, num_hashes):
        out &= bits[pos]
    return out
