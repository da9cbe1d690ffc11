// Hash-table probe for the general hash join, written for Hopper (sm_90a).
//
// Replaces the TPU kernel probe_hash_table_pallas
// (spark_rapids_tpu/exec/kernels.py, kernel body _pallas_probe_kernel).
// Plain version and contract: probe_hash_table in
// spark_rapids_tpu_torch/exec/kernels.py; wrapper probe_hash_table_kernel.
//
// What it computes: for each probe row i, start at the home slot
// splitmix64(h1[i] ^ seed_mix) & (capacity - 1) and walk at most max_probes
// slots of the open-addressing table. The first used slot whose (h1, h2)
// record equals (h1[i], h2[i]) is the answer; an empty slot or the end of
// the walk gives -1. hit[i] is slot[i] >= 0.
//
// Table layout (HashTable in exec/kernels.py): one tag byte a slot, 0 for
// an empty slot and 0x80 | (h2 & 0x7f) of its key otherwise, and one
// array of interleaved 16-byte (h1, h2) records. A slot whose tag is not
// the row's cannot hold the row's key, so its record is never read.
//
// What bounds it: bytes in principle, latency in practice. Each probe row
// reads 16 B of hashes and writes a 4 B slot (and a 1 B hit); of the table
// it needs one byte of every slot and the 16-byte record of the used slots:
// 20 B a probe row, 1 B a slot and 16 B a stored key, each moved once. But
// every table read is a gather whose address is known only after the row's
// hashes arrive. Joins probe mostly keys that are not in the table (3.8%
// hit at TPC-H Q5's largest probe, at a table load of 0.22), so most walks
// end at an empty home slot; and a warp waits for its longest walk.
// Measured on an H100 (PERF.md lists the designs timed against this one):
// streaming the rows alone, with no table, takes about 0.011 ms of a
// 0.0091 ms bound at Q5's 1,048,576 probes; with one table byte a row,
// 0.015 ms.
//
// What the design does about it:
//   - The walk reads the 2 MB tag array, which stays in the L2 and mostly
//     in L1, first; the record (32 MB at 2^21 slots) only on a tag match,
//     as one 16-byte ld.global.nc.v2.u64. A miss that lands on a used slot
//     (22% of homes at Q5) goes on to the next tag with no record read,
//     where the used byte alone would need one. Loading the record
//     together with the first byte (to save a round trip) was measured
//     slower: it reads a random 32-byte sector of the records for nearly
//     every row instead of for the few that match.
//   - One row a thread, one thread per row (20 registers, so the SMs hold
//     2048 threads each), and the probe hashes are read and slot/hit
//     written with evict-first streaming hints (ld/st .cs), so the
//     streamed rows do not push the table out of the 50 MB L2. Walking
//     two or four adjacent rows a thread (16-byte row loads), four rows
//     strided across a grid sized to the card, or software-pipelined
//     walks that keep several rows a thread in flight, each at its own
//     step, were all measured slower: a warp waits for the longest of its
//     walks, and the extra registers cost more resident warps than the
//     extra rows in flight win back.
// Records that are not 16-byte aligned take a template variant with two
// 8-byte loads (the wrapper never takes the plain version for a CUDA
// tensor). It allocates nothing, launches on the caller's stream and does
// not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct ProbeArgs {
  const uint8_t* slot_tag;
  const uint64_t* slot_keys;  // (h1, h2) of slot pos at 2 * pos, 2 * pos + 1
  const uint64_t* h1;
  const uint64_t* h2;
  int32_t* out_slot;
  uint8_t* out_hit;
  int64_t n;
  uint64_t mask;
  uint64_t seed_mix;
  int max_probes;
};

__device__ __forceinline__ uint8_t tag_of(uint64_t h2) {
  return (uint8_t)(0x80 | (h2 & 0x7f));
}

// The two hash words of slot pos, as one 16-byte load (kVector: the
// records are 16-byte aligned) or two 8-byte loads.
template <bool kVector>
__device__ __forceinline__ void load_key(const ProbeArgs& a, uint64_t pos,
                                         uint64_t& s1, uint64_t& s2) {
  if constexpr (kVector) {
    const ulonglong2 r =
        __ldg(reinterpret_cast<const ulonglong2*>(a.slot_keys) + pos);
    s1 = r.x;
    s2 = r.y;
  } else {
    const unsigned long long* r =
        reinterpret_cast<const unsigned long long*>(a.slot_keys) + 2 * pos;
    s1 = __ldg(r);
    s2 = __ldg(r + 1);
  }
}

// One row a thread: the slot's tag first, its record only on a tag match;
// the row's hashes read and its slot and hit written with streaming hints.
template <bool kVector>
__global__ void __launch_bounds__(kThreads) probe_kernel(const ProbeArgs a) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  using u64 = unsigned long long;
  const uint64_t x = __ldcs(reinterpret_cast<const u64*>(a.h1) + i);
  const uint64_t y = __ldcs(reinterpret_cast<const u64*>(a.h2) + i);
  const uint8_t want = tag_of(y);
  uint64_t pos = splitmix64(x ^ a.seed_mix) & a.mask;
  int32_t found = -1;
  for (int p = 0; p < a.max_probes; ++p) {
    const uint8_t tag = __ldg(a.slot_tag + pos);
    if (tag == 0) break;  // an empty slot
    if (tag == want) {
      uint64_t s1, s2;
      load_key<kVector>(a, pos, s1, s2);
      if (s1 == x && s2 == y) {
        found = (int32_t)pos;
        break;
      }
    }
    pos = (pos + 1) & a.mask;
  }
  __stcs(a.out_slot + i, found);
  __stcs(reinterpret_cast<unsigned char*>(a.out_hit) + i,
         (unsigned char)(found >= 0));
}

template <bool kVector>
int launch(ProbeArgs a, cudaStream_t stream) {
  const int64_t blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe_kernel<kVector><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// slot_tag: one tag byte a slot; slot_keys: interleaved (h1, h2) records,
// 16 bytes a slot. Returns the launch's error code (0 on success).
extern "C" int srt_hashtbl_probe(const void* slot_tag, const void* slot_keys,
                                 const void* h1, const void* h2,
                                 void* out_slot, void* out_hit, int64_t n,
                                 int64_t capacity, uint64_t seed_mix,
                                 int max_probes, void* stream) {
  if (n <= 0) return 0;
  const ProbeArgs a{(const uint8_t*)slot_tag, (const uint64_t*)slot_keys,
                    (const uint64_t*)h1, (const uint64_t*)h2,
                    (int32_t*)out_slot, (uint8_t*)out_hit, n,
                    (uint64_t)(capacity - 1), seed_mix, max_probes};
  cudaStream_t st = (cudaStream_t)stream;
  if (((uintptr_t)slot_keys & 15) == 0) return launch<true>(a, st);
  return launch<false>(a, st);
}

extern "C" const char* srt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
