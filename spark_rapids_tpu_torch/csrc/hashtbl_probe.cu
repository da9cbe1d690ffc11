// Hash-table probe for the general hash join, written for Hopper (sm_90a).
//
// Replaces the TPU kernel probe_hash_table_pallas
// (spark_rapids_tpu/exec/kernels.py, kernel body _pallas_probe_kernel).
// Plain version and contract: probe_hash_table in
// spark_rapids_tpu_torch/exec/kernels.py.
//
// What it computes: for each probe row i, start at the home slot
// splitmix64(h1[i] ^ seed_mix) & (capacity - 1) and walk at most max_probes
// slots of the open-addressing table. The first slot whose (slot_h1,
// slot_h2) equals (h1[i], h2[i]) is the answer; an empty slot or the end of
// the walk gives -1.
//
// What bounds it: bytes. Each probe row reads 16 B of hashes and writes a
// 4 B slot. Of the table it needs the used byte of every slot and the two
// 64-bit hash words (16 B) of the used slots only, since a slot's words are
// read only when its used byte is set: 20 B a probe row, 1 B a slot and
// 16 B a stored key, each moved once. There is no arithmetic to speak of,
// and every table read is a data-dependent gather.
//
// What the design does about it: one thread per probe row, 256 threads a
// block, so neighbouring threads read neighbouring probe hashes and write
// neighbouring slots (coalesced 8 B and 4 B accesses). The home slot is
// computed here from h1 and the seed, which saves the reference's separate
// int32 base array (4 B a row in and out). Table words are native 64-bit
// (no 32-bit word split as on the TPU), and the walk checks the used byte
// first and stops at the first empty slot or match, so a miss in a table at
// load <= 0.5 costs about one or two slot reads. The table of a TPC-H join
// build (about 18 MB at 2^20 slots) fits the 50 MB L2, so its random reads
// are mostly served from L2 after the first touch. It allocates nothing,
// launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void __launch_bounds__(256)
hashtbl_probe_kernel(const uint8_t* __restrict__ slot_used,
                     const uint64_t* __restrict__ slot_h1,
                     const uint64_t* __restrict__ slot_h2,
                     const uint64_t* __restrict__ h1,
                     const uint64_t* __restrict__ h2,
                     int32_t* __restrict__ out_slot, int64_t n,
                     uint64_t mask, uint64_t seed_mix, int max_probes) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint64_t a = h1[i];
  const uint64_t b = h2[i];
  const uint64_t base = splitmix64(a ^ seed_mix) & mask;
  int32_t found = -1;
  for (int p = 0; p < max_probes; ++p) {
    const uint64_t pos = (base + (uint64_t)p) & mask;
    if (!slot_used[pos]) break;
    if (slot_h1[pos] == a && slot_h2[pos] == b) {
      found = (int32_t)pos;
      break;
    }
  }
  out_slot[i] = found;
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int srt_hashtbl_probe(const void* slot_used, const void* slot_h1,
                                 const void* slot_h2, const void* h1,
                                 const void* h2, void* out_slot, int64_t n,
                                 int64_t capacity, uint64_t seed_mix,
                                 int max_probes, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  hashtbl_probe_kernel<<<(unsigned int)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)slot_used, (const uint64_t*)slot_h1,
      (const uint64_t*)slot_h2, (const uint64_t*)h1, (const uint64_t*)h2,
      (int32_t*)out_slot, n, (uint64_t)(capacity - 1), seed_mix, max_probes);
  return (int)cudaGetLastError();
}

extern "C" const char* srt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
