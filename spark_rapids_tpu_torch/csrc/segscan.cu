// Inclusive segmented scan (add, min or max) for the window operator,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel segmented_scan_pallas
// (spark_rapids_tpu/exec/kernels.py:1990, kernel body
// _pallas_segscan_kernel). Plain version and contract: segmented_scan in
// spark_rapids_tpu_torch/exec/kernels.py; wrapper segmented_scan_kernel.
//
// What it computes: out[i] = v[j] op v[j+1] op ... op v[i], where j is the
// last row <= i whose is_start flag is set (row 0 when there is none). The
// pair (seen-a-head, running value) under the combine
//   (fa, va) . (fb, vb) = (fa | fb, fb ? vb : va op vb)
// is associative, so the scan runs in any grouping. Values are int32,
// int64, float32 or float64. Integer add wraps like torch's cumsum (added
// as unsigned and cast back: signed overflow is undefined in C++). min and
// max propagate NaN like torch.minimum and torch.maximum (fminf/fmaxf would
// drop it).
//
// What bounds it: bytes. Each row reads its value and its one-byte flag and
// writes its value once: (2 * sizeof(value) + 1) bytes a row, at 3.35 TB/s
// on an H100 SXM, one or two operations a row. At the window's sizes (about
// half a million rows, 4.7 MB) that is 1.4 us, less than the fixed cost of
// one launch, so the number of dependent launches, barriers and round
// trips counts as much as the bytes.
//
// What the design does about it: one launch, one pass, a decoupled
// look-back across tiles, and no memset.
//   - A block of 256 threads scans one tile of 4096 rows, 16 a thread, in
//     a striped layout: each lane holds 4 runs of 4 rows, and run j of a
//     warp's 32 lanes is 128 contiguous rows, so a thread loads a run as
//     one int4 (two for 64-bit values) and its 4 flags as one 32-bit word,
//     and every load and store a warp makes covers 512 contiguous bytes.
//     (The blocked layout, a thread's 16 rows contiguous, left each load
//     instruction's 16-byte pieces 64 bytes apart: a plain copy in it took
//     25% longer at 16M rows on an H100, and 1024 threads x 4 rows, as
//     coalesced, held fewer rows in flight around each look-back.) A
//     misaligned view, or the ragged rows of the last tile, take scalar
//     loads and stores in the same kernel.
//   - Tiles take their ids from an atomic counter in the order blocks
//     start, so a block only ever waits on tiles that are already running.
//   - The rows are scanned in registers: each run in its thread, then its
//     thread totals across the lanes with __shfl_up_sync, then the warp's
//     4 runs in order, then the 8 warp totals with the same shuffles by
//     one warp: two __syncthreads a tile, no per-step barrier.
//   - Warp 0 publishes the tile's aggregate, then looks back over the
//     descriptors of the 32 tiles before it at a time (one L2 round trip
//     for 32 tiles), reducing them with shuffles, until it meets a tile's
//     inclusive prefix. A tile that holds a head publishes its aggregate as
//     its inclusive prefix at once, since nothing before a head reaches
//     past it; so the look-back stops at the first head as well. The tile
//     then publishes its own inclusive prefix.
//   - For 32-bit values a descriptor is one 64-bit word (status in the high
//     half, value bits in the low half), written and read whole with
//     relaxed gpu-scope accesses. For 64-bit values the value goes to an
//     aggregate or an inclusive slot first and a status word is then
//     published with release semantics, which the reader acquires.
//   - The scratch (tile counter and descriptors) arrives all zero and is
//     left all zero: each block counts itself done with an acq_rel atomic
//     after its look-back, and the block that counts last, which knows no
//     block will read a descriptor again, zeroes it. The wrapper keeps one
//     such buffer for each stream, so a call needs no memset before its
//     launch (a memset first cost about 1 us at 518,011 rows on an H100).
// n == 0 launches nothing. It allocates nothing, runs on the caller's
// stream and does not synchronise. PERF.md lists the other layouts and
// the memset that were measured against this design; a look-back reading
// 128 tiles a pass (4 a lane) was measured slower at 518,011 and at 16M
// rows as well.
//
// Rounding of float add: on its way into a row a value passes through at
// most 20 adds inside its tile (3 in its run, 5 shuffle steps over the
// lanes, 3 chaining the warp's runs, 3 shuffle steps over the warps, then
// up to 6 prefix folds) and at most one add for each tile it is carried
// across in the look-back chain: 20 + ceil(n / 4096) in all
// (segscan_add_tolerance).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kTile = 4096;  // rows a tile (segscan_add_tolerance uses it)

// A block of kThreads threads scans one tile, kItems rows a thread, in
// runs of kRun rows: run j of the lanes of warp w covers the 128 rows
// w * 32 * kItems + 128 * j ..., so every load and store a warp makes
// covers 512 contiguous bytes (of 4-byte values).
constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kRun = 4;
constexpr int kRuns = kItems / kRun;  // runs a thread
constexpr int kWarps = kThreads / 32;
static_assert(kThreads * kItems == kTile, "a block scans one tile");

// first row (in its tile) of run j of a lane of a warp
__device__ __forceinline__ int run_row(int warp, int lane, int j) {
  return warp * 32 * kItems + j * 32 * kRun + lane * kRun;
}
constexpr int64_t kDescOffset = 128;  // the tile counters live before it
constexpr int64_t kHeaderBytes = 512;
constexpr int64_t kTileBytes = 24;
constexpr unsigned kFull = 0xffffffffu;

enum { kAdd = 0, kMin = 1, kMax = 2 };
enum { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };
enum : uint32_t { kEmpty = 0, kAggregate = 1, kInclusive = 2 };
enum { kVecValues = 1, kVecFlags = 2, kVecOut = 4 };

// a op b, with a the earlier operand
template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  if constexpr (OP == kAdd) {
    if constexpr (std::is_integral<T>::value) {
      using U = typename std::make_unsigned<T>::type;
      return (T)((U)a + (U)b);
    } else {
      return a + b;
    }
  } else if constexpr (OP == kMin) {
    if constexpr (std::is_floating_point<T>::value) {
      if (a != a) return a;
      if (b != b) return b;
    }
    return b < a ? b : a;
  } else {
    if constexpr (std::is_floating_point<T>::value) {
      if (a != a) return a;
      if (b != b) return b;
    }
    return b > a ? b : a;
  }
}

template <typename U, typename T>
__device__ __forceinline__ U bit_cast(T v) {
  static_assert(sizeof(U) == sizeof(T), "bit_cast between sizes");
  U u;
  memcpy(&u, &v, sizeof(U));
  return u;
}

__device__ __forceinline__ void st_relaxed_b64(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed_b64(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_b32(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ uint32_t atomic_add_acq_rel(uint32_t* p,
                                                       uint32_t v) {
  uint32_t old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ uint32_t ld_acquire_b32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Tile descriptors: a status (kEmpty, kAggregate, kInclusive) and a value.
template <typename T, bool kPacked = sizeof(T) == 4>
struct Descriptors;

// 32-bit values: one word a tile, status << 32 | value bits.
template <typename T>
struct Descriptors<T, true> {
  uint64_t* word;

  __device__ __forceinline__ void publish(int64_t tile, uint32_t status,
                                          T v) const {
    st_relaxed_b64(word + tile,
                   (uint64_t)status << 32 | bit_cast<uint32_t>(v));
  }
  __device__ __forceinline__ uint32_t read(int64_t tile, T& v) const {
    const uint64_t w = ld_relaxed_b64(word + tile);
    v = bit_cast<T>((uint32_t)w);
    return (uint32_t)(w >> 32);
  }
};

// 64-bit values: the value in its own slot, then the status with release.
template <typename T>
struct Descriptors<T, false> {
  uint32_t* status;
  uint64_t* aggregate;
  uint64_t* inclusive;

  __device__ __forceinline__ void publish(int64_t tile, uint32_t s,
                                          T v) const {
    uint64_t* slot = (s == kAggregate ? aggregate : inclusive) + tile;
    st_relaxed_b64(slot, bit_cast<uint64_t>(v));
    st_release_b32(status + tile, s);
  }
  __device__ __forceinline__ uint32_t read(int64_t tile, T& v) const {
    const uint32_t s = ld_acquire_b32(status + tile);
    if (s != kEmpty)
      v = bit_cast<T>(ld_relaxed_b64(
          (s == kAggregate ? aggregate : inclusive) + tile));
    return s;
  }
};

// The op-combination of every tile before `tile` back to the nearest
// inclusive prefix, computed by one warp (all lanes return it); lane l
// reads the descriptor l + 1 tiles back, 32 tiles a pass.
template <typename T, int OP>
__device__ __forceinline__ T look_back(const Descriptors<T>& desc,
                                       int64_t tile, int lane) {
  T excl = T(0);
  bool have = false;
  for (int64_t idx = tile - 1 - lane;; idx -= 32) {
    uint32_t s;
    T v;
    for (;;) {
      // lanes before tile 0 lie past the stop (tile 0 is inclusive)
      s = kInclusive;
      v = T(0);
      if (idx >= 0) s = desc.read(idx, v);
      if (!__any_sync(kFull, s == kEmpty)) break;
      __nanosleep(32);
    }
    const unsigned incl = __ballot_sync(kFull, s == kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    // reduce lanes 0..stop; a higher lane is an earlier tile
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T o = __shfl_down_sync(kFull, v, d);
      if ((lane & (2 * d - 1)) == 0 && lane + d <= stop)
        v = apply<T, OP>(o, v);
    }
    const T window = __shfl_sync(kFull, v, 0);
    excl = have ? apply<T, OP>(window, excl) : window;
    have = true;
    if (incl) return excl;
  }
}

// One run's kRun rows; rows at or past `count` read as 0.
template <typename T>
__device__ __forceinline__ void load_values(const T* __restrict__ src,
                                            bool vector, int count,
                                            T (&v)[kRun]) {
  if (vector) {
    constexpr int kVecs = kRun * (int)sizeof(T) / 16;
    union {
      int4 q[kVecs];
      T t[kRun];
    } u;
    const int4* p = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) u.q[j] = p[j];
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = u.t[k];
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = k < count ? src[k] : T(0);
  }
}

// Bit k set: row k of the run is a head; rows past `count` are heads. The
// vector path reads the run's 4 flag bytes as one 32-bit word.
__device__ __forceinline__ uint32_t load_heads(const uint8_t* __restrict__ src,
                                               bool vector, int count) {
  uint32_t heads = 0;
  if (vector) {
    union {
      uint32_t q;
      uint8_t b[kRun];
    } u;
    u.q = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int k = 0; k < kRun; ++k) heads |= (uint32_t)(u.b[k] != 0) << k;
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      heads |= (uint32_t)(k >= count || src[k] != 0) << k;
  }
  return heads;
}

template <typename T>
__device__ __forceinline__ void store_values(T* __restrict__ dst, bool vector,
                                             int count, const T (&v)[kRun]) {
  if (vector) {
    constexpr int kVecs = kRun * (int)sizeof(T) / 16;
    union {
      int4 q[kVecs];
      T t[kRun];
    } u;
#pragma unroll
    for (int k = 0; k < kRun; ++k) u.t[k] = v[k];
    int4* p = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int j = 0; j < kVecs; ++j) p[j] = u.q[j];
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (k < count) dst[k] = v[k];
  }
}

// pre := pre . (f, v), where `have` says whether pre holds anything yet
template <typename T, int OP>
__device__ __forceinline__ void fold(bool& have, T& pre, bool f, T v) {
  pre = (have && !f) ? apply<T, OP>(pre, v) : v;
  have = true;
}

// The scratch arrives all zero, and the last block to finish zeroes it
// again, so no memset precedes the launch.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
segscan_kernel(const T* __restrict__ values,
               const uint8_t* __restrict__ is_start, T* __restrict__ out,
               int64_t n, unsigned int* __restrict__ counters,
               const Descriptors<T> desc, int vec, int64_t clean_vecs) {
  __shared__ unsigned int s_tile;
  __shared__ T s_warp_val[kWarps];
  __shared__ int s_warp_flag[kWarps];
  __shared__ T s_excl;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(counters, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile;
  const int64_t rem = n - base;
  const int valid = rem < kTile ? (int)rem : kTile;

  T v[kRuns][kRun];
  uint32_t heads[kRuns];
  int count[kRuns];  // rows of each run inside the input
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    const int row = run_row(warp, lane, j);
    count[j] = valid - row;
    const bool whole = count[j] >= kRun;
    load_values<T>(values + base + row, whole && (vec & kVecValues),
                   count[j], v[j]);
    heads[j] = load_heads(is_start + base + row, whole && (vec & kVecFlags),
                          count[j]);
  }

  // each run: its rows in the thread, then its thread totals across the
  // lanes (inclusive, and exclusive for the lane), then its warp total
  T lane_v[kRuns], run_v[kRuns];
  int lane_f[kRuns], run_f[kRuns];
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
#pragma unroll
    for (int k = 1; k < kRun; ++k)
      if (!((heads[j] >> k) & 1)) v[j][k] = apply<T, OP>(v[j][k - 1], v[j][k]);
    T wv = v[j][kRun - 1];
    int wf = heads[j] != 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T ov = __shfl_up_sync(kFull, wv, d);
      const int of = __shfl_up_sync(kFull, wf, d);
      if (lane >= d) {
        if (!wf) wv = apply<T, OP>(ov, wv);
        wf |= of;
      }
    }
    lane_v[j] = __shfl_up_sync(kFull, wv, 1);
    lane_f[j] = __shfl_up_sync(kFull, wf, 1);
    run_v[j] = __shfl_sync(kFull, wv, 31);
    run_f[j] = __shfl_sync(kFull, wf, 31);
  }
  if (lane == 0) {  // the warp's total: its runs in order
    T wt = run_v[0];
    int wtf = run_f[0];
#pragma unroll
    for (int j = 1; j < kRuns; ++j) {
      wt = run_f[j] ? run_v[j] : apply<T, OP>(wt, run_v[j]);
      wtf |= run_f[j];
    }
    s_warp_val[warp] = wt;
    s_warp_flag[warp] = wtf;
  }
  __syncthreads();

  if (warp == 0) {
    // the same shuffle scan over the warp totals: warp w's prefix
    // (exclusive) goes back to slot w, the tile's aggregate is the last;
    // lanes past the warps stand for heads after them
    T tv = lane < kWarps ? s_warp_val[lane] : T(0);
    int tf = lane < kWarps ? s_warp_flag[lane] : 1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T ov = __shfl_up_sync(kFull, tv, d);
      const int of = __shfl_up_sync(kFull, tf, d);
      if (lane >= d) {
        if (!tf) tv = apply<T, OP>(ov, tv);
        tf |= of;
      }
    }
    const T ex_v = __shfl_up_sync(kFull, tv, 1);
    const int ex_f = __shfl_up_sync(kFull, tf, 1);
    if (lane < kWarps) {
      s_warp_val[lane] = ex_v;
      s_warp_flag[lane] = ex_f;
    }
    const T agg = __shfl_sync(kFull, tv, kWarps - 1);
    const int agg_f = __shfl_sync(kFull, tf, kWarps - 1);
    if (lane == 0)
      desc.publish(tile, (tile == 0 || agg_f) ? kInclusive : kAggregate, agg);
    if (tile > 0) {
      const T excl = look_back<T, OP>(desc, tile, lane);
      if (lane == 0) {
        s_excl = excl;
        if (!agg_f) desc.publish(tile, kInclusive, apply<T, OP>(excl, agg));
      }
    }
  }
  __syncthreads();

  // prefix of every row before each run's rows: the tiles and warps
  // before, the warp's runs before, the run's lanes before
  bool have = tile > 0;
  T pre = have ? s_excl : T(0);
  if (warp > 0) fold<T, OP>(have, pre, s_warp_flag[warp], s_warp_val[warp]);
#pragma unroll
  for (int j = 0; j < kRuns; ++j) {
    bool h = have;
    T p = pre;
    if (lane > 0) fold<T, OP>(h, p, lane_f[j], lane_v[j]);
    if (h) {
      const int first = heads[j] ? __ffs(heads[j]) - 1 : kRun;
#pragma unroll
      for (int k = 0; k < kRun; ++k)
        if (k < first) v[j][k] = apply<T, OP>(p, v[j][k]);
    }
    fold<T, OP>(have, pre, run_f[j], run_v[j]);
    const int row = run_row(warp, lane, j);
    store_values<T>(out + base + row, count[j] >= kRun && (vec & kVecOut),
                    count[j], v[j]);
  }

  // Warp 0 is past its look-back: this block reads and writes no
  // descriptor again. The block that counts last knows every block is,
  // and zeroes the scratch; the other warps need not wait for the count.
  if (warp == 0) {
    unsigned done = 0;
    if (lane == 0) done = atomic_add_acq_rel(counters + 1, 1u);
    if (__shfl_sync(kFull, done, 0) == gridDim.x - 1) {
      uint4* p = reinterpret_cast<uint4*>(counters);
      for (int64_t i = lane; i < clean_vecs; i += 32)
        p[i] = make_uint4(0, 0, 0, 0);
    }
  }
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename T, int OP>
int launch(const void* values, const void* is_start, void* out, int64_t n,
           char* scratch, cudaStream_t stream) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  Descriptors<T> desc;
  int64_t used;  // scratch bytes the launch writes
  if constexpr (sizeof(T) == 4) {
    desc.word = (uint64_t*)(scratch + kDescOffset);
    used = kDescOffset + 8 * tiles;
  } else {
    desc.status = (uint32_t*)(scratch + kDescOffset);
    const int64_t status_bytes = (4 * tiles + 127) / 128 * 128;
    desc.aggregate = (uint64_t*)(scratch + kDescOffset + status_bytes);
    desc.inclusive = desc.aggregate + tiles;
    used = kDescOffset + status_bytes + 16 * tiles;
  }
  const int vec = (aligned16(values) ? kVecValues : 0) |
                  (aligned16(is_start) ? kVecFlags : 0) |
                  (aligned16(out) ? kVecOut : 0);
  segscan_kernel<T, OP><<<(unsigned int)tiles, kThreads, 0, stream>>>(
      (const T*)values, (const uint8_t*)is_start, (T*)out, n,
      (unsigned int*)scratch, desc, vec, (used + 15) / 16);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const void* values, const void* is_start, void* out,
              int64_t n, char* scratch, cudaStream_t stream) {
  switch (op) {
    case kAdd:
      return launch<T, kAdd>(values, is_start, out, n, scratch, stream);
    case kMin:
      return launch<T, kMin>(values, is_start, out, n, scratch, stream);
    case kMax:
      return launch<T, kMax>(values, is_start, out, n, scratch, stream);
  }
  return (int)cudaErrorInvalidValue;
}

bool scratch_ok(int64_t n, const void* scratch, int64_t scratch_bytes) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  return tiles <= 0x7fffffffLL && aligned16(scratch) &&
         scratch_bytes >= kHeaderBytes + kTileBytes * tiles;
}

}  // namespace

// Rows a tile, and the scratch srt_segscan needs for n rows:
// header + per_tile * ceil(n / tile_rows) bytes, 16-byte aligned.
extern "C" void srt_segscan_scratch_layout(int64_t* tile_rows,
                                           int64_t* header_bytes,
                                           int64_t* per_tile_bytes) {
  *tile_rows = kTile;
  *header_bytes = kHeaderBytes;
  *per_tile_bytes = kTileBytes;
}

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; op: 0 add, 1 min, 2 max.
// The scratch must arrive all zero; it is left all zero. Returns the
// launch's error code (0 on success).
extern "C" int srt_segscan(const void* values, const void* is_start,
                           void* out, int64_t n, int dtype, int op,
                           void* scratch, int64_t scratch_bytes,
                           void* stream) {
  if (n <= 0) return 0;
  if (!scratch_ok(n, scratch, scratch_bytes))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  char* s = (char*)scratch;
  switch (dtype) {
    case kInt32:
      return launch_op<int32_t>(op, values, is_start, out, n, s, st);
    case kInt64:
      return launch_op<int64_t>(op, values, is_start, out, n, s, st);
    case kFloat32:
      return launch_op<float>(op, values, is_start, out, n, s, st);
    case kFloat64:
      return launch_op<double>(op, values, is_start, out, n, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* srt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
