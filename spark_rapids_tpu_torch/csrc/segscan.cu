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
// int64, float32 or float64 (the TPU kept 64-bit lanes off its kernel only
// because Pallas on a TPU has no 64-bit lanes). Integer add wraps like
// torch's cumsum (added as unsigned and cast back: signed overflow is
// undefined in C++). min and max propagate NaN like torch.minimum and
// torch.maximum (fminf/fmaxf would drop it).
//
// What bounds it: bytes. Each row reads its value and its one-byte flag and
// writes its value once: (2 * sizeof(value) + 1) bytes a row, at 3.35 TB/s
// on an H100 SXM. There are one or two operations a row.
//
// What the design does about it (simple and right first; a single-pass
// decoupled look-back scan is later work):
//   1. tile_scan: one block of 256 threads scans a tile of 1024 rows. The
//      tile is staged through shared memory so global loads and stores are
//      coalesced; each thread scans its 4 contiguous rows sequentially, a
//      Hillis-Steele scan over the 256 thread summaries in shared memory
//      gives each thread its in-tile prefix, and the block writes its tile
//      summary (saw-a-head, value) and the tile-relative row of its first
//      head. Rows are read and written once.
//   2. summary_scan: one block scans the tile summaries in chunks of 1024
//      with a running carry (about a thousandth of the rows).
//   3. carry_fixup: for every tile after the first, the rows before the
//      tile's first head take op(carry, value), where carry is the scanned
//      summary of the tiles before it. Only those rows are read again.
// The ragged last tile is masked; no padding is needed, and n == 0
// launches nothing. Everything launches on the caller's stream, allocates
// nothing (the wrapper passes scratch of srt_segscan_scratch_bytes) and
// does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kSumThreads = 1024;

enum { kAdd = 0, kMin = 1, kMax = 2 };
enum { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

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

// In-place inclusive Hillis-Steele scan of (flag, value) pairs held in
// shared memory, double-buffered; returns the buffer holding the result.
template <typename T, int OP, int N>
__device__ __forceinline__ int block_pair_scan(T (*sv)[N], uint8_t (*sf)[N],
                                               int tid) {
  int cur = 0;
#pragma unroll 1
  for (int d = 1; d < N; d <<= 1) {
    T v = sv[cur][tid];
    uint8_t f = sf[cur][tid];
    if (tid >= d) {
      if (!f) v = apply<T, OP>(sv[cur][tid - d], v);
      f |= sf[cur][tid - d];
    }
    sv[cur ^ 1][tid] = v;
    sf[cur ^ 1][tid] = f;
    __syncthreads();
    cur ^= 1;
  }
  return cur;
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
tile_scan(const T* __restrict__ values, const uint8_t* __restrict__ is_start,
          T* __restrict__ out, int64_t n, T* __restrict__ tile_val,
          uint8_t* __restrict__ tile_flag, int32_t* __restrict__ first_head) {
  __shared__ T s_val[kTile];
  __shared__ uint8_t s_flag[kTile];
  __shared__ T s_sv[2][kThreads];
  __shared__ uint8_t s_sf[2][kThreads];
  __shared__ int32_t s_first;

  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  const int64_t rem = n - base;
  const int valid = rem < kTile ? (int)rem : kTile;
  if (tid == 0) s_first = kTile;

  // coalesced load into shared memory; rows past n become heads
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = k * kThreads + tid;
    if (r < valid) {
      s_val[r] = values[base + r];
      s_flag[r] = is_start[base + r] != 0;
    } else {
      s_val[r] = T(0);
      s_flag[r] = 1;
    }
  }
  __syncthreads();

  // sequential scan of this thread's 4 contiguous rows
  T local[kItems];
  uint8_t lflag[kItems];
  int my_first = kTile;
  {
    const int r0 = tid * kItems;
    T acc = s_val[r0];
    uint8_t f = s_flag[r0];
    local[0] = acc;
    lflag[0] = f;
    if (f) my_first = r0;
#pragma unroll
    for (int k = 1; k < kItems; ++k) {
      const T v = s_val[r0 + k];
      const uint8_t fk = s_flag[r0 + k];
      acc = fk ? v : apply<T, OP>(acc, v);
      f |= fk;
      if (fk && my_first == kTile) my_first = r0 + k;
      local[k] = acc;
      lflag[k] = f;
    }
    s_sv[0][tid] = acc;
    s_sf[0][tid] = f;
  }
  if (my_first < kTile) atomicMin(&s_first, my_first);
  __syncthreads();

  const int cur = block_pair_scan<T, OP, kThreads>(s_sv, s_sf, tid);

  // apply the in-tile prefix of the threads before this one
  if (tid > 0) {
    const T prefix = s_sv[cur][tid - 1];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!lflag[k]) local[k] = apply<T, OP>(prefix, local[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) s_val[tid * kItems + k] = local[k];
  __syncthreads();

#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int r = k * kThreads + tid;
    if (r < valid) out[base + r] = s_val[r];
  }
  if (tid == kThreads - 1) {
    tile_val[blockIdx.x] = s_sv[cur][tid];
    tile_flag[blockIdx.x] = s_sf[cur][tid];
    first_head[blockIdx.x] = s_first;
  }
}

// Inclusive scan of the tile summaries' values, in place, by one block
// (the scanned flags are not needed after it).
template <typename T, int OP>
__global__ void __launch_bounds__(kSumThreads)
summary_scan(T* __restrict__ tile_val, uint8_t* __restrict__ tile_flag,
             int64_t n_tiles) {
  __shared__ T s_sv[2][kSumThreads];
  __shared__ uint8_t s_sf[2][kSumThreads];
  const int tid = threadIdx.x;
  T carry = T(0);
  bool have_carry = false;
  for (int64_t c = 0; c < n_tiles; c += kSumThreads) {
    const int64_t i = c + tid;
    if (i < n_tiles) {
      s_sv[0][tid] = tile_val[i];
      s_sf[0][tid] = tile_flag[i];
    } else {
      s_sv[0][tid] = T(0);
      s_sf[0][tid] = 1;
    }
    __syncthreads();
    const int cur = block_pair_scan<T, OP, kSumThreads>(s_sv, s_sf, tid);
    T v = s_sv[cur][tid];
    if (have_carry && !s_sf[cur][tid]) v = apply<T, OP>(carry, v);
    if (i < n_tiles) tile_val[i] = v;
    // the chunk's last entry, carried into the next chunk
    T last = s_sv[cur][kSumThreads - 1];
    if (have_carry && !s_sf[cur][kSumThreads - 1])
      last = apply<T, OP>(carry, last);
    carry = last;
    have_carry = true;
    __syncthreads();  // the buffers are reloaded by the next chunk
  }
}

// Rows of tile b (b >= 1) before its first head take the carry of tiles
// 0..b-1.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
carry_fixup(T* __restrict__ out, int64_t n, const T* __restrict__ tile_val,
            const int32_t* __restrict__ first_head) {
  const int64_t b = (int64_t)blockIdx.x + 1;
  const int64_t base = b * kTile;
  const int64_t rem = n - base;
  const int valid = rem < kTile ? (int)rem : kTile;
  const int stop = first_head[b] < valid ? first_head[b] : valid;
  const T carry = tile_val[b - 1];
  for (int r = threadIdx.x; r < stop; r += kThreads)
    out[base + r] = apply<T, OP>(carry, out[base + r]);
}

inline int64_t align_up(int64_t x) { return (x + 255) / 256 * 256; }

int64_t n_tiles_of(int64_t n) { return (n + kTile - 1) / kTile; }

template <typename T, int OP>
int launch(const void* values, const void* is_start, void* out, int64_t n,
           void* scratch, cudaStream_t stream) {
  const int64_t tiles = n_tiles_of(n);
  char* s = (char*)scratch;
  T* tile_val = (T*)s;
  int32_t* first_head = (int32_t*)(s + align_up(tiles * 8));
  uint8_t* tile_flag = (uint8_t*)(s + align_up(tiles * 8) +
                                  align_up(tiles * 4));
  tile_scan<T, OP><<<(unsigned int)tiles, kThreads, 0, stream>>>(
      (const T*)values, (const uint8_t*)is_start, (T*)out, n, tile_val,
      tile_flag, first_head);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  summary_scan<T, OP><<<1, kSumThreads, 0, stream>>>(tile_val, tile_flag,
                                                      tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  carry_fixup<T, OP><<<(unsigned int)(tiles - 1), kThreads, 0, stream>>>(
      (T*)out, n, tile_val, first_head);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const void* values, const void* is_start, void* out,
              int64_t n, void* scratch, cudaStream_t stream) {
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

}  // namespace

// Bytes of scratch srt_segscan needs for n rows (any dtype).
extern "C" int64_t srt_segscan_scratch_bytes(int64_t n) {
  const int64_t tiles = n_tiles_of(n > 0 ? n : 1);
  return align_up(tiles * 8) + align_up(tiles * 4) + align_up(tiles);
}

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; op: 0 add, 1 min, 2 max.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int srt_segscan(const void* values, const void* is_start,
                           void* out, int64_t n, int dtype, int op,
                           void* scratch, void* stream) {
  if (n <= 0) return 0;
  if ((n + kTile - 1) / kTile > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kInt32:
      return launch_op<int32_t>(op, values, is_start, out, n, scratch, st);
    case kInt64:
      return launch_op<int64_t>(op, values, is_start, out, n, scratch, st);
    case kFloat32:
      return launch_op<float>(op, values, is_start, out, n, scratch, st);
    case kFloat64:
      return launch_op<double>(op, values, is_start, out, n, scratch, st);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* srt_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
