// Compressed-chunk decode kernels for Hopper (sm_90a): the device half of
// the storage reader. Each turns one encoded chunk member, copied to the
// card at its stored width, into the chunk's int64 rows (floats travel as
// their int64 bit patterns), written straight into the chunk's slice of
// the device column. All four are exact integer work: no float math, no
// atomics, the same bits in any launch order.
//
// rle_expand replaces src/repro/kernels/decode.py · rle_expand_pallas:
//   out[i] = values[j] for the run j covering row i. The Pallas kernel
//   took run starts and ends made on the host and compared every output
//   row with every run in dense one-hot tiles (O(n*r)). Here the stored
//   run lengths cross to the card at their width (int32) and an
//   exclusive scan of them (the three passes of delta_unpack) writes the
//   run starts to scratch memory. Then output rows go to threads: a
//   block owns a tile of 1024 rows, one thread finds the runs that cover
//   the tile with two binary searches over the starts, the block stages
//   those runs' starts and values in shared memory (a tile meets at most
//   1024 runs, since every run has at least one row), and each thread
//   finds its rows' runs by a binary search in shared memory. A constant
//   column (one run of 2^20 rows) and a label column (runs of 1-7 rows)
//   cost the same per row.
// delta_unpack replaces decode.py · delta_unpack_pallas:
//   out = first + inclusive prefix sum of unzigzag(z), modulo 2^64.
//   The Pallas kernel carried the running total through a sequential
//   grid. Blocks run in no order here, so the scan has three passes:
//   per-tile sums, one block that scans the tile sums from `first`, and
//   a per-tile block scan that adds its tile's offset. uint64 adds are
//   associative modulo 2^64, so every order gives the same bits. `z` is
//   read at its stored width (1, 2, 4 or 8 bytes) and widened in
//   registers.
// bitunpack replaces decode.py · bitunpack_pallas:
//   out[i] = ((words[i / vpw] >> ((i % vpw) * k)) & (2^k - 1)) + lo,
//   one thread per output row (values never straddle a word).
// dict_gather replaces decode.py · dict_gather_pallas:
//   out[i] = values[codes[i]], 0 for a code outside [0, r). The Pallas
//   kernel compared every row with every dictionary entry; here it is
//   one load per row, from shared memory when the dictionary fits in
//   32 KB (one chunk's distinct values; qty has 49), else through the
//   read-only cache. Codes are read at their stored width.
//
// What bounds them on the card: bytes. Each must read its members once
// at their stored widths and write 8 bytes per output row; the one-byte
// members of the TPC-H chunks make the int64 output write most of the
// traffic (delta_unpack also reads z a second time in its third pass,
// rle_expand its lengths twice and its starts once more).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RLE_THREADS = 256;
constexpr int RLE_ITEMS = 4;
constexpr int RLE_TILE = RLE_THREADS * RLE_ITEMS;

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int CARRY_THREADS = 1024;

constexpr int GATHER_THREADS = 256;
constexpr int DICT_SMEM_MAX = 4096;  // entries: 32 KB of int64

// first index in [lo, hi) whose key is > x (or hi)
__device__ __forceinline__ int64_t search_above(const int64_t* __restrict__ a,
                                               int64_t lo, int64_t hi,
                                               int64_t x) {
  while (lo < hi) {
    int64_t m = lo + ((hi - lo) >> 1);
    if (a[m] <= x) lo = m + 1; else hi = m;
  }
  return lo;
}

// first index in [lo, hi) whose key is >= x (or hi)
__device__ __forceinline__ int64_t search_from(const int64_t* __restrict__ a,
                                               int64_t lo, int64_t hi,
                                               int64_t x) {
  while (lo < hi) {
    int64_t m = lo + ((hi - lo) >> 1);
    if (a[m] < x) lo = m + 1; else hi = m;
  }
  return lo;
}

__global__ void __launch_bounds__(RLE_THREADS)
rle_expand_kernel(const int64_t* __restrict__ values,
                  const int64_t* __restrict__ starts, int64_t r, int64_t n,
                  int64_t* __restrict__ out) {
  __shared__ int64_t s_start[RLE_TILE];
  __shared__ int64_t s_val[RLE_TILE];
  __shared__ int64_t s_first, s_count;
  const int64_t tile0 = (int64_t)blockIdx.x * RLE_TILE;
  const int64_t tile1 = tile0 + RLE_TILE < n ? tile0 + RLE_TILE : n;
  if (threadIdx.x == 0) {
    // the run covering tile0, and the first run that starts at or after
    // tile1: the tile's rows lie in runs [j0, j1)
    int64_t j0 = search_above(starts, 0, r, tile0) - 1;
    if (j0 < 0) j0 = 0;
    int64_t j1 = search_from(starts, j0 + 1, r, tile1);
    int64_t count = j1 - j0;
    if (count > RLE_TILE) count = RLE_TILE;  // only if runs of length 0
    s_first = j0;
    s_count = count;
  }
  __syncthreads();
  const int64_t j0 = s_first;
  const int count = (int)s_count;
  for (int t = threadIdx.x; t < count; t += RLE_THREADS) {
    s_start[t] = starts[j0 + t];
    s_val[t] = values[j0 + t];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) {
    const int64_t i = tile0 + k * RLE_THREADS + threadIdx.x;
    if (i < tile1) {
      int a = 0, b = count;  // last staged run with start <= i
      while (a < b) {
        int m = (a + b) >> 1;
        if (s_start[m] <= i) a = m + 1; else b = m;
      }
      out[i] = s_val[a > 0 ? a - 1 : 0];
    }
  }
}

// a stored member widened to the uint64 that the scan adds: delta's
// zigzag codes decoded, rle's run lengths (at least 1) as they are
struct Unzigzag {
  template <typename T>
  __device__ __forceinline__ uint64_t operator()(T z) const {
    const uint64_t u = (uint64_t)z;
    return (u >> 1) ^ (0ull - (u & 1ull));
  }
};

struct Widen {
  __device__ __forceinline__ uint64_t operator()(int32_t z) const {
    return (uint64_t)(int64_t)z;
  }
};

__device__ __forceinline__ uint64_t warp_inclusive(uint64_t v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    uint64_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// inclusive scan over the block (THREADS a multiple of 32, at most 1024);
// s_warp holds THREADS / 32 entries. Every thread must call it.
template <int THREADS>
__device__ __forceinline__ uint64_t block_inclusive(uint64_t v,
                                                    uint64_t* s_warp) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint64_t inc = warp_inclusive(v);
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    uint64_t w = lane < WARPS ? s_warp[lane] : 0ull;
    w = warp_inclusive(w);
    if (lane < WARPS) s_warp[lane] = w;
  }
  __syncthreads();
  const uint64_t res = inc + (warp > 0 ? s_warp[warp - 1] : 0ull);
  __syncthreads();  // s_warp may be reused by the caller
  return res;
}

template <typename T, typename F>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tile_sums(const T* __restrict__ z, int64_t n,
               uint64_t* __restrict__ tile_sums) {
  __shared__ uint64_t s_warp[SCAN_THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
  uint64_t s = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int64_t i = base + k * SCAN_THREADS + threadIdx.x;
    if (i < n) s += F()(z[i]);
  }
  s = block_inclusive<SCAN_THREADS>(s, s_warp);
  if (threadIdx.x == SCAN_THREADS - 1) tile_sums[blockIdx.x] = s;
}

// one block: tile_sums[t] <- first + sum of tile_sums[0 .. t), in place
__global__ void __launch_bounds__(CARRY_THREADS)
scan_tile_offsets(uint64_t* __restrict__ tile_sums, int64_t tiles,
                  uint64_t first) {
  __shared__ uint64_t s_warp[CARRY_THREADS / 32];
  uint64_t carry = first;
  for (int64_t base = 0; base < tiles; base += CARRY_THREADS) {
    const int64_t i = base + threadIdx.x;
    const uint64_t v = i < tiles ? tile_sums[i] : 0ull;
    const uint64_t inc = block_inclusive<CARRY_THREADS>(v, s_warp);
    if (i < tiles) tile_sums[i] = carry + inc - v;
    // the block total, from the last thread, via shared memory
    if (threadIdx.x == CARRY_THREADS - 1) s_warp[0] = inc;
    __syncthreads();
    carry += s_warp[0];
    __syncthreads();
  }
}

// out[i] = tile offset + the tile's sum of F(z) up to row i, inclusive
// (delta_unpack) or exclusive (rle_expand's run starts)
template <typename T, typename F, bool EXCLUSIVE>
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(const T* __restrict__ z, int64_t n,
           const uint64_t* __restrict__ tile_offsets,
           int64_t* __restrict__ out) {
  __shared__ uint64_t s_data[SCAN_TILE];
  __shared__ uint64_t s_warp[SCAN_THREADS / 32];
  const int64_t base = (int64_t)blockIdx.x * SCAN_TILE;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {  // coalesced load, widened
    const int idx = k * SCAN_THREADS + threadIdx.x;
    const int64_t i = base + idx;
    s_data[idx] = i < n ? F()(z[i]) : 0ull;
  }
  __syncthreads();
  uint64_t run = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k)  // this thread's consecutive rows
    run += s_data[threadIdx.x * SCAN_ITEMS + k];
  const uint64_t inc = block_inclusive<SCAN_THREADS>(run, s_warp);
  uint64_t acc = tile_offsets[blockIdx.x] + (inc - run);
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {  // again, now from the offset
    const uint64_t v = s_data[threadIdx.x * SCAN_ITEMS + k];
    if constexpr (EXCLUSIVE) {
      s_data[threadIdx.x * SCAN_ITEMS + k] = acc;
      acc += v;
    } else {
      acc += v;
      s_data[threadIdx.x * SCAN_ITEMS + k] = acc;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {  // coalesced store
    const int idx = k * SCAN_THREADS + threadIdx.x;
    const int64_t i = base + idx;
    if (i < n) out[i] = (int64_t)s_data[idx];
  }
}

__global__ void bitunpack_kernel(const uint32_t* __restrict__ words, int k,
                                 int vpw, int64_t n, uint64_t lo,
                                 int64_t* __restrict__ out) {
  const uint32_t mask = k >= 32 ? 0xffffffffu : ((1u << k) - 1u);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t w = i / vpw;
    const int pos = (int)(i - w * vpw);
    const uint32_t v = (__ldg(words + w) >> (pos * k)) & mask;
    out[i] = (int64_t)((uint64_t)v + lo);  // wraps as int64 addition does
  }
}

template <typename C>
__global__ void dict_gather_kernel(const int64_t* __restrict__ values,
                                   int64_t r, const C* __restrict__ codes,
                                   int64_t n, int64_t* __restrict__ out,
                                   int staged) {
  extern __shared__ int64_t s_vals[];
  const int64_t* dict = values;
  if (staged) {  // uniform across the block
    for (int t = threadIdx.x; t < r; t += blockDim.x) s_vals[t] = values[t];
    __syncthreads();
    dict = s_vals;
  }
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t c = (int64_t)codes[i];
    out[i] = (c >= 0 && c < r) ? (staged ? dict[c] : __ldg(values + c)) : 0;
  }
}

int grid_for(int64_t work, int threads, int64_t cap) {
  int64_t b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > cap) b = cap;  // grid-stride loops cover the rest
  return (int)b;
}

// the three passes over n stored values; tiles_buf holds ceil(n / 2048)
// uint64 of scratch
template <typename T, typename F, bool EXCLUSIVE>
void scan_launch(const void* z, int64_t n, uint64_t first, void* tiles_buf,
                 int64_t* out, cudaStream_t stream) {
  const int64_t tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  uint64_t* sums = (uint64_t*)tiles_buf;
  scan_tile_sums<T, F><<<(unsigned)tiles, SCAN_THREADS, 0, stream>>>(
      (const T*)z, n, sums);
  scan_tile_offsets<<<1, CARRY_THREADS, 0, stream>>>(sums, tiles, first);
  scan_tiles<T, F, EXCLUSIVE><<<(unsigned)tiles, SCAN_THREADS, 0, stream>>>(
      (const T*)z, n, sums, out);
}

template <typename T>
void delta_launch(const void* z, int64_t n, uint64_t first, void* tiles_buf,
                  void* out, cudaStream_t stream) {
  scan_launch<T, Unzigzag, false>(z, n, first, tiles_buf, (int64_t*)out,
                                  stream);
}

template <typename C>
void dict_launch(const void* values, int64_t r, const void* codes,
                 int64_t n, void* out, cudaStream_t stream) {
  const int staged = r <= DICT_SMEM_MAX ? 1 : 0;
  const size_t smem = staged ? (size_t)r * sizeof(int64_t) : 0;
  dict_gather_kernel<C><<<grid_for(n, GATHER_THREADS, 132 * 16),
                          GATHER_THREADS, smem, stream>>>(
      (const int64_t*)values, r, (const C*)codes, n, (int64_t*)out, staged);
}

}  // namespace

// lengths: int32, as stored; scratch holds r + ceil(r / 2048) int64 (the
// run starts, then the scan's tiles)
extern "C" int rle_expand_launch(const void* values, const void* lengths,
                                 int64_t r, int64_t n, void* scratch,
                                 void* out, void* stream) {
  if (n > 0 && r > 0) {
    int64_t* starts = (int64_t*)scratch;
    cudaStream_t s = (cudaStream_t)stream;
    scan_launch<int32_t, Widen, true>(lengths, r, 0ull, starts + r, starts,
                                      s);
    const int64_t blocks = (n + RLE_TILE - 1) / RLE_TILE;
    rle_expand_kernel<<<(unsigned)blocks, RLE_THREADS, 0, s>>>(
        (const int64_t*)values, starts, r, n, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

// width: bytes per stored delta (1, 2, 4 or 8); tiles_buf holds
// ceil(n / 2048) uint64 of scratch
extern "C" int delta_unpack_launch(const void* z, int width, int64_t n,
                                   uint64_t first, void* tiles_buf, void* out,
                                   void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (width) {
      case 1: delta_launch<uint8_t>(z, n, first, tiles_buf, out, s); break;
      case 2: delta_launch<uint16_t>(z, n, first, tiles_buf, out, s); break;
      case 4: delta_launch<uint32_t>(z, n, first, tiles_buf, out, s); break;
      case 8: delta_launch<uint64_t>(z, n, first, tiles_buf, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int bitunpack_launch(const void* words, int k, int vpw, int64_t n,
                                uint64_t lo, void* out, void* stream) {
  if (k < 1 || k > 32 || vpw < 1 || (int64_t)vpw * k > 32)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    bitunpack_kernel<<<grid_for(n, GATHER_THREADS, 132 * 32),
                       GATHER_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, k, vpw, n, lo, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}

// code_kind: 1 = uint8, 2 = uint16, 4 = uint32, -4 = int32
extern "C" int dict_gather_launch(const void* values, int64_t r,
                                  const void* codes, int code_kind,
                                  int64_t n, void* out, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (code_kind) {
      case 1: dict_launch<uint8_t>(values, r, codes, n, out, s); break;
      case 2: dict_launch<uint16_t>(values, r, codes, n, out, s); break;
      case 4: dict_launch<uint32_t>(values, r, codes, n, out, s); break;
      case -4: dict_launch<int32_t>(values, r, codes, n, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
