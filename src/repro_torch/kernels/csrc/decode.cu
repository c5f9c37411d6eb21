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
//   run lengths cross to the card at their width (int32), and a call is
//   one memset and two kernels:
//   - rle_scan_kernel: a single-pass scan of the lengths into the run
//     starts, with decoupled look-back (Merrill and Garland, 2016). A
//     block takes the next tile of RLE_SCAN_TILE runs from a ticket
//     counter, so a tile waits only on tiles already started; it scans
//     its tile, publishes its sum, and warp 0 looks back over the tiles
//     before it, 32 * RLE_LOOK at a time, adding sums back to the
//     nearest tile that has published its inclusive prefix; then it
//     publishes its own. A status word is sum << 2 | flag (sums below
//     2^61, hence r < 2^30): one word carries all that it publishes, so
//     its loads and stores are relaxed ones at the card's scope (acquire
//     and release would order nothing that the word does not hold, and
//     timed slower). The block writes its runs' starts and, for each row
//     tile of RLE_ROWS rows whose first row its runs cover, that tile's
//     first run: a binary search over the staged starts, the row tiles
//     spread over the block's threads, so that a run of 2^20 rows costs
//     the block 1024 short searches, 4 a thread.
//     The status words and the counter are cleared by one
//     cudaMemsetAsync before it.
//   - rle_expand_kernel: a block a row tile stages the runs from its
//     first run to the next tile's (at most RLE_ROWS + 1 runs, every run
//     having a row) in shared memory; each thread finds the run of its
//     first row by one binary search there and walks forward over its
//     RLE_ITEMS consecutive rows; the tile goes out through shared memory
//     in coalesced stores, 16 bytes where out is 16-byte aligned. A
//     constant column (one run of 2^20 rows) and a label column (runs of
//     1-7 rows) spread alike over every block.
//   What holds it back at a 2^20-row chunk is not bytes but the two
//   kernels' dependent steps (the ticket, the lengths, the block scan,
//   the look-back, then the staged window) and the memset: chip_smoke.py
//   prints each operation's device time at D0's chunk and at a chunk of
//   one run. Tried and dropped (a script kept out of the tree): one kernel
//   whose later tickets expand row tiles once every scan tile is done
//   (its waiting blocks slowed the scan), a launch of the expansion as a
//   programmatic dependent of the scan, wider and narrower tiles, and
//   an expansion that rescans the lengths instead of reading starts.
//   Lengths below 1 break the contract: the result is then unspecified,
//   but every index stays inside its array.
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
// rle_expand its starts once more).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RLE_SCAN_THREADS = 256;
constexpr int RLE_SCAN_ITEMS = 8;
constexpr int RLE_SCAN_TILE = RLE_SCAN_THREADS * RLE_SCAN_ITEMS;  // runs
constexpr int RLE_THREADS = 256;
constexpr int RLE_ITEMS = 4;
constexpr int RLE_ROWS = RLE_THREADS * RLE_ITEMS;  // rows an expand tile
constexpr int RLE_LOOK = 4;  // tiles a lane reads in a look-back window
constexpr uint64_t RLE_AGGREGATE = 1, RLE_PREFIX = 2;  // status flags

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int CARRY_THREADS = 1024;

constexpr int GATHER_THREADS = 256;
constexpr int DICT_SMEM_MAX = 4096;  // entries: 32 KB of int64

// a stored member widened to the uint64 that the scan adds: delta's
// zigzag codes decoded
struct Unzigzag {
  template <typename T>
  __device__ __forceinline__ uint64_t operator()(T z) const {
    const uint64_t u = (uint64_t)z;
    return (u >> 1) ^ (0ull - (u & 1ull));
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
// (delta_unpack) or exclusive (set by no caller)
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

// A status word carries all that it publishes (its flag and its sum), so
// relaxed loads and stores at the card's scope are enough: no other
// memory is ordered by them.
__device__ __forceinline__ void st_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ uint64_t ld_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// the sum that a status word carries (sum << 2 | flag)
__device__ __forceinline__ int64_t status_sum(uint64_t w) {
  return (int64_t)w >> 2;
}

// One tile of RLE_SCAN_TILE runs a block, in the order of the ticket
// counter: the runs' starts (the exclusive prefix sum of the lengths),
// and tile_run[b] for each row tile b whose first row b * RLE_ROWS lies
// in the tile's rows (the last tile: every row from its first on).
__global__ void __launch_bounds__(RLE_SCAN_THREADS)
rle_scan_kernel(const int32_t* __restrict__ lengths, int64_t r, int64_t nb,
                uint64_t* status, unsigned* ticket,
                int64_t* __restrict__ starts, int64_t* __restrict__ tile_run) {
  constexpr int WARPS = RLE_SCAN_THREADS / 32;
  __shared__ int64_t s_run[RLE_SCAN_TILE];
  __shared__ uint64_t s_warp[WARPS];
  __shared__ int64_t s_tile, s_excl;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t j0 = t * RLE_SCAN_TILE;
  const int cnt = (int)min((int64_t)RLE_SCAN_TILE, r - j0);
#pragma unroll
  for (int k = 0; k < RLE_SCAN_ITEMS; ++k) {  // coalesced load, widened
    const int x = k * RLE_SCAN_THREADS + threadIdx.x;
    s_run[x] = x < cnt ? (int64_t)lengths[j0 + x] : 0;
  }
  __syncthreads();
  int64_t run = 0;
#pragma unroll
  for (int k = 0; k < RLE_SCAN_ITEMS; ++k)  // this thread's consecutive runs
    run += s_run[threadIdx.x * RLE_SCAN_ITEMS + k];
  const int64_t inc =
      (int64_t)block_inclusive<RLE_SCAN_THREADS>((uint64_t)run, s_warp);
  const int64_t total = (int64_t)s_warp[WARPS - 1];
  if (threadIdx.x < 32) {
    // warp 0: publish the tile's sum, look back, publish its prefix
    const int lane = threadIdx.x;
    int64_t excl = 0;
    if (t == 0) {
      if (lane == 0) st_status(status, ((uint64_t)total << 2) | RLE_PREFIX);
    } else {
      if (lane == 0)
        st_status(status + t, ((uint64_t)total << 2) | RLE_AGGREGATE);
      // windows of 32 * RLE_LOOK tiles back from t - 1: lane l reads
      // tiles top - l, top - 32 - l, ...; all of a window's loads are in
      // flight at once
      for (int64_t top = t - 1;; top -= 32 * RLE_LOOK) {
        uint64_t w[RLE_LOOK];
        bool wait;
        do {
          wait = false;
#pragma unroll
          for (int k = 0; k < RLE_LOOK; ++k) {
            const int64_t q = top - 32 * k - lane;  // before tile 0: a
            w[k] = q >= 0 ? ld_status(status + q)   // prefix of 0
                          : RLE_PREFIX;
            wait |= (w[k] & 3) == 0;
          }
        } while (__any_sync(0xffffffffu, wait));
        // the sums of the tiles down to the nearest prefix, that included
        int64_t v = 0;
        bool found = false;  // the same in every lane
#pragma unroll
        for (int k = 0; k < RLE_LOOK; ++k) {
          const unsigned pre =
              __ballot_sync(0xffffffffu, (w[k] & 3) == RLE_PREFIX);
          if (!found && (pre == 0 || lane < __ffs(pre)))
            v += status_sum(w[k]);
          found |= pre != 0;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (found) break;
      }
      if (lane == 0)
        st_status(status + t, ((uint64_t)(excl + total) << 2) | RLE_PREFIX);
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  const int64_t excl = s_excl;
  int64_t acc = excl + (inc - run);
#pragma unroll
  for (int k = 0; k < RLE_SCAN_ITEMS; ++k) {  // lengths -> starts
    const int x = threadIdx.x * RLE_SCAN_ITEMS + k;
    const int64_t len = s_run[x];
    s_run[x] = acc;
    acc += len;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < RLE_SCAN_ITEMS; ++k) {  // coalesced store
    const int x = k * RLE_SCAN_THREADS + threadIdx.x;
    if (x < cnt) starts[j0 + x] = s_run[x];
  }
  // the row tiles whose first row lies in [excl, excl + total): each
  // takes the last of this tile's runs that starts at or before it
  const int64_t end = excl + total;
  const int64_t b0 = excl <= 0 ? 0 : (excl - 1) / RLE_ROWS + 1;
  const int64_t b1 = j0 + cnt >= r ? nb
                     : end <= 0  ? 0
                                 : min(nb, (end - 1) / RLE_ROWS + 1);
  for (int64_t b = b0 + threadIdx.x; b < b1; b += RLE_SCAN_THREADS) {
    const int64_t row = b * RLE_ROWS;
    int a = 0, c = cnt;  // the first staged start above row
    while (a < c) {
      const int m = (a + c) >> 1;
      if (s_run[m] <= row) a = m + 1; else c = m;
    }
    tile_run[b] = j0 + (a > 0 ? a - 1 : 0);
  }
}

// One row tile of RLE_ROWS rows a block: out[i] = values[j] for the last
// run j that starts at or before row i.
__global__ void __launch_bounds__(RLE_THREADS)
rle_expand_kernel(const int64_t* __restrict__ values,
                  const int64_t* __restrict__ starts,
                  const int64_t* __restrict__ tile_run, int64_t r, int64_t n,
                  int64_t nb, bool vec, int64_t* __restrict__ out) {
  __shared__ __align__(16) int64_t s_start[RLE_ROWS + 1];
  __shared__ int64_t s_val[RLE_ROWS + 1];
  const int64_t b = blockIdx.x;
  const int64_t row0 = b * RLE_ROWS;
  // the runs from the one covering this tile's first row to the one
  // covering the next tile's (clamped: in range whatever the lengths)
  const int64_t j0 = min(max(tile_run[b], (int64_t)0), r - 1);
  const int64_t j1 = b + 1 < nb ? min(max(tile_run[b + 1], j0), r - 1)
                                : r - 1;
  const int count = (int)min(j1 - j0 + 1, (int64_t)RLE_ROWS + 1);
  for (int x = threadIdx.x; x < count; x += RLE_THREADS) {
    s_start[x] = starts[j0 + x];
    s_val[x] = values[j0 + x];
  }
  __syncthreads();
  const int64_t i0 = row0 + threadIdx.x * RLE_ITEMS;
  int a = 0, c = count;  // the first staged start above i0
  while (a < c) {
    const int m = (a + c) >> 1;
    if (s_start[m] <= i0) a = m + 1; else c = m;
  }
  int j = a > 0 ? a - 1 : 0;
  int64_t v[RLE_ITEMS];
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k) {  // forward over consecutive rows
    while (j + 1 < count && s_start[j + 1] <= i0 + k) ++j;
    v[k] = s_val[j];
  }
  __syncthreads();  // s_start now holds the tile's rows
#pragma unroll
  for (int k = 0; k < RLE_ITEMS; ++k)
    s_start[threadIdx.x * RLE_ITEMS + k] = v[k];
  __syncthreads();
  const int rows = (int)min((int64_t)RLE_ROWS, n - row0);
  int64_t* const o = out + row0;
  if (vec) {
    const longlong2* s2 = reinterpret_cast<const longlong2*>(s_start);
    longlong2* o2 = reinterpret_cast<longlong2*>(o);
    for (int x = threadIdx.x; 2 * x + 1 < rows; x += RLE_THREADS)
      o2[x] = s2[x];
    if ((rows & 1) && threadIdx.x == 0) o[rows - 1] = s_start[rows - 1];
  } else {
    for (int x = threadIdx.x; x < rows; x += RLE_THREADS) o[x] = s_start[x];
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

// lengths: int32, as stored, r < 2^30; scratch: 8-byte aligned, of
// scratch_len >= ceil(r / 2048) + 1 + r + ceil(n / 1024) int64 — the scan
// tiles' status words and the ticket counter (cleared here), the run
// starts, each row tile's first run. Returns cudaErrorInvalidValue for
// arguments it does not take, else cudaGetLastError().
// int64 entries of rle_expand_launch's scratch for r runs and n rows: a
// status word a scan tile and the ticket counter, the r run starts, and
// the first run of each row tile
extern "C" int64_t rle_scratch_len(int64_t r, int64_t n) {
  return (r + RLE_SCAN_TILE - 1) / RLE_SCAN_TILE + 1 + r +
         (n + RLE_ROWS - 1) / RLE_ROWS;
}

extern "C" int rle_expand_launch(const void* values, const void* lengths,
                                 int64_t r, int64_t n, void* scratch,
                                 int64_t scratch_len, void* out,
                                 void* stream) {
  if (n <= 0 || r <= 0) return (int)cudaGetLastError();
  const int64_t tiles = (r + RLE_SCAN_TILE - 1) / RLE_SCAN_TILE;
  const int64_t nb = (n + RLE_ROWS - 1) / RLE_ROWS;
  if (r >= (1LL << 30) || nb > 0x7fffffffLL || scratch == nullptr ||
      ((uintptr_t)scratch & 7) != 0 || scratch_len < rle_scratch_len(r, n))
    return (int)cudaErrorInvalidValue;
  uint64_t* status = (uint64_t*)scratch;
  unsigned* ticket = (unsigned*)(status + tiles);
  int64_t* starts = (int64_t*)(status + tiles + 1);
  int64_t* tile_run = starts + r;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      status, 0, (size_t)(tiles + 1) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return (int)err;
  rle_scan_kernel<<<(unsigned)tiles, RLE_SCAN_THREADS, 0, s>>>(
      (const int32_t*)lengths, r, nb, status, ticket, starts, tile_run);
  rle_expand_kernel<<<(unsigned)nb, RLE_THREADS, 0, s>>>(
      (const int64_t*)values, starts, tile_run, r, n, nb,
      ((uintptr_t)out & 15) == 0, (int64_t*)out);
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
