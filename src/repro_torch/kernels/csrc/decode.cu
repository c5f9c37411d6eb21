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
//   grid. Here a call is one memset and one kernel, delta_scan_kernel: a
//   single-pass scan with decoupled look-back, as rle_scan_kernel's. A
//   block takes the next tile of DELTA_TILE rows from a ticket counter;
//   each thread loads its DELTA_ITEMS consecutive rows once, at their
//   stored width (1, 2, 4 or 8 bytes), in 16-byte words, and widens them
//   in registers. The tiles are counted from the 16-byte boundary at or
//   below z (the reader hands z in as a view 8-byte aligned in the
//   chunk's blob): the `head` rows between the boundary and z, and rows
//   past the end, count as 0, and a word is read only where it holds a
//   row before the end, so inside z's 16-byte blocks. Each thread sums
//   its rows, the block scans the sums, the tile publishes its sum, and
//   warp 0 looks back over the tiles before it, 32 at a time (a lane
//   waits for its tile to publish), adding values down to the nearest
//   tile that has published its inclusive prefix (tile 0 starts from
//   `first`); then the tile publishes its own. uint64 adds are
//   associative modulo 2^64, so every order of look-back gives the same
//   bits. The tile goes out through shared memory (two pad slots after
//   every 16 keep a thread's writes and the pair reads to at most two
//   ways of bank conflict) in 16-byte stores: the slots are shifted by
//   one where that puts the pairs on out's 16-byte boundaries, so only
//   a tile's first and last row may take an 8-byte store.
//   The status: a tile's sums are full uint64 values, so no bit is free
//   for a flag in one word (rle's sums stay below 2^61 and carry theirs
//   there), and a 16-byte {flag, value} store is not single-copy atomic.
//   So a status is two words, each a 32-bit state tag (sum or prefix)
//   above one 32-bit half of the value; each word is stored whole, and a
//   word is single-copy atomic. A reader loads both and takes the value
//   only when both tags are set and equal: the halves then come from one
//   publication (each state writes each word once), so a reader never
//   takes a value before it is published whole, nor half a sum with
//   half a prefix. One round trip reads a window: the first form, a flag
//   word stored with st.release after separate value words and loaded
//   with ld.acquire before them, took two and timed slower. Tried and
//   dropped (scripts kept out of the tree): 8-row tiles, windows of 64
//   to 512 tiles, a back-off in the spin, re-reading only the statuses
//   not yet published, and statuses spread one to a sector; each was
//   slower or no faster. The ticket and the statuses are cleared by one
//   cudaMemsetAsync. The look-back is a copy of rle_scan_kernel's in
//   shape, not shared with it: the status words differ, and rle_expand
//   stays as it was timed.
//   What holds it back at a 2^20-row chunk is latency, not bytes: its
//   257 tiles run as one wave, so every tile loads, then scans, then
//   waits for its look-back, then stores, and the stores start only
//   after the look-back's chain of prefixes; the memset before it is a
//   device operation of its own. chip_smoke.py prints both operations'
//   times at D0's chunk.
// bitunpack replaces decode.py · bitunpack_pallas:
//   out[i] = ((words[i / vpw] >> ((i % vpw) * k)) & (2^k - 1)) + lo,
//   one thread per output row (values never straddle a word).
// dict_gather replaces decode.py · dict_gather_pallas:
//   out[i] = values[codes[i]], 0 for a code outside [0, r). The Pallas
//   kernel compared every row with every dictionary entry; here it is
//   one load a row, from the dictionary staged in shared memory or, for
//   a larger one, through L1.
//   - The grid: persistent, one block of DICT_THREADS = 512 threads on
//     each SM (fewer blocks when the chunk has fewer warp tiles). A warp
//     tile is 32 16-byte vectors of codes, 512 bytes: 512, 256 or 128
//     rows. Tile t goes to warp t of the grid, then t + the grid's warps
//     and so on, the warps counted block by block first (warp w of block
//     b is the grid's warp w * blocks + b), so that a chunk with fewer
//     tiles than the grid has warps still keeps every SM busy.
//   - The staging: where r <= DICT_STAGE_MAX, each block copies the r
//     entries into shared memory once, before its first row, each thread
//     DICT_STAGE_LOADS loads in flight at a time, and looks every row up
//     there; each warp issues the load of its first tile before the
//     copy, so the two overlap. Above 48 KB the kernel opts in to more
//     shared memory. DICT_STAGE_MAX = 28,032 is the most that fits in
//     the 227 KB a block may have beside the warps' 8 KB of codes: a
//     random lookup in shared memory costs a few bank conflicts, one
//     through L1 about a cycle of the SM's L1 for each row, and staging
//     timed faster than the L1 path up to that size, its 219 KB a block
//     of L2 reads included (tools/dict_gather_sizes.py times r =
//     28,032 and 28,033 side by side). Above it the entries come through
//     __ldg, with L1 given all of the SM's memory that the codes' stage
//     leaves.
//   - The vectors: each lane loads one 16-byte vector of its warp's tile
//     (16, 8 or 4 codes at 1, 2 or 4 bytes), a warp 512 consecutive
//     bytes, and the next tile's while it works on this one. The tile
//     goes through 512 bytes of shared memory a warp, so that lane l
//     then takes rows 2p and 2p + 1 for p = l, l + 32, ...: their two
//     codes in one shared-memory load, their two entries, and one
//     16-byte streaming store (st.global.cs: nothing reads the rows back
//     here), a warp's stores 512 consecutive bytes. A full tile looks up
//     all of a lane's entries before its stores.
//   - The head and tail: the body starts at the first 16-byte boundary
//     at or after codes; the `head` rows before it, and the rows after
//     the last full vector (fewer than one vector), are read and written
//     one at a time by the first threads of block 0. Where out's rows of
//     the body start 8 bytes off a 16-byte boundary, a tile's stores
//     pair rows 2p + 1 and 2p + 2 instead, and its first and last row
//     take an 8-byte store each. Nothing is copied to align either
//     pointer.
//   - The byte bound is 8 r + code_bytes n + 8 n (chip_smoke.decode_fns
//     counts it so): the dictionary, the codes and the rows, each once.
//     The staging's reads are not in it: at r = 4,096 the 132 blocks read
//     32 KB each from L2, 4.3 MB in all beside a 2^20-row chunk's 8.4 MB
//     of output, while the first codes are in flight.
//   What holds it back above DICT_STAGE_MAX is L1: a warp's 32 random
//   lookups take about 32 of its cycles, and a dictionary of 512 KB (r =
//   65,536) mostly misses it; 2^20 rows then take about 3 times the
//   byte bound, as the kernel it replaces did. Tried and dropped, each
//   slower (a script kept out of the tree): one lane's codes written by
//   that lane as consecutive rows (a warp's stores 32 lines apart), the
//   dictionary split over the shared memory of a cluster of 8 blocks
//   and read through distributed shared memory (slower than L2 at every
//   r), 1024- and 256-thread blocks, two and four blocks an SM, and
//   lookups through L2 alone (ld.global.cg, .cs).
//   codes are read at their stored width; int32 codes below 0 are out
//   of range like those >= r.
//
// What bounds them on the card: bytes. Each must read its members once
// at their stored widths and write 8 bytes per output row; the one-byte
// members of the TPC-H chunks make the int64 output write most of the
// traffic (rle_expand reads its starts once more).
//
// Every entry point returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int RLE_SCAN_THREADS = 256;
constexpr int RLE_SCAN_ITEMS = 8;
constexpr int RLE_SCAN_TILE = RLE_SCAN_THREADS * RLE_SCAN_ITEMS;  // runs
constexpr int RLE_THREADS = 256;
constexpr int RLE_ITEMS = 4;
constexpr int RLE_ROWS = RLE_THREADS * RLE_ITEMS;  // rows an expand tile
constexpr int RLE_LOOK = 4;  // tiles a lane reads in a look-back window
constexpr uint64_t RLE_AGGREGATE = 1, RLE_PREFIX = 2;  // status flags

constexpr int DELTA_THREADS = 256;
constexpr int DELTA_ITEMS = 16;  // 16 bytes at width 1
constexpr int DELTA_TILE = DELTA_THREADS * DELTA_ITEMS;  // rows a tile
// the output stage: slots for local rows 0 .. DELTA_TILE + 1, two pad
// slots after every 16
constexpr int DELTA_SLOTS = DELTA_TILE + 2 + DELTA_TILE / 8;
constexpr unsigned DELTA_AGGREGATE = 1, DELTA_PREFIX = 2;  // flags

constexpr int GATHER_THREADS = 256;  // bitunpack's blocks
constexpr int DICT_THREADS = 512;
constexpr int DICT_STAGE_MAX = 28032;  // entries staged (see the note)
constexpr int DICT_STAGE_LOADS = 8;  // staging loads a thread in flight
constexpr int DEFAULT_SMEM = 48 * 1024;  // bytes a block may use unasked

// the device's SM count, read once a device
int sm_count(int dev) {
  static std::atomic<int> known[64];
  if (dev < 0 || dev >= 64) return 0;
  int sms = known[dev].load(std::memory_order_relaxed);
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ==
          cudaSuccess)
    known[dev].store(sms, std::memory_order_relaxed);
  return sms;
}

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

// A delta tile's status: two words, each a 32-bit state tag above one
// 32-bit half of the value that the state carries (the low half in the
// first). Each is stored and loaded whole, relaxed at the card's scope.
__device__ __forceinline__ void publish(uint64_t* st, unsigned state,
                                        uint64_t value) {
  const uint64_t tag = (uint64_t)state << 32;
  st_status(st, tag | (value & 0xffffffffull));
  st_status(st + 1, tag | (value >> 32));
}

// the state that both words of a status carry (0 while they differ), and
// the value that they carry then
__device__ __forceinline__ unsigned read_status(const uint64_t* st,
                                                uint64_t* value) {
  const uint64_t lo = ld_status(st), hi = ld_status(st + 1);
  *value = (hi << 32) | (lo & 0xffffffffull);
  return (lo >> 32) == (hi >> 32) ? (unsigned)(lo >> 32) : 0u;
}

// delta's zigzag code decoded
__device__ __forceinline__ uint64_t unzigzag(uint64_t u) {
  return (u >> 1) ^ (0ull - (u & 1ull));
}

// the stage slot of local position x (two pad slots after every 16)
__device__ __forceinline__ int delta_slot(int x) { return x + 2 * (x >> 4); }

// DELTA_ITEMS stored values from virtual row v0, a multiple of
// DELTA_ITEMS, so that their bytes start on a 16-byte boundary. A 16-byte
// word is read only where its first row lies before `end`: it then lies
// in a 16-byte block that holds a byte of z.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ base,
                                          int64_t v0, int64_t end,
                                          T (&e)[DELTA_ITEMS]) {
  constexpr int PER = 16 / sizeof(T);  // rows a word
#pragma unroll
  for (int j = 0; j < DELTA_ITEMS / PER; ++j) {
    const int64_t v = v0 + j * PER;
    const uint4 w = v < end ? __ldg(reinterpret_cast<const uint4*>(base + v))
                            : make_uint4(0u, 0u, 0u, 0u);
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if constexpr (sizeof(T) == 1)
        e[j * PER + k] = (T)(u[k >> 2] >> (8 * (k & 3)));
      else if constexpr (sizeof(T) == 2)
        e[j * PER + k] = (T)(u[k >> 1] >> (16 * (k & 1)));
      else if constexpr (sizeof(T) == 4)
        e[j * PER + k] = (T)u[k];
      else
        e[j * PER + k] = (T)(u[2 * k] | ((uint64_t)u[2 * k + 1] << 32));
    }
  }
}

// One tile of DELTA_TILE virtual rows a block, in the order of the
// ticket counter. Virtual row v is z's row v - head; `base` is z - head,
// on a 16-byte boundary. out[i] = first + the sum of unzigzag(z[0..i]);
// shift puts the stage's slot pairs on out's 16-byte boundaries.
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
delta_scan_kernel(const T* __restrict__ base, int head, int64_t n,
                  uint64_t first, unsigned* ticket, uint64_t* status,
                  int shift, int64_t* __restrict__ out) {
  constexpr int WARPS = DELTA_THREADS / 32;
  __shared__ __align__(16) uint64_t s_out[DELTA_SLOTS];
  __shared__ uint64_t s_warp[WARPS];
  __shared__ int64_t s_tile;
  __shared__ uint64_t s_excl;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t v_tile = t * DELTA_TILE;  // the tile's first virtual row
  const int64_t end = n + head;           // z's rows: [head, end)
  const int64_t v0 = v_tile + threadIdx.x * DELTA_ITEMS;
  T e[DELTA_ITEMS];
  load_rows(base, v0, end, e);
  uint64_t d[DELTA_ITEMS];
  uint64_t run = 0;
#pragma unroll
  for (int k = 0; k < DELTA_ITEMS; ++k) {
    const int64_t v = v0 + k;
    d[k] = v >= head && v < end ? unzigzag((uint64_t)e[k]) : 0ull;
    run += d[k];
  }
  const uint64_t inc = block_inclusive<DELTA_THREADS>(run, s_warp);
  const uint64_t total = s_warp[WARPS - 1];
  if (threadIdx.x < 32) {
    // warp 0: publish the tile's sum, look back, publish its prefix
    const int lane = threadIdx.x;
    uint64_t excl = first;
    if (t == 0) {
      if (lane == 0) publish(status, DELTA_PREFIX, first + total);
    } else {
      if (lane == 0) publish(status + 2 * t, DELTA_AGGREGATE, total);
      excl = 0;
      // windows of 32 tiles back from t - 1: lane l waits for tile
      // top - l to publish, then the warp adds the values down to the
      // nearest prefix in the window, that included
      for (int64_t top = t - 1;; top -= 32) {
        const int64_t q = top - lane;
        uint64_t v = 0;  // before tile 0: a prefix of 0
        unsigned f = DELTA_PREFIX;
        if (q >= 0)
          while ((f = read_status(status + 2 * q, &v)) == 0) {
          }
        const unsigned pre = __ballot_sync(0xffffffffu, f == DELTA_PREFIX);
        if (pre != 0 && lane >= __ffs(pre)) v = 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (pre != 0) break;
      }
      if (lane == 0) publish(status + 2 * t, DELTA_PREFIX, excl + total);
    }
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  uint64_t acc = s_excl + (inc - run);
#pragma unroll
  for (int k = 0; k < DELTA_ITEMS; ++k) {
    acc += d[k];
    s_out[delta_slot(threadIdx.x * DELTA_ITEMS + k + shift)] = acc;
  }
  __syncthreads();
  // local rows [lo, hi) are z's; local row x is out's row v_tile - head + x
  // and lies in slot position x + shift, so that slot pair p (positions
  // 2p, 2p + 1) is one 16-byte block of out
  const int lo = (int)max((int64_t)0, head - v_tile);
  const int hi = (int)min((int64_t)DELTA_TILE, end - v_tile);
  const int p1 = (hi + shift + 1) >> 1;
  for (int p = ((lo + shift) >> 1) + threadIdx.x; p < p1;
       p += DELTA_THREADS) {
    const int x = 2 * p - shift;
    const int64_t g = v_tile - head + x;
    const longlong2 w =
        *reinterpret_cast<const longlong2*>(s_out + delta_slot(2 * p));
    if (x >= lo && x + 1 < hi) {
      *reinterpret_cast<longlong2*>(out + g) = w;
    } else {
      if (x >= lo && x < hi) out[g] = w.x;
      if (x + 1 >= lo && x + 1 < hi) out[g + 1] = w.y;
    }
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

// a warp's 32 vectors of codes, read from shared memory two codes at a
// time: rows 2p and 2p + 1 of the tile
template <typename C>
struct alignas(2 * sizeof(C)) CodePair {
  C a, b;
};

template <typename C, bool STAGED>
__global__ void __launch_bounds__(DICT_THREADS)
dict_gather_kernel(const int64_t* __restrict__ values, int64_t r,
                   const C* __restrict__ codes, int64_t n, int head,
                   int64_t* __restrict__ out) {
  constexpr int V = 16 / (int)sizeof(C);  // codes a 16-byte load
  constexpr int WARPS = DICT_THREADS / 32;
  constexpr int TILE = 32 * V;            // rows a warp tile
  extern __shared__ __align__(16) unsigned char dict_smem[];
  uint4* s_codes = reinterpret_cast<uint4*>(dict_smem);
  int64_t* s_dict = reinterpret_cast<int64_t*>(s_codes + 32 * WARPS);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t nvec = (n - head) / V;
  const int64_t tiles = (nvec + 31) / 32;
  const int64_t warps = (int64_t)gridDim.x * WARPS;
  // warp tiles are dealt to the blocks first, so that a chunk with
  // fewer tiles than the grid has warps still spreads over every SM
  const int64_t first = (int64_t)warp * gridDim.x + blockIdx.x;
  const uint4* body = reinterpret_cast<const uint4*>(codes + head);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load = [&](int64_t t) {
    const int64_t v = t * 32 + lane;
    return v < nvec ? __ldg(body + v) : zero;
  };
  uint4 w = first < tiles ? load(first) : zero;  // in flight while staging
  if (STAGED) {
    // DICT_STAGE_LOADS entries a thread in flight at a time
    for (int t0 = 0; t0 < r; t0 += DICT_STAGE_LOADS * DICT_THREADS) {
      int64_t e[DICT_STAGE_LOADS];
#pragma unroll
      for (int k = 0; k < DICT_STAGE_LOADS; ++k) {
        const int t = t0 + k * DICT_THREADS + threadIdx.x;
        e[k] = t < r ? __ldg(values + t) : 0;
      }
#pragma unroll
      for (int k = 0; k < DICT_STAGE_LOADS; ++k) {
        const int t = t0 + k * DICT_THREADS + threadIdx.x;
        if (t < r) s_dict[t] = e[k];
      }
    }
    __syncthreads();
  }
  // code c's entry, 0 out of range (an int32 code below 0 widens to a
  // uint64 above any r)
  auto entry = [&](int64_t c) -> int64_t {
    if ((uint64_t)c >= (uint64_t)r) return 0;
    return STAGED ? s_dict[c] : __ldg(values + c);
  };
  // rows go out with streaming stores: nothing reads them back here
  auto put2 = [](int64_t* o, int64_t a, int64_t b) {
    __stcs(reinterpret_cast<longlong2*>(o), make_longlong2(a, b));
  };
  const int64_t tail = head + nvec * V;  // the tail's first row
  const int64_t tid = (int64_t)blockIdx.x * DICT_THREADS + threadIdx.x;
  if (tid < head) out[tid] = entry(codes[tid]);
  if (tid < n - tail) out[tail + tid] = entry(codes[tail + tid]);
  // a tile's rows are 16-byte aligned in out in pairs (2p, 2p + 1),
  // unless `odd`: then in pairs (2p + 1, 2p + 2), and its first and last
  // row go alone
  const bool odd = ((((uintptr_t)out >> 3) + head) & 1) != 0;
  uint4* buf = s_codes + 32 * warp;
  const C* bc = reinterpret_cast<const C*>(buf);
  const CodePair<C>* bp = reinterpret_cast<const CodePair<C>*>(buf);
  for (int64_t t = first; t < tiles; t += warps) {
    const uint4 next = t + warps < tiles ? load(t + warps) : zero;
    buf[lane] = w;
    __syncwarp();
    int64_t* o = out + head + t * TILE;
    const int rows = (int)min((int64_t)TILE, (nvec - t * 32) * V);
    if (!odd && rows == TILE) {
      int64_t e[V];
#pragma unroll
      for (int j = 0; j < V / 2; ++j) {
        const CodePair<C> c = bp[32 * j + lane];
        e[2 * j] = entry(c.a);
        e[2 * j + 1] = entry(c.b);
      }
#pragma unroll
      for (int j = 0; j < V / 2; ++j)
        put2(o + 2 * (32 * j + lane), e[2 * j], e[2 * j + 1]);
    } else if (!odd) {
      for (int p = lane; p < rows / 2; p += 32) {
        const CodePair<C> c = bp[p];
        put2(o + 2 * p, entry(c.a), entry(c.b));
      }
    } else {
      for (int p = lane; p < rows / 2; p += 32) {
        if (p < rows / 2 - 1) {
          put2(o + 2 * p + 1, entry(bc[2 * p + 1]), entry(bc[2 * p + 2]));
        } else {
          o[0] = entry(bc[0]);
          o[rows - 1] = entry(bc[rows - 1]);
        }
      }
    }
    __syncwarp();
    w = next;
  }
}

int grid_for(int64_t work, int threads, int64_t cap) {
  int64_t b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > cap) b = cap;  // grid-stride loops cover the rest
  return (int)b;
}

template <typename T>
void delta_launch(const void* z, int head, int64_t n, uint64_t first,
                  int64_t tiles, uint64_t* scratch, int shift, void* out,
                  cudaStream_t stream) {
  delta_scan_kernel<T><<<(unsigned)tiles, DELTA_THREADS, 0, stream>>>(
      (const T*)z - head, head, n, first, (unsigned*)scratch, scratch + 2,
      shift, (int64_t*)out);
}

template <typename C>
cudaError_t dict_launch(const void* values, int64_t r, const void* codes,
                        int64_t n, void* out, cudaStream_t stream) {
  constexpr int V = 16 / (int)sizeof(C);
  if (((uintptr_t)codes % sizeof(C)) != 0 || ((uintptr_t)out & 7) != 0 ||
      ((uintptr_t)values & 7) != 0 || r < 0)
    return cudaErrorInvalidValue;
  // rows before the first 16-byte boundary at or after codes
  const int64_t to_boundary =
      (int64_t)(((16 - ((uintptr_t)codes & 15)) & 15) / sizeof(C));
  const int head = (int)(n < to_boundary ? n : to_boundary);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int sms = sm_count(dev);
  if (sms <= 0) return cudaErrorInvalidValue;
  const bool staged = r <= DICT_STAGE_MAX;
  const size_t smem = DICT_THREADS / 32 * 512 +
                      (staged ? (size_t)r * sizeof(int64_t) : 0);
  void (*kernel)(const int64_t*, int64_t, const C*, int64_t, int,
                 int64_t*) = staged ? dict_gather_kernel<C, true>
                                    : dict_gather_kernel<C, false>;
  if (smem > DEFAULT_SMEM) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (!staged) {
    // the entries come through L1: leave it as much of the SM's 256 KB
    // as the codes' stage allows, once a device
    static std::atomic<uint64_t> carved{0};
    const uint64_t bit = 1ull << (dev & 63);
    if (!(carved.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxL1);
      if (err != cudaSuccess) return err;
      carved.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  // a block an SM, none without a warp tile of 32 vectors to walk (the
  // head and the tail take fewer than V threads of block 0)
  const int64_t tiles = ((n - head) / V + 31) / 32;
  const int blocks = (int)(tiles < sms ? (tiles > 0 ? tiles : 1) : sms);
  kernel<<<blocks, DICT_THREADS, smem, stream>>>(
      (const int64_t*)values, r, (const C*)codes, n, head, (int64_t*)out);
  return cudaSuccess;
}

// tiles of delta_unpack_launch for n rows, `head` rows past the 16-byte
// boundary at or below z (at most 15)
int64_t delta_tiles(int64_t n, int head) {
  return (n + head + DELTA_TILE - 1) / DELTA_TILE;
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

// int64 entries of delta_unpack_launch's scratch for n rows: the ticket
// counter and a pad, then a status of two words a tile (16-byte aligned
// where the scratch is)
extern "C" int64_t delta_scratch_len(int64_t n) {
  return 2 + 2 * delta_tiles(n, 15);
}

// width: bytes per stored delta (1, 2, 4 or 8), z aligned to it; out
// 8-byte aligned; scratch: 8-byte aligned, of scratch_len >=
// delta_scratch_len(n) int64 (cleared here).
// Returns cudaErrorInvalidValue for arguments it does not take, else
// cudaGetLastError().
extern "C" int delta_unpack_launch(const void* z, int width, int64_t n,
                                   uint64_t first, void* scratch,
                                   int64_t scratch_len, void* out,
                                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if ((width != 1 && width != 2 && width != 4 && width != 8) ||
      ((uintptr_t)z & (width - 1)) != 0 || ((uintptr_t)out & 7) != 0 ||
      scratch == nullptr || ((uintptr_t)scratch & 7) != 0 ||
      scratch_len < delta_scratch_len(n))
    return (int)cudaErrorInvalidValue;
  const int head = (int)(((uintptr_t)z & 15) / width);
  const int64_t tiles = delta_tiles(n, head);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  uint64_t* words = (uint64_t*)scratch;
  const int shift = (int)((((uintptr_t)out >> 3) - head) & 1);
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      words, 0, (size_t)(2 + 2 * tiles) * sizeof(uint64_t), s);
  if (err != cudaSuccess) return (int)err;
  switch (width) {
    case 1: delta_launch<uint8_t>(z, head, n, first, tiles, words, shift,
                                  out, s); break;
    case 2: delta_launch<uint16_t>(z, head, n, first, tiles, words, shift,
                                   out, s); break;
    case 4: delta_launch<uint32_t>(z, head, n, first, tiles, words, shift,
                                   out, s); break;
    default: delta_launch<uint64_t>(z, head, n, first, tiles, words, shift,
                                    out, s); break;
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

// code_kind: 1 = uint8, 2 = uint16, 4 = uint32, -4 = int32; codes
// aligned to their width, values and out to 8 bytes. Returns
// cudaErrorInvalidValue for arguments it does not take, else
// cudaGetLastError().
extern "C" int dict_gather_launch(const void* values, int64_t r,
                                  const void* codes, int code_kind,
                                  int64_t n, void* out, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    switch (code_kind) {
      case 1: err = dict_launch<uint8_t>(values, r, codes, n, out, s); break;
      case 2: err = dict_launch<uint16_t>(values, r, codes, n, out, s); break;
      case 4: err = dict_launch<uint32_t>(values, r, codes, n, out, s); break;
      case -4: err = dict_launch<int32_t>(values, r, codes, n, out, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
