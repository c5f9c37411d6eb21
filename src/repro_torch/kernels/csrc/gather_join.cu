// Join inner loop kernels for Hopper (sm_90a): merge positions and row
// gather, the two halves of fk_join / general_join.
//
// merge_positions replaces the TPU kernel src/repro/kernels/gather_join.py ·
// merge_positions_pallas: (lo, hi) = the left and right searchsorted of
// each int64 query into the sorted int64 keys, as int32. Keys equal to
// INT64_MAX (the padding of invalid build rows) are ordinary values.
// gather_rows replaces gather_join.py · gather_rows_pallas:
// out[i, :] = values[idx[i], :] over int64 bit-view lanes, 0 for an index
// outside [0, r). Floats travel as their int64 bits, so -0.0 and NaN
// payloads survive.
//
// What bounds them on the card: bytes, in principle. merge_positions must
// read the r keys and n queries once and write 2n int32 (8r + 8n + 8n
// bytes); gather_rows must read n indices and n*d lanes and write n*d
// lanes (8n + 16nd bytes). The Pallas kernels compared every query with
// every key (and every output row with every source row) in dense
// one-hot tiles shaped for the MXU, O(n*r) work.
//
// gather_rows gathers each row directly, over tiles of GATHER_TILE
// consecutive rows walked by a persistent grid of GATHER_PER_SM blocks an
// SM (the design of shuffle_pack.cu's pack_rows_kernel, specialised to
// int64 ids and no flags):
//   - a tile's ids come into shared memory by cp.async, in 16-byte chunks
//     from the 16-byte boundary at or below the tile's first byte (a view
//     need not start on one), and the next tile's into a second buffer
//     while the block gathers this one, so no value load waits behind an
//     id load; the ids are read with an evict-first hint, and the output
//     is stored evict-first (__stcs), so that L2 keeps what it can of
//     values, the one array read at random;
//   - each row's element offset is resolved once, by one thread, into
//     shared memory: -1 for an id outside [0, r), so that such a row is
//     stored as 0 without a load;
//   - a thread's elements of a tile are (row, lane) pairs GATHER_THREADS
//     apart, stepped with adds and one compare (no division an element),
//     and it issues GATHER_UNROLL lanes of loads (64 bytes) before its
//     stores; with d even and both bases 16-byte aligned a load and a
//     store move two lanes;
//   - the stores stay coalesced: rows consecutive, lanes innermost.
// Nothing assumes idx sorted, unique or in range. What no design inside
// the kernel removes is the gather's own waste: a row read at random pulls
// whole 32-byte sectors, and rows far apart share none. chip_smoke.py
// times the captured calls again with idx sorted, which reads the same
// rows in order: the difference is what the random reads cost.
// The tile and the blocks an SM were chosen by timing tiles of 256, 512
// and 1024 rows at 2, 3 and 4 blocks an SM at B's two call shapes on an
// H100: with random ids the choice hardly matters (the reads bound
// them); with the ids sorted, 1024 rows at 3 or 4 blocks an SM (or 512
// at 4) ran fastest and 256 at 2 slowest. 2048 rows exceed the 48 KB of
// static shared memory.
//
// merge_positions searches instead: one thread per query, so what
// bounds it is the 32-byte sectors each query pulls from L2 and device
// memory (an ablation on the card at phase B, in PERF.md: the time
// follows the sectors a query reads, not its dependent trips). B's
// build side is 7.5M keys, 60 MB, more than the 50 MB L2. The design
// cuts those sectors:
//   0. heads (merge_heads): a pre-pass copies the first key of every
//      sector (every 4th key) into a compact array, r / 4 keys (15 MB
//      at B: it stays in L2 while the queries run);
//   1. fences: each block (as many as the SMs hold, persistent over the
//      queries) stages every w-th key in shared memory, w = 16 * 2^m the
//      least that keeps the fences within MAX_FENCES (16,384 = 128 KB:
//      w = 512 at B). A binary search there finds the fence bracket
//      [(a - 1) w, a w) that holds lo (or sector 0 when no fence is
//      below the query), with no load from memory;
//   2. the bracket's heads: a binary search over the heads' sectors (4
//      heads, one load of 32 bytes; a probe whose sector holds a head
//      >= the query ends it) finds the last head below the query, so
//      the keys' sector that holds lo: log2(w / 16) + 1 sectors at most
//      from L2 (6 at B);
//   3. that sector of keys, one load from memory: lo is its start plus
//      its keys below the query, and hi its start plus its keys at most
//      the query, when some key of the sector exceeds the query (or the
//      keys end there). Otherwise the run of keys equal to the query
//      goes on past it (a general join's build side, or the INT64_MAX
//      padding): hi by a gallop from the sector's end and a binary
//      search inside the bracket it found.
// An r that fits in the fences is the same code with one sector of heads
// a bracket.

#include <cuda_runtime.h>
#include <stdint.h>

#define MERGE_THREADS 1024
#define MAX_FENCES 16384            // 128 KB of shared memory

static int blocks_for(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 65535LL * 32) b = 65535LL * 32;  // grid-stride loops cover the rest
  return (int)b;
}

// arr[4 m, 4 m + len) (len <= 4), 16 bytes a load where arr is 16-byte
// aligned: the entries below q and at most q
__device__ __forceinline__ void count_sector(const int64_t* __restrict__ arr,
                                             int64_t m, int len, bool vec,
                                             int64_t q, int& lt, int& le) {
  int64_t x[4];
  if (vec && len == 4) {
    const longlong2* p = reinterpret_cast<const longlong2*>(arr + 4 * m);
    const longlong2 y0 = __ldg(p), y1 = __ldg(p + 1);
    x[0] = y0.x; x[1] = y0.y; x[2] = y1.x; x[3] = y1.y;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < len) x[u] = arr[4 * m + u];
  }
  lt = le = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < len) {
      lt += x[u] < q;
      le += x[u] <= q;
    }
}

#define GATHER_THREADS 256
#define GATHER_TILE 1024   // rows a tile
#define GATHER_PER_SM 4    // blocks of the persistent grid an SM
#define GATHER_UNROLL 8    // lanes a thread loads before its stores

// an L2 policy that evicts the lines it tags first
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes, uint64_t policy) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;"
      ::"r"(s), "l"(src), "r"(src_bytes), "l"(policy));
}

// `bytes` bytes from p into sh by cp.async, in 16-byte chunks from the
// 16-byte boundary at or below p (those bytes before p lie in p's own
// 16-byte block, so inside its allocation); the last chunk stops at
// p + bytes and is zero-filled beyond.
__device__ __forceinline__ void stage_bytes(int4* sh, const void* p,
                                            int bytes, uint64_t policy) {
  const uintptr_t a = (uintptr_t)p;
  const char* base = (const char*)(a & ~(uintptr_t)15);
  const int total = (int)(a & 15) + bytes;
  for (int c = threadIdx.x; 16 * c < total; c += GATHER_THREADS)
    cp_async16(sh + c, base + 16 * c, min(16, total - 16 * c), policy);
}

// where the bytes of p begin in the chunks stage_bytes copied from p
template <typename T>
__device__ __forceinline__ const T* staged(const int4* sh, const T* p) {
  return (const T*)((const char*)sh + ((uintptr_t)p & 15));
}

// VEC lanes moved by one load and one store
template <int VEC> struct Lanes;
template <> struct Lanes<1> {
  typedef long long T;
  __device__ static T zero() { return 0; }
};
template <> struct Lanes<2> {
  typedef longlong2 T;
  __device__ static T zero() { return make_longlong2(0, 0); }
};

__global__ void merge_heads_kernel(const int64_t* __restrict__ keys,
                                   int64_t r, int64_t* __restrict__ heads) {
  const int64_t nh = (r + 3) / 4, stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nh;
       i += stride)
    heads[i] = keys[4 * i];
}

__global__ void __launch_bounds__(MERGE_THREADS, 1)
    merge_positions_kernel(const int64_t* __restrict__ keys, int64_t r,
                           const int64_t* __restrict__ heads,
                           const int64_t* __restrict__ queries, int64_t n,
                           int wl, int nf, bool vec,
                           int32_t* __restrict__ lo_out,
                           int32_t* __restrict__ hi_out) {
  extern __shared__ int64_t fence[];
  const int sh = wl - 2;             // a fence every 2^sh heads
  for (int f = threadIdx.x; f < nf; f += blockDim.x)
    fence[f] = heads[(int64_t)f << sh];
  __syncthreads();
  const int64_t n_heads = (r + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t q = queries[i];
    // 1. the fences below q
    int a = 0, b = nf;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (fence[m] < q) a = m + 1; else b = m;
    }
    // 2. the last sector j of the heads in the bracket whose first head
    // is below q (the bracket's first is fence a - 1; the head after the
    // bracket is >= q), and its heads below q (c)
    int64_t sec = 0;                 // the keys' sector that holds lo
    if (a > 0) {
      int64_t j = ((int64_t)(a - 1) << sh) / 4;
      int64_t jb = (min((int64_t)a << sh, n_heads) + 3) / 4;
      int c = -1, ce;
      while (jb - j > 1) {
        const int64_t m = (j + jb) >> 1;
        const int len = (int)min((int64_t)4, n_heads - 4 * m);
        int plt;
        count_sector(heads, m, len, true, q, plt, ce);
        if (plt == 0) {              // its first head >= q
          jb = m;
          continue;
        }
        j = m;
        c = plt;
        if (plt < len) break;        // lo in it
      }
      if (c < 0)
        count_sector(heads, j, (int)min((int64_t)4, n_heads - 4 * j), true,
                     q, c, ce);
      sec = 4 * j + c - 1;           // the last head below q
    }
    // 3. the keys' sector that holds lo: its keys below q and at most q
    const int len = (int)min((int64_t)4, r - 4 * sec);
    int lt, le;
    count_sector(keys, sec, len, vec, q, lt, le);
    lo_out[i] = (int32_t)(4 * sec + lt);
    int64_t h = 4 * sec + le;
    if (le == len && h < r) {
      // keys equal to q go on past the sector: gallop from its end, then
      // a binary search inside the bracket the gallop found
      int64_t below = h, c = h, step = 1;   // keys[x] <= q for x < below
      while (c < r && keys[c] <= q) {
        below = c + 1;
        c = h + step;
        step <<= 1;
      }
      if (c > r) c = r;                      // keys[c] > q, or c == r
      h = below;
      while (h < c) {
        const int64_t m = h + ((c - h) >> 1);
        if (keys[m] <= q) h = m + 1; else c = m;
      }
    }
    hi_out[i] = (int32_t)h;
  }
}

template <int VEC>
__global__ void __launch_bounds__(GATHER_THREADS, GATHER_PER_SM)
gather_rows_kernel(const int64_t* __restrict__ values, int64_t r, int d,
                   const int64_t* __restrict__ idx, int64_t n,
                   int64_t* __restrict__ out) {
  typedef typename Lanes<VEC>::T V;
  constexpr int U = GATHER_UNROLL / VEC;       // loads in flight a thread
  // a tile's ids, with room for the head below the first
  __shared__ int4 stage[2][GATHER_TILE / 2 + 1];
  __shared__ int64_t off[GATHER_TILE];
  const uint64_t first = evict_first_policy();
  const int64_t tiles = (n + GATHER_TILE - 1) / GATHER_TILE;
  const int du = d / VEC;                      // units of VEC lanes a row
  // this thread's first (row, unit) of every tile, and the step between
  // its units: one division each, here, for the whole grid walk
  const int row0 = threadIdx.x / du, unit0 = threadIdx.x - row0 * du;
  const int step_s = GATHER_THREADS / du;
  const int step_u = GATHER_THREADS - step_s * du;
  auto fill = [&](int64_t t, int b) {
    const int64_t s0 = t * GATHER_TILE;
    const int rows = (int)(n - s0 < GATHER_TILE ? n - s0 : GATHER_TILE);
    stage_bytes(stage[b], idx + s0, rows * 8, first);
  };
  int64_t t = blockIdx.x;
  if (t < tiles) fill(t, 0);
  asm volatile("cp.async.commit_group;");
  for (int b = 0; t < tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < tiles) fill(t + gridDim.x, b ^ 1);
    asm volatile("cp.async.commit_group;");   // empty after the last tile
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // tile t's copies
    __syncthreads();
    const int64_t s0 = t * GATHER_TILE;
    const int rows = (int)(n - s0 < GATHER_TILE ? n - s0 : GATHER_TILE);
    const int64_t* ti = staged(stage[b], idx + s0);
    for (int j = threadIdx.x; j < rows; j += GATHER_THREADS) {
      const int64_t v = ti[j];
      off[j] = (v >= 0 && v < r) ? v * d : -1;
    }
    __syncthreads();
    int64_t* const o = out + s0 * d;
    int s = row0, u = unit0;
    while (s < rows) {
      int ss[U], uu[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        ss[k] = s;
        uu[k] = u;
        s += step_s;
        u += step_u;
        if (u >= du) {
          u -= du;
          ++s;
        }
      }
      V x[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        x[k] = Lanes<VEC>::zero();
        if (ss[k] < rows) {
          const int64_t at = off[ss[k]];
          if (at >= 0) x[k] = __ldg((const V*)(values + at) + uu[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (ss[k] < rows) __stcs((V*)(o + (int64_t)ss[k] * d) + uu[k], x[k]);
    }
  }
}

static cudaError_t launch_merge(const int64_t* keys, int64_t r,
                                int64_t* heads, const int64_t* queries,
                                int64_t n, int32_t* lo, int32_t* hi,
                                cudaStream_t st) {
  int wl = 4;                         // w = 2^wl keys between two fences
  while (((r + (1LL << wl) - 1) >> wl) > MAX_FENCES) ++wl;
  const int nf = (int)((r + (1LL << wl) - 1) >> wl);
  const size_t smem = (size_t)nf * sizeof(int64_t);
  cudaError_t err = cudaFuncSetAttribute(
      merge_positions_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      MAX_FENCES * (int)sizeof(int64_t));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, merge_positions_kernel, MERGE_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (r > 0)
    merge_heads_kernel<<<blocks_for((r + 3) / 4, 256), 256, 0, st>>>(
        keys, r, heads);
  int64_t blocks = (n + MERGE_THREADS - 1) / MERGE_THREADS;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > resident) blocks = resident;
  merge_positions_kernel<<<(int)blocks, MERGE_THREADS, smem, st>>>(
      keys, r, heads, queries, n, wl, nf, ((uintptr_t)keys & 15) == 0, lo,
      hi);
  return cudaSuccess;
}

// keys (r,) ascending, r < 2^31; queries (n,); lo and hi (n,) int32;
// heads: scratch of ceil(r / 4) int64, 16-byte aligned (null only for
// r = 0). Returns cudaGetLastError() after the launches (nonzero: not
// launched).
extern "C" int merge_positions_launch(const void* keys, int64_t r,
                                      const void* queries, int64_t n,
                                      void* lo, void* hi, void* heads,
                                      void* stream) {
  if (r < 0 || r > 2147483647LL || n < 0 || ((uintptr_t)heads & 15) != 0 ||
      (r > 0 && heads == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int64_t* k = (const int64_t*)keys;
    const int64_t* q = (const int64_t*)queries;
    int64_t* h = (int64_t*)heads;
    int32_t *l = (int32_t*)lo, *g = (int32_t*)hi;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t err = launch_merge(k, r, h, q, n, l, g, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_launch(const void* values, int64_t r, int d,
                                  const void* idx, int64_t n, void* out,
                                  void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (n + GATHER_TILE - 1) / GATHER_TILE;
  const int64_t grid = (int64_t)(sms > 0 ? sms : 1) * GATHER_PER_SM;
  const int B = (int)(tiles < grid ? tiles : grid);
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t* v = (const int64_t*)values;
  const int64_t* i = (const int64_t*)idx;
  int64_t* o = (int64_t*)out;
  if (d % 2 == 0 && ((uintptr_t)values | (uintptr_t)out) % 16 == 0)
    gather_rows_kernel<2><<<B, GATHER_THREADS, 0, st>>>(v, r, d, i, n, o);
  else
    gather_rows_kernel<1><<<B, GATHER_THREADS, 0, st>>>(v, r, d, i, n, o);
  return (int)cudaGetLastError();
}
