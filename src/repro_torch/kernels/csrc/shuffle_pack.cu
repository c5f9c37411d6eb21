// Packed-shuffle kernels for Hopper (sm_90a): the pack and unpack around
// the single collective of the distributed exchange, the HyperCube
// replicating scatter, and the heavy-key membership test of the skew
// triple. All four move or compare int64 bit patterns: no float math, no
// atomics, the same bits in any launch order.
//
// pack_rows replaces src/repro/kernels/shuffle_pack.py · pack_rows_pallas:
//   out[j, :] = values[idx[j], :] where ok[j] and idx[j] lies in [0, r),
//   else 0. The Pallas kernel built each block of send slots as a dense
//   one-hot compare against every block of source rows (O(m*r) work,
//   shaped for the MXU). Here each slot's row is one direct gather.
//   Floats travel as their int64 bits, so -0.0 and NaN payloads survive.
// replicate_scatter replaces shuffle_pack.py · replicate_scatter_pallas:
//   the same gather from source row vidx[j] / repl, where ok[j],
//   vidx[j] >= 0 and the row lies in range, else 0. vidx >= 0 is checked
//   first, so the truncating division equals the reference's floor
//   division.
//   Both are one kernel, pack_rows_kernel, over tiles of PACK_TILE
//   consecutive slots. A persistent grid of PACK_PER_SM blocks an SM
//   walks the tiles:
//   - a tile's idx and ok come into shared memory by cp.async, in 16-byte
//     chunks from the 16-byte boundary at or below the tile's first byte
//     (a view need not start on one), and the next tile's into a second
//     buffer while the block gathers this one, so no value load waits
//     behind an index load;
//   - each slot's source row is resolved once, by one thread, into a
//     shared element offset (-1 for a slot that takes none); the
//     division by repl happens there, once a slot, in 32 bits for int32
//     ids;
//   - a thread's elements of a tile are (slot, lane) pairs PACK_THREADS
//     apart, stepped with adds and one compare (no division an element),
//     and it loads PACK_UNROLL lanes (64 bytes) before its stores; with d
//     even and both bases 16-byte aligned a load and a store move two
//     lanes (4 loads of 16 bytes in flight, not 8 of 8);
//   - an empty slot is stored as 0 without a load; the stores stay
//     coalesced, slots consecutive and lanes innermost, and are marked
//     evict-first, since nothing here reads them again.
//   Nothing assumes idx sorted, unique or in range. Tiles of 256 to 1024
//   slots and 2 to 4 blocks an SM timed alike on the H100 over an
//   exchange of F's size (the larger tile needs fewer barriers); 6 blocks
//   an SM capped the registers below what the unrolled loads hold, and
//   spilled.
// unpack_cols replaces shuffle_pack.py · unpack_cols_pallas: the (m, d)
//   wire buffer transposed to (d, m). A block stages a tile of 128 rows by
//   up to 8 lanes in shared memory (rows padded by one against bank
//   conflicts): it reads the tile row by row, as the buffer lies, and
//   writes it lane by lane, so both sides coalesce. d is small (3-10
//   lanes), so the tile runs along the rows.
// member_mask replaces shuffle_pack.py · member_mask_pallas:
//   out[i] = keys[i] in heavy, where a key equal to INT64_MAX never
//   matches and a heavy slot holding INT64_MAX (padding) never matches.
//   The set need not be sorted and may hold duplicates. A set of at most
//   MEMBER_SORTED keys (the planned path passes 40) takes
//   member_sorted_kernel, a persistent grid of MEMBER_PER_SM blocks an
//   SM:
//   - each block builds a sorted copy of the set's keys in shared memory
//     once, padding left out, by a rank sort (one key a thread: its slot
//     is the number of keys below it plus the number of equal keys
//     before it, so duplicates fill distinct slots), then fills the
//     slots up to the power of two P at or above the key count with
//     INT64_MAX;
//   - each thread takes MEMBER_ITEMS consecutive keys a round, loaded in
//     16-byte words counted from the 16-byte boundary at or below keys
//     (a view need not start on one: with a head of one key, a thread
//     reads five words and takes the middle eight keys);
//   - each key is found by a branchless binary search of log2 P steps
//     (6 for 40 keys), the steps of a thread's keys interleaved, where
//     the old kernel compared every key with every staged key (40
//     shared loads a key);
//   - a thread's flags go out as one 8-byte store (the output is
//     8-byte aligned), byte by byte only in the last, partial round.
//   A larger set takes member_staged_kernel: the set is staged in shared
//   memory MEMBER_STAGE keys at a time and every key is compared with
//   every staged key, as before.
//
// What bounds them on the card: bytes. pack_rows and replicate_scatter
// must read m indices and m flags and write m*d lanes, and read the d
// lanes of each row a slot takes; unpack_cols reads and writes m*d
// lanes; member_mask reads n keys and writes n flags (the heavy set is a
// few hundred bytes, read once a block). Each kernel touches each of
// those bytes once.
// The gather itself adds what no design inside the kernel removes: the
// slots of one destination take rows far apart, so a 32-byte sector that
// rows bound for two destinations share is fetched twice, and a row that
// straddles sectors pulls bytes it does not use. chip_smoke.py times the
// captured calls again with the slots sorted by source row, which reads
// the same rows in order: the difference is what the scattered rows cost.

#include <cuda_runtime.h>
#include <stdint.h>

#define I64_MAX_ 0x7fffffffffffffffLL

#define PACK_THREADS 256
#define PACK_TILE 1024    // slots a tile
#define PACK_UNROLL 8     // lanes a thread loads before its stores
#define PACK_PER_SM 4     // blocks of the persistent grid an SM

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// `bytes` bytes from p into sh by cp.async, in 16-byte chunks from the
// 16-byte boundary at or below p (those bytes before p lie in p's own
// 16-byte block, so inside its allocation); the last chunk stops at
// p + bytes and is zero-filled beyond.
__device__ __forceinline__ void stage_bytes(int4* sh, const void* p,
                                            int bytes) {
  const uintptr_t a = (uintptr_t)p;
  const char* base = (const char*)(a & ~(uintptr_t)15);
  const int total = (int)(a & 15) + bytes;
  for (int c = threadIdx.x; 16 * c < total; c += PACK_THREADS)
    cp_async16(sh + c, base + 16 * c, min(16, total - 16 * c));
}

// where the bytes of p begin in the chunks stage_bytes copied from p
template <typename T>
__device__ __forceinline__ const T* staged(const int4* sh, const T* p) {
  return (const T*)((const char*)sh + ((uintptr_t)p & 15));
}

// one tile's idx and ok bytes, with room for the head below the first
template <typename IdxT, typename OkT>
struct PackStage {
  int4 idx[PACK_TILE * sizeof(IdxT) / 16 + 1];
  int4 ok[(PACK_TILE * sizeof(OkT) + 15) / 16 + 1];
};

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

template <typename IdxT, typename OkT, bool REPL, int VEC>
__global__ void __launch_bounds__(PACK_THREADS, PACK_PER_SM)
pack_rows_kernel(const int64_t* __restrict__ values, int64_t r, int d,
                 const IdxT* __restrict__ idx, const OkT* __restrict__ ok,
                 int64_t m, int64_t repl, int64_t* __restrict__ out) {
  typedef typename Lanes<VEC>::T V;
  constexpr int U = PACK_UNROLL / VEC;         // loads in flight a thread
  __shared__ PackStage<IdxT, OkT> stage[2];
  __shared__ int64_t off[PACK_TILE];
  const int64_t tiles = (m + PACK_TILE - 1) / PACK_TILE;
  const int du = d / VEC;                      // units of VEC lanes a slot
  // this thread's first (slot, unit) of every tile, and the step between
  // its units: one division each, here, for the whole grid walk
  const int slot0 = threadIdx.x / du, unit0 = threadIdx.x - slot0 * du;
  const int step_s = PACK_THREADS / du, step_u = PACK_THREADS - step_s * du;
  // an int32 id below 2^31 over a repl of 2^31 or more gives row 0 either way
  const uint32_t repl32 = (uint32_t)(repl < 0x80000000LL ? repl
                                                         : 0x80000000LL);
  auto fill = [&](int64_t t, int b) {
    const int64_t s0 = t * PACK_TILE;
    const int n = (int)(m - s0 < PACK_TILE ? m - s0 : PACK_TILE);
    stage_bytes(stage[b].idx, idx + s0, n * (int)sizeof(IdxT));
    stage_bytes(stage[b].ok, ok + s0, n * (int)sizeof(OkT));
  };
  int64_t t = blockIdx.x;
  if (t < tiles) fill(t, 0);
  asm volatile("cp.async.commit_group;");
  for (int b = 0; t < tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < tiles) fill(t + gridDim.x, b ^ 1);
    asm volatile("cp.async.commit_group;");   // empty after the last tile
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // tile t's copies
    __syncthreads();
    const int64_t s0 = t * PACK_TILE;
    const int n = (int)(m - s0 < PACK_TILE ? m - s0 : PACK_TILE);
    const IdxT* ti = staged(stage[b].idx, idx + s0);
    const OkT* to = staged(stage[b].ok, ok + s0);
    for (int j = threadIdx.x; j < n; j += PACK_THREADS) {
      const int64_t v = (int64_t)ti[j];
      int64_t src = -1;
      if (to[j] != 0 && v >= 0) {
        if constexpr (!REPL)
          src = v;
        else if constexpr (sizeof(IdxT) == 4)
          src = (uint32_t)v / repl32;
        else
          src = (int64_t)((uint64_t)v / (uint64_t)repl);
        if (src >= r) src = -1;
      }
      off[j] = src < 0 ? -1 : src * d;
    }
    __syncthreads();
    int64_t* const o = out + s0 * d;
    int s = slot0, u = unit0;
    while (s < n) {
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
        if (ss[k] < n) {
          const int64_t at = off[ss[k]];
          if (at >= 0) x[k] = __ldg((const V*)(values + at) + uu[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)  // evict-first: values keep more of L2
        if (ss[k] < n) __stcs((V*)(o + (int64_t)ss[k] * d) + uu[k], x[k]);
    }
  }
}

#define UNPACK_ROWS 128
#define UNPACK_LANES 8

__global__ void unpack_cols_kernel(const int64_t* __restrict__ buf,
                                   int64_t m, int d,
                                   int64_t* __restrict__ out) {
  __shared__ int64_t tile[UNPACK_LANES][UNPACK_ROWS + 1];
  const int64_t row0 = (int64_t)blockIdx.x * UNPACK_ROWS;
  const int lane0 = blockIdx.y * UNPACK_LANES;
  const int lanes = min(UNPACK_LANES, d - lane0);
  const int rows = (int)min((int64_t)UNPACK_ROWS, m - row0);
  const int n = rows * lanes;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int rr = e / lanes, l = e - rr * lanes;
    tile[l][rr] = buf[(row0 + rr) * d + lane0 + l];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int l = e / rows, rr = e - l * rows;
    out[(int64_t)(lane0 + l) * m + row0 + rr] = tile[l][rr];
  }
}

#define MEMBER_THREADS 256
#define MEMBER_ITEMS 8      // consecutive keys a thread takes a round
#define MEMBER_SORTED 256   // the largest set a block sorts (a key a thread)
#define MEMBER_PER_SM 4     // blocks of the persistent grid an SM
#define MEMBER_STAGE 2048   // keys a stage of member_staged_kernel

// out[i] = keys[i] in heavy, for m <= MEMBER_SORTED. Key i lies at
// base[i + HEAD]: base is keys' 16-byte boundary at or below it.
template <int HEAD>
__global__ void __launch_bounds__(MEMBER_THREADS, MEMBER_PER_SM)
member_sorted_kernel(const int64_t* __restrict__ base, int64_t n,
                     const int64_t* __restrict__ heavy, int m,
                     uint8_t* __restrict__ out) {
  __shared__ int64_t s_set[MEMBER_SORTED];
  __shared__ int64_t s_sorted[MEMBER_SORTED];
  const int i = threadIdx.x;
  const int64_t mine = i < m ? heavy[i] : I64_MAX_;
  s_set[i] = mine;
  const int count = __syncthreads_count(mine != I64_MAX_);
  if (mine != I64_MAX_) {  // rank sort; ties by index
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const int64_t h = s_set[j];
      rank += h < mine || (h == mine && j < i);
    }
    s_sorted[rank] = mine;
  }
  int P = 1;  // slots searched: a power of two, at least one
  while (P < count) P <<= 1;
  if (i >= count && i < P) s_sorted[i] = I64_MAX_;
  __syncthreads();
  const int64_t chunks = (n + MEMBER_ITEMS - 1) / MEMBER_ITEMS;
  constexpr int WORDS = MEMBER_ITEMS / 2 + HEAD;  // 16-byte words a round
  for (int64_t c = (int64_t)blockIdx.x * MEMBER_THREADS + i; c < chunks;
       c += (int64_t)gridDim.x * MEMBER_THREADS) {
    const int64_t r0 = c * MEMBER_ITEMS;  // this round's first key
    longlong2 w[WORDS];
#pragma unroll
    for (int j = 0; j < WORDS; ++j)  // a word that holds a key before n
      w[j] = r0 + 2 * j - HEAD < n
                 ? __ldg(reinterpret_cast<const longlong2*>(base + r0) + j)
                 : make_longlong2(0, 0);
    int64_t key[MEMBER_ITEMS];
    int at[MEMBER_ITEMS];
#pragma unroll
    for (int k = 0; k < MEMBER_ITEMS; ++k) {
      const longlong2 x = w[(k + HEAD) >> 1];
      key[k] = (k + HEAD) & 1 ? x.y : x.x;
      at[k] = 0;
    }
    for (int h = P >> 1; h > 0; h >>= 1) {
#pragma unroll
      for (int k = 0; k < MEMBER_ITEMS; ++k)
        at[k] += s_sorted[at[k] + h] <= key[k] ? h : 0;
    }
    uint64_t bits = 0;
#pragma unroll
    for (int k = 0; k < MEMBER_ITEMS; ++k)
      bits |= (uint64_t)(key[k] != I64_MAX_ && s_sorted[at[k]] == key[k])
              << (8 * k);
    if (r0 + MEMBER_ITEMS <= n) {
      *reinterpret_cast<uint64_t*>(out + r0) = bits;
    } else {
      for (int k = 0; r0 + k < n; ++k)
        out[r0 + k] = (uint8_t)(bits >> (8 * k));
    }
  }
}

// out[i] = keys[i] in heavy, for any m: every block walks its keys tile
// by tile, and each tile meets the set stage by stage (the loops are
// uniform over the block, so every thread reaches every barrier)
__global__ void member_staged_kernel(const int64_t* __restrict__ keys,
                                     int64_t n,
                                     const int64_t* __restrict__ heavy,
                                     int64_t m, uint8_t* __restrict__ out) {
  __shared__ int64_t sh[MEMBER_STAGE];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const int64_t key = i < n ? keys[i] : I64_MAX_;
    bool hit = false;
    for (int64_t s0 = 0; s0 < m; s0 += MEMBER_STAGE) {
      const int cnt = (int)min((int64_t)MEMBER_STAGE, m - s0);
      __syncthreads();
      for (int t = threadIdx.x; t < cnt; t += blockDim.x)
        sh[t] = heavy[s0 + t];
      __syncthreads();
      if (key != I64_MAX_)
        for (int t = 0; t < cnt; ++t) hit |= (sh[t] == key);
    }
    if (i < n) out[i] = hit ? 1 : 0;
  }
}

static int blocks_for(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 65535LL * 32) b = 65535LL * 32;  // grid-stride loops cover the rest
  return (int)b;
}

template <typename IdxT, typename OkT, bool REPL>
static void launch_tiles(const void* values, int64_t r, int d,
                        const void* idx, const void* ok, int64_t m,
                        int64_t repl, void* out, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t tiles = (m + PACK_TILE - 1) / PACK_TILE;
  const int64_t grid = (int64_t)(sms > 0 ? sms : 1) * PACK_PER_SM;
  const int B = (int)(tiles < grid ? tiles : grid);
  const bool pair = d % 2 == 0 &&
                    ((uintptr_t)values | (uintptr_t)out) % 16 == 0;
  if (pair)
    pack_rows_kernel<IdxT, OkT, REPL, 2><<<B, PACK_THREADS, 0, s>>>(
        (const int64_t*)values, r, d, (const IdxT*)idx, (const OkT*)ok, m,
        repl, (int64_t*)out);
  else
    pack_rows_kernel<IdxT, OkT, REPL, 1><<<B, PACK_THREADS, 0, s>>>(
        (const int64_t*)values, r, d, (const IdxT*)idx, (const OkT*)ok, m,
        repl, (int64_t*)out);
}

template <typename IdxT, typename OkT>
static void launch_pack(const void* values, int64_t r, int d,
                        const void* idx, const void* ok, int64_t m,
                        int64_t repl, void* out, cudaStream_t s) {
  if (repl > 0)
    launch_tiles<IdxT, OkT, true>(values, r, d, idx, ok, m, repl, out, s);
  else
    launch_tiles<IdxT, OkT, false>(values, r, d, idx, ok, m, repl, out, s);
}

// idx_bytes: 4 (int32) or 8 (int64); ok_bytes: 1 (bool) or 4 (int32);
// repl: 0 for pack_rows, the replication factor (>= 1) for
// replicate_scatter. Returns cudaGetLastError(), or -1 for a width the
// kernels do not take.
extern "C" int pack_rows_launch(const void* values, int64_t r, int d,
                                const void* idx, int idx_bytes,
                                const void* ok, int ok_bytes, int64_t m,
                                int64_t repl, void* out, void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_bytes == 4 && ok_bytes == 1)
    launch_pack<int32_t, uint8_t>(values, r, d, idx, ok, m, repl, out, s);
  else if (idx_bytes == 4 && ok_bytes == 4)
    launch_pack<int32_t, int32_t>(values, r, d, idx, ok, m, repl, out, s);
  else if (idx_bytes == 8 && ok_bytes == 1)
    launch_pack<int64_t, uint8_t>(values, r, d, idx, ok, m, repl, out, s);
  else if (idx_bytes == 8 && ok_bytes == 4)
    launch_pack<int64_t, int32_t>(values, r, d, idx, ok, m, repl, out, s);
  else
    return -1;
  return (int)cudaGetLastError();
}

extern "C" int unpack_cols_launch(const void* buf, int64_t m, int d,
                                  void* out, void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)((m + UNPACK_ROWS - 1) / UNPACK_ROWS),
            (unsigned)((d + UNPACK_LANES - 1) / UNPACK_LANES));
  unpack_cols_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const int64_t*)buf, m, d, (int64_t*)out);
  return (int)cudaGetLastError();
}

// keys 8-byte aligned, out 8-byte aligned. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for pointers it does not take.
extern "C" int member_mask_launch(const void* keys, int64_t n,
                                  const void* heavy, int64_t m, void* out,
                                  void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (((uintptr_t)keys & 7) != 0 || ((uintptr_t)out & 7) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (m > MEMBER_SORTED) {
    member_staged_kernel<<<blocks_for(n, 256), 256, 0, s>>>(
        (const int64_t*)keys, n, (const int64_t*)heavy, m, (uint8_t*)out);
    return (int)cudaGetLastError();
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  constexpr int64_t ROUND = MEMBER_ITEMS * MEMBER_THREADS;  // keys a block
  const int64_t rounds = (n + ROUND - 1) / ROUND;
  const int64_t grid = (int64_t)(sms > 0 ? sms : 1) * MEMBER_PER_SM;
  const int B = (int)(rounds < grid ? rounds : grid);
  const int64_t* k = (const int64_t*)keys;
  if (((uintptr_t)keys & 15) == 0)
    member_sorted_kernel<0><<<B, MEMBER_THREADS, 0, s>>>(
        k, n, (const int64_t*)heavy, (int)m, (uint8_t*)out);
  else
    member_sorted_kernel<1><<<B, MEMBER_THREADS, 0, s>>>(
        k - 1, n, (const int64_t*)heavy, (int)m, (uint8_t*)out);
  return (int)cudaGetLastError();
}
