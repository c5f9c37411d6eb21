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
//   shaped for the MXU). Here each output element is one direct load:
//   one thread per (slot, lane) with the lanes innermost, so neighbouring
//   threads store neighbouring addresses of the (m, d) int64 output.
//   Floats travel as their int64 bits, so -0.0 and NaN payloads survive.
// replicate_scatter replaces shuffle_pack.py · replicate_scatter_pallas:
//   the same load from source row vidx[j] / repl, where ok[j], vidx[j] >= 0
//   and the row lies in range, else 0. vidx >= 0 is checked first, so the
//   truncating division equals the reference's floor division.
// unpack_cols replaces shuffle_pack.py · unpack_cols_pallas: the (m, d)
//   wire buffer transposed to (d, m). A block stages a tile of 128 rows by
//   up to 8 lanes in shared memory (rows padded by one against bank
//   conflicts): it reads the tile row by row, as the buffer lies, and
//   writes it lane by lane, so both sides coalesce. d is small (3-10
//   lanes), so the tile runs along the rows.
// member_mask replaces shuffle_pack.py · member_mask_pallas:
//   out[i] = keys[i] in heavy, where a key equal to INT64_MAX never
//   matches and a heavy slot holding INT64_MAX never matches. The heavy
//   set (40 keys on the planned path) is staged in shared memory, in
//   stages of 2048 keys when it is larger, and every key is compared with
//   every staged key: no assumption that the set is sorted.
//
// What bounds them on the card: bytes. pack_rows and replicate_scatter
// must read m indices and m flags and write m*d lanes, and read the m*d
// lanes they gather; unpack_cols reads and writes m*d lanes; member_mask
// reads n keys and writes n flags (the heavy set is a few hundred bytes).
// Each kernel touches each of those bytes once.

#include <cuda_runtime.h>
#include <stdint.h>

#define I64_MAX_ 0x7fffffffffffffffLL

template <typename IdxT, typename OkT, bool REPL>
__global__ void pack_rows_kernel(const int64_t* __restrict__ values,
                                 int64_t r, int d,
                                 const IdxT* __restrict__ idx,
                                 const OkT* __restrict__ ok, int64_t m,
                                 int64_t repl, int64_t* __restrict__ out) {
  const int64_t total = m * d;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int64_t j = t / d;
    const int lane = (int)(t - j * d);
    const int64_t v = (int64_t)idx[j];
    int64_t src = v;
    bool good = ok[j] != 0 && v >= 0;
    if (REPL) src = good ? v / repl : -1;
    good = good && src < r;
    out[t] = good ? values[src * d + lane] : 0;
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

#define MEMBER_STAGE 2048

__global__ void member_mask_kernel(const int64_t* __restrict__ keys,
                                   int64_t n,
                                   const int64_t* __restrict__ heavy,
                                   int64_t m, uint8_t* __restrict__ out) {
  __shared__ int64_t sh[MEMBER_STAGE];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  if (m <= MEMBER_STAGE) {
    // the whole set in one stage, loaded once per block
    for (int t = threadIdx.x; t < m; t += blockDim.x) sh[t] = heavy[t];
    __syncthreads();
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += stride) {
      const int64_t key = keys[i];
      bool hit = false;
      if (key != I64_MAX_)
        for (int t = 0; t < (int)m; ++t) hit |= (sh[t] == key);
      out[i] = hit ? 1 : 0;
    }
    return;
  }
  // a larger set: every block walks its keys tile by tile, and each tile
  // meets the set stage by stage (the loops are uniform over the block,
  // so every thread reaches every barrier)
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

template <typename IdxT, typename OkT>
static void launch_pack(const void* values, int64_t r, int d,
                        const void* idx, const void* ok, int64_t m,
                        int64_t repl, void* out, cudaStream_t s) {
  const int T = 256;
  const int B = blocks_for(m * d, T);
  if (repl > 0)
    pack_rows_kernel<IdxT, OkT, true><<<B, T, 0, s>>>(
        (const int64_t*)values, r, d, (const IdxT*)idx, (const OkT*)ok, m,
        repl, (int64_t*)out);
  else
    pack_rows_kernel<IdxT, OkT, false><<<B, T, 0, s>>>(
        (const int64_t*)values, r, d, (const IdxT*)idx, (const OkT*)ok, m,
        1, (int64_t*)out);
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

extern "C" int member_mask_launch(const void* keys, int64_t n,
                                  const void* heavy, int64_t m, void* out,
                                  void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int T = 256;
  member_mask_kernel<<<blocks_for(n, T), T, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, n, (const int64_t*)heavy, m, (uint8_t*)out);
  return (int)cudaGetLastError();
}
