// Sorted-segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py ·
// segment_reduce_pallas: out[s, :] = sum of values[i, :] over the rows i
// with seg_ids[i] == s, for s in [0, S), in f32. Rows whose id lies
// outside [0, S) are dropped, wherever they stand: at either end (the
// -1 sentinels of invalid rows) or between two rows of one id, which
// are then summed across it. Empty segments give 0.
//
// Precondition: the in-range ids are non-decreasing (the dense group
// ids of a sorted bag). The kernel checks it as it reads the ids and
// stops with an error where it fails: a descending in-range pair, within
// a tile or across two, makes the block that sees it print the row and
// trap, so that the next synchronisation raises ("unspecified launch
// failure") and the process's CUDA context is lost, as with PyTorch's
// own device-side asserts. It never returns other sums than the plain
// version's; the check costs no host synchronisation.
//
// What bounds it on the card: bytes. Each row's id and its d values are
// read once (4 + 4d bytes) and each segment is written once (4d bytes);
// one add per value. The Pallas kernel built one-hot (rows x segments)
// tiles for the MXU, which is O(n*S) work; sorted ids make that
// unnecessary. With the bytes read once, what is left to cut is the
// instructions per row (a block's scans cost the same for any number of
// rows), so the design is two launches, no float atomics, no device-side
// list:
//   1. tile pass (sr_tile): a block takes a tile of 2048 rows (and up to
//      4 value columns: more columns run as more blocks along y, whose
//      values are read 4 bytes at a time; no caller passes more than 4)
//      and stages its ids and values in shared memory with 16-byte
//      coalesced loads (each thread's rows padded by 16 bytes, so that
//      the vector reads below hit distinct banks). Each thread then sums
//      its consecutive rows serially: 32 for one column (64 threads a
//      block), 16 for two, 8 for more (registers bound the rows it
//      holds), writing every run that starts and ends among them and
//      zeroing the ids skipped between two of its in-range ids. A
//      block-wide exclusive max-scan of the threads' last ids and a
//      segmented scan of their last runs' sums (warp shuffles, then the
//      warps' totals in order) join the runs that cross threads: the
//      thread where such a run ends writes it, and zeroes the ids
//      skipped since the last thread's id. The tile's first and last runs
//      (its lowest and highest in-range id) may continue in the
//      neighbouring tiles, so they go to the tile's carry record (ids and
//      sums) instead of the output.
//   2. carry pass (sr_carry): a warp per tile. The tile that holds a
//      boundary run's first rows owns it: it adds the carries of the
//      following tiles while they continue the run (32 tiles at a time,
//      each batch by a fixed shuffle tree, the batches in tile order)
//      and writes the sum. Neighbours and continuing tiles are found by
//      one batched scan each way (32 tiles a ballot). Each tile also
//      zeroes the ids between its last id and the next non-empty tile's
//      first (or S), and the first non-empty tile the ids below its
//      first.
// Every id in [0, S) is written exactly once. Every sum runs in an order
// fixed by the ids and the tile shape alone, so repeated runs are
// bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#define TILE 2048                  // rows per block of the tile pass
#define BATCH 8                    // rows a thread holds in registers
#define CARRY_THREADS 256          // carry pass: 8 warps, a tile each
#define FULL 0xffffffffu

// The tile pass's shape for DC value columns: each thread sums ITEMS
// consecutive rows (more for fewer columns, so that the block's scans
// spread over more rows while the registers stay within bounds).
template <int DC>
struct Tile {
  static constexpr int ITEMS = DC == 1 ? 32 : (DC == 2 ? 16 : 8);
  static constexpr int THREADS = TILE / ITEMS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int ID_STRIDE = ITEMS / 4 + 1;  // int4 (+1 pad)
  static constexpr int CH = ITEMS * DC / 4;        // float4 of values
  static constexpr int VS = CH + 1;                // ... (+1 pad)
  static constexpr size_t SMEM = (size_t)16 * THREADS * (ID_STRIDE + VS);
};

template <int DC>
__device__ __forceinline__ void write_run(float* __restrict__ out, int d,
                                          int j0, int nc, int s,
                                          const float* acc) {
  float* o = out + (int64_t)s * d + j0;
#pragma unroll
  for (int j = 0; j < DC; ++j)
    if (j < nc) o[j] = acc[j];
}

template <int DC>
__device__ __forceinline__ void zero_ids(float* __restrict__ out, int d,
                                         int j0, int nc, int a, int b) {
  for (int s = a; s < b; ++s) {
    float* o = out + (int64_t)s * d + j0;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (j < nc) o[j] = 0.0f;
  }
}

__device__ __noinline__ void descending(const char* where, int64_t row,
                                        int after, int id) {
  printf("segment_reduce: in-range seg_ids descend (%d after %d) %s row "
         "%lld; the kernel needs them non-decreasing\n",
         id, after, where, (long long)row);
  __trap();
}

// Tile pass. Writes the runs that start and end inside the tile and the
// ids skipped between them; tile_first/tile_last[t] get the tile's lowest
// and highest in-range id (-1 for a tile without one), carry_first/
// carry_last[t, :] the sums of those two runs within the tile (the same
// run when the two ids are equal).
template <int DC>
__global__ void __launch_bounds__(Tile<DC>::THREADS)
    sr_tile(const float* __restrict__ vals, const int32_t* __restrict__ seg,
            int64_t n, int d, int S, float* __restrict__ out,
            int32_t* __restrict__ tile_first, int32_t* __restrict__ tile_last,
            float* __restrict__ carry_first, float* __restrict__ carry_last) {
  constexpr int THREADS = Tile<DC>::THREADS, WARPS = Tile<DC>::WARPS;
  constexpr int ITEMS = Tile<DC>::ITEMS, ID_STRIDE = Tile<DC>::ID_STRIDE;
  constexpr int CH = Tile<DC>::CH, VS = Tile<DC>::VS;
  extern __shared__ float4 smem4[];
  int4* sid4 = reinterpret_cast<int4*>(smem4);
  float4* sval4 = smem4 + THREADS * ID_STRIDE;
  int* sid = reinterpret_cast<int*>(sid4);
  float* sval = reinterpret_cast<float*>(sval4);
  __shared__ int w_max[WARPS], w_min[WARPS], w_flag[WARPS];
  __shared__ float w_val[WARPS][DC];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * TILE;
  const int rows = (int)min((int64_t)TILE, n - row0);
  const int j0 = blockIdx.y * DC, nc = min(DC, d - j0);

  // ---- stage ids and values, thread-chunked with one pad float4 each
  if (rows == TILE && ((uintptr_t)seg & 15) == 0) {
    const int4* g = reinterpret_cast<const int4*>(seg + row0);
    for (int e = tid; e < TILE / 4; e += THREADS)
      sid4[(e / (ITEMS / 4)) * ID_STRIDE + e % (ITEMS / 4)] =
          __ldcs(g + e);
  } else {
    for (int r = tid; r < TILE; r += THREADS)
      sid[(r / ITEMS) * 4 * ID_STRIDE + r % ITEMS] =
          r < rows ? seg[row0 + r] : -1;
  }
  if (rows == TILE && nc == d && ((uintptr_t)vals & 15) == 0) {
    const float4* g = reinterpret_cast<const float4*>(vals + row0 * d);
    for (int e = tid; e < TILE * DC / 4; e += THREADS)
      sval4[(e / CH) * VS + e % CH] = __ldcs(g + e);
  } else {
    for (int f = tid; f < TILE * DC; f += THREADS) {
      const int r = f / DC, j = f % DC;
      sval[(r / ITEMS) * 4 * VS + (r % ITEMS) * DC + j] =
          (r < rows && j < nc) ? vals[(row0 + r) * d + j0 + j] : 0.0f;
    }
  }
  __syncthreads();

  // ---- the thread's rows in order, BATCH at a time from shared memory:
  // head = its first run, tail = its last
  int head = -1, tail = -1;
  bool single = true;
  float hsum[DC], acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) hsum[j] = acc[j] = 0.0f;
#pragma unroll 1
  for (int b0 = 0; b0 < ITEMS; b0 += BATCH) {
    int ids[BATCH];
    float v[BATCH * DC];
    const int4 a = sid4[tid * ID_STRIDE + b0 / 4];
    const int4 b = sid4[tid * ID_STRIDE + b0 / 4 + 1];
    ids[0] = a.x; ids[1] = a.y; ids[2] = a.z; ids[3] = a.w;
    ids[4] = b.x; ids[5] = b.y; ids[6] = b.z; ids[7] = b.w;
#pragma unroll
    for (int m = 0; m < BATCH * DC / 4; ++m) {
      const float4 x = sval4[tid * VS + b0 * DC / 4 + m];
      v[4 * m] = x.x; v[4 * m + 1] = x.y; v[4 * m + 2] = x.z;
      v[4 * m + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int s = ids[i];
      if ((unsigned)s >= (unsigned)S) continue;      // dropped, run goes on
      if (s != tail) {
        if (tail >= 0) {
          if (s < tail)
            descending("in a tile at", row0 + tid * ITEMS + b0 + i, tail, s);
          if (single) {
#pragma unroll
            for (int j = 0; j < DC; ++j) hsum[j] = acc[j];
            single = false;
          } else {
            write_run<DC>(out, d, j0, nc, tail, acc);  // inside the thread
          }
          zero_ids<DC>(out, d, j0, nc, tail + 1, s);
        } else {
          head = s;
        }
        tail = s;
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] += v[i * DC + j];
    }
  }
  if (single) {
#pragma unroll
    for (int j = 0; j < DC; ++j) hsum[j] = acc[j];
  }

  // ---- the tile's lowest and highest id, each thread's previous id
  int imax = tail;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(FULL, imax, off);
    if (lane >= off) imax = max(imax, up);
  }
  int imin = head >= 0 ? head : INT32_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    imin = min(imin, __shfl_xor_sync(FULL, imin, off));
  if (lane == 31) w_max[warp] = imax;
  if (lane == 0) w_min[warp] = imin;
  __syncthreads();
  int first = INT32_MAX, last = -1, wprev = -1;
#pragma unroll
  for (int u = 0; u < WARPS; ++u) {
    first = min(first, w_min[u]);
    last = max(last, w_max[u]);
    if (u < warp) wprev = max(wprev, w_max[u]);
  }
  int prev = __shfl_up_sync(FULL, imax, 1);
  prev = max(lane == 0 ? -1 : prev, wprev);           // last id before
  if (head >= 0 && head < prev)
    descending("between threads at", row0 + tid * ITEMS, prev, head);

  // ---- segmented scan of the last runs' sums across threads
  const bool nonempty = tail >= 0;
  bool flag = nonempty && !(single && head == prev);  // run starts here
  float val[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) val[j] = acc[j];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool fu = __shfl_up_sync(FULL, flag, off);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const float vu = __shfl_up_sync(FULL, val[j], off);
      if (lane >= off && !flag) val[j] = vu + val[j];
    }
    if (lane >= off) flag = flag || fu;
  }
  if (lane == 31) {
    w_flag[warp] = flag;
#pragma unroll
    for (int j = 0; j < DC; ++j) w_val[warp][j] = val[j];
  }
  __syncthreads();
  float pre[DC];                                      // warps before mine
#pragma unroll
  for (int j = 0; j < DC; ++j) pre[j] = 0.0f;
  for (int u = 0; u < warp; ++u) {
    const bool fl = w_flag[u];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      pre[j] = fl ? w_val[u][j] : pre[j] + w_val[u][j];
  }
  const bool fe = __shfl_up_sync(FULL, flag, 1);
  float before[DC];                                   // run `prev` so far
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    const float ve = __shfl_up_sync(FULL, val[j], 1);
    before[j] = lane == 0 ? pre[j] : (fe ? ve : pre[j] + ve);
  }

  const int64_t t = blockIdx.x;
  if (nonempty) {
    const bool cont = head == prev;
    if (!cont && prev >= 0) {                         // `prev` ended before
      if (prev == first)
        write_run<DC>(carry_first, d, j0, nc, (int)t, before);
      else
        write_run<DC>(out, d, j0, nc, prev, before);
      zero_ids<DC>(out, d, j0, nc, prev + 1, head);
    }
    if (!single) {                                    // head ends in here
      float tot[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j)
        tot[j] = cont ? before[j] + hsum[j] : hsum[j];
      if (head == first)
        write_run<DC>(carry_first, d, j0, nc, (int)t, tot);
      else
        write_run<DC>(out, d, j0, nc, head, tot);
    }
  }
  if (tid == THREADS - 1) {          // the tile's last run: val is its sum
    if (blockIdx.y == 0) {
      tile_first[t] = last >= 0 ? first : -1;
      tile_last[t] = last;
    }
    if (last >= 0) {
      float tot[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) tot[j] = flag ? val[j] : pre[j] + val[j];
      write_run<DC>(carry_last, d, j0, nc, (int)t, tot);
      if (first == last) write_run<DC>(carry_first, d, j0, nc, (int)t, tot);
    }
  }
}

// The first tile q from `start` on, walking by `dir` (+1 or -1), for
// which hit(q) holds; -1 if there is none. 32 tiles a batch, each settled
// by a ballot; every lane of the warp gets the answer.
template <class Hit>
__device__ int scan_tiles(int NT, int start, int dir, int lane, Hit hit) {
  for (int base = start; base >= 0 && base < NT; base += 32 * dir) {
    const int q = base + dir * lane;
    const unsigned m = __ballot_sync(FULL, q >= 0 && q < NT && hit(q));
    if (m) return base + dir * (__ffs(m) - 1);
  }
  return -1;
}

__device__ void zero_span(float* __restrict__ out, int64_t a, int64_t b,
                          int d, int lane) {
  for (int64_t e = a * d + lane; e < b * d; e += 32) out[e] = 0.0f;
}

// Carry pass: a warp per tile (see the note at the top). Its neighbours
// and the tiles that continue its last run are found by scans from t - 1
// down and from t + 1 up, whose first batch settles nearly every tile.
__global__ void __launch_bounds__(CARRY_THREADS)
    sr_carry(const int32_t* __restrict__ tile_first,
             const int32_t* __restrict__ tile_last,
             const float* __restrict__ carry_first,
             const float* __restrict__ carry_last, int NT, int d, int S,
             float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int t = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (t >= max(NT, 1)) return;
  auto nonempty = [&](int q) { return tile_first[q] >= 0; };
  const int first = t < NT ? tile_first[t] : -1;
  if (first < 0) {                   // no in-range id: only tile 0 acts,
    if (t == 0 && scan_tiles(NT, 0, 1, lane, nonempty) < 0)
      zero_span(out, 0, S, d, lane); // and only where no tile has one
    return;
  }
  const int last = tile_last[t];
  const int p = scan_tiles(NT, t - 1, -1, lane, nonempty);
  const int q = scan_tiles(NT, t + 1, 1, lane, nonempty);
  const int prev = p >= 0 ? tile_last[p] : -1;  // the neighbouring
  const int next = q >= 0 ? tile_first[q] : S;  // non-empty tiles' ids
  if (prev > first) {
    if (lane == 0) descending("at the tile of", (int64_t)t * TILE, prev, first);
    __syncwarp();
  }
  if (prev < 0) zero_span(out, 0, first, d, lane);
  if (next > last + 1) zero_span(out, last + 1, next, d, lane);
  if (first != last && prev != first)      // the first run is all here
    for (int j = lane; j < d; j += 32)
      out[(int64_t)first * d + j] = carry_first[(int64_t)t * d + j];
  if (first == last && prev == first) return;   // an earlier tile owns it
  // own the last run: the tiles [t + 1, end) that hold it or no id
  const int s = last;
  int end = t + 1;
  if (next == s) {
    const int e = scan_tiles(NT, q, 1, lane, [&](int r) {
      const int f = tile_first[r];
      return (f >= 0 && f != s) || (f == s && tile_last[r] != s);
    });
    end = e < 0 ? NT : e + (tile_first[e] == s ? 1 : 0);
  }
  for (int j = 0; j < d; ++j) {     // in tile order, 32 tiles a time
    float sum = carry_last[(int64_t)t * d + j];
    for (int base = t + 1; base < end; base += 32) {
      const int r = base + lane;
      float x = (r < end && tile_first[r] == s)
                    ? carry_first[(int64_t)r * d + j] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(FULL, x, off);
      sum += __shfl_sync(FULL, x, 0);
    }
    if (lane == 0) out[(int64_t)s * d + j] = sum;
  }
}

template <int DC>
static cudaError_t launch_tile(int NT, int groups, cudaStream_t st,
                               const float* vals, const int32_t* seg,
                               int64_t n, int d, int S, float* out,
                               int32_t* tf, int32_t* tl, float* cf,
                               float* cl) {
  const size_t smem = Tile<DC>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      sr_tile<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sr_tile<DC><<<dim3(NT, groups), Tile<DC>::THREADS, smem, st>>>(
      vals, seg, n, d, S, out, tf, tl, cf, cl);
  return cudaSuccess;
}

// n rows of d >= 1 f32 values and int32 ids; S >= 1 segments. Scratch
// for NT = ceil(n / 2048) tiles (refused if `tiles` differs): tile_first
// and tile_last hold NT int32 each, carry_first and carry_last NT rows
// of d floats. Returns cudaGetLastError() after the launches (nonzero:
// not launched).
extern "C" int segment_reduce_launch(const void* vals, const void* seg,
                                     int64_t n, int d, int64_t S, void* out,
                                     int64_t tiles, void* tile_first,
                                     void* tile_last, void* carry_first,
                                     void* carry_last, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || d < 1 || S < 1 || S >= INT32_MAX || n >= INT32_MAX ||
      tiles != (n + TILE - 1) / TILE)
    return (int)cudaErrorInvalidValue;
  const int NT = (int)tiles;
  const int DC = d < 4 ? d : 4, groups = (d + DC - 1) / DC;
  const float* v = (const float*)vals;
  const int32_t* g = (const int32_t*)seg;
  float* o = (float*)out;
  int32_t *tf = (int32_t*)tile_first, *tl = (int32_t*)tile_last;
  float *cf = (float*)carry_first, *cl = (float*)carry_last;
  if (NT > 0) {
    const int s = (int)S;
    const cudaError_t err =
        DC == 1   ? launch_tile<1>(NT, groups, st, v, g, n, d, s, o, tf, tl,
                                   cf, cl)
        : DC == 2 ? launch_tile<2>(NT, groups, st, v, g, n, d, s, o, tf, tl,
                                   cf, cl)
        : DC == 3 ? launch_tile<3>(NT, groups, st, v, g, n, d, s, o, tf, tl,
                                   cf, cl)
                  : launch_tile<4>(NT, groups, st, v, g, n, d, s, o, tf, tl,
                                   cf, cl);
    if (err != cudaSuccess) return (int)err;
  }
  const int warps = NT > 0 ? NT : 1;
  sr_carry<<<(warps + CARRY_THREADS / 32 - 1) / (CARRY_THREADS / 32),
             CARRY_THREADS, 0, st>>>(
      tf, tl, cf, cl, NT, d, (int)S, o);
  return (int)cudaGetLastError();
}
