// Fused sorted-segment sum + first-row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_fused.py ·
// segment_sum_first_pallas: per segment s in [0, S) it gives the f32 sums
// of the d value columns, the index of the segment's first row (INT32_MAX
// when the segment is empty) and that row's k int64 key lanes (0 when
// empty). Rows whose id lies outside [0, S) are dropped.
//
// Precondition: seg_ids are non-decreasing (sum_by / nest_level hand over
// the dense group ids of a sorted bag), so every segment is one
// contiguous run of rows.
//
// What bounds it on the card: bytes. Each row's id and values are read
// once (4 + 4d bytes), the keys only at each non-empty segment's first
// row (8k bytes), and each segment is written once (4d + 4 + 8k bytes);
// there is no arithmetic to speak of. The Pallas kernel compared every
// row with every segment of a block (one-hot tiles for the MXU), which
// is O(n*S) work; here the sorted ids make that unnecessary:
//   1. init:     fidx = INT32_MAX and run end = 0 for all S segments;
//   2. boundary: one thread per row; the first row of a run (id differs
//                from the previous row's, and lies in [0, S)) writes
//                fidx, the last row writes the run's end;
//   3. finish:   one thread per segment writes its key lanes (0 when
//                empty) and sums a run of at most SHORT_RUN rows in row
//                order; a longer run goes on a device-side list;
//   4. long:     one block per listed run sums it in block-strided f32
//                partials and a fixed shared-memory tree.
// Most groups of a GROUP BY are a few rows long, so step 3 keeps every
// lane busy; the list keeps a giant run (e.g. the invalid tail that a
// general join's padding folds into the last segment) off one thread
// without a host round trip. Every sum is taken in an order fixed by the
// run's start alone, so results are bit-identical from run to run: no
// float atomics (the one atomic only hands out list slots).

#include <cuda_runtime.h>
#include <stdint.h>

#define I32_MAX 2147483647
#define SHORT_RUN 64      // longest run one thread sums on its own
#define LONG_THREADS 256  // block size of the long-run pass (power of 2)
#define LONG_BLOCKS 264   // grid of the long-run pass (2 per SM)

__global__ void ssf_init(int64_t S, int32_t* __restrict__ fidx,
                         int32_t* __restrict__ send,
                         int32_t* __restrict__ nlong) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t0 == 0) *nlong = 0;
  for (int64_t s = t0; s < S; s += stride) {
    fidx[s] = I32_MAX;
    send[s] = 0;
  }
}

__global__ void ssf_boundary(const int32_t* __restrict__ seg, int64_t n,
                             int64_t S, int32_t* __restrict__ fidx,
                             int32_t* __restrict__ send) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t s = seg[i];
    if (s < 0 || s >= S) continue;
    if (i == 0 || seg[i - 1] != s) fidx[s] = (int32_t)i;
    if (i == n - 1 || seg[i + 1] != s) send[s] = (int32_t)(i + 1);
  }
}

__global__ void ssf_finish(const float* __restrict__ vals,
                           const int64_t* __restrict__ keys, int64_t S,
                           int d, int k, const int32_t* __restrict__ fidx,
                           const int32_t* __restrict__ send,
                           float* __restrict__ sums,
                           int64_t* __restrict__ fvals,
                           int32_t* __restrict__ long_list,
                           int32_t* __restrict__ nlong) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += stride) {
    int32_t start = fidx[s];
    if (start == I32_MAX) {            // empty segment
      for (int j = 0; j < d; ++j) sums[s * d + j] = 0.0f;
      for (int j = 0; j < k; ++j) fvals[s * k + j] = 0;
      continue;
    }
    for (int j = 0; j < k; ++j)
      fvals[s * k + j] = keys[(int64_t)start * k + j];
    int32_t end = send[s];
    if (end - start > SHORT_RUN) {
      long_list[atomicAdd(nlong, 1)] = (int32_t)s;
      continue;
    }
    for (int j = 0; j < d; ++j) {
      float acc = 0.0f;
      for (int64_t i = start; i < end; ++i) acc += vals[i * d + j];
      sums[s * d + j] = acc;
    }
  }
}

__global__ void ssf_sum_long(const float* __restrict__ vals, int d,
                             const int32_t* __restrict__ fidx,
                             const int32_t* __restrict__ send,
                             const int32_t* __restrict__ long_list,
                             const int32_t* __restrict__ nlong,
                             float* __restrict__ sums) {
  __shared__ float part[LONG_THREADS];
  const int t = threadIdx.x;
  const int count = *nlong;
  for (int e = blockIdx.x; e < count; e += gridDim.x) {
    const int64_t s = long_list[e];
    const int64_t start = fidx[s], end = send[s];
    for (int j = 0; j < d; ++j) {
      float acc = 0.0f;
      for (int64_t i = start + t; i < end; i += LONG_THREADS)
        acc += vals[i * d + j];
      part[t] = acc;
      __syncthreads();
      for (int off = LONG_THREADS / 2; off > 0; off >>= 1) {
        if (t < off) part[t] += part[t + off];
        __syncthreads();
      }
      if (t == 0) sums[s * d + j] = part[0];
      __syncthreads();
    }
  }
}

static int blocks_for(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 65535LL * 32) b = 65535LL * 32;  // grid-stride loops cover the rest
  return (int)b;
}

// long_list holds at least n / (SHORT_RUN + 1) entries (the most runs
// longer than SHORT_RUN that n rows can form); nlong is one int32.
extern "C" int segment_sum_first_launch(
    const void* vals, const void* keys, const void* seg, int64_t n, int d,
    int k, int64_t S, void* sums, void* fidx, void* fvals, void* send,
    void* long_list, void* nlong, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int T = 256;
  if (S > 0) {
    ssf_init<<<blocks_for(S, T), T, 0, st>>>(S, (int32_t*)fidx,
                                             (int32_t*)send,
                                             (int32_t*)nlong);
    if (n > 0)
      ssf_boundary<<<blocks_for(n, T), T, 0, st>>>(
          (const int32_t*)seg, n, S, (int32_t*)fidx, (int32_t*)send);
    ssf_finish<<<blocks_for(S, T), T, 0, st>>>(
        (const float*)vals, (const int64_t*)keys, S, d, k,
        (const int32_t*)fidx, (const int32_t*)send, (float*)sums,
        (int64_t*)fvals, (int32_t*)long_list, (int32_t*)nlong);
    if (n > SHORT_RUN && d > 0)
      ssf_sum_long<<<LONG_BLOCKS, LONG_THREADS, 0, st>>>(
          (const float*)vals, d, (const int32_t*)fidx,
          (const int32_t*)send, (const int32_t*)long_list,
          (const int32_t*)nlong, (float*)sums);
  }
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_first_short_run() { return SHORT_RUN; }
