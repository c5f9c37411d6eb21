// Sorted-segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_reduce.py ·
// segment_reduce_pallas: out[s, :] = sum of values[i, :] over the rows i
// with seg_ids[i] == s, for s in [0, S), in f32. Rows whose id lies
// outside [0, S) are dropped, wherever they stand: at either end (the
// -1 sentinels of invalid rows) or between two rows of one id, which
// are then summed across it.
//
// Precondition: the in-range ids are non-decreasing (the dense group
// ids of a sorted bag). The result does not depend on it: each segment
// sums, in row order, the rows of its id between its first and its last
// row, skipping the others. The cost does: with sorted ids those ranges
// are disjoint and every row is read once.
//
// What bounds it on the card: bytes. Each row's id and its d values are
// read once (4 + 4d bytes) and each segment is written once (4d bytes);
// one add per value. The Pallas kernel built one-hot (rows x segments)
// tiles for the MXU, which is O(n*S) work; sorted ids make that
// unnecessary:
//   1. init:     first = INT32_MAX and end = 0 for all S segments;
//   2. boundary: one thread per row; a row whose id differs from the
//                previous row's is a run start, from the next row's a
//                run end: atomicMin of the start into first[s],
//                atomicMax of the end into end[s] (integer atomics, so
//                the result is the same in any order; with sorted ids
//                each address is written once);
//   3. finish:   one thread per segment zeroes an empty one and sums a
//                range of at most SHORT_RUN rows in row order; a longer
//                range goes on a device-side list, ranges of at most
//                WARP_RUN rows from its front, longer ones from its back;
//   4. warp:     one warp per listed medium range: lane-strided partial
//                sums in row order and a fixed shuffle tree;
//   5. block:    one block per listed long range: block-strided partials
//                and a fixed shared-memory tree.
// Every sum is taken in an order fixed by the range alone, so repeated
// runs are bit-identical: no float atomics (the integer atomics set range
// ends, a minimum and a maximum that no order changes, and hand out list
// slots).

#include <cuda_runtime.h>
#include <stdint.h>

#define I32_MAX 2147483647
#define SHORT_RUN 32        // longest range one thread sums on its own
#define WARP_RUN 4096       // longest range one warp sums
#define THREADS 256         // block size of every pass (power of 2)
#define LIST_BLOCKS 1056    // grid of the warp and block passes (8 per SM)

__global__ void sr_init(int64_t S, int32_t* __restrict__ first,
                        int32_t* __restrict__ end,
                        int32_t* __restrict__ counts) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t t0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t0 == 0) {
    counts[0] = 0;
    counts[1] = 0;
  }
  for (int64_t s = t0; s < S; s += stride) {
    first[s] = I32_MAX;
    end[s] = 0;
  }
}

__global__ void sr_boundary(const int32_t* __restrict__ seg, int64_t n,
                            int64_t S, int32_t* __restrict__ first,
                            int32_t* __restrict__ end) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int32_t s = seg[i];
    if (s < 0 || s >= S) continue;
    if (i == 0 || seg[i - 1] != s) atomicMin(first + s, (int32_t)i);
    if (i == n - 1 || seg[i + 1] != s) atomicMax(end + s, (int32_t)(i + 1));
  }
}

__global__ void sr_finish(const float* __restrict__ vals,
                          const int32_t* __restrict__ seg, int64_t S, int d,
                          const int32_t* __restrict__ first,
                          const int32_t* __restrict__ end,
                          float* __restrict__ out,
                          int32_t* __restrict__ list, int64_t list_len,
                          int32_t* __restrict__ counts) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += stride) {
    const int32_t start = first[s];
    if (start == I32_MAX) {            // empty segment
      for (int j = 0; j < d; ++j) out[s * d + j] = 0.0f;
      continue;
    }
    const int32_t stop = end[s];
    if (stop - start > WARP_RUN) {
      list[list_len - 1 - atomicAdd(counts + 1, 1)] = (int32_t)s;
      continue;
    }
    if (stop - start > SHORT_RUN) {
      list[atomicAdd(counts, 1)] = (int32_t)s;
      continue;
    }
    for (int j = 0; j < d; ++j) {
      float acc = 0.0f;
      for (int64_t i = start; i < stop; ++i)
        if (seg[i] == s) acc += vals[i * d + j];
      out[s * d + j] = acc;
    }
  }
}

__global__ void sr_sum_warp(const float* __restrict__ vals,
                            const int32_t* __restrict__ seg, int d,
                            const int32_t* __restrict__ first,
                            const int32_t* __restrict__ end,
                            const int32_t* __restrict__ list,
                            const int32_t* __restrict__ counts,
                            float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int count = counts[0];
  for (int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       e < count; e += nwarps) {             // the same e in every lane
    const int32_t s = list[e];
    const int64_t start = first[s], stop = end[s];
    for (int j = 0; j < d; ++j) {
      float acc = 0.0f;
      for (int64_t i = start + lane; i < stop; i += 32)
        if (seg[i] == s) acc += vals[i * d + j];
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) out[(int64_t)s * d + j] = acc;
    }
  }
}

__global__ void sr_sum_block(const float* __restrict__ vals,
                             const int32_t* __restrict__ seg, int d,
                             const int32_t* __restrict__ first,
                             const int32_t* __restrict__ end,
                             const int32_t* __restrict__ list,
                             int64_t list_len,
                             const int32_t* __restrict__ counts,
                             float* __restrict__ out) {
  __shared__ float part[THREADS];
  const int t = threadIdx.x;
  const int count = counts[1];
  for (int e = blockIdx.x; e < count; e += gridDim.x) {
    const int32_t s = list[list_len - 1 - e];
    const int64_t start = first[s], stop = end[s];
    for (int j = 0; j < d; ++j) {
      float acc = 0.0f;
      for (int64_t i = start + t; i < stop; i += THREADS)
        if (seg[i] == s) acc += vals[i * d + j];
      part[t] = acc;
      __syncthreads();
      for (int off = THREADS / 2; off > 0; off >>= 1) {
        if (t < off) part[t] += part[t + off];
        __syncthreads();
      }
      if (t == 0) out[(int64_t)s * d + j] = part[0];
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

// first and end hold S int32 each; list holds list_len >= min(S, n)
// int32 entries (at most one per non-empty segment); counts two int32.
extern "C" int segment_reduce_launch(const void* vals, const void* seg,
                                     int64_t n, int d, int64_t S, void* out,
                                     void* first, void* end, void* list,
                                     int64_t list_len, void* counts,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S > 0) {
    sr_init<<<blocks_for(S, THREADS), THREADS, 0, st>>>(
        S, (int32_t*)first, (int32_t*)end, (int32_t*)counts);
    if (n > 0)
      sr_boundary<<<blocks_for(n, THREADS), THREADS, 0, st>>>(
          (const int32_t*)seg, n, S, (int32_t*)first, (int32_t*)end);
    sr_finish<<<blocks_for(S, THREADS), THREADS, 0, st>>>(
        (const float*)vals, (const int32_t*)seg, S, d,
        (const int32_t*)first, (const int32_t*)end, (float*)out,
        (int32_t*)list, list_len, (int32_t*)counts);
    if (n > SHORT_RUN && d > 0) {
      sr_sum_warp<<<LIST_BLOCKS, THREADS, 0, st>>>(
          (const float*)vals, (const int32_t*)seg, d, (const int32_t*)first,
          (const int32_t*)end, (const int32_t*)list,
          (const int32_t*)counts, (float*)out);
      if (n > WARP_RUN)
        sr_sum_block<<<LIST_BLOCKS, THREADS, 0, st>>>(
            (const float*)vals, (const int32_t*)seg, d,
            (const int32_t*)first, (const int32_t*)end,
            (const int32_t*)list, list_len, (const int32_t*)counts,
            (float*)out);
    }
  }
  return (int)cudaGetLastError();
}
