// Join inner loop kernels for Hopper (sm_90a): merge positions and row
// gather, the two halves of fk_join / general_join.
//
// merge_positions replaces the TPU kernel src/repro/kernels/gather_join.py ·
// merge_positions_pallas: (lo, hi) = the left and right searchsorted of
// each int64 query into the sorted int64 keys, as int32. Keys equal to
// INT64_MAX (the padding of invalid build rows) are ordinary values.
// gather_rows replaces gather_join.py · gather_rows_pallas:
// out[i, :] = values[idx[i], :] over int64 bit-view lanes, 0 for an index
// outside [0, r).
//
// What bounds them on the card: bytes. merge_positions must read the r
// keys and n queries once and write 2n int32 (8r + 8n + 8n bytes);
// gather_rows must read n indices and n*d lanes and write n*d lanes
// (8n + 16nd bytes). The Pallas kernels compared every query with every
// key (and every output row with every source row) in dense one-hot tiles
// shaped for the MXU, O(n*r) work. On Hopper each query is instead one
// binary search for lo, O(log r) dependent loads whose upper levels the
// 50 MB L2 absorbs, and a gallop from lo for hi (hi - lo is the number of
// equal keys: 0 or 1 on a unique build side); each gathered lane is one
// direct load: one thread per (row, lane), so neighbouring threads write
// neighbouring addresses. Both are exact integer work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void merge_positions_kernel(const int64_t* __restrict__ keys,
                                       int64_t r,
                                       const int64_t* __restrict__ queries,
                                       int64_t n, int32_t* __restrict__ lo_out,
                                       int32_t* __restrict__ hi_out) {
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t q = queries[i];
    int64_t a = 0, b = r;              // first key >= q
    while (a < b) {
      int64_t m = a + ((b - a) >> 1);
      if (keys[m] < q) a = m + 1; else b = m;
    }
    lo_out[i] = (int32_t)a;
    // first key > q: gallop from lo (a unique key needs one or two
    // loads), then a binary search inside the bracket it found
    int64_t below = a, step = 1;       // keys[x] <= q for every x < below
    b = a;
    while (b < r && keys[b] <= q) {
      below = b + 1;
      b = a + step;
      step <<= 1;
    }
    if (b > r) b = r;                  // keys[b] > q, or b == r
    a = below;
    while (a < b) {
      int64_t m = a + ((b - a) >> 1);
      if (keys[m] <= q) a = m + 1; else b = m;
    }
    hi_out[i] = (int32_t)a;
  }
}

__global__ void gather_rows_kernel(const int64_t* __restrict__ values,
                                   int64_t r, int d,
                                   const int64_t* __restrict__ idx, int64_t n,
                                   int64_t* __restrict__ out) {
  int64_t total = n * d;
  int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    int64_t i = t / d;
    int j = (int)(t - i * d);
    int64_t src = idx[i];
    out[t] = (src >= 0 && src < r) ? values[src * d + j] : 0;
  }
}

static int blocks_for(int64_t work, int threads) {
  int64_t b = (work + threads - 1) / threads;
  if (b < 1) b = 1;
  if (b > 65535LL * 32) b = 65535LL * 32;  // grid-stride loops cover the rest
  return (int)b;
}

extern "C" int merge_positions_launch(const void* keys, int64_t r,
                                      const void* queries, int64_t n,
                                      void* lo, void* hi, void* stream) {
  if (n > 0) {
    const int T = 256;
    merge_positions_kernel<<<blocks_for(n, T), T, 0, (cudaStream_t)stream>>>(
        (const int64_t*)keys, r, (const int64_t*)queries, n, (int32_t*)lo,
        (int32_t*)hi);
  }
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_launch(const void* values, int64_t r, int d,
                                  const void* idx, int64_t n, void* out,
                                  void* stream) {
  if (n > 0 && d > 0) {
    const int T = 256;
    gather_rows_kernel<<<blocks_for(n * d, T), T, 0, (cudaStream_t)stream>>>(
        (const int64_t*)values, r, d, (const int64_t*)idx, n,
        (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
