// Chunked RWKV-6 (Finch) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py · rwkv6_pallas:
// for r, k, w (B, H, T, K), v (B, H, T, V) and u (H, K), the linear
// recurrence with data-dependent per-channel decay
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
// in the Pallas kernel's chunked form. Within a chunk of C steps, with
// lw = log(max(w, 1e-12)), cwi its inclusive and cwe its exclusive
// cumulative sum over the chunk (all <= 0, so every exponential below is
// of a non-positive number):
//   A[t, i] = sum_c r[t,c] k[i,c] exp(cwe[t,c] - cwi[i,c])    for i < t,
//   A[t, t] = sum_c r[t,c] u[c] k[t,c],
//   o       = A v + (r * exp(cwe)) S,
//   S      <- diag(exp(cwi[C-1])) S + (k * exp(cwi[C-1] - cwi))^T v.
// The tail chunk runs as if padded with w = 1 and r = k = v = 0, as the
// Pallas kernel pads it. Inputs f32 or bf16 (u as f32), all arithmetic
// in f32, the output in r's dtype.
//
// What bounds it on the card: operations. The bytes are r, k, v, w read
// once and o written once; the chunked form does C * K exponentials and
// multiply-adds per pair (t, i) of a chunk plus the C x K x V products
// of o and S: at C = K = V = 64 in bf16 about 50 flops per byte, above
// the card's f32 balance point (67 TFLOP/s over 3.35 TB/s: 20), and the
// exponentials run on the special-function units at a quarter of the
// FMA rate or less. What the design does about it:
//   * one block of 256 threads per (b, h) walks the chunks in order, the
//     K x V f32 state resident in shared memory for the whole sequence
//     (the TPU kernel carried it in VMEM scratch over a sequential grid
//     axis; here a loop inside the block takes that axis's place);
//   * the chunk's r, k, v, the log-decay cumulative sums and A are
//     staged in shared memory, about 97 KB at C = K = V = 64 (two blocks
//     per SM) and 209 KB at K = V = 128. k and the sums are padded to
//     K + 1 floats a row, so that the lanes of a warp, which take
//     consecutive i, hit distinct banks;
//   * a thread per (t, i) for A, computing only the pairs below the
//     diagonal and the diagonal (the rest is 0); a thread per (t, v)
//     for o and per (c, v) for S;
//   * exp(cwe) and exp(cwi[C-1] - cwi) are applied to r and k in place
//     once per chunk instead of once per output.
// The exclusive sum is read as the inclusive sum of the row before (the
// Pallas kernel subtracts lw from the inclusive sum: the same number up
// to rounding). Deterministic: every sum runs in a fixed order; no
// atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ float load_f(const float* p, int64_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i,
                                        float x) {
  p[i] = __float2bfloat16(x);
}

static size_t smem_floats(int K, int V, int C) {
  return (size_t)C * K + 2 * (size_t)C * (K + 1) + (size_t)C * V +
         (size_t)C * C + (size_t)K * V + K;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, T* __restrict__ o, int H,
                 int Tn, int K, int V, int C) {
  extern __shared__ float4 smem4[];
  const int KP = K + 1;
  float* rs = reinterpret_cast<float*>(smem4);  // C x K   r, then r*exp(cwe)
  float* ks = rs + C * K;                       // C x KP  k, then k*exp(..)
  float* cw = ks + C * KP;                      // C x KP  lw, then cwi
  float* vs = cw + C * KP;                      // C x V
  float* As = vs + C * V;                       // C x C
  float* Ss = As + C * C;                       // K x V   state
  float* us = Ss + K * V;                       // K

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, h = bh % H;
  const int64_t kb = (int64_t)bh * Tn * K, vb = (int64_t)bh * Tn * V;

  for (int e = tid; e < K * V; e += THREADS) Ss[e] = 0.0f;
  for (int c = tid; c < K; c += THREADS) us[c] = u[(int64_t)h * K + c];

  for (int c0 = 0; c0 < Tn; c0 += C) {
    __syncthreads();                 // the last chunk's S update is done
    for (int e = tid; e < C * K; e += THREADS) {
      const int t = e / K, c = e % K, g = c0 + t;
      const bool in = g < Tn;
      const int64_t at = kb + (int64_t)g * K + c;
      rs[t * K + c] = in ? load_f(r, at) : 0.0f;
      ks[t * KP + c] = in ? load_f(k, at) : 0.0f;
      const float wv = in ? load_f(w, at) : 1.0f;
      cw[t * KP + c] = logf(fmaxf(wv, 1e-12f));
    }
    for (int e = tid; e < C * V; e += THREADS) {
      const int t = e / V, c = e % V, g = c0 + t;
      vs[t * V + c] = g < Tn ? load_f(v, vb + (int64_t)g * V + c) : 0.0f;
    }
    __syncthreads();
    for (int c = tid; c < K; c += THREADS) {     // inclusive sums over t
      float run = 0.0f;
      for (int t = 0; t < C; ++t) {
        run += cw[t * KP + c];
        cw[t * KP + c] = run;
      }
    }
    __syncthreads();
    for (int p = tid; p < C * C; p += THREADS) {
      const int t = p / C, i = p % C;
      float a = 0.0f;
      if (i < t) {
        const float* rt = rs + t * K;
        const float* ct = cw + (t - 1) * KP;     // cwe[t] = cwi[t - 1]
        const float* ki = ks + i * KP;
        const float* ci = cw + i * KP;
        for (int c = 0; c < K; ++c)
          a = fmaf(rt[c] * ki[c], expf(ct[c] - ci[c]), a);
      } else if (i == t) {
        const float* rt = rs + t * K;
        const float* kt = ks + t * KP;
        for (int c = 0; c < K; ++c) a = fmaf(rt[c] * us[c], kt[c], a);
      }
      As[t * C + i] = a;
    }
    __syncthreads();
    for (int e = tid; e < C * K; e += THREADS) {
      const int t = e / K, c = e % K;
      const float last = cw[(C - 1) * KP + c];
      const float cwe = t > 0 ? cw[(t - 1) * KP + c] : 0.0f;
      rs[t * K + c] *= expf(cwe);
      ks[t * KP + c] *= expf(last - cw[t * KP + c]);
    }
    __syncthreads();
    for (int e = tid; e < C * V; e += THREADS) {
      const int t = e / V, c = e % V, g = c0 + t;
      if (g >= Tn) continue;
      float a = 0.0f;
      for (int i = 0; i <= t; ++i) a = fmaf(As[t * C + i], vs[i * V + c], a);
      for (int j = 0; j < K; ++j) a = fmaf(rs[t * K + j], Ss[j * V + c], a);
      store_f(o, vb + (int64_t)g * V + c, a);
    }
    __syncthreads();                 // every o read the old state
    for (int e = tid; e < K * V; e += THREADS) {
      const int c = e / V, j = e % V;
      float a = expf(cw[(C - 1) * KP + c]) * Ss[e];
      for (int i = 0; i < C; ++i) a = fmaf(ks[i * KP + c], vs[i * V + j], a);
      Ss[e] = a;
    }
  }
}

// r, k, w: (B, H, Tn, K); v, o: (B, H, Tn, V); u: (H, K) float32; all
// contiguous; r, k, v, w, o of one dtype (bf16 != 0: bfloat16, else
// float32). 1 <= K, V <= 128, 1 <= C <= 64. Returns cudaGetLastError()
// after the launch (nonzero: not launched).
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* o, int B,
                            int H, int Tn, int K, int V, int C, int bf16,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (K < 1 || K > 128 || V < 1 || V > 128 || C < 1 || C > 64 || Tn < 1 ||
      B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * smem_floats(K, V, C);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(rwkv6_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rwkv6_kernel<__nv_bfloat16><<<B * H, THREADS, smem, st>>>(
        (const __nv_bfloat16*)r, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)w, (const float*)u,
        (__nv_bfloat16*)o, H, Tn, K, V, C);
  } else {
    err = cudaFuncSetAttribute(rwkv6_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rwkv6_kernel<float><<<B * H, THREADS, smem, st>>>(
        (const float*)r, (const float*)k, (const float*)v, (const float*)w,
        (const float*)u, (float*)o, H, Tn, K, V, C);
  }
  return (int)cudaGetLastError();
}
