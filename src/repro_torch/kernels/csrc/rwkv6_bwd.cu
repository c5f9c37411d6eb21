// RWKV-6 (Finch) recurrence's backward for Hopper (sm_90a): the gradient
// of csrc/rwkv6_scan.cu's forward, built as a library of its own so that
// the two compile in parallel.
//
// No TPU kernel is replaced here: the reference differentiates its XLA
// rwkv6_chunked (src/repro/models/ssm.py) and the Pallas kernel has no
// backward. This gives the gradient of the recurrence for the
// output's cotangent do. With G_t = dL/dS_t, G_{T-1} = 0 and
// G_{t-1} = diag(w_t) G_t + r_t do_t^T:
//   dr_t = S_{t-1} do_t + (u k_t)(v_t . do_t)
//   dk_t = G_t v_t + (u r_t)(v_t . do_t)
//   dv_t = G_t^T k_t + (r_t . (u k_t)) do_t
//   dw_t = rowsum(G_t * S_{t-1}), 0 where w_t < 1e-12 (the reference's
//          log(maximum(w, 1e-12)) gives those no gradient)
//   du   = sum over b and t of r_t k_t (v_t . do_t): this kernel writes
//          each (b, h)'s partial sum; the caller sums them over b.
//
// What bounds it: bytes (r, k, v, w and do read, dr, dk, dv and dw
// written, plus the chunk states below, once each). Design, simple first:
//   * one block of 256 threads per (b, h); each thread owns fixed
//     elements (c, j) of the K x V state S and of G, in registers. Both
//     recurrences are then elementwise: no sum across threads;
//   * S_{t-1} is needed in reverse and w is never divided by: a first
//     pass runs S forward and writes it at every chunk start (every C
//     steps) to scratch, f32 (B, H, T / C, K, V). The backward walks the
//     chunks from the last. A chunk is formed again from its start, in
//     sub-chunks of R steps (R as many as shared memory holds: 6 at K =
//     V = 64), the state at each sub-chunk start going to a second
//     scratch (ceil(C / R) states a block); then its sub-chunks are
//     taken from the last: each from its start state, its R states and
//     R values of G to shared memory, and the outputs of its R steps
//     come from them in parallel: a
//     thread per (t, c) for dr, dk and dw (V-term sums, their order
//     rotated by c so that the lanes read distinct banks), a thread per
//     (t, j) for dv (K-term sums);
//   * inputs come into shared memory R steps at a time, as f32. Where V
//     divides the block's 256 threads, a thread's elements share one
//     column j (c steps by 256 / V), which takes the divisions out of
//     the recurrences.
// Deterministic: every sum runs in a fixed order; no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define MAX_SMEM 232448          // a block's shared memory on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i,
                                        float x) {
  p[i] = __float2bfloat16(x);
}

#define BWD_RESERVE 1024         // shared bytes kept for the dot products

struct BwdDims {
  int H, T, K, V, C, R;          // R: steps staged in shared memory
};

// The state element e = tid + THREADS i of the calling thread as (c, j),
// e = c V + j; false beyond K V.
__device__ __forceinline__ bool bwd_elem(const BwdDims& D, int i, int& c,
                                         int& j) {
  if (THREADS % D.V == 0) {       // one column a thread
    j = threadIdx.x % D.V;
    c = threadIdx.x / D.V + (THREADS / D.V) * i;
    return c < D.K;
  }
  const int e = threadIdx.x + THREADS * i;
  c = e / D.V;
  j = e - c * D.V;
  return c < D.K;
}

// Steps [t0, t0 + n) of the (b, h) row's k, w, v (and r, do where given)
// into shared memory as f32: rows of K (k, w, r) and V (v, do) floats.
template <typename T>
__device__ void bwd_stage(const BwdDims& D, int64_t bh, int t0, int n,
                          const T* __restrict__ k, const T* __restrict__ w,
                          const T* __restrict__ v, const T* __restrict__ r,
                          const T* __restrict__ dout, float* Ks, float* Ws,
                          float* Vs, float* Rs, float* DOs) {
  const int64_t kb = (bh * D.T + t0) * D.K, vb = (bh * D.T + t0) * D.V;
  for (int e = threadIdx.x; e < n * D.K; e += THREADS) {
    Ks[e] = to_f(k[kb + e]);
    Ws[e] = to_f(w[kb + e]);
    if (r != nullptr) Rs[e] = to_f(r[kb + e]);
  }
  for (int e = threadIdx.x; e < n * D.V; e += THREADS) {
    Vs[e] = to_f(v[vb + e]);
    if (dout != nullptr) DOs[e] = to_f(dout[vb + e]);
  }
}

// S <- diag(w_t) S + k_t v_t^T over the n staged steps, on the thread's
// NE elements e = tid + THREADS i (c = e / V, j = e % V).
template <int NE>
__device__ __forceinline__ void bwd_advance(const BwdDims& D, float (&s)[NE],
                                            int n, const float* Ks,
                                            const float* Ws,
                                            const float* Vs) {
  for (int t = 0; t < n; ++t) {
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      int c, j;
      if (bwd_elem(D, i, c, j))
        s[i] = fmaf(Ks[t * D.K + c], Vs[t * D.V + j], Ws[t * D.K + c] * s[i]);
    }
  }
}

template <typename T, int NE>
__global__ void __launch_bounds__(THREADS)
    rwkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ w,
                     const float* __restrict__ u, const T* __restrict__ dout,
                     T* __restrict__ dr, T* __restrict__ dk,
                     T* __restrict__ dv, T* __restrict__ dw,
                     float* __restrict__ du_part, float* __restrict__ ckpt,
                     float* __restrict__ subst, const BwdDims D) {
  extern __shared__ float4 smem4[];
  const int K = D.K, V = D.V, R = D.R, KV = K * V;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Ws = Ks + R * K;
  float* Rs = Ws + R * K;
  float* Vs = Rs + R * K;
  float* DOs = Vs + R * V;
  float* As = DOs + R * V;           // v_t . do_t
  float* Bs = As + R;                // r_t . (u k_t)
  float* Sb = Bs + R;                // the R states S_{t-1}
  float* Gb = Sb + R * KV;           // the R values of G_t

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t bh = blockIdx.x;
  const int h = (int)(bh % D.H);
  const int NC = (D.T + D.C - 1) / D.C;
  const int NS = (D.C + R - 1) / R;  // sub-chunks of a chunk
  float* ck = ckpt + bh * NC * KV;
  float* sb = subst + bh * NS * KV;

  // pass 1: S at every chunk start
  float s[NE], g[NE];
#pragma unroll
  for (int i = 0; i < NE; ++i) s[i] = 0.0f;
  for (int t0 = 0; t0 < D.T; t0 += D.C) {
#pragma unroll
    for (int i = 0; i < NE; ++i)
      if (tid + THREADS * i < KV) ck[(int64_t)(t0 / D.C) * KV + tid + THREADS * i] = s[i];
    const int t1 = min(t0 + D.C, D.T);
    for (int a = t0; a < t1; a += R) {
      const int n = min(R, t1 - a);
      __syncthreads();
      bwd_stage<T>(D, bh, a, n, k, w, v, nullptr, nullptr, Ks, Ws, Vs, Rs,
                   DOs);
      __syncthreads();
      bwd_advance<NE>(D, s, n, Ks, Ws, Vs);
    }
  }

  // pass 2: the chunks and their sub-chunks from the last
  float du = 0.0f;                   // thread c < K: its channel's sum
#pragma unroll
  for (int i = 0; i < NE; ++i) g[i] = 0.0f;
  for (int n0 = NC - 1; n0 >= 0; --n0) {
    const int t0 = n0 * D.C, t1 = min(t0 + D.C, D.T);
    // the chunk again from its start, each sub-chunk's start state kept
#pragma unroll
    for (int i = 0; i < NE; ++i)
      if (tid + THREADS * i < KV) s[i] = ck[(int64_t)n0 * KV + tid + THREADS * i];
    for (int a2 = t0; a2 < t1; a2 += R) {
#pragma unroll
      for (int i = 0; i < NE; ++i)
        if (tid + THREADS * i < KV) sb[(int64_t)((a2 - t0) / R) * KV + tid + THREADS * i] = s[i];
      const int n2 = min(R, t1 - a2);
      __syncthreads();
      bwd_stage<T>(D, bh, a2, n2, k, w, v, nullptr, nullptr, Ks, Ws, Vs, Rs,
                   DOs);
      __syncthreads();
      bwd_advance<NE>(D, s, n2, Ks, Ws, Vs);
    }
    for (int a = t0 + (t1 - 1 - t0) / R * R; a >= t0; a -= R) {
      const int n = min(R, t1 - a);
      // S_{a-1}: the sub-chunk's start state
#pragma unroll
      for (int i = 0; i < NE; ++i)
        if (tid + THREADS * i < KV) s[i] = sb[(int64_t)((a - t0) / R) * KV + tid + THREADS * i];
      __syncthreads();
      bwd_stage<T>(D, bh, a, n, k, w, v, r, dout, Ks, Ws, Vs, Rs, DOs);
      __syncthreads();
      // the sub-chunk's states S_{t-1} and G_t, and its dot products
      for (int t = 0; t < n; ++t) {
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          int c, j;
          if (bwd_elem(D, i, c, j)) {
            Sb[t * KV + c * V + j] = s[i];
            s[i] = fmaf(Ks[t * K + c], Vs[t * V + j], Ws[t * K + c] * s[i]);
          }
        }
      }
      for (int t = n - 1; t >= 0; --t) {
#pragma unroll
        for (int i = 0; i < NE; ++i) {
          int c, j;
          if (bwd_elem(D, i, c, j)) {
            Gb[t * KV + c * V + j] = g[i];
            g[i] = fmaf(Rs[t * K + c], DOs[t * V + j], Ws[t * K + c] * g[i]);
          }
        }
      }
      for (int t = warp; t < n; t += THREADS / 32) {
        float x = 0.0f, y = 0.0f;
        for (int j = lane; j < V; j += 32)
          x = fmaf(Vs[t * V + j], DOs[t * V + j], x);
        for (int c = lane; c < K; c += 32)
          y = fmaf(Rs[t * K + c], u[(int64_t)h * K + c] * Ks[t * K + c], y);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          x += __shfl_xor_sync(0xffffffffu, x, off);
          y += __shfl_xor_sync(0xffffffffu, y, off);
        }
        if (lane == 0) {
          As[t] = x;
          Bs[t] = y;
        }
      }
      __syncthreads();
      // dr, dk, dw: a thread per (t, c)
      for (int q = tid; q < n * K; q += THREADS) {
        const int t = q / K, c = q - t * K;
        const float* Sr = Sb + t * KV + c * V;
        const float* Gr = Gb + t * KV + c * V;
        float xr = 0.0f, xk = 0.0f, xw = 0.0f;
        const int j0 = c % V;            // rotated: distinct banks
        for (int jj = 0; jj < V; ++jj) {
          int j = jj + j0;
          j -= j >= V ? V : 0;
          const float sv = Sr[j], gv = Gr[j];
          xr = fmaf(sv, DOs[t * V + j], xr);
          xk = fmaf(gv, Vs[t * V + j], xk);
          xw = fmaf(gv, sv, xw);
        }
        const float uk = u[(int64_t)h * K + c] * As[t];
        const int64_t o = (bh * D.T + a + t) * K + c;
        store_f(dr, o, fmaf(uk, Ks[t * K + c], xr));
        store_f(dk, o, fmaf(uk, Rs[t * K + c], xk));
        store_f(dw, o, Ws[t * K + c] < 1e-12f ? 0.0f : xw);
      }
      // dv: a thread per (t, j)
      for (int q = tid; q < n * V; q += THREADS) {
        const int t = q / V, j = q - t * V;
        float x = 0.0f;
        for (int c = 0; c < K; ++c)
          x = fmaf(Gb[t * KV + c * V + j], Ks[t * K + c], x);
        store_f(dv, (bh * D.T + a + t) * V + j,
                fmaf(Bs[t], DOs[t * V + j], x));
      }
      if (tid < K)
        for (int t = n - 1; t >= 0; --t)
          du = fmaf(Rs[t * K + tid] * Ks[t * K + tid], As[t], du);
    }
  }
  if (tid < K) du_part[bh * K + tid] = du;
}

// R, the steps a block stages in shared memory: its inputs, states and
// values of G, as many as fit, at most C (0: not even one).
extern "C" int rwkv6_bwd_steps(int K, int V, int C) {
  const size_t step = sizeof(float) * (3 * K + 2 * V + 2 + 2 * K * V);
  const int R = (int)((MAX_SMEM - BWD_RESERVE) / step);
  return R < C ? R : C;
}

template <typename T, int NE>
static int launch_bwd(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* dout,
                      void* dr, void* dk, void* dv, void* dw, float* du_part,
                      float* ckpt, float* subst, int B, int H, int Tn, int K,
                      int V, int C, cudaStream_t st) {
  BwdDims D{H, Tn, K, V, C, rwkv6_bwd_steps(K, V, C)};
  if (D.R < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (3 * K + 2 * V + 2 + 2 * K * V) * (size_t)D.R;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_kernel<T, NE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_kernel<T, NE><<<B * H, THREADS, smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const T*)dout, (T*)dr, (T*)dk, (T*)dv, (T*)dw, du_part, ckpt, subst,
      D);
  return (int)cudaGetLastError();
}

// The thread's NE = 16 elements of the state cover K V <= 4096 (K = V =
// 64, RWKV-6 7B's heads); larger states are refused (one instantiation
// keeps the build short).
#define BWD_NE 16

// r, k, w, dr, dk, dw: (B, H, Tn, K); v, dout, dv: (B, H, Tn, V), of one
// dtype (bf16 != 0: bfloat16, else float32); u: (H, K) f32; du_part:
// (B, H, K) f32, each (b, h)'s share of du; ckpt and subst: f32 scratch
// of B * H * ceil(Tn / C) * K * V and B * H * ceil(C / R) * K * V floats
// (R = rwkv6_bwd_steps(K, V, C)). All contiguous. K V <= 4096, 1 <= C.
// Returns cudaGetLastError() after the launch (nonzero: not launched).
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const void* dout, void* dr, void* dk,
                                void* dv, void* dw, float* du_part,
                                float* ckpt, float* subst, int B, int H,
                                int Tn, int K, int V, int C, int bf16,
                                void* stream) {
  if (K < 1 || V < 1 || K * V > BWD_NE * THREADS || C < 1 || Tn < 1 ||
      B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_bwd<__nv_bfloat16, BWD_NE>(
                    r, k, v, w, u, dout, dr, dk, dv, dw, du_part, ckpt, subst,
                    B, H, Tn, K, V, C, st)
              : launch_bwd<float, BWD_NE>(r, k, v, w, u, dout, dr, dk, dv,
                                          dw, du_part, ckpt, subst, B, H, Tn,
                                          K, V, C, st);
}
