// Tiled attention backward for Hopper (sm_90a): the gradient of
// csrc/flash_attention.cu's forward, built as libraries of their own so
// that they compile in parallel: this file holds the CUDA-core path,
// csrc/flash_attention_bwd_tc.cu the tensor-core path.
//
// No TPU kernel is replaced here: the reference differentiates its XLA
// chunked_attention (src/repro/models/layers.py) and the Pallas kernel
// has no backward. These give the same gradient for the forward.
// Given q, k, v, the forward's o and row log-sum-exp lse, and the
// output's cotangent dO, per unmasked pair (the forward's masks):
//   S  = c tanh(s / c), s = scale q.k   (S = s without a softcap)
//   P  = exp(S - lse),  Delta = rowsum(dO * o),  dP = dO . v^T
//   dS = P (dP - Delta) (1 - (S / c)^2)   (the last factor 1 without one)
//   dq = scale dS . k,  dk = scale dS^T . q,  dv = P^T . dO
// with dk and dv summed over the H / Hkv query heads of a KV head.
//
// What bounds it: operations, 5 products of 2 D flops per unmasked pair
// and head; the two kernels of either path run 7 or more (S and dP are
// formed in both), and one exp per pair in each.
//
// Two kernels a call, no sum needs an atomic, so two launches are
// bit-identical:
// * dq kernel: one block per (64-row query tile, h, b) walks the key
//   tiles the masks leave (the forward's) and writes dq; it also writes
//   Delta for its rows, once, for both kernels;
// * dk/dv kernel, launched after it: one block per (64-key tile, KV
//   head, b) keeps its K and V tiles, walks the group's query heads (1
//   to 8, 7 among them) and, for each, the query tiles that see a key of
//   the tile, and sums dk and dv over them in registers.
//
// Two paths, chosen by kernels/flash_attention.py:bwd_kernel_path (each
// library launches its own and refuses nothing else), never as a
// fallback: the tensor cores for bf16 with D a multiple of 16 and at most
// 128; the CUDA cores (here) for the rest.
//
// CUDA cores (fa_bwd_dq_kernel, fa_bwd_dkdv_kernel): f32 inputs, bf16
// with D not a multiple of 16, and D above 128 (at D = 256 dk and dv of a
// 64-key tile would be 128 f32 registers a thread of a warpgroup each;
// Gemma 7B's head). The forward's CUDA-core design (256 threads, a
// thread's 4x4 block of a 64x64 score tile, 4 rows x D/16 columns of its
// output tile, f32 tiles in shared memory read as float4) in f32; the
// dk/dv kernel's query tile Q and dO take turns in one buffer (Q twice),
// so that D = 256 fits in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


#define BQ 64            // query rows per block
#define BK 64            // key rows per tile
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

// rows [row0, row0 + 64) of a (S, D) matrix into dst (64 x LD floats),
// zero beyond S rows and D columns.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t base, int row0, int S,
                                          int D) {
  constexpr int LD = DP + 4;
  for (int e = threadIdx.x; e < 64 * DP; e += THREADS) {
    const int row = e / DP, d = e % DP;
    const int g = row0 + row;
    dst[row * LD + d] =
        (g < S && d < D) ? load_f(src, base + (int64_t)g * D + d) : 0.0f;
  }
}

// out[i][c] = A[4 ty + i] . B[tx + 16 c] over DP columns, for two 64-row
// f32 tiles with rows of DP + 4 floats (the forward's score loop).
template <int DP>
__device__ __forceinline__ void tile_dots(float (&out)[4][4],
                                          const float* A, const float* B,
                                          int tx, int ty) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[i][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty * 4 + i) * LD + d]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bb[c] = *reinterpret_cast<const float4*>(&B[(tx + 16 * c) * LD + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = out[i][c];
        x = fmaf(a[i].x, bb[c].x, x);
        x = fmaf(a[i].y, bb[c].y, x);
        x = fmaf(a[i].z, bb[c].z, x);
        x = fmaf(a[i].w, bb[c].w, x);
        out[i][c] = x;
      }
  }
}

// acc[i][4 j + e] += sum over 64 kk of P[4 ty + i][kk] X[kk][4 tx + 64 j
// + e]: P a 64 x 64 tile with rows of 68 floats, X a 64-row tile with
// rows of DP + 4 (the forward's P.V loop).
template <int DP>
__device__ __forceinline__ void tile_pv(float (&acc)[4][DP / 16],
                                        const float* P, const float* X,
                                        int tx, int ty) {
  constexpr int LD = DP + 4;
  constexpr int NJ = DP / 64;
#pragma unroll 2
  for (int kk = 0; kk < 64; kk += 4) {
    float pa[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t4 =
          *reinterpret_cast<const float4*>(&P[(ty * 4 + i) * 68 + kk]);
      pa[i][0] = t4.x;
      pa[i][1] = t4.y;
      pa[i][2] = t4.z;
      pa[i][3] = t4.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 xx = *reinterpret_cast<const float4*>(
            &X[(kk + e) * LD + 4 * tx + 64 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * j + 0] = fmaf(pa[i][e], xx.x, acc[i][4 * j + 0]);
          acc[i][4 * j + 1] = fmaf(pa[i][e], xx.y, acc[i][4 * j + 1]);
          acc[i][4 * j + 2] = fmaf(pa[i][e], xx.z, acc[i][4 * j + 2]);
          acc[i][4 * j + 3] = fmaf(pa[i][e], xx.w, acc[i][4 * j + 3]);
        }
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const float* __restrict__ lse,
                     const T* __restrict__ dout, T* __restrict__ dq,
                     float* __restrict__ delta, int H, int Hkv, int Sq,
                     int Sk, int D, int causal, int window, float scale,
                     float softcap) {
  extern __shared__ float4 smem4[];
  __shared__ float lse_s[BQ], del_s[BQ];
  constexpr int LD = DP + 4;
  constexpr int PLD = BK + 4;
  constexpr int NJ = DP / 64;
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + BQ * LD;
  float* KVs = dOs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int64_t qbase = ((int64_t)b * H + h) * Sq * D;
  const int64_t kbase = ((int64_t)b * Hkv + hk) * Sk * D;
  const int64_t rbase = ((int64_t)b * H + h) * Sq;

  load_tile<T, DP>(Qs, q, qbase, q0, Sq, D);
  load_tile<T, DP>(dOs, dout, qbase, q0, Sq, D);
  __syncthreads();
  // Delta = rowsum(dO * o): a warp a row, a fixed shuffle tree
  for (int rr = warp; rr < BQ; rr += THREADS / 32) {
    const int row = q0 + rr;
    float acc = 0.0f;
    if (row < Sq)
      for (int d = lane; d < D; d += 32)
        acc = fmaf(dOs[rr * LD + d], load_f(o, qbase + (int64_t)row * D + d),
                   acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      del_s[rr] = acc;
      lse_s[rr] = row < Sq ? lse[rbase + row] : 0.0f;
      if (row < Sq) delta[rbase + row] = acc;
    }
  }

  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_last) : Sk - 1;

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.0f;

  for (int kt = lo / BK; kt <= hi / BK; ++kt) {
    __syncthreads();                 // the last tile's dS.K is done
    load_tile<T, DP>(KVs, v, kbase, kt * BK, Sk, D);
    __syncthreads();
    float dp[4][4];
    tile_dots<DP>(dp, dOs, KVs, tx, ty);
    __syncthreads();                 // every dP read V
    load_tile<T, DP>(KVs, k, kbase, kt * BK, Sk, D);
    __syncthreads();
    float s[4][4];
    tile_dots<DP>(s, Qs, KVs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = ty * 4 + i, row = q0 + rr;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kt * BK + tx + 16 * c;
        float x = s[i][c] * scale, fac = 1.0f;
        if (softcap > 0.0f) {
          const float t = tanhf(x / softcap);
          x = softcap * t;
          fac = 1.0f - t * t;
        }
        bool ok = row < Sq && col < Sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        const float p = ok ? expf(x - lse_s[rr]) : 0.0f;
        Ps[rr * PLD + tx + 16 * c] = p * (dp[i][c] - del_s[rr]) * fac;
      }
    }
    __syncthreads();                 // dS is written
    tile_pv<DP>(acc, Ps, KVs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * j + e;
        if (col < D)
          store_f(dq, qbase + (int64_t)row * D + col, acc[i][4 * j + e] * scale);
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dk,
                       T* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                       int D, int causal, int window, float scale,
                       float softcap) {
  extern __shared__ float4 smem4[];
  __shared__ float lse_s[BQ], del_s[BQ];
  constexpr int LD = DP + 4;
  constexpr int PLD = BQ + 4;
  constexpr int NJ = DP / 64;
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BK * LD;
  float* As = Vs + BK * LD;          // the query tile's Q or dO
  float* Ps = As + BQ * LD;          // P^T, then dS^T (keys x queries)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kt = blockIdx.x;         // the first tiles see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int k0 = kt * BK;
  const int64_t kbase = ((int64_t)b * Hkv + hk) * Sk * D;

  load_tile<T, DP>(Ks, k, kbase, k0, Sk, D);
  load_tile<T, DP>(Vs, v, kbase, k0, Sk, D);

  // the query rows that see a key of this tile
  const int k_last = min(k0 + BK - 1, Sk - 1);
  const int r_lo = causal ? k0 : 0;
  const int r_hi = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;

  float dka[4][4 * NJ], dva[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) {
      dka[i][j] = 0.0f;
      dva[i][j] = 0.0f;
    }

  for (int g = 0; g < group && r_lo <= r_hi; ++g) {
    const int h = hk * group + g;
    const int64_t qbase = ((int64_t)b * H + h) * Sq * D;
    const int64_t rbase = ((int64_t)b * H + h) * Sq;
    for (int qt = r_lo / BQ; qt <= r_hi / BQ; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();               // the last tile's dS^T.Q is done
      load_tile<T, DP>(As, q, qbase, q0, Sq, D);
      for (int rr = tid; rr < BQ; rr += THREADS) {
        const int row = q0 + rr;
        lse_s[rr] = row < Sq ? lse[rbase + row] : 0.0f;
        del_s[rr] = row < Sq ? delta[rbase + row] : 0.0f;
      }
      __syncthreads();
      // transposed scores: key rows 4 ty + i, query columns tx + 16 c
      float p[4][4], fac[4][4];
      tile_dots<DP>(p, Ks, As, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + ty * 4 + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = tx + 16 * c, row = q0 + rr;
          float x = p[i][c] * scale;
          fac[i][c] = 1.0f;
          if (softcap > 0.0f) {
            const float t = tanhf(x / softcap);
            x = softcap * t;
            fac[i][c] = 1.0f - t * t;
          }
          bool ok = row < Sq && col < Sk;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          p[i][c] = ok ? expf(x - lse_s[rr]) : 0.0f;
        }
      }
      __syncthreads();               // every score read Q
      load_tile<T, DP>(As, dout, qbase, q0, Sq, D);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          Ps[(ty * 4 + i) * PLD + tx + 16 * c] = p[i][c];
      __syncthreads();
      float dp[4][4];
      tile_dots<DP>(dp, Vs, As, tx, ty);
      tile_pv<DP>(dva, Ps, As, tx, ty);   // dv += P^T . dO
      __syncthreads();               // every thread is done with P^T, dO
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int rr = tx + 16 * c;
          Ps[(ty * 4 + i) * PLD + rr] =
              p[i][c] * (dp[i][c] - del_s[rr]) * fac[i][c];
        }
      load_tile<T, DP>(As, q, qbase, q0, Sq, D);
      __syncthreads();
      tile_pv<DP>(dka, Ps, As, tx, ty);   // dk += dS^T . Q
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * j + e;
        if (col < D) {
          store_f(dk, kbase + (int64_t)row * D + col, dka[i][4 * j + e] * scale);
          store_f(dv, kbase + (int64_t)row * D + col, dva[i][4 * j + e]);
        }
      }
  }
}

template <typename T, int DP>
static int launch_bwd(const void* q, const void* k, const void* v,
                      const void* o, const float* lse, const void* dout,
                      void* dq, void* dk, void* dv, float* delta, int B,
                      int H, int Hkv, int Sq, int Sk, int D, int causal,
                      int window, float scale, float softcap,
                      cudaStream_t st) {
  constexpr int LD = DP + 4;
  const size_t smem = sizeof(float) * (3 * 64 * LD + 64 * (64 + 4));
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 gq((Sq + BQ - 1) / BQ, H, B);
  fa_bwd_dq_kernel<T, DP><<<gq, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, lse,
      (const T*)dout, (T*)dq, delta, H, Hkv, Sq, Sk, D, causal, window,
      scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gk((Sk + BK - 1) / BK, Hkv, B);
  fa_bwd_dkdv_kernel<T, DP><<<gk, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, H, Hkv, Sq, Sk, D, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd_d(const void* q, const void* k, const void* v,
                        const void* o, const float* lse, const void* dout,
                        void* dq, void* dk, void* dv, float* delta, int B,
                        int H, int Hkv, int Sq, int Sk, int D, int causal,
                        int window, float scale, float softcap,
                        cudaStream_t st) {
  if (D <= 64)
    return launch_bwd<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H,
                             Hkv, Sq, Sk, D, causal, window, scale, softcap,
                             st);
  if (D <= 128)
    return launch_bwd<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H,
                              Hkv, Sq, Sk, D, causal, window, scale, softcap,
                              st);
  return launch_bwd<T, 256>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H,
                            Hkv, Sq, Sk, D, causal, window, scale, softcap,
                            st);
}

// q, o, dout, dq: (B, H, Sq, D); k, v, dk, dv: (B, Hkv, Sk, D), of one
// dtype (is_bf16 != 0: bfloat16, else float32); lse and delta (scratch,
// written here): (B, H, Sq) f32; all contiguous. The other arguments as
// flash_attention_launch's, with the lse its call wrote. Launches
// fa_bwd_dq_kernel, then fa_bwd_dkdv_kernel; returns cudaGetLastError()
// (nonzero: not launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int H, int Hkv, int Sq, int Sk, int D, int is_bf16,
    int causal, int window, float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return launch_bwd_d<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv,
                                       delta, B, H, Hkv, Sq, Sk, D, causal,
                                       window, scale, softcap, st);
  return launch_bwd_d<float>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H,
                             Hkv, Sq, Sk, D, causal, window, scale, softcap,
                             st);
}
