// Tiled online-softmax attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ·
// flash_attention_pallas: for q (B, H, Sq, D) and k, v (B, Hkv, Sk, D),
// query head h reading KV head h / (H / Hkv),
//   s[r, c] = (q[r] . k[c]) * scale, then softcap * tanh(s / softcap)
//             when a softcap is given;
//   masked  = c < Sk, and c <= r when causal, and c > r - window when a
//             window is given (rows and columns both count from 0: no
//             query offset); masked scores are set to -1e30;
//   o[r]    = sum_c exp(s[r, c] - m) v[c] / max(sum_c exp(s[r, c] - m),
//             1e-30), by the online softmax over 64-column tiles.
// Inputs f32 or bf16, all arithmetic in f32, the output in q's dtype.
//
// What bounds it on the card: operations. A (b, h) pair does
// 4 * D * (unmasked pairs) flops and moves q, k, v and o once; at
// Gemma-2's global layer (S = 8192, D = 128, bf16) that is about 2,700
// flops per byte, far above the card's balance point (about 295), so
// the bound is the tensor cores' 989 TFLOP/s in bf16. This first version
// runs on the CUDA cores in f32 (the tensor cores would round the
// probabilities to bf16 before the P.V product, where the Pallas kernel
// keeps them in f32), so it can reach at best the 67 TFLOP/s f32 rate:
// a few percent of the bound.
// What the design does about it:
//   * one block of 256 threads per (64-row query tile, h, b); the query
//     tile, one 64-row K or V tile and the 64x64 probabilities sit in
//     shared memory as f32 (rows padded by 4 floats so that the float4
//     reads below hit distinct banks); K and V take turns in one buffer,
//     so that two blocks fit on an SM at D <= 128;
//   * a thread owns a 4x4 block of scores (rows 4*ty+i, columns tx+16*c)
//     and a 4 x D/16 block of the output (columns 4*tx+64*j+e), so that
//     every shared-memory read is a float4 feeding 4 to 16 FMAs;
//   * the K tiles that the causal or window mask hides from every row of
//     the query tile are skipped. Every row of a call keeps at least one
//     unmasked column (the wrapper refuses calls where a row has none),
//     so skipping changes nothing beyond rounding;
//   * the query tiles run from the last to the first, so that the
//     longest causal rows start first.
// Deterministic: every sum runs in a fixed order (a fixed shuffle tree
// across the 16 lanes of a row); no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64            // query rows per block
#define BK 64            // key rows per tile
#define THREADS 256
#define NEG_INF -1e30f

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

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
              int Sq, int Sk, int D, int causal, int window, float scale,
              float softcap) {
  extern __shared__ float4 smem4[];
  constexpr int LD = DP + 4;
  constexpr int PLD = BK + 4;
  constexpr int NJ = DP / 64;        // float4 groups of a thread's output row
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + BQ * LD;
  float* Ps = KVs + BK * LD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int64_t qbase = ((int64_t)b * H + h) * Sq * D;
  const int64_t kbase = ((int64_t)b * Hkv + hk) * Sk * D;

  load_tile<T, DP>(Qs, q, qbase, q0, Sq, D);

  const int q_last = min(q0 + BQ - 1, Sq - 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_last) : Sk - 1;

  float m[4], l[4], acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = lo / BK; kt <= hi / BK; ++kt) {
    __syncthreads();                 // the last tile's P.V is done
    load_tile<T, DP>(KVs, k, kbase, kt * BK, Sk, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * LD + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kb[c] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * c) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[i][c];
          x = fmaf(qa[i].x, kb[c].x, x);
          x = fmaf(qa[i].y, kb[c].y, x);
          x = fmaf(qa[i].z, kb[c].z, x);
          x = fmaf(qa[i].w, kb[c].w, x);
          s[i][c] = x;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = kt * BK + tx + 16 * c;
        float x = s[i][c] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        x = ok ? x : NEG_INF;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[i][c] - m_new);
        Ps[(ty * 4 + i) * PLD + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4 * NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();                 // every score read K; P is written
    load_tile<T, DP>(KVs, v, kbase, kt * BK, Sk, D);
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 t4 =
            *reinterpret_cast<const float4*>(&Ps[(ty * 4 + i) * PLD + kk]);
        pa[i][0] = t4.x;
        pa[i][1] = t4.y;
        pa[i][2] = t4.z;
        pa[i][3] = t4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &KVs[(kk + e) * LD + 4 * tx + 64 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][4 * j + 0] = fmaf(pa[i][e], vv.x, acc[i][4 * j + 0]);
            acc[i][4 * j + 1] = fmaf(pa[i][e], vv.y, acc[i][4 * j + 1]);
            acc[i][4 * j + 2] = fmaf(pa[i][e], vv.z, acc[i][4 * j + 2]);
            acc[i][4 * j + 3] = fmaf(pa[i][e], vv.w, acc[i][4 * j + 3]);
          }
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * tx + 64 * j + e;
        if (col < D)
          store_f(o, qbase + (int64_t)row * D + col, acc[i][4 * j + e] / den);
      }
  }
}

template <typename T, int DP>
static int launch(const void* q, const void* k, const void* v, void* o,
                  int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
                  int window, float scale, float softcap,
                  cudaStream_t st) {
  constexpr int LD = DP + 4;
  const size_t smem = sizeof(float) * ((BQ + BK) * LD + BQ * (BK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T, DP><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq, Sk, D,
      causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
                    int window, float scale, float softcap,
                    cudaStream_t st) {
  if (D <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                         scale, softcap, st);
  if (D <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                          scale, softcap, st);
  return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                        scale, softcap, st);
}

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); all contiguous, of one
// dtype (bf16 != 0: bfloat16, else float32). 1 <= D <= 256, H % Hkv ==
// 0, Sq, Sk >= 1. window <= 0: no window; softcap <= 0: no softcap. The
// caller checks that every row keeps an unmasked column. Returns
// cudaGetLastError() after the launch (nonzero: not launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      int bf16, int causal, int window,
                                      float scale, float softcap,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                                   window, scale, softcap, st);
  return launch_d<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                         scale, softcap, st);
}
