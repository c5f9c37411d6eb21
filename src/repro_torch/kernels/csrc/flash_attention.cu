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
// Inputs f32 or bf16, the softmax in f32, the output in q's dtype.
//
// What bounds it on the card: operations. A (b, h) pair does
// 4 * D * (unmasked pairs) flops and moves q, k, v and o once; at
// Gemma-2's global layer (S = 8192, D = 128, bf16) that is about 2,700
// flops per byte, far above the card's balance point (about 295), so
// the bound is the tensor cores' 989 TFLOP/s in bf16. Each unmasked
// pair also needs one exp and, with a softcap, one tanh, on the SFU's
// 16 results per clock per SM: about 0.3 ms per transcendental at that
// layer, the same order as the products' bound.
//
// Two kernels, chosen by a rule in flash_attention_launch (which
// kernels/flash_attention.py:kernel_path states again, for counting),
// never as a fallback:
//
// * Tensor cores (fa_tc_kernel): bf16 inputs with D a multiple of 16.
//   S = Q.K^T runs as bf16 wgmma with f32 accumulators: a bf16 x bf16
//   product is exact in f32, so only the order of the sum differs from
//   an f32 dot product. P stays f32 for the row sums; for P.V it is
//   split into hi = bf16(P) and lo = bf16(P - hi) (P - hi is exact), and
//   hi.V + lo.V go into one f32 accumulator, so that P is carried to
//   |P - hi - lo| <= 2^-18 P and the output moves by at most 2^-18
//   max|v| against an f32 P.V. Design:
//     - one warpgroup (4 warps) per (64-row query tile, h, b), two per
//       SM; S (64 x 64 keys, 64 x 32 at D = 256) comes from Q and K in
//       shared memory (wgmma m64n64k16), and its fragments, converted in
//       registers, are the A operand of P.V, with V in shared memory as
//       the transposed B operand (m64nDk16);
//     - Q, K and V sit in shared memory as bf16 in the tensor cores'
//       128-byte swizzled layout (no bank conflicts), Q for the whole
//       loop, K and V in two stages each, filled by cp.async a tile
//       ahead; one barrier per tile;
//     - each tile issues its S and then the previous tile's P.V, waits
//       for S alone and runs its softmax while P.V runs on the tensor
//       cores (no product stays pending across tiles);
//     - the scores in log2 units (log2(e) folded into the scale or the
//       softcap), so that each probability is one ex2 on the SFU; tanh
//       by an odd polynomial below 0.6 and 1 - 2 / (1 + e^2y) above, to
//       a few f32 ulps, with the second branch (two SFU operations)
//       skipped by a warp whose arguments all lie below 0.6;
//     - only the tiles that the causal or window mask (or the end of the
//       keys) cut apply the mask; the tiles it hides from every row of
//       the query tile are skipped, which is exact while every row keeps
//       an unmasked key (the wrapper refuses other calls).
//   Next steps on this path: K and V by TMA into an mbarrier ring fed by
//   a producer warp, and two consumer warpgroups taking turns so that
//   one's softmax overlaps the other's products.
// * CUDA cores (fa_kernel): f32 inputs, and bf16 with D not a multiple
//   of 16. A bf16 split of f32 Q and K would break the score term of the
//   rounding bound, so f32 runs f32 FMAs:
//     - one block of 256 threads per (64-row query tile, h, b); the query
//       tile, one 64-row K or V tile and the 64x64 probabilities sit in
//       shared memory as f32 (rows padded by 4 floats so that the float4
//       reads below hit distinct banks); K and V take turns in one
//       buffer, so that two blocks fit on an SM at D <= 128;
//     - a thread owns a 4x4 block of scores (rows 4*ty+i, columns
//       tx+16*c) and a 4 x D/16 block of the output (columns 4*tx+64*j+e),
//       so that every shared-memory read is a float4 feeding 4 to 16 FMAs;
//     - masked tiles are skipped as above.
// Both run the query tiles from the last to the first, so that the
// longest causal rows start first. Deterministic: every sum runs in a
// fixed order (fixed shuffle trees within a row's lanes); no atomics, no
// split of the keys across blocks.

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

// ---------------------------------------------------------------------------
// the tensor-core path: bf16, D a multiple of 16
// ---------------------------------------------------------------------------

#define TC_THREADS 128   // one warpgroup
#define LOG2E 1.4426950408889634f
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes made visible to the tensor cores' reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma: the warpgroup's 64 x N products, issued asynchronously and
// completed in groups (wg_wait<n>: all but the newest n groups done).
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins fragments at this point of the program for the compiler, which
// does not know that a product writes them after its issue: placed after
// the wait that completes them and before the issue that uses them.
template <int N>
__device__ __forceinline__ void wg_pin(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Shared-memory operand descriptor of a tile in the 128-byte swizzled
// layout below: sbo is the byte stride between groups of 8 rows (1024);
// lbo, for an MN-major tile, the byte stride between its 64-column
// blocks (a K-major tile's depth stays inside one block).
__device__ __forceinline__ uint64_t wg_desc(const bf16* p, int lbo,
                                            int sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// Accumulator fragments (d[j][e], as mma.sync's m16n8 per warp): warp w,
// lane t, g = t / 4, tg = t % 4 holds rows 16 w + g (e = 0, 1) and
// 16 w + g + 8 (e = 2, 3) of columns 8 j + 2 tg (+1). The register A
// operand (a 64 x 16 slice): a = {(g, 2tg..), (g+8, 2tg..), (g, 8+2tg..),
// (g+8, 8+2tg..)} of the warp's 16 rows.
// wg_ss: d (64 x N) = a . b^T over 16 columns, a and b K-major tiles in
// shared memory (scale_d = 0: d is overwritten). wg_rs: d (64 x N) +=
// a . b, a in registers, b an MN-major tile in shared memory.
__device__ __forceinline__ void wg_ss(float (&d)[4][4], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wg_ss(float (&d)[8][4], uint64_t da,
                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wg_rs(float (&d)[8][4],
                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wg_rs(float (&d)[16][4],
                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void wg_rs(float (&d)[32][4],
                                      const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// hi = bf16(x0, x1) packed; lo = bf16(x - hi) packed (x - hi is exact).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// 2^x on the SFU (relative error about 2^-22; below 2^-126 flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x on the SFU (relative error about 2^-23)
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(|y|) for |y| < 0.6: an odd polynomial, minimax for the relative
// error (1.3 ulps in f32), on the FMA units only.
__device__ __forceinline__ float tanh_small(float a) {
  const float z = a * a;
  float p = -6.14530686e-3f;
  p = fmaf(p, z, 2.10001227e-2f);
  p = fmaf(p, z, -5.38409501e-2f);
  p = fmaf(p, z, 1.33325517e-1f);
  p = fmaf(p, z, -3.33333194e-1f);
  return fmaf(a * z, p, a);
}

// tanh(y) to a few f32 ulps, without branches: tanh_small below |y| =
// 0.6, above it 1 - 2 / (1 + e^(2|y|)) (two SFU operations), whose
// absolute error of about 2^-22 is a few ulps of a result above 0.53.
// FULL = false takes tanh_small alone, for |y| < 0.6: the same bits.
template <bool FULL>
__device__ __forceinline__ float tanh_f32(float y) {
  const float a = fabsf(y);
  const float small = tanh_small(a);
  if (!FULL) return copysignf(small, y);
  const float large = fmaf(-2.0f, rcp(1.0f + ex2(a * (2.0f * LOG2E))), 1.0f);
  return copysignf(a < 0.6f ? small : large, y);
}

// A tile's scores, in place, in log2 units: x = s * mul (mul = scale *
// log2(e)), or cap_l2e * tanh(s * mul) with a softcap (mul = scale /
// softcap, cap_l2e = softcap * log2(e)) (the exponentials below are
// powers of 2), and, where the tile is CUT by a mask, NEG_INF at the
// masked pairs. mx gets the maxima of the lane's two rows (row0 and
// row0 + 8) over its columns. FULL: tanh_f32's full range.
template <bool SOFTCAP, bool CUT, bool FULL, int NS>
__device__ __forceinline__ void tc_scores(float (&s)[NS][4], float (&mx)[2],
                                          float mul, float cap_l2e, int row0,
                                          int c0, int tg, int Sk, int causal,
                                          int window) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * mul;
      if (SOFTCAP) x = cap_l2e * tanh_f32<FULL>(x);
      if (CUT) {
        const int row = row0 + (e >> 1) * 8;
        const int col = c0 + j * 8 + 2 * tg + (e & 1);
        bool ok = col < Sk;
        if (causal) ok = ok && col <= row;
        if (window > 0) ok = ok && col > row - window;
        x = ok ? x : NEG_INF;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
}

// With a softcap, whether some lane of the warp has a tanh argument
// |s * mul| of 0.6 or more (else the polynomial alone gives the same
// bits, with no SFU work).
template <bool SOFTCAP, int NS>
__device__ __forceinline__ bool tc_needs_full_tanh(const float (&s)[NS][4],
                                                   float mul) {
  if (!SOFTCAP) return false;
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(s[j][e] * mul));
  return __any_sync(0xffffffffu, !(amax < 0.6f));
}

// Rows [row0, row0 + R) of a (S, D) bf16 matrix into an R x DP tile in
// the 128-byte swizzled layout of the tensor cores: 64-column blocks,
// each R rows of 128 bytes (block b at b * R * 128 bytes, 1024-byte
// aligned), with the 16-byte chunk c of row r at chunk c ^ (r % 8), so
// that the eight rows of a group spread over all banks. By cp.async in
// 16-byte pieces, zero beyond S rows and D columns.
template <int R, int DP>
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src,
                                             int64_t base, int row0, int S,
                                             int D) {
  constexpr int CH = DP / 8;
  for (int e = threadIdx.x; e < R * CH; e += TC_THREADS) {
    const int r = e / CH, ch = e % CH;
    const int g = row0 + r;
    const bool ok = g < S && ch * 8 < D;
    const bf16* p = ok ? src + base + (int64_t)g * D + ch * 8 : src;
    cp_async16(smem_u32(dst + ((ch >> 3) * R + r) * 64 +
                        (((ch & 7) ^ (r & 7)) << 3)),
               p, ok ? 16 : 0);
  }
}

// One warpgroup per (64-row query tile, h, b); key tiles of BKT keys.
// Q stays in shared memory; K and V in two stages each, filled by
// cp.async a tile ahead. Each step issues tile kt's S = Q.K^T and then
// tile kt - 1's P.V, both asynchronous, waits for S only, and runs tile
// kt's softmax while P.V runs on the tensor cores; then it waits for P.V
// and rescales the output. No product stays pending across steps.
template <int DP, int BKT, bool SOFTCAP>
__global__ void __launch_bounds__(TC_THREADS)
    fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                 int Hkv, int Sq, int Sk, int D, int causal, int window,
                 float scale, float softcap) {
  extern __shared__ float4 smem4[];
  constexpr int NS = BKT / 8;        // score fragments (n8 tiles over keys)
  constexpr int NO = DP / 8;         // output fragments (n8 tiles over d)
  constexpr int TILE = BKT * DP;     // elements of a K or V stage
  // the swizzle's 1024-byte atoms (the launch adds 1024 bytes for this)
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* Ks = Qs + 64 * DP;           // two stages
  bf16* Vs = Ks + 2 * TILE;          // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * 64;
  const int64_t qbase = ((int64_t)b * H + h) * Sq * D;
  const int64_t kbase = ((int64_t)b * Hkv + hk) * Sk * D;

  const int q_last = min(q0 + 63, Sq - 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int kt0 = lo / BKT, kt1 = hi / BKT;

  tc_load_tile<64, DP>(Qs, q, qbase, q0, Sq, D);
  tc_load_tile<BKT, DP>(Ks, k, kbase, kt0 * BKT, Sk, D);
  cp_async_commit();

  // O += P . V for the V stage at Vc, 16 keys at a time, P as hi + lo.
  // V (keys x d) is MN-major: LBO over its 64-column blocks.
  float acc[NO][4];
  uint32_t ph[BKT / 16][4], pl[BKT / 16][4];
  auto pv = [&](const bf16* Vc) {
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      const uint64_t dv = wg_desc(Vc + kk * 16 * 64, BKT * 128, 1024);
      wg_rs(acc, ph[kk], dv);
      wg_rs(acc, pl[kk], dv);
    }
    wg_commit();
  };

  const int row0 = q0 + warp * 16 + g;   // fragment rows row0, row0 + 8
  const float mul = SOFTCAP ? scale / softcap : scale * LOG2E;
  const float cap_l2e = softcap * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f}, s[NS][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  int it = 0;
  for (int kt = kt0; kt <= kt1; ++kt, ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // K of tile kt and V of tile kt - 1
                                     // are in; every warp is past kt - 1
    // K of tile kt + 1 over K of tile kt - 1, V of tile kt over V of tile
    // kt - 2 (their products are done)
    if (kt < kt1)
      tc_load_tile<BKT, DP>(Ks + ((it + 1) & 1) * TILE, k, kbase,
                            (kt + 1) * BKT, Sk, D);
    tc_load_tile<BKT, DP>(Vs + (it & 1) * TILE, v, kbase, kt * BKT, Sk, D);
    cp_async_commit();

    // S (64 x BKT) = Q . K^T, 16 columns of d at a time (the tiles'
    // columns beyond D are zero): 32 bytes into a 64-column block
    const bf16* Kc = Ks + (it & 1) * TILE;
    wg_pin(acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < DP / 16; ++c)
      wg_ss(s, wg_desc(Qs + (c >> 2) * 64 * 64 + (c & 3) * 16, 16, 1024),
            wg_desc(Kc + (c >> 2) * BKT * 64 + (c & 3) * 16, 16, 1024), c);
    wg_commit();
    if (it > 0) {
      pv(Vs + ((it - 1) & 1) * TILE);   // tile kt - 1's P.V
      wg_wait<1>();
    } else {
      wg_wait<0>();
    }
    wg_pin(s);

    // the softmax of tile kt; the mask applies only where it cuts the tile
    const int c0 = kt * BKT;
    float mx[2] = {NEG_INF, NEG_INF};
    const bool cut = c0 + BKT > Sk || (causal && c0 + BKT - 1 > q0) ||
                     (window > 0 && c0 <= q_last - window);
    const bool full = tc_needs_full_tanh<SOFTCAP>(s, mul);
    if (cut && full)
      tc_scores<SOFTCAP, true, true>(s, mx, mul, cap_l2e, row0, c0, tg, Sk,
                                     causal, window);
    else if (cut)
      tc_scores<SOFTCAP, true, false>(s, mx, mul, cap_l2e, row0, c0, tg, Sk,
                                      causal, window);
    else if (full)
      tc_scores<SOFTCAP, false, true>(s, mx, mul, cap_l2e, row0, c0, tg, Sk,
                                      causal, window);
    else
      tc_scores<SOFTCAP, false, false>(s, mx, mul, cap_l2e, row0, c0, tg, Sk,
                                       causal, window);
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float x = mx[i];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[i], x);
      corr[i] = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = ex2(s[j][e] - m[e >> 1]);
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      l[0] += (s[2 * kk][0] + s[2 * kk][1]) + (s[2 * kk + 1][0] +
                                               s[2 * kk + 1][1]);
      l[1] += (s[2 * kk][2] + s[2 * kk][3]) + (s[2 * kk + 1][2] +
                                               s[2 * kk + 1][3]);
    }

    wg_wait<0>();                    // tile kt - 1's P.V is done
    wg_pin(acc);
    // P (f32) as hi + lo, the A operands of tile kt's P.V
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[kk][0], pl[kk][0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[kk][1], pl[kk][1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[kk][2], pl[kk][2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[kk][3], pl[kk][3]);
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }
  }
  // the last tile's P.V
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  wg_pin(acc);
  wg_fence();
  pv(Vs + ((it - 1) & 1) * TILE);
  wg_wait<0>();
  wg_pin(acc);

  // the row sums over the four lanes of a row (the same tree in each)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float x = l[i];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(x, 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + 2 * tg;
      if (col < D)
        *reinterpret_cast<uint32_t*>(o + qbase + (int64_t)row * D + col) =
            pack_bf16(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    }
  }
}

// 64 keys per tile, 32 at D = 256, so that the fragments fit in
// registers.
template <int DP, bool SOFTCAP>
static int launch_tc_cap(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Hkv, int Sq, int Sk,
                         int D, int causal, int window, float scale,
                         float softcap, cudaStream_t st) {
  constexpr int BKT = DP <= 128 ? 64 : 32;
  const size_t smem = sizeof(bf16) * (64 + 4 * BKT) * DP + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      fa_tc_kernel<DP, BKT, SOFTCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + 63) / 64, H, B);
  fa_tc_kernel<DP, BKT, SOFTCAP><<<grid, TC_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, H, Hkv, Sq,
      Sk, D, causal, window, scale, softcap);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Hkv, int Sq, int Sk, int D, int causal,
                     int window, float scale, float softcap,
                     cudaStream_t st) {
  if (softcap > 0.0f)
    return launch_tc_cap<DP, true>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                                   window, scale, softcap, st);
  return launch_tc_cap<DP, false>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                                  window, scale, softcap, st);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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

// The path rule: 1 (tensor cores) for bf16 with D a multiple of 16, the
// mma tile's depth; 0 (CUDA cores) otherwise.
extern "C" int flash_attention_uses_tensor_cores(int is_bf16, int D) {
  return is_bf16 && D % 16 == 0;
}

// q, o: (B, H, Sq, D); k, v: (B, Hkv, Sk, D); all contiguous, of one
// dtype (is_bf16 != 0: bfloat16, else float32). 1 <= D <= 256, H % Hkv ==
// 0, Sq, Sk >= 1. window <= 0: no window; softcap <= 0: no softcap. The
// caller checks that every row keeps an unmasked column. The kernel is
// the one flash_attention_uses_tensor_cores picks. Returns
// cudaGetLastError() after the launch (nonzero: not launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Sk, int D,
                                      int is_bf16, int causal,
                                      int window, float scale, float softcap,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (flash_attention_uses_tensor_cores(is_bf16, D)) {
    if (D <= 64)
      return launch_tc<64>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                           scale, softcap, st);
    if (D <= 128)
      return launch_tc<128>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                            scale, softcap, st);
    return launch_tc<256>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                          scale, softcap, st);
  }
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal,
                                   window, scale, softcap, st);
  return launch_d<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, causal, window,
                         scale, softcap, st);
}
