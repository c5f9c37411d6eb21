// Tiled attention backward for Hopper (sm_90a) on the tensor cores: the
// gradient of csrc/flash_attention.cu's forward for bf16 with D a multiple
// of 16 and at most 128, built as a library of its own (the function, the
// two-kernel split and the CUDA-core path: csrc/flash_attention_bwd.cu).
// No TPU kernel is replaced here (the reference takes this gradient by
// jax.grad of src/repro/models/layers.py's chunked_attention).
//
// Tensor cores (fa_bwd_dq_tc, fa_bwd_dkdv_tc): bf16 inputs with D a
// multiple of 16 and at most 128. Every product is one of the forward
// kernel's wgmma shapes, one warpgroup (128 threads) a block:
//   - S = Q.K^T and dP = dO.V^T (the dk/dv kernel forms S^T = K.Q^T and
//     dP^T = V.dO^T, keys as rows) as bf16 wgmma with both operands in
//     shared memory and f32 accumulators: bf16 x bf16 products are exact
//     in f32, so only the order of the sums differs from f32 dots;
//   - dq += dS.K, dv += P^T.dO and dk += dS^T.Q with the score
//     fragments, converted in registers, as the A operand (m64nDk16)
//     and K, dO or Q in shared memory as the transposed B operand, as V
//     is in the forward's P.V. P and dS are f32; each is split into
//     hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact) and hi.B +
//     lo.B go into one f32 accumulator. bf16's unit roundoff is 2^-8, so
//     |x - hi - lo| <= 2^-8 |x - hi| <= 2^-16 |x|: each of those products
//     moves by at most 2^-16 sum |x| |B| against an f32 one
//     (chip_smoke.attention_bwd_bound's split terms);
//   - Q, K, V and dO sit in shared memory as bf16 in the tensor cores'
//     128-byte swizzled layout; the tiles that a block walks (K and V
//     in the dq kernel; Q, dO and their rows' lse and Delta in the dk/dv
//     kernel) come by cp.async a tile ahead into a second stage; two
//     blocks fit on an SM;
//   - the scores in log2 units (log2(e) folded into the scale or the
//     softcap, lse scaled by it), so that each P is one ex2 on the SFU;
//     the softcap's tanh as the forward computes it (a polynomial on
//     the FMA units where a warp's arguments all lie below 0.6) and its
//     factor 1 - t^2; only the tiles that a mask or the end of the rows
//     cuts apply the mask, and the tiles it hides are never visited;
//   - at D = 128 the dk/dv kernel takes the query tile 32 columns at a
//     time (m64n32k16 scores), so that dk, dv and the score fragments
//     fit in the registers of one thread.
// Next steps on this path: one kernel per key tile that also writes dq
// partials (S and dP formed once), TMA and a producer warp, and the
// elementwise work of one tile overlapped with the products of the next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

// 4 bytes; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The fragments of a 64 x 16 NS columns score tile as NS A operands,
// hi and lo parts.
template <int NS>
__device__ __forceinline__ void split_frags(const float (&x)[2 * NS][4],
                                            uint32_t (&hi)[NS][4],
                                            uint32_t (&lo)[NS][4]) {
#pragma unroll
  for (int kk = 0; kk < NS; ++kk) {
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[kk][0], lo[kk][0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[kk][1], lo[kk][1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], lo[kk][2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], lo[kk][3]);
  }
}

// The operand descriptors of a 64-row tile at the swizzled layout:
// kmaj(X, c, r0): rows r0.. as a K-major operand, 16 columns from 16 c;
// mnmaj(X, r0): rows r0 .. r0 + 15 as the MN-major B operand (64 x DP
// tile: 8192 bytes between its 64-column blocks).
__device__ __forceinline__ uint64_t kmaj(const bf16* X, int c, int r0) {
  return wg_desc(X + (c >> 2) * 64 * 64 + r0 * 64 + (c & 3) * 16, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmaj(const bf16* X, int r0) {
  return wg_desc(X + r0 * 64, 64 * 128, 1024);
}

// P and dS of a tile, in place (s <- P, dp <- dS), in log2 units: x = s *
// mul (mul = scale log2(e)), or cap_l2e tanh(s mul) with a softcap (mul =
// scale / softcap, cap_l2e = softcap log2(e)) and its factor 1 - t^2;
// P = 2^(x - lse2), lse2 = lse log2(e); dS = P (dP - Delta) (1 - t^2).
// Rows are queries (dq kernel, TRANS = false: lse2 and Delta by fragment
// row, in registers) or keys (dk/dv kernel, TRANS = true: lse2 and Delta
// by column, from the shared stage ls, ds). (r0, c0): the lane's first
// fragment row and column 2 tg of the tile's first; where the tile is CUT
// by a mask or the end of the rows, P = 0 at masked pairs.
template <bool SOFTCAP, bool CUT, bool FULL, bool TRANS, int NS>
__device__ __forceinline__ void tc_probs(float (&s)[NS][4],
                                         float (&dp)[NS][4],
                                         const float (&lse2)[2],
                                         const float (&del)[2],
                                         const float* ls, const float* ds,
                                         float mul, float cap_l2e, int r0,
                                         int c0, int Sq, int Sk, int causal,
                                         int window) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float2 lc = make_float2(0.0f, 0.0f), dc = lc;
    if (TRANS) {
      lc = *reinterpret_cast<const float2*>(ls + j * 8);
      dc = *reinterpret_cast<const float2*>(ds + j * 8);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * mul, fac = 1.0f;
      if (SOFTCAP) {
        const float t = tanh_f32<FULL>(x);
        x = cap_l2e * t;
        fac = 1.0f - t * t;
      }
      const float l2 = TRANS ? ((e & 1) ? lc.y : lc.x) * LOG2E
                             : lse2[e >> 1];
      const float dl = TRANS ? ((e & 1) ? dc.y : dc.x) : del[e >> 1];
      float p = ex2(x - l2);
      if (CUT) {
        const int row = r0 + (e >> 1) * 8;
        const int col = c0 + j * 8 + (e & 1);
        const int qr = TRANS ? col : row, kc = TRANS ? row : col;
        bool ok = qr < Sq && kc < Sk;
        if (causal) ok = ok && kc <= qr;
        if (window > 0) ok = ok && kc > qr - window;
        p = ok ? p : 0.0f;
      }
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - dl) * fac;
    }
  }
}

template <bool SOFTCAP, bool TRANS, int NS>
__device__ __forceinline__ void tc_probs_any(
    float (&s)[NS][4], float (&dp)[NS][4], const float (&lse2)[2],
    const float (&del)[2], const float* ls, const float* ds, float mul,
    float cap_l2e, int r0, int c0, int Sq, int Sk, int causal, int window,
    bool cut) {
  const bool full = tc_needs_full_tanh<SOFTCAP>(s, mul);
  if (cut && full)
    tc_probs<SOFTCAP, true, true, TRANS>(s, dp, lse2, del, ls, ds, mul,
                                         cap_l2e, r0, c0, Sq, Sk, causal,
                                         window);
  else if (cut)
    tc_probs<SOFTCAP, true, false, TRANS>(s, dp, lse2, del, ls, ds, mul,
                                          cap_l2e, r0, c0, Sq, Sk, causal,
                                          window);
  else if (full)
    tc_probs<SOFTCAP, false, true, TRANS>(s, dp, lse2, del, ls, ds, mul,
                                          cap_l2e, r0, c0, Sq, Sk, causal,
                                          window);
  else
    tc_probs<SOFTCAP, false, false, TRANS>(s, dp, lse2, del, ls, ds, mul,
                                           cap_l2e, r0, c0, Sq, Sk, causal,
                                           window);
}

// dq: one warpgroup per (64-row query tile, h, b). Q and dO stay in
// shared memory; K and V in two stages each, filled by cp.async a tile
// ahead. Each key tile: S = Q.K^T and dP = dO.V^T, P and dS, then dq +=
// dS.K with dS as hi + lo. Also writes Delta = rowsum(dO * o) of its
// rows (four lanes a row, a fixed shuffle tree).
template <int DP, bool SOFTCAP>
__global__ void __launch_bounds__(TC_THREADS)
    fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const float* __restrict__ lse,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq,
                 float* __restrict__ delta, int H, int Hkv, int Sq, int Sk,
                 int D, int causal, int window, float scale,
                 float softcap) {
  extern __shared__ float4 smem4[];
  constexpr int NO = DP / 8;         // output fragments (n8 tiles over d)
  constexpr int TILE = 64 * DP;
  // the swizzle's 1024-byte atoms (the launch adds 1024 bytes for this)
  bf16* Qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* dOs = Qs + TILE;
  bf16* Ks = dOs + TILE;             // two stages
  bf16* Vs = Ks + 2 * TILE;          // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * 64;
  const int64_t qbase = ((int64_t)b * H + h) * Sq * D;
  const int64_t kbase = ((int64_t)b * Hkv + hk) * Sk * D;
  const int64_t rbase = ((int64_t)b * H + h) * Sq;

  const int q_last = min(q0 + 63, Sq - 1);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int hi = causal ? min(Sk - 1, q_last) : Sk - 1;
  const int kt0 = lo / 64, kt1 = hi / 64;

  tc_load_tile<64, DP>(Qs, q, qbase, q0, Sq, D);
  tc_load_tile<64, DP>(dOs, dout, qbase, q0, Sq, D);
  tc_load_tile<64, DP>(Ks, k, kbase, kt0 * 64, Sk, D);
  tc_load_tile<64, DP>(Vs, v, kbase, kt0 * 64, Sk, D);
  cp_async_commit();

  // Delta and lse (log2 units) of the lane's rows row0 and row0 + 8
  const int row0 = q0 + warp * 16 + g;
  float del[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    float acc = 0.0f;
    if (row < Sq)
      for (int ch = tg; ch < D / 8; ch += 4) {
        const int64_t at = qbase + (int64_t)row * D + ch * 8;
        const uint4 a4 = *reinterpret_cast<const uint4*>(dout + at);
        const uint4 b4 = *reinterpret_cast<const uint4*>(o + at);
        const __nv_bfloat162* a2 =
            reinterpret_cast<const __nv_bfloat162*>(&a4);
        const __nv_bfloat162* b2 =
            reinterpret_cast<const __nv_bfloat162*>(&b4);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 x = __bfloat1622float2(a2[m]);
          const float2 y = __bfloat1622float2(b2[m]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    del[i] = acc;
    lse2[i] = row < Sq ? lse[rbase + row] * LOG2E : 0.0f;
    if (row < Sq && tg == 0) delta[rbase + row] = acc;
  }

  const float mul = SOFTCAP ? scale / softcap : scale * LOG2E;
  const float cap_l2e = softcap * LOG2E;
  float acc[NO][4], s[8][4], dp[8][4];
  uint32_t dh[4][4], dl[4][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  int it = 0;
  for (int kt = kt0; kt <= kt1; ++kt, ++it) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // K, V of tile kt are in; every warp
                                     // is done with tile kt - 1
    if (kt < kt1) {
      tc_load_tile<64, DP>(Ks + ((it + 1) & 1) * TILE, k, kbase, (kt + 1) * 64,
                       Sk, D);
      tc_load_tile<64, DP>(Vs + ((it + 1) & 1) * TILE, v, kbase, (kt + 1) * 64,
                       Sk, D);
    }
    cp_async_commit();
    const bf16* Kc = Ks + (it & 1) * TILE;
    const bf16* Vc = Vs + (it & 1) * TILE;

    wg_pin(acc);
    wg_fence();
#pragma unroll
    for (int c = 0; c < DP / 16; ++c)
      wg_ss(s, kmaj(Qs, c, 0), kmaj(Kc, c, 0), c);
#pragma unroll
    for (int c = 0; c < DP / 16; ++c)
      wg_ss(dp, kmaj(dOs, c, 0), kmaj(Vc, c, 0), c);
    wg_commit();
    wg_wait<0>();
    wg_pin(s);
    wg_pin(dp);

    const int c0 = kt * 64;
    const bool cut = c0 + 64 > Sk || (causal && c0 + 63 > q0) ||
                     (window > 0 && c0 <= q_last - window);
    tc_probs_any<SOFTCAP, false>(s, dp, lse2, del, nullptr, nullptr, mul,
                                 cap_l2e, row0, c0 + 2 * tg, Sq, Sk, causal,
                                 window, cut);
    split_frags<4>(dp, dh, dl);

    // dq += dS . K: K (keys x d) as the MN-major B operand
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dk = mnmaj(Kc, kk * 16);
      wg_rs(acc, dh[kk], dk);
      wg_rs(acc, dl[kk], dk);
    }
    wg_commit();
    wg_wait<0>();
    wg_pin(acc);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + 2 * tg;
      if (col < D)
        *reinterpret_cast<uint32_t*>(dq + qbase + (int64_t)row * D + col) =
            pack_bf16(acc[j][2 * i] * scale, acc[j][2 * i + 1] * scale);
    }
  }
}

// dk, dv: one warpgroup per (64-key tile, KV head, b). K and V stay in
// shared memory; the query tiles of the group's heads that see a key of
// the tile come in turn, Q, dO and their rows' lse and Delta in two
// stages filled by cp.async a tile ahead. Each query tile, QN columns at
// a time: S^T = K.Q^T and dP^T = V.dO^T (keys as rows), P^T and dS^T,
// then dv += P^T.dO and dk += dS^T.Q with P^T and dS^T as hi + lo.
template <int DP, int QN, bool SOFTCAP>
__global__ void __launch_bounds__(TC_THREADS)
    fa_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk,
                   int D, int causal, int window, float scale,
                   float softcap) {
  extern __shared__ float4 smem4[];
  constexpr int NO = DP / 8;
  constexpr int NS = QN / 8;         // score fragments over a column step
  constexpr int TILE = 64 * DP;
  bf16* Ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem4) + 1023) & ~uintptr_t(1023));
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;              // two stages
  bf16* dOs = Qs + 2 * TILE;         // two stages
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TILE);   // [2][64] lse
  float* Ds = Ls + 2 * 64;                                // [2][64] Delta

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int kt = blockIdx.x;         // the first tiles see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int k0 = kt * 64;
  const int64_t kbase = ((int64_t)b * Hkv + hk) * Sk * D;

  // the query rows that see a key of this tile
  const int k_last = min(k0 + 63, Sk - 1);
  const int r_lo = causal ? k0 : 0;
  const int r_hi = window > 0 ? min(Sq - 1, k_last + window - 1) : Sq - 1;
  const int nq = r_lo <= r_hi ? r_hi / 64 - r_lo / 64 + 1 : 0;
  const int total = group * nq;

  // query tile n of the walk (head hk group + n / nq) into stage n & 1
  auto fill = [&](int n) {
    const int h = hk * group + n / nq, q0 = (r_lo / 64 + n % nq) * 64;
    const int64_t qbase = ((int64_t)b * H + h) * Sq * D;
    const int64_t rbase = ((int64_t)b * H + h) * Sq;
    tc_load_tile<64, DP>(Qs + (n & 1) * TILE, q, qbase, q0, Sq, D);
    tc_load_tile<64, DP>(dOs + (n & 1) * TILE, dout, qbase, q0, Sq, D);
    const int t = threadIdx.x & 63, row = q0 + t;
    const float* src = threadIdx.x < 64 ? lse : delta;
    float* dst = (threadIdx.x < 64 ? Ls : Ds) + (n & 1) * 64 + t;
    cp_async4(smem_u32(dst), row < Sq ? src + rbase + row : src,
              row < Sq ? 4 : 0);
  };

  tc_load_tile<64, DP>(Ks, k, kbase, k0, Sk, D);
  tc_load_tile<64, DP>(Vs, v, kbase, k0, Sk, D);
  if (total > 0) fill(0);
  cp_async_commit();

  const float mul = SOFTCAP ? scale / softcap : scale * LOG2E;
  const float cap_l2e = softcap * LOG2E;
  const int rowk = k0 + warp * 16 + g;   // fragment rows rowk, rowk + 8
  const float none[2] = {0.0f, 0.0f};
  float dka[NO][4], dva[NO][4], st[NS][4], dpt[NS][4];
  uint32_t ph[NS / 2][4], pl[NS / 2][4], dh[NS / 2][4], dl[NS / 2][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] = 0.0f;
      dva[j][e] = 0.0f;
    }

  for (int n = 0; n < total; ++n) {
    const int q0 = (r_lo / 64 + n % nq) * 64;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();                 // tile n is in; every warp is done
                                     // with tile n - 1
    if (n + 1 < total) fill(n + 1);
    cp_async_commit();
    const bf16* Qc = Qs + (n & 1) * TILE;
    const bf16* dOc = dOs + (n & 1) * TILE;
    const float* Lc = Ls + (n & 1) * 64;
    const float* Dc = Ds + (n & 1) * 64;

#pragma unroll
    for (int qh = 0; qh < 64; qh += QN) {
      wg_pin(dka);
      wg_pin(dva);
      wg_fence();
#pragma unroll
      for (int c = 0; c < DP / 16; ++c)
        wg_ss(st, kmaj(Ks, c, 0), kmaj(Qc, c, qh), c);
#pragma unroll
      for (int c = 0; c < DP / 16; ++c)
        wg_ss(dpt, kmaj(Vs, c, 0), kmaj(dOc, c, qh), c);
      wg_commit();
      wg_wait<0>();
      wg_pin(st);
      wg_pin(dpt);

      const int c0 = q0 + qh;
      const bool cut = c0 + QN > Sq || k0 + 64 > Sk ||
                       (causal && k0 + 63 > c0) ||
                       (window > 0 && c0 + QN - 1 >= k0 + window);
      tc_probs_any<SOFTCAP, true>(st, dpt, none, none, Lc + qh + 2 * tg,
                                  Dc + qh + 2 * tg, mul, cap_l2e, rowk,
                                  c0 + 2 * tg, Sq, Sk, causal, window, cut);
      split_frags<NS / 2>(st, ph, pl);
      split_frags<NS / 2>(dpt, dh, dl);

      // dv += P^T . dO and dk += dS^T . Q: dO and Q (queries x d) as the
      // MN-major B operand
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        const uint64_t ddo = mnmaj(dOc, qh + kk * 16);
        wg_rs(dva, ph[kk], ddo);
        wg_rs(dva, pl[kk], ddo);
        const uint64_t dq = mnmaj(Qc, qh + kk * 16);
        wg_rs(dka, dh[kk], dq);
        wg_rs(dka, dl[kk], dq);
      }
      wg_commit();
      wg_wait<0>();
      wg_pin(dka);
      wg_pin(dva);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rowk + 8 * i;
    if (row >= Sk) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = j * 8 + 2 * tg;
      if (col < D) {
        const int64_t at = kbase + (int64_t)row * D + col;
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack_bf16(dka[j][2 * i] * scale, dka[j][2 * i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at) =
            pack_bf16(dva[j][2 * i], dva[j][2 * i + 1]);
      }
    }
  }
}

// 64-column query steps at D <= 64, 32 at D = 128, so that dk, dv and the
// fragments fit in registers.
template <int DP, bool SOFTCAP>
static int launch_tc_cap(const void* q, const void* k, const void* v,
                         const void* o, const float* lse, const void* dout,
                         void* dq, void* dk, void* dv, float* delta, int B,
                         int H, int Hkv, int Sq, int Sk, int D, int causal,
                         int window, float scale, float softcap,
                         cudaStream_t st) {
  constexpr int QN = DP <= 64 ? 64 : 32;
  const size_t smem_q = sizeof(bf16) * 6 * 64 * DP + 1024;
  const size_t smem_k = smem_q + sizeof(float) * 4 * 64;
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_tc<DP, SOFTCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_tc<DP, QN, SOFTCAP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_k);
  if (err != cudaSuccess) return (int)err;
  dim3 gq((Sq + 63) / 64, H, B);
  fa_bwd_dq_tc<DP, SOFTCAP><<<gq, TC_THREADS, smem_q, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, lse,
      (const bf16*)dout, (bf16*)dq, delta, H, Hkv, Sq, Sk, D, causal, window,
      scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 gk((Sk + 63) / 64, Hkv, B);
  fa_bwd_dkdv_tc<DP, QN, SOFTCAP><<<gk, TC_THREADS, smem_k, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, lse,
      delta, (bf16*)dk, (bf16*)dv, H, Hkv, Sq, Sk, D, causal, window, scale,
      softcap);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_tc(const void* q, const void* k, const void* v,
                     const void* o, const float* lse, const void* dout,
                     void* dq, void* dk, void* dv, float* delta, int B, int H,
                     int Hkv, int Sq, int Sk, int D, int causal, int window,
                     float scale, float softcap, cudaStream_t st) {
  if (softcap > 0.0f)
    return launch_tc_cap<DP, true>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                   B, H, Hkv, Sq, Sk, D, causal, window,
                                   scale, softcap, st);
  return launch_tc_cap<DP, false>(q, k, v, o, lse, dout, dq, dk, dv, delta,
                                  B, H, Hkv, Sq, Sk, D, causal, window, scale,
                                  softcap, st);
}

// The arguments as flash_attention_bwd_launch's (csrc/flash_attention_bwd.cu),
// for bf16 (is_bf16 != 0) with D a multiple of 16 and at most 128, the
// calls kernels/flash_attention.py:bwd_kernel_path gives this path; others
// are refused (cudaErrorInvalidValue). Launches fa_bwd_dq_tc, then
// fa_bwd_dkdv_tc; returns cudaGetLastError() (nonzero: not launched).
extern "C" int flash_attention_bwd_tc_launch(
    const void* q, const void* k, const void* v, const void* o,
    const float* lse, const void* dout, void* dq, void* dk, void* dv,
    float* delta, int B, int H, int Hkv, int Sq, int Sk, int D, int is_bf16,
    int causal, int window, float scale, float softcap, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16 || D < 16 || D > 128 || D % 16 != 0 || Hkv < 1 ||
      H % Hkv != 0 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (D <= 64)
    return launch_tc<64>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Hkv,
                         Sq, Sk, D, causal, window, scale, softcap, st);
  return launch_tc<128>(q, k, v, o, lse, dout, dq, dk, dv, delta, B, H, Hkv,
                        Sq, Sk, D, causal, window, scale, softcap, st);
}
