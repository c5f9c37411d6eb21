// Chunked RWKV-6 (Finch) recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py · rwkv6_pallas:
// for r, k, w (B, H, T, K), v (B, H, T, V) and u (H, K), the linear
// recurrence with data-dependent per-channel decay
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,
//   o_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
// in the Pallas kernel's chunked form. Within a chunk of C steps, with
// lw = log2(max(w, 1e-12)), cwi its inclusive and cwe its exclusive
// cumulative sum over the chunk (all <= 0, so every power below is of a
// non-positive number):
//   A[t, i] = sum_c r[t,c] k[i,c] 2^(cwe[t,c] - cwi[i,c])    for i < t,
//   A[t, t] = sum_c r[t,c] u[c] k[t,c],
//   o       = A v + (r * 2^cwe) S,
//   S      <- diag(2^cwi[C-1]) S + (k * 2^(cwi[C-1] - cwi))^T v.
// The tail chunk runs as if padded with w = 1 and r = k = v = 0, as the
// Pallas kernel pads it. Inputs f32 or bf16 (u as f32), all arithmetic
// in f32, the output in r's dtype.
//
// What bounds it on the card: bytes. r, k, v, w are read once and o
// written once (0.200 ms at RWKV-6 7B's layer, B=4, H=64, T=4096,
// K=V=64, bf16). The chunked form's products, counted once, take 0.052
// ms on the tensor cores in TF32, and its own logs and powers of 2 (the
// recurrence itself needs none) 0.18 ms on the special-function units.
// What the design does about them:
//   * sub-chunks of 16 steps factor the pairwise decays. For a source i
//     in sub-chunk a and a query t in a later one, with b = cwi at the
//     end of a, 2^(cwe[t] - cwi[i]) = 2^(cwe[t] - b) * 2^(b - cwi[i]):
//     both factors <= 1, so nothing overflows even at decays of 1e-9
//     (-30 per step in log2, -480 over a sub-chunk; one reference point
//     per chunk would overflow there). The off-diagonal 16 x 16 blocks
//     of A become products of (16 x K) scaled r and (K x 16) scaled k;
//     only the diagonal blocks keep a power of 2 per pair and channel
//     (480 of a 64-step chunk's 2,016 pairs), on the CUDA cores;
//   * every product runs on the tensor cores as mma.sync m16n8k8 in TF32
//     with f32 accumulators: the off-diagonal A blocks, o = A v + r~ S
//     and S <- diag(d) S + k~^T v. Each f32 operand x is split into
//     hi = tf32(x) and lo = tf32(x - hi) (|x - hi - lo| <= 2^-22 |x|),
//     and a product takes hi.hi + hi.lo + lo.hi; v in bf16 is exact in
//     TF32 and is not split. A CPU model of this arithmetic
//     (tests/test_torch_lm_kernels.py) stays within 0.027 of the rounding
//     bound over every edge case, where bf16 splits in two terms leave
//     it on three. f32 inputs take the same path;
//   * a block of 256 threads per (b, h) walks the chunks in order (the
//     TPU kernel carried the state in VMEM over a sequential grid axis;
//     a loop inside the block takes that axis's place), the K x V f32
//     state resident in shared memory. r, k and v of the next chunk come
//     in by cp.async into a second stage while the current one computes
//     (one stage where two do not fit, as at K = V = 128 in f32), its w
//     by loads into registers. A chunk takes 4 barriers: after the copy,
//     after the cumulative sums, after A, and between o (which reads the
//     old state) and the state's update in place;
//   * the log-decays' cumulative sums are a two-level scan: a thread per
//     (channel, sub-chunk) runs its 16 steps, and the sub-chunk totals
//     are combined across lanes by shuffles;
//   * A's phase is split by warps so that neither kind of work waits on
//     the other: 3 warps take the off-diagonal blocks and the u bonus,
//     5 warps the diagonal pairs, a thread per (row t, 4 sources i) with
//     two channels a step (each row's r and decays read once for 4
//     pairs); the powers of 2 of the factors and pairs are ex2.approx
//     (2 ulp);
//   * 256 (b, h) blocks fill 128 of 132 SMs two per SM (109 KB of shared
//     memory each at K = V = 64 in bf16). The V columns are not split
//     across blocks: each split would compute A's powers of 2 again.
// Deterministic: every sum runs in a fixed order; no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define THREADS 256
#define WARPS (THREADS / 32)
#define SUB 16                   // steps per sub-chunk
#define OFF_WARPS 3              // warps on A's off-diagonal blocks
#define MAX_SMEM 232448          // a block's shared memory on sm_90

struct Dims {
  int H, T, K, V, C;             // C: chunk steps (<= 64)
  int CP, KP, VP;                // C and K to multiples of 16, V of 8
  int LDK, LDV;                  // stage row strides (elements)
  int LDC, LDA, LDS;             // cw, A, S row strides (floats)
  int nch, nsub;                 // chunks, sub-chunks per chunk
  int stage_bytes, stages, vec;  // vec: 16-byte cp.async rows
};

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

// 2^x on the SFU (ex2.approx: 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// two neighbouring elements (the first at an even index) as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a.b with a split (hi, lo) and b split unless it is exact in TF32
template <bool BEXACT>
__device__ __forceinline__ void mma_split(float (&d)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float (&b)[2]) {
  if (BEXACT) {
    const uint32_t bb[2] = {__float_as_uint(b[0]), __float_as_uint(b[1])};
    mma(d, ah, bb);
    mma(d, al, bb);
  } else {
    uint32_t bh[2], bl[2];
    split(b[0], bh[0], bl[0]);
    split(b[1], bh[1], bl[1]);
    mma(d, ah, bh);
    mma(d, ah, bl);
    mma(d, al, bh);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

// rows [row0, row0 + n) of r, k (K wide) and v (V wide) into a stage,
// zero beyond n rows (the padding columns stay as zeroed at the start)
template <typename T>
__device__ void fill_stage(const Dims& D, T* st, const T* r, const T* k,
                           const T* v, int64_t kb, int64_t vb, int row0,
                           int n) {
  T* rs = st;
  T* ks = rs + D.CP * D.LDK;
  T* vs = ks + D.CP * D.LDK;
  if (D.vec) {
    constexpr int E = 16 / sizeof(T);         // elements per 16 bytes
    const int pk = D.K / E, pv = D.V / E;
    const int per_row = 2 * pk + pv;
    const float inv = 1.0f / per_row;   // e / per_row below, exactly
    for (int e = threadIdx.x; e < D.CP * per_row; e += THREADS) {
      const int t = (int)(((float)e + 0.5f) * inv), p = e - t * per_row;
      const bool in = t < n;
      const int g = row0 + (in ? t : 0);
      if (p < 2 * pk) {
        const int m = p < pk ? p : p - pk;
        const T* src = (p < pk ? r : k) + kb + (int64_t)g * D.K + m * E;
        cp_async16((p < pk ? rs : ks) + t * D.LDK + m * E, src,
                   in ? 16 : 0);
      } else {
        const int m = p - 2 * pk;
        cp_async16(vs + t * D.LDV + m * E, v + vb + (int64_t)g * D.V + m * E,
                   in ? 16 : 0);
      }
    }
  } else {
    const T zero = T(0.0f);
    for (int e = threadIdx.x; e < D.CP * D.K; e += THREADS) {
      const int t = e / D.K, c = e % D.K;
      const int64_t at = kb + (int64_t)(row0 + t) * D.K + c;
      rs[t * D.LDK + c] = t < n ? r[at] : zero;
      ks[t * D.LDK + c] = t < n ? k[at] : zero;
    }
    for (int e = threadIdx.x; e < D.CP * D.V; e += THREADS) {
      const int t = e / D.V, c = e % D.V;
      vs[t * D.LDV + c] = t < n ? v[vb + (int64_t)(row0 + t) * D.V + c] : zero;
    }
  }
  asm volatile("cp.async.commit_group;");
}

// the chunk's w for the scan: thread (channel 8 cg + lane % 8, sub-chunk
// lane / 8) holds its 16 steps, 1 beyond the chunk's rows and K
template <typename T>
__device__ __forceinline__ void load_w(const Dims& D, T (&wv)[2][SUB],
                                       const T* w, int64_t kb, int row0,
                                       int n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a = lane >> 3;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    if (8 * (warp + WARPS * it) >= D.KP) break;   // no channel of the group
    const int c = 8 * (warp + WARPS * it) + (lane & 7);
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int t = SUB * a + j;
      wv[it][j] = (c < D.K && t < n)
                      ? w[kb + (int64_t)(row0 + t) * D.K + c] : T(1.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, T* __restrict__ o,
                 const Dims D) {
  constexpr bool VEXACT = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ float4 smem4[];
  char* base = reinterpret_cast<char*>(smem4);
  T* stage0 = reinterpret_cast<T*>(base);
  float* cw = reinterpret_cast<float*>(base + D.stages * D.stage_bytes);
  float* As = cw + D.CP * D.LDC;
  float* Ss = As + D.CP * D.LDA;
  float* decay = Ss + D.KP * D.LDS;
  float* us = decay + D.KP;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int bh = blockIdx.x, h = bh % D.H;
  const int64_t kb = (int64_t)bh * D.T * D.K, vb = (int64_t)bh * D.T * D.V;
  const int CP = D.CP, KP = D.KP;

  // ---- zero the stages (their padding columns stay 0) and the state
  {
    float4* z = smem4;
    const int n4 = (D.stages * D.stage_bytes) / 16;
    for (int e = tid; e < n4; e += THREADS) z[e] = make_float4(0, 0, 0, 0);
    for (int e = tid; e < KP * D.LDS; e += THREADS) Ss[e] = 0.0f;
    for (int c = tid; c < KP; c += THREADS)
      us[c] = c < D.K ? u[(int64_t)h * D.K + c] : 0.0f;
  }
  __syncthreads();
  T wv[2][SUB];
  fill_stage<T>(D, stage0, r, k, v, kb, vb, 0, min(D.C, D.T));
  load_w<T>(D, wv, w, kb, 0, min(D.C, D.T));

  for (int ch = 0; ch < D.nch; ++ch) {
    const int row0 = ch * D.C, n = min(D.C, D.T - row0);
    const T* st = reinterpret_cast<const T*>(
        base + (D.stages == 2 ? (ch & 1) : 0) * D.stage_bytes);
    const T* rs = st;
    const T* ks = rs + CP * D.LDK;
    const T* vs = ks + CP * D.LDK;
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();                 // the chunk is in; the last one done
    const bool more = ch + 1 < D.nch;
    const int n1 = more ? min(D.C, D.T - row0 - D.C) : 0;
    if (D.stages == 2 && more)
      fill_stage<T>(D, reinterpret_cast<T*>(base + ((ch + 1) & 1) *
                                                        D.stage_bytes),
                    r, k, v, kb, vb, row0 + D.C, n1);

    // ---- P1: cumulative log2-decays, a thread per (channel, sub-chunk)
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int cg = warp + WARPS * it;
      if (cg < KP / 8) {
        const int c = 8 * cg + (lane & 7), a = lane >> 3;
        float loc[SUB], run = 0.0f;
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          run += log2f(fmaxf(to_f(wv[it][j]), 1e-12f));
          loc[j] = run;
        }
        float incl = run;
        float x = __shfl_up_sync(0xffffffffu, incl, 8);
        if (a >= 1) incl = x + incl;
        x = __shfl_up_sync(0xffffffffu, incl, 16);
        if (a >= 2) incl = x + incl;
        float pre = __shfl_up_sync(0xffffffffu, incl, 8);
        if (a == 0) pre = 0.0f;
        if (a < D.nsub) {
#pragma unroll
          for (int j = 0; j < SUB; ++j)
            cw[(SUB * a + j) * D.LDC + c] = pre + loc[j];
          if (a == D.nsub - 1) decay[c] = exp2f(pre + loc[SUB - 1]);
        }
      }
    }
    if (more) load_w<T>(D, wv, w, kb, row0 + D.C, n1);
    __syncthreads();

    // ---- P2: A. Off-diagonal 16 x 16 blocks on the tensor cores, the
    // first OFF_WARPS warps taking the pairs of sub-chunks (b > a) in
    // turn, then the u bonus on the diagonal ...
    if (warp < OFF_WARPS) {
      const int npairs = D.nsub * (D.nsub - 1) / 2;
      for (int pair = warp; pair < npairs; pair += OFF_WARPS) {
        int b = 1;
        while ((b + 1) * b / 2 <= pair) ++b;
        const int a = pair - b * (b - 1) / 2;
        const int t0 = SUB * b + g, t1 = t0 + 8, iend = SUB * a + SUB - 1;
        float acc[2][4] = {};
#pragma unroll 2
        for (int c0 = 0; c0 < KP; c0 += 8) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = (e & 1) ? t1 : t0, c = c0 + q + ((e & 2) ? 4 : 0);
            const float x = to_f(rs[t * D.LDK + c]) *
                            ex2(cw[(t - 1) * D.LDC + c] - cw[iend * D.LDC + c]);
            split(x, ah[e], al[e]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int i = SUB * a + 8 * nt + g;
            uint32_t bh[2], bl[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = c0 + q + 4 * e;
              const float y = to_f(ks[i * D.LDK + c]) *
                              ex2(cw[iend * D.LDC + c] - cw[i * D.LDC + c]);
              split(y, bh[e], bl[e]);
            }
            mma(acc[nt], ah, bh);
            mma(acc[nt], ah, bl);
            mma(acc[nt], al, bh);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int i = SUB * a + 8 * nt + 2 * q;
          As[t0 * D.LDA + i] = acc[nt][0];
          As[t0 * D.LDA + i + 1] = acc[nt][1];
          As[t1 * D.LDA + i] = acc[nt][2];
          As[t1 * D.LDA + i + 1] = acc[nt][3];
        }
      }
      for (int t = tid; t < CP; t += OFF_WARPS * 32) {
        const T* rt = rs + t * D.LDK;
        const T* kt = ks + t * D.LDK;
        float acc = 0.0f;
        for (int c = 0; c < KP; c += 2) {
          const float2 rr = load2(rt + c), kk = load2(kt + c);
          const float2 uu = load2(us + c);
          acc = fmaf(rr.x * uu.x, kk.x, acc);
          acc = fmaf(rr.y * uu.y, kk.y, acc);
        }
        As[t * D.LDA + t] = acc;
      }
    } else {
      // ... and the pairs i < t of the diagonal blocks on the CUDA cores,
      // a power of 2 per pair and channel: a thread per (sub-chunk, row
      // t, group of 4 sources i with the first at most t), two channels
      // a step. The pairs above the diagonal are zeroed.
      for (int e = tid - OFF_WARPS * 32; e < D.nsub * 40;
           e += THREADS - OFF_WARPS * 32) {
        const int sb = e / 40, p = e % 40;
        int tt, j;
        if (p < 4) {
          tt = p, j = 0;
        } else if (p < 12) {
          tt = 4 + (p - 4) / 2, j = (p - 4) % 2;
        } else if (p < 24) {
          tt = 8 + (p - 12) / 3, j = (p - 12) % 3;
        } else {
          tt = 12 + (p - 24) / 4, j = (p - 24) % 4;
        }
        const int t = SUB * sb + tt, i0 = SUB * sb + 4 * j;
        float acc[4] = {};
        if (t > 0) {
          const T* rt = rs + t * D.LDK;
          const float* ct = cw + (t - 1) * D.LDC;
          for (int c = 0; c < KP; c += 2) {
            const float2 rr = load2(rt + c), ce = load2(ct + c);
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const float2 kk = load2(ks + (i0 + m) * D.LDK + c);
              const float2 ci = load2(cw + (i0 + m) * D.LDC + c);
              acc[m] = fmaf(rr.x * kk.x, ex2(ce.x - ci.x), acc[m]);
              acc[m] = fmaf(rr.y * kk.y, ex2(ce.y - ci.y), acc[m]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (i0 + m != t) As[t * D.LDA + i0 + m] = i0 + m < t ? acc[m] : 0.0f;
      }
    }
    for (int e = tid; e < D.nsub * SUB * SUB; e += THREADS) {
      const int sb = e / (SUB * SUB), tt = (e / SUB) % SUB, ii = e % SUB;
      if (ii > tt + 3 - tt % 4)   // beyond the row's last group of 4
        As[(SUB * sb + tt) * D.LDA + SUB * sb + ii] = 0.0f;
    }
    __syncthreads();

    // ---- P3: o = A v + (r * 2^cwe) S, a warp per (16 rows, 32 columns)
    const int units3 = (CP / 16) * ((D.VP + 31) / 32);
    for (int unit = warp; unit < units3; unit += WARPS) {
      const int mt = unit % (CP / 16), ng = unit / (CP / 16);
      const int ntn = min(4, D.VP / 8 - 4 * ng);
      const int t0 = 16 * mt + g, t1 = t0 + 8;
      float acc[4][4] = {};
#pragma unroll 2
      for (int i0 = 0; i0 < 16 * (mt + 1); i0 += 8) {    // A v
        uint32_t ah[4], al[4];
        split(As[t0 * D.LDA + i0 + q], ah[0], al[0]);
        split(As[t1 * D.LDA + i0 + q], ah[1], al[1]);
        split(As[t0 * D.LDA + i0 + q + 4], ah[2], al[2]);
        split(As[t1 * D.LDA + i0 + q + 4], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ntn) {
            const int vc = 32 * ng + 8 * nt + g;
            const float bv[2] = {to_f(vs[(i0 + q) * D.LDV + vc]),
                                 to_f(vs[(i0 + q + 4) * D.LDV + vc])};
            mma_split<VEXACT>(acc[nt], ah, al, bv);
          }
        }
      }
#pragma unroll 2
      for (int c0 = 0; c0 < KP; c0 += 8) {                // r~ S
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (e & 1) ? t1 : t0, c = c0 + q + ((e & 2) ? 4 : 0);
          const float ce = t > 0 ? cw[(t - 1) * D.LDC + c] : 0.0f;
          split(to_f(rs[t * D.LDK + c]) * ex2(ce), ah[e], al[e]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ntn) {
            const int vc = 32 * ng + 8 * nt + g;
            const float bs[2] = {Ss[(c0 + q) * D.LDS + vc],
                                 Ss[(c0 + q + 4) * D.LDS + vc]};
            mma_split<false>(acc[nt], ah, al, bs);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int vc = 32 * ng + 8 * nt + 2 * q;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = (e & 2) ? t1 : t0, col = vc + (e & 1);
          if (nt < ntn && t < n && col < D.V)
            store_f(o, vb + (int64_t)(row0 + t) * D.V + col, acc[nt][e]);
        }
      }
    }
    __syncthreads();                 // every o read the old state

    // ---- P4: S <- diag(2^cwi[C-1]) S + (k * 2^(cwi[C-1] - cwi))^T v,
    // a warp per (16 channels, 32 columns), in place
    const int units4 = (KP / 16) * ((D.VP + 31) / 32);
    for (int unit = warp; unit < units4; unit += WARPS) {
      const int mt = unit % (KP / 16), ng = unit / (KP / 16);
      const int ntn = min(4, D.VP / 8 - 4 * ng);
      const int ca = 16 * mt + g, cb = ca + 8;
      const float da = decay[ca], db = decay[cb];
      const float la = cw[(CP - 1) * D.LDC + ca];
      const float lb = cw[(CP - 1) * D.LDC + cb];
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int vc = 32 * ng + 8 * nt + 2 * q;
        const bool in = nt < ntn;
        acc[nt][0] = in ? Ss[ca * D.LDS + vc] * da : 0.0f;
        acc[nt][1] = in ? Ss[ca * D.LDS + vc + 1] * da : 0.0f;
        acc[nt][2] = in ? Ss[cb * D.LDS + vc] * db : 0.0f;
        acc[nt][3] = in ? Ss[cb * D.LDS + vc + 1] * db : 0.0f;
      }
#pragma unroll 2
      for (int i0 = 0; i0 < CP; i0 += 8) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (e & 1) ? cb : ca, i = i0 + q + ((e & 2) ? 4 : 0);
          const float lc = (e & 1) ? lb : la;
          split(to_f(ks[i * D.LDK + c]) * ex2(lc - cw[i * D.LDC + c]),
                ah[e], al[e]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt < ntn) {
            const int vc = 32 * ng + 8 * nt + g;
            const float bv[2] = {to_f(vs[(i0 + q) * D.LDV + vc]),
                                 to_f(vs[(i0 + q + 4) * D.LDV + vc])};
            mma_split<VEXACT>(acc[nt], ah, al, bv);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < ntn) {
          const int vc = 32 * ng + 8 * nt + 2 * q;
          Ss[ca * D.LDS + vc] = acc[nt][0];
          Ss[ca * D.LDS + vc + 1] = acc[nt][1];
          Ss[cb * D.LDS + vc] = acc[nt][2];
          Ss[cb * D.LDS + vc + 1] = acc[nt][3];
        }
      }
    }
    if (D.stages == 1 && more) {
      __syncthreads();               // every read of the stage is done
      fill_stage<T>(D, reinterpret_cast<T*>(base), r, k, v, kb, vb,
                    row0 + D.C, n1);
    }
  }
}

static int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The shape's dimensions and shared memory (bytes); 0 if it does not fit.
static size_t plan(Dims& D, int H, int Tn, int K, int V, int C, int es,
                   bool vec) {
  D.H = H; D.T = Tn; D.K = K; D.V = V; D.C = C;
  D.CP = round_up(C, SUB); D.KP = round_up(K, 16); D.VP = round_up(V, 8);
  D.LDK = D.KP + 16 / es; D.LDV = D.VP + 16 / es;
  D.LDC = D.KP + 4; D.LDA = D.CP + 4; D.LDS = D.VP + 8;
  D.nch = (Tn + C - 1) / C; D.nsub = D.CP / SUB;
  D.stage_bytes = round_up(es * (2 * D.CP * D.LDK + D.CP * D.LDV), 16);
  D.vec = vec;
  const size_t rest = sizeof(float) * ((size_t)D.CP * D.LDC +
                                       (size_t)D.CP * D.LDA +
                                       (size_t)D.KP * D.LDS + 2 * D.KP);
  for (D.stages = 2; D.stages >= 1; --D.stages) {
    const size_t total = (size_t)D.stages * D.stage_bytes + rest;
    if (total <= MAX_SMEM) return total;
  }
  return 0;
}

template <typename T>
static int launch(const void* r, const void* k, const void* v, const void* w,
                  const void* u, void* o, int B, int H, int Tn, int K, int V,
                  int C, cudaStream_t st) {
  const int es = sizeof(T);
  const uintptr_t any = (uintptr_t)r | (uintptr_t)k | (uintptr_t)v;
  const bool vec = (K * es) % 16 == 0 && (V * es) % 16 == 0 &&
                   (any & 15) == 0;
  Dims D;
  const size_t smem = plan(D, H, Tn, K, V, C, es, vec);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  rwkv6_kernel<T><<<B * H, THREADS, smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (T*)o, D);
  return (int)cudaGetLastError();
}

// r, k, w: (B, H, Tn, K); v, o: (B, H, Tn, V); u: (H, K) float32; all
// contiguous; r, k, v, w, o of one dtype (bf16 != 0: bfloat16, else
// float32). 1 <= K, V <= 128, 1 <= C <= 64. Returns cudaGetLastError()
// after the launch (nonzero: not launched).
extern "C" int rwkv6_launch(const void* r, const void* k, const void* v,
                            const void* w, const void* u, void* o, int B,
                            int H, int Tn, int K, int V, int C, int bf16,
                            void* stream) {
  if (K < 1 || K > 128 || V < 1 || V > 128 || C < 1 || C > 64 || Tn < 1 ||
      B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(r, k, v, w, u, o, B, H, Tn, K, V, C, st)
              : launch<float>(r, k, v, w, u, o, B, H, Tn, K, V, C, st);
}
