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
//   du   = sum over b and t of r_t k_t (v_t . do_t): the kernels write
//          each (b, h, chunk)'s partial sum; the caller sums them.
//
// What bounds it: bytes (r, k, v, w and do read, dr, dk, dv and dw
// written, once each). The recurrences are elementwise in the K x V
// state, and every output is a sum of products of S_{t-1} or G_t with a
// step's inputs, so the design keeps both in f32 registers and runs
// every chunk of C steps (C = min(chunk, 64)) in parallel, in three
// kernels:
//   (a, b) rwkv6_bwd_local, a block per (b, h, chunk): the chunk's own
//     contributions from zero, L = the state after the chunk (S run
//     forward from 0: sum_i (k_i prod_{s>i} w_s) v_i^T) and M = the
//     gradient before it (G run backward from 0: sum_i (r_i prod_{s<i}
//     w_s) do_i^T), and its decay D = prod_t w_t (per channel), the
//     products of w taken in sequence; a thread a 4 x 4 block of L and M;
//   rwkv6_bwd_carry, a thread per (state element, b, h): S at every chunk
//     start and G at every chunk end, S <- D S + L forward and G <- D G +
//     M backward over the chunks, in place of L and M: two f32 scratch
//     arrays of (B, H, T / C, K, V) (268 MB each at RWKV-6 7B's layer,
//     B = 4, H = 64, T = 4096, K = V = 64);
//   (c) rwkv6_bwd_out, a block per (b, h, chunk): the chunk's outputs from
//     its S_start and G_end. Every factor is a w itself, at most 1 in
//     practice: no logarithm, no power, no division by w, no sum of large
//     terms with opposite signs, so dw = rowsum(G_t * S_{t-1}) is taken
//     as the plain version takes it, and is exactly 0 where G_t or S_{t-1}
//     is (the last step, the first).
// The out kernel's 512 threads cover a 64 x 64 tile of the state, a
// thread one row and 8 columns 8 apart (8 lanes a row, 4 rows a warp),
// larger states in two passes (K V <= 4096). S_{t-1} is needed in
// reverse beside G_t: a first walk runs S forward over the chunk and
// keeps it at every 8th step in shared memory; a second walk takes the
// chunk's 8-step sub-chunks from the last, forms their states again from
// the checkpoint into registers, 4 at a time (the register file holds
// no more beside S and G at 512 threads), and walks G backward over them
// for dr, dk and dw (8 FMAs each, and one reduce-scatter of the three
// across the row's 8 lanes: 4 shuffles) and dv (a reduce-scatter across
// the warp's 4 rows, then the 16 warps' partials summed in shared
// memory, a fixed order). A sub-chunk's inputs come into shared memory as
// f32, loaded into registers one sub-chunk ahead, and its outputs go out
// with their bonus terms from there. The walks are bound by the
// shared-memory reads of each step's inputs (a row's k, w, r, and a
// column's v and do, for every element) and by the register file.
// Deterministic: every sum runs in a fixed order; no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512              // out kernel: 8 elements of a 64 x 64 tile
#define LTHREADS 256             // local kernel: 16 elements a thread
#define TILE 64                  // rows and columns of a state tile
#define SUBR 8                   // steps of a sub-chunk
#define HALF 4                   // states of a sub-chunk held at a time
#define MAX_C 64                 // the kernels' chunk, at most
#define CARRY_THREADS 256
#define W_FLOOR 1e-12f

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

// 16 bytes at p as floats (zeros where !in); p 16-byte aligned.
__device__ __forceinline__ void load16(float (&x)[4], const float* p,
                                       bool in) {
  const float4 a = in ? *reinterpret_cast<const float4*>(p)
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load16(float (&x)[8],
                                       const __nv_bfloat16* p, bool in) {
  const uint4 a =
      in ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const float2 f = __bfloat1622float2(h[m]);
    x[2 * m] = f.x;
    x[2 * m + 1] = f.y;
  }
}

struct BwdDims {
  int H, T, K, V, C, NC;         // C: the chunk; NC: chunks
  int nrp, ncp;                  // passes over 64-row and 64-column tiles
};

// The thread's 8 elements of row c of a (K, V) state at src: columns
// col0 + (cb ^ 8 q) (q < 8), 0 outside the state.
__device__ __forceinline__ void load_state(float (&x)[8], const float* src,
                                           int c, int col0, int cb, int K,
                                           int V) {
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int j = col0 + (cb ^ (q << 3));
    x[q] = (c < K && j < V) ? src[(int64_t)c * V + j] : 0.0f;
  }
}

// The out kernel's stage: Ks, Ws, Rs (steps x 64 rows), then Vs and DOs
// (steps x 64 columns) in 4 copies each, copy g holding column x at x ^
// 16 g (g: the lane's row group, lane / 8, whose columns run in that
// order), copies 8 words apart (the warp's 4 row groups read 32 banks).
#define SK 0
#define SW (SUBR * TILE)
#define SR (2 * SUBR * TILE)
#define SCOPY (SUBR * TILE + 8)
#define SV (3 * SUBR * TILE)
#define SD (SV + 4 * SCOPY)
#define STAGE (SD + 4 * SCOPY)

// A sub-chunk's inputs in a thread's registers: steps [t0, t0 + n) of the
// (b, h) row, the tile's rows row0 .. row0 + 63 of k, w, r and columns
// col0 .. col0 + 63 of v, do, 0 outside. With vec (rows of whole 16-byte
// pieces), 16-byte pieces of the 5 x SUBR x 64 values, the thread's E or
// 2 E at tid and tid + THREADS; else one value of each array.
struct StageRegs {
  float x[8];
};

template <typename T>
__device__ __forceinline__ StageRegs stage_load(
    const BwdDims& D, bool vec, int64_t bh, int t0, int n, int row0,
    int col0, const T* __restrict__ k, const T* __restrict__ w,
    const T* __restrict__ r, const T* __restrict__ v,
    const T* __restrict__ dout) {
  StageRegs s;
  if (vec) {
    constexpr int E = 16 / sizeof(T), P = TILE / E;
#pragma unroll
    for (int i = 0; i < 8 / E; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int a = e / (SUBR * P), t = e / P % SUBR, x0 = e % P * E;
      const bool rows = a < 3;
      const T* src = a == 0 ? k : a == 1 ? w : a == 2 ? r : a == 3 ? v : dout;
      const int X = rows ? D.K : D.V, at0 = rows ? row0 : col0;
      const bool in = a < 5 && t < n && at0 + x0 < X;
      float y[E];
      load16(y, src + ((bh * D.T + t0 + (in ? t : 0)) * X + at0 + x0), in);
#pragma unroll
      for (int m = 0; m < E; ++m) s.x[i * E + m] = y[m];
    }
    return s;
  }
  const int t = threadIdx.x / TILE, x = threadIdx.x % TILE;
#pragma unroll
  for (int i = 0; i < 5; ++i) s.x[i] = 0.0f;
  if (t < n) {
    const int64_t step = bh * D.T + t0 + t;
    if (row0 + x < D.K) {
      const int64_t at = step * D.K + row0 + x;
      s.x[0] = to_f(k[at]);
      s.x[1] = to_f(w[at]);
      s.x[2] = to_f(r[at]);
    }
    if (col0 + x < D.V) {
      const int64_t at = step * D.V + col0 + x;
      s.x[3] = to_f(v[at]);
      s.x[4] = to_f(dout[at]);
    }
  }
  return s;
}

template <typename T>
__device__ __forceinline__ void stage_store(const StageRegs& s, bool vec,
                                            float* st) {
  if (vec) {
    constexpr int E = 16 / sizeof(T), P = TILE / E;
#pragma unroll
    for (int i = 0; i < 8 / E; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int a = e / (SUBR * P), t = e / P % SUBR, x0 = e % P * E;
      if (a >= 5) continue;
#pragma unroll
      for (int m = 0; m < E; m += 4) {
        const float4 y = make_float4(s.x[i * E + m], s.x[i * E + m + 1],
                                     s.x[i * E + m + 2], s.x[i * E + m + 3]);
        if (a < 3) {
          *reinterpret_cast<float4*>(st + a * SUBR * TILE + t * TILE + x0 +
                                     m) = y;
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<float4*>(st + (a == 3 ? SV : SD) + g * SCOPY +
                                       t * TILE + ((x0 + m) ^ (16 * g))) = y;
        }
      }
    }
    return;
  }
  const int t = threadIdx.x / TILE, x = threadIdx.x % TILE;
  st[SK + threadIdx.x] = s.x[0];
  st[SW + threadIdx.x] = s.x[1];
  st[SR + threadIdx.x] = s.x[2];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    st[SV + g * SCOPY + t * TILE + (x ^ (16 * g))] = s.x[3];
    st[SD + g * SCOPY + t * TILE + (x ^ (16 * g))] = s.x[4];
  }
}

// (a, b): the chunk's L (S after it, from 0), M (G before it, from 0) and
// D (the product of its decays), per 64 x 64 tile of the state. The whole
// chunk's inputs of the tile are staged at once, f32, [C][64] each of k,
// w, r, v, do; the decays are folded into k and r (products of w, each at
// most 1 in practice), and L and M are then two sums of outer products,
// a thread a 4 x 4 block of each (4 float4 shared loads a step for 32
// FMAs).
template <typename T>
__global__ void __launch_bounds__(LTHREADS)
    rwkv6_bwd_local(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    const T* __restrict__ dout, float* __restrict__ s_st,
                    float* __restrict__ g_st, float* __restrict__ dn,
                    const BwdDims D) {
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sw = sk + MAX_C * TILE;
  float* sr = sw + MAX_C * TILE;
  float* sv = sr + MAX_C * TILE;
  float* sd = sv + MAX_C * TILE;
  const int64_t bh = blockIdx.x;
  const int n = blockIdx.y;
  const int t0 = n * D.C, nt = min(D.C, D.T - t0);
  const int64_t sbase = (bh * D.NC + n) * (int64_t)D.K * D.V;
  const int tid = threadIdx.x;
  const int r4 = (tid >> 4) * 4, c4 = (tid & 15) * 4;
  // rows of whole 16-byte pieces (the tensors' bases are 16-byte aligned)
  const bool vec = (D.K * sizeof(T)) % 16 == 0 && (D.V * sizeof(T)) % 16 == 0;

  for (int rp = 0; rp < D.nrp; ++rp)
    for (int cp = 0; cp < D.ncp; ++cp) {
      const int row0 = rp * TILE, col0 = cp * TILE;
      __syncthreads();               // the last pass is done with the stage
      if (vec) {                     // 16-byte loads: E elements each
        constexpr int E = 16 / sizeof(T), P = TILE / E;
        for (int e0 = 0; e0 < nt * P; e0 += 2 * LTHREADS) {
          float x[2][5][E];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = e0 + i * LTHREADS + tid;
            const int t = e / P, x0 = (e % P) * E;
            const bool in = t < nt;
            const int64_t step = bh * D.T + t0 + (in ? t : 0);
            const bool kin = in && row0 + x0 < D.K, vin = in && col0 + x0 < D.V;
            const int64_t ak = step * D.K + row0 + x0;
            const int64_t av = step * D.V + col0 + x0;
            load16(x[i][0], k + ak, kin);
            load16(x[i][1], w + ak, kin);
            load16(x[i][2], r + ak, kin);
            load16(x[i][3], v + av, vin);
            load16(x[i][4], dout + av, vin);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int e = e0 + i * LTHREADS + tid;
            const int t = e / P, x0 = (e % P) * E;
            if (t < nt)
#pragma unroll
              for (int m = 0; m < E; m += 4) {
                float* const dst[5] = {sk, sw, sr, sv, sd};
#pragma unroll
                for (int a = 0; a < 5; ++a)
                  *reinterpret_cast<float4*>(dst[a] + t * TILE + x0 + m) =
                      make_float4(x[i][a][m], x[i][a][m + 1], x[i][a][m + 2],
                                  x[i][a][m + 3]);
              }
          }
        }
      } else {                       // element by element
        // 8 steps' values a thread in flight at a time
        for (int e0 = 0; e0 < nt * TILE; e0 += 8 * LTHREADS) {
          float tk[8], tw[8], tr[8], tv[8], td[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = e0 + i * LTHREADS + tid;
            const int t = e / TILE, x = e % TILE;
            tk[i] = tw[i] = tr[i] = tv[i] = td[i] = 0.0f;
            if (t < nt) {
              const int64_t step = bh * D.T + t0 + t;
              if (row0 + x < D.K) {
                const int64_t at = step * D.K + row0 + x;
                tk[i] = to_f(k[at]);
                tw[i] = to_f(w[at]);
                tr[i] = to_f(r[at]);
              }
              if (col0 + x < D.V) {
                const int64_t at = step * D.V + col0 + x;
                tv[i] = to_f(v[at]);
                td[i] = to_f(dout[at]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int e = e0 + i * LTHREADS + tid;
            if (e < MAX_C * TILE) {
              sk[e] = tk[i];
              sw[e] = tw[i];
              sr[e] = tr[i];
              sv[e] = tv[i];
              sd[e] = td[i];
            }
          }
        }
      }
      __syncthreads();
      // the decays folded in, in place, a thread per channel: k_i times
      // the product of the chunk's later decays (the suffix products, at
      // the end D), r_i times that of its earlier ones (the prefix
      // products); every product is of factors w
      if (tid < 2 * TILE) {
        const int x = tid % TILE;
        float p = 1.0f;
        if (tid < TILE) {
          for (int t = nt - 1; t >= 0; --t) {
            sk[t * TILE + x] *= p;
            p *= sw[t * TILE + x];
          }
          if (cp == 0 && row0 + x < D.K)
            dn[(bh * D.NC + n) * D.K + row0 + x] = p;
        } else {
          for (int t = 0; t < nt; ++t) {
            sr[t * TILE + x] *= p;
            p *= sw[t * TILE + x];
          }
        }
      }
      __syncthreads();
      // L = sum_i k~_i v_i^T and M = sum_i r~_i do_i^T, the steps in order
      float s[4][4], g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = g[i][j] = 0.0f;
      for (int t = 0; t < nt; ++t) {
        const float4 kq = *reinterpret_cast<const float4*>(sk + t * TILE + r4);
        const float4 rq = *reinterpret_cast<const float4*>(sr + t * TILE + r4);
        const float4 vq = *reinterpret_cast<const float4*>(sv + t * TILE + c4);
        const float4 dq = *reinterpret_cast<const float4*>(sd + t * TILE + c4);
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float vv[4] = {vq.x, vq.y, vq.z, vq.w};
        const float dd[4] = {dq.x, dq.y, dq.z, dq.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kk[i], vv[j], s[i][j]);
            g[i][j] = fmaf(rr[i], dd[j], g[i][j]);
          }
      }
      const bool vst = (D.V & 3) == 0 && col0 + c4 + 3 < D.V;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = row0 + r4 + i;
        if (c >= D.K) continue;
        const int64_t at = sbase + (int64_t)c * D.V + col0 + c4;
        if (vst) {                   // a row's 64 columns in 16 lanes
          *reinterpret_cast<float4*>(s_st + at) =
              make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
          *reinterpret_cast<float4*>(g_st + at) =
              make_float4(g[i][0], g[i][1], g[i][2], g[i][3]);
          continue;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + c4 + j < D.V) {
            s_st[at + j] = s[i][j];
            g_st[at + j] = g[i][j];
          }
      }
    }
}

// The chunk-start states and chunk-end gradients, in place of L and M: a
// thread per state element of a (b, h), the chunks in order (S) and in
// reverse (G); the loads run ahead of the carried sums.
__global__ void __launch_bounds__(CARRY_THREADS)
    rwkv6_bwd_carry(float* __restrict__ s_st, float* __restrict__ g_st,
                    const float* __restrict__ dn, const BwdDims D) {
  const int KV = D.K * D.V;
  const int e = blockIdx.y * CARRY_THREADS + threadIdx.x;
  if (e >= KV) return;
  const int64_t bh = blockIdx.x;
  const int c = e / D.V;
  float* sp = s_st + bh * D.NC * (int64_t)KV + e;
  float* gp = g_st + bh * D.NC * (int64_t)KV + e;
  const float* dp = dn + bh * D.NC * D.K + c;
  constexpr int U = 16;
  float s = 0.0f;
  for (int n0 = 0; n0 < D.NC; n0 += U) {
    float l[U], d[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (n0 + i < D.NC) {
        l[i] = sp[(int64_t)(n0 + i) * KV];
        d[i] = dp[(int64_t)(n0 + i) * D.K];
      }
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (n0 + i < D.NC) {
        sp[(int64_t)(n0 + i) * KV] = s;
        s = fmaf(d[i], s, l[i]);
      }
  }
  float g = 0.0f;
  for (int n1 = D.NC - 1; n1 >= 0; n1 -= U) {
    float m[U], d[U];
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (n1 - i >= 0) {
        m[i] = gp[(int64_t)(n1 - i) * KV];
        d[i] = dp[(int64_t)(n1 - i) * D.K];
      }
#pragma unroll
    for (int i = 0; i < U; ++i)
      if (n1 - i >= 0) {
        gp[(int64_t)(n1 - i) * KV] = g;
        g = fmaf(d[i], g, m[i]);
      }
  }
}

// (c): the chunk's dr, dk, dv, dw and du partial from S_start (s_st) and
// G_end (g_st). A thread holds row rr of the tile at 8 columns 8 apart,
// so that a step's v and do are read by 8 lanes from 8 neighbouring words
// (the warp's 4 rows from their copies: 32 banks). Shared memory (floats):
// the S checkpoints at sub-chunks 1 .. 7 ([a][q][thread]), the stage,
// dv's per-warp partials of a sub-chunk (SUBR x 16 x 64; du's partials at
// the end), the row outputs before their bonus (3 x RB x 64: dr, dk, dw of
// the tile's rows; RB = 8, a sub-chunk, or C where column passes add up),
// dv's (C x 64, only where row passes add up), and the steps' v . do and
// r . (u k). Each sub-chunk's outputs are written, with their bonus, from
// the stage that holds its inputs, once the last pass adding to them is in.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    rwkv6_bwd_out(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const T* __restrict__ dout,
                  T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                  T* __restrict__ dw, float* __restrict__ du_part,
                  const float* __restrict__ s_st,
                  const float* __restrict__ g_st, const BwdDims D) {
  extern __shared__ float4 smem4[];
  const int64_t bh = blockIdx.x;
  const int n = blockIdx.y;
  const int h = (int)(bh % D.H);
  const int t0 = n * D.C, nt = min(D.C, D.T - t0);
  const int nsub = (nt + SUBR - 1) / SUBR;
  const int RB = D.ncp > 1 ? MAX_C : SUBR;
  float* ck = reinterpret_cast<float*>(smem4);     // (nsub - 1) x 8 x THREADS
  float* st = ck + (MAX_C / SUBR - 1) * 8 * THREADS;
  float* dvp = st + STAGE;                         // SUBR x 16 x 64
  float* av = dvp + SUBR * 16 * TILE;              // C: v_t . do_t
  float* bv = av + MAX_C;                          // C: r_t . (u k_t)
  float* ro = bv + MAX_C;                          // 3 x RB x 64
  float* dva = ro + 3 * RB * TILE;                 // C x 64 (row passes)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // row rr of the tile; the lane's column q at cb ^ 8 q: the 8 lanes of a
  // row take columns l, l + 8, ... (l = lane % 8), each row group of the
  // warp in an order permuted by it, so that dv's reduce-scatter over the
  // warp's rows sends registers q + 4, then q + 2, in every lane
  const int rg = lane >> 3, rr = warp * 4 + rg;
  const int cb = (lane & 7) + 16 * rg;
  const int vb = SV + rg * SCOPY + (lane & 7);
  const int db = SD + rg * SCOPY + (lane & 7);
  const int64_t sbase = (bh * D.NC + n) * (int64_t)D.K * D.V;
  // rows of whole 16-byte pieces (the tensors' bases are 16-byte aligned)
  const bool vec = (D.K * sizeof(T)) % 16 == 0 && (D.V * sizeof(T)) % 16 == 0;

  // v_t . do_t and r_t . (u k_t) of every step: 8 lanes a step, a fixed
  // shuffle tree
  {
    const int t = tid >> 3, sub = tid & 7;
    float x = 0.0f, y = 0.0f;
    if (t < nt && vec) {             // 16-byte pieces sub, sub + 8, ...
      constexpr int E = 16 / sizeof(T);
      const int64_t step = bh * D.T + t0 + t;
      for (int j0 = sub * E; j0 < D.V; j0 += 8 * E) {
        float a[E], b[E];
        load16(a, v + step * D.V + j0, true);
        load16(b, dout + step * D.V + j0, true);
#pragma unroll
        for (int m = 0; m < E; ++m) x = fmaf(a[m], b[m], x);
      }
      for (int c0 = sub * E; c0 < D.K; c0 += 8 * E) {
        float a[E], b[E];
        load16(a, r + step * D.K + c0, true);
        load16(b, k + step * D.K + c0, true);
#pragma unroll
        for (int m = 0; m < E; ++m)
          y = fmaf(a[m], u[(int64_t)h * D.K + c0 + m] * b[m], y);
      }
    } else if (t < nt) {
      const int64_t step = bh * D.T + t0 + t;
      for (int j = sub; j < D.V; j += 8)
        x = fmaf(to_f(v[step * D.V + j]), to_f(dout[step * D.V + j]), x);
      for (int c = sub; c < D.K; c += 8)
        y = fmaf(to_f(r[step * D.K + c]),
                 u[(int64_t)h * D.K + c] * to_f(k[step * D.K + c]), y);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, off);
      y += __shfl_xor_sync(0xffffffffu, y, off);
    }
    if (sub == 0 && t < nt) {
      av[t] = x;
      bv[t] = y;
    }
  }

  const bool hi2 = lane & 2, hi4 = lane & 4;
  for (int rp = 0; rp < D.nrp; ++rp)
    for (int cp = 0; cp < D.ncp; ++cp) {
      const int row0 = rp * TILE, col0 = cp * TILE;
      const int c = row0 + rr;
      const bool first_col = cp == 0, first_row = rp == 0;
      const bool last_col = cp == D.ncp - 1, last_row = rp == D.nrp - 1;
      // the finishing thread's row (x = tid % 64) and its u
      const int fx = tid % TILE, ftt = tid / TILE;
      const float fu = row0 + fx < D.K ? u[(int64_t)h * D.K + row0 + fx] : 0.0f;
      float dup = 0.0f;              // du over this thread's steps
      float s[8], g[8];
      load_state(s, s_st + sbase, c, col0, cb, D.K, D.V);
      load_state(g, g_st + sbase, c, col0, cb, D.K, D.V);

      // Sub-chunk a's outputs, from the stage (which holds its inputs),
      // dv's partials and the row sums: a thread per (step, 64 rows or
      // columns of the tile)
      auto finish = [&](int a) {
        const int t = a * SUBR + ftt;
        if (ftt >= min(SUBR, nt - a * SUBR)) return;
        const int j = col0 + fx;
        if (j < D.V) {
          float acc = 0.0f;
#pragma unroll
          for (int m = 0; m < 16; ++m) acc += dvp[(ftt * 16 + m) * TILE + fx];
          if (!first_row) acc += dva[t * TILE + fx];
          if (last_row)
            store_f(dv, (bh * D.T + t0 + t) * D.V + j,
                    fmaf(bv[t], st[SD + ftt * TILE + fx], acc));
          else
            dva[t * TILE + fx] = acc;
        }
        const int cc = row0 + fx;
        if (last_col && cc < D.K) {
          const int tb = D.ncp > 1 ? t : ftt;
          const float kk = st[SK + ftt * TILE + fx];
          const float rk = st[SR + ftt * TILE + fx];
          const float uk = fu * av[t];
          const int64_t at = (bh * D.T + t0 + t) * D.K + cc;
          store_f(dr, at, fmaf(uk, kk, ro[tb * TILE + fx]));
          store_f(dk, at, fmaf(uk, rk, ro[(RB + tb) * TILE + fx]));
          store_f(dw, at, st[SW + ftt * TILE + fx] < W_FLOOR
                              ? 0.0f : ro[(2 * RB + tb) * TILE + fx]);
          dup = fmaf(rk * kk, av[t], dup);
        }
      };

      // walk 1: S forward, a checkpoint at every sub-chunk start
      StageRegs pre = stage_load<T>(D, vec, bh, t0, min(SUBR, nt), row0,
                                    col0, k, w, r, v, dout);
      for (int a = 0; a < nsub; ++a) {
        if (a > 0)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            ck[((a - 1) * 8 + q) * THREADS + tid] = s[q];
        __syncthreads();             // every thread is done with the stage
        stage_store<T>(pre, vec, st);
        __syncthreads();
        const int ns = min(SUBR, nt - a * SUBR);
        if (a + 1 < nsub)
          pre = stage_load<T>(D, vec, bh, t0 + (a + 1) * SUBR,
                              min(SUBR, nt - (a + 1) * SUBR), row0, col0, k,
                              w, r, v, dout);
#pragma unroll
        for (int tt = 0; tt < SUBR; ++tt) {
          if (tt < ns) {
            const float kc = st[SK + tt * TILE + rr];
            const float wc = st[SW + tt * TILE + rr];
#pragma unroll
            for (int q = 0; q < 8; ++q)
              s[q] = fmaf(kc, st[vb + tt * TILE + 8 * q], wc * s[q]);
          }
        }
      }

      // walk 2: the sub-chunks from the last; each one's states again
      // from its checkpoint, then G backward over its steps with dr, dk,
      // dw (a reduce-scatter over the row's 8 lanes) and dv (over the
      // warp's 4 rows, then over the warps in shared memory)
      pre = stage_load<T>(D, vec, bh, t0 + (nsub - 1) * SUBR,
                          nt - (nsub - 1) * SUBR, row0, col0, k, w, r, v,
                          dout);
      for (int a = nsub - 1; a >= 0; --a) {
        __syncthreads();             // sub-chunk a + 1's sums are in
        if (a < nsub - 1) finish(a + 1);
        __syncthreads();             // and read, with its stage
        stage_store<T>(pre, vec, st);
        __syncthreads();
        const int ns = min(SUBR, nt - a * SUBR);
        if (a > 0)
          pre = stage_load<T>(D, vec, bh, t0 + (a - 1) * SUBR, SUBR, row0,
                              col0, k, w, r, v, dout);
        // S_{t-1} of the sub-chunk's steps [h0, h0 + 4) into hs, from the
        // checkpoint (4 states at a time: the second half first, then the
        // first half from the checkpoint again)
        float hs[HALF][8];
        auto states = [&](int h0) {
          if (a == 0) {
            load_state(hs[0], s_st + sbase, c, col0, cb, D.K, D.V);
          } else {
#pragma unroll
            for (int q = 0; q < 8; ++q)
              hs[0][q] = ck[((a - 1) * 8 + q) * THREADS + tid];
          }
#pragma unroll
          for (int tt = 0; tt < SUBR - 1; ++tt) {
            if (tt < h0 + HALF - 1 && tt + 1 < ns) {
              const float kc = st[SK + tt * TILE + rr];
              const float wc = st[SW + tt * TILE + rr];
              const int to = tt < h0 ? 0 : tt + 1 - h0;
              const int from = tt < h0 ? 0 : tt - h0;
#pragma unroll
              for (int q = 0; q < 8; ++q)
                hs[to][q] = fmaf(kc, st[vb + tt * TILE + 8 * q],
                                 wc * hs[from][q]);
            }
          }
        };
        // step tt (of the half at h0): G_t with S_{t-1} = hs[tt - h0]
        auto back = [&](int tt, int h0) {
          const float wc = st[SW + tt * TILE + rr];
          const float rc = st[SR + tt * TILE + rr];
#ifdef RWKV6_BWD_WALK_DW_ONLY
          // A measurement build (tools/rwkv6_bwd_walk.py; build.py never
          // defines it): G and dw alone, dr, dk and dv left unset, to
          // time what the walk costs without them. dw comes out
          // bit-identical (the same sums, each pair added either way).
          {
            float yw = 0.0f;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              yw = fmaf(g[q], hs[tt - h0][q], yw);
              g[q] = fmaf(rc, st[db + tt * TILE + 8 * q], wc * g[q]);
            }
            yw += __shfl_xor_sync(0xffffffffu, yw, 4);
            yw += __shfl_xor_sync(0xffffffffu, yw, 2);
            yw += __shfl_xor_sync(0xffffffffu, yw, 1);
            if ((lane & 7) == 4) {
              float* o = ro + (2 * RB + (D.ncp > 1 ? a * SUBR : 0) + tt) *
                                  TILE + rr;
              if (first_col)
                *o = yw;
              else
                *o += yw;
            }
            return;
          }
#endif
          const float kc = st[SK + tt * TILE + rr];
          float ys = 0.0f, yk = 0.0f, yw = 0.0f, pv[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const float vq = st[vb + tt * TILE + 8 * q];
            const float dq = st[db + tt * TILE + 8 * q];
            ys = fmaf(hs[tt - h0][q], dq, ys);
            yk = fmaf(g[q], vq, yk);
            yw = fmaf(g[q], hs[tt - h0][q], yw);
            pv[q] = g[q] * kc;
            g[q] = fmaf(rc, dq, wc * g[q]);
          }
          // (dr, dk, dw, 0) over the row's 8 lanes: lanes 0, 2 and 4 of
          // the 8 end with the sums of dr, dk and dw
          const float a0 = (hi4 ? yw : ys) +
                           __shfl_xor_sync(0xffffffffu, hi4 ? ys : yw, 4);
          const float a1 = (hi4 ? 0.0f : yk) +
                           __shfl_xor_sync(0xffffffffu, hi4 ? yk : 0.0f, 4);
          float b = (hi2 ? a1 : a0) +
                    __shfl_xor_sync(0xffffffffu, hi2 ? a0 : a1, 2);
          b += __shfl_xor_sync(0xffffffffu, b, 1);
          const int qi = (hi4 ? 2 : 0) + (hi2 ? 1 : 0);
          if ((lane & 1) == 0 && qi < 3) {
            float* o = ro + (qi * RB + (D.ncp > 1 ? a * SUBR : 0) + tt) *
                                TILE + rr;
            if (first_col)
              *o = b;
            else
              *o += b;
          }
          // dv: the warp's 4 rows summed (the lanes' column orders make
          // registers q + 4, then q + 2, the ones sent), 2 columns a lane
          float y4[4], y2[2];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            y4[q] = pv[q] + __shfl_xor_sync(0xffffffffu, pv[q + 4], 16);
#pragma unroll
          for (int q = 0; q < 2; ++q)
            y2[q] = y4[q] + __shfl_xor_sync(0xffffffffu, y4[q + 2], 8);
          float* o = dvp + (tt * 16 + warp) * TILE + cb;
          o[0] = y2[0];
          o[8] = y2[1];
        };
        if (ns > HALF) {
          states(HALF);
#pragma unroll
          for (int tt = SUBR - 1; tt >= HALF; --tt)
            if (tt < ns) back(tt, HALF);
        }
        states(0);
#pragma unroll
        for (int tt = HALF - 1; tt >= 0; --tt)
          if (tt < ns) back(tt, 0);
      }
      __syncthreads();
      finish(0);
      if (last_col) {                // du of the tile's rows, over the steps
        __syncthreads();             // every finish read dv's partials
        dvp[tid] = dup;
        __syncthreads();
        if (tid < TILE && row0 + tid < D.K) {
          float du = 0.0f;
#pragma unroll
          for (int m = 0; m < THREADS / TILE; ++m) du += dvp[m * TILE + tid];
          du_part[(bh * D.NC + n) * D.K + row0 + tid] = du;
        }
      }
    }
}

// Shared memory of the out kernel (bytes) for ncp column passes and nrp
// row passes.
static size_t out_smem(int ncp, int nrp) {
  const size_t RB = ncp > 1 ? MAX_C : SUBR;
  return sizeof(float) * ((size_t)(MAX_C / SUBR - 1) * 8 * THREADS + STAGE +
                          SUBR * 16 * TILE + 2 * MAX_C + 3 * RB * TILE +
                          (nrp > 1 ? MAX_C * TILE : 0));
}

template <typename T>
static int launch_bwd(const void* r, const void* k, const void* v,
                      const void* w, const void* u, const void* dout,
                      void* dr, void* dk, void* dv, void* dw, float* du_part,
                      float* s_st, float* g_st, float* dn, int B, int H,
                      int Tn, int K, int V, int C, cudaStream_t st) {
  BwdDims D{H, Tn, K, V, C, (Tn + C - 1) / C, (K + TILE - 1) / TILE,
            (V + TILE - 1) / TILE};
  const size_t local_smem = sizeof(float) * 5 * MAX_C * TILE;
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_bwd_local<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)local_smem);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = out_smem(D.ncp, D.nrp);
  err = cudaFuncSetAttribute(rwkv6_bwd_out<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, D.NC);
  rwkv6_bwd_local<T><<<grid, LTHREADS, local_smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const T*)dout,
      s_st, g_st, dn, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_carry<<<dim3(B * H, (K * V + CARRY_THREADS - 1) / CARRY_THREADS),
                    CARRY_THREADS, 0, st>>>(s_st, g_st, dn, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rwkv6_bwd_out<T><<<grid, THREADS, smem, st>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const T*)dout, (T*)dr, (T*)dk, (T*)dv, (T*)dw, du_part, s_st, g_st, D);
  return (int)cudaGetLastError();
}

// The largest state the kernels take: two 64 x 64 tiles' passes.
#define MAX_STATE 4096

// r, k, w, dr, dk, dw: (B, H, Tn, K); v, dout, dv: (B, H, Tn, V), of one
// dtype (bf16 != 0: bfloat16, else float32); u: (H, K) f32; du_part:
// (B, H, ceil(Tn / C), K) f32, each (b, h, chunk)'s share of du; s_st,
// g_st: f32 scratch of B * H * ceil(Tn / C) * K * V floats each (the
// chunk-start states and chunk-end gradients), dn: of B * H * ceil(Tn /
// C) * K (the chunks' decays). All contiguous. K, V <= 128, K V <= 4096,
// 1 <= C <= 64. Launches rwkv6_bwd_local, rwkv6_bwd_carry, rwkv6_bwd_out;
// returns cudaGetLastError() (nonzero: not launched).
extern "C" int rwkv6_bwd_launch(const void* r, const void* k, const void* v,
                                const void* w, const void* u,
                                const void* dout, void* dr, void* dk,
                                void* dv, void* dw, float* du_part,
                                float* s_st, float* g_st, float* dn, int B,
                                int H, int Tn, int K, int V, int C, int bf16,
                                void* stream) {
  if (K < 1 || V < 1 || K > 2 * TILE || V > 2 * TILE || K * V > MAX_STATE ||
      C < 1 || C > MAX_C || Tn < 1 || B < 1 || H < 1 ||
      (Tn + C - 1) / C > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch_bwd<__nv_bfloat16>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                          du_part, s_st, g_st, dn, B, H, Tn,
                                          K, V, C, st)
              : launch_bwd<float>(r, k, v, w, u, dout, dr, dk, dv, dw,
                                  du_part, s_st, g_st, dn, B, H, Tn, K, V, C,
                                  st);
}
