// Fused sorted-segment sum + first-row gather for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segment_fused.py ·
// segment_sum_first_pallas: per segment s in [0, S) it gives the f32 sums
// of the d value columns, the index of the segment's first row (INT32_MAX
// when the segment is empty) and that row's k int64 key lanes (0 when
// empty). Rows whose id lies outside [0, S) are dropped, at either end or
// between two rows of one id (summed across, as segment_reduce does).
//
// Precondition: the in-range seg_ids are non-decreasing (sum_by and
// nest_level hand over the dense group ids of a sorted bag), so every
// segment is one contiguous run of rows. A descending pair traps, as in
// segment_reduce (the next synchronisation raises).
//
// What bounds it on the card: bytes. Each row's id and values are read
// once (4 + 4d bytes), the keys only at each non-empty segment's first
// row (8k bytes), and each segment is written once (4d + 4 + 8k bytes).
// The Pallas kernel compared every row with every segment of a block
// (one-hot tiles for the MXU), O(n*S) work; sorted ids make that
// unnecessary. The callers' bags are capacity-padded: their invalid rows
// fold into the running segment, so the last group of a bag takes its
// whole invalid tail (tens of millions of rows in a distributed site's
// receive buffer or a general join's 4x output), and S is the capacity,
// so the ids above the last group are an empty tail as long. Both have
// to run at the card's bandwidth over every SM.
//
// The design is segment_reduce's (the note at the top of
// segment_reduce.cu), two launches, no float atomics, with the first row
// added; the passes are a copy of its own, so that each kernel's shape
// and launch bounds follow what its callers hand it:
//   1. tile pass (ssf_tile): 2048-row tiles; each id and value read once
//      with 16-byte coalesced loads into shared memory; each thread sums
//      16 consecutive rows (8 for more than 2 columns), and a segmented
//      scan joins the runs that cross threads. A max-scan of the rows
//      where each thread's last run starts (they rise with the thread)
//      gives every run its first row. The runs that start and end in the
//      tile (sums, fidx = the first row) and the empty ids between them
//      go to a slot per id in shared memory, and out together at the
//      end, coalesced; then the block gathers those segments' k key
//      lanes, 16 a thread in flight (the keys are read only at first
//      rows). Most groups of a GROUP BY are a row or a few long, so
//      these writes are most of the bytes, and scattered 4-byte stores
//      from each thread, or one run's keys after another in a thread,
//      would bound the pass. (A tile whose ids span more than 2048
//      writes each run directly.) The tile's first and last runs go to
//      its carry record: ids, sums and the rows where they start.
//   2. carry pass (ssf_carry): the tile that holds a run's first row
//      owns it: it writes fidx and the keys, and adds the carries of the
//      tiles that continue the run. A giant run is so summed by every
//      tile it spans, at the bandwidth of all SMs, and joined by one
//      warp that reads one carry per tile. Each empty segment is written
//      once (fidx = INT32_MAX, sums 0, keys 0): between two runs of a
//      tile by the tile, between two tiles by the earlier one, and the
//      ids below the first in-range id and above the last by every warp
//      of the grid, a share each. Nothing passes over S beforehand.
// Every sum runs in an order fixed by the ids and the tile shape alone,
// so repeated runs are bit-identical. With more than 4 value columns,
// more blocks along y take 4 columns each; the first of them writes the
// first rows and keys.
//
// Batched launches (the batched family execution, core.codegen
// vmap_program): the two passes take a batch of B calls, the batch as
// blockIdx.z of the tile pass and blockIdx.y of the carry pass. The
// values, keys and ids have a batch stride each, in elements (0 for an
// operand the calls share: read in place, not copied B times); the
// outputs and the scratch are B rows of a call's. Each batch row runs
// exactly the code of a launch of its own on its slice, carries and all,
// so it gives that launch's bits.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <type_traits>

#define TILE 2048                  // rows per block of the tile pass
#define BATCH 8                    // rows a thread holds in registers
#define CARRY_THREADS 256          // carry pass: 8 warps, a tile each
#define GAP_IDS 2048               // the end gaps' ids per carry warp
#define FILL_BATCH 16              // key lanes a thread gathers at a time
#define I32_MAX 2147483647
#define FULL 0xffffffffu

// The tile pass's shape for DC value columns: each thread sums ITEMS
// consecutive rows (fewer for more columns, as the registers bound the
// rows a thread holds; 16 for one column, where segment_reduce takes 32,
// for more threads to write and gather with).
template <int DC>
struct Tile {
  static constexpr int ITEMS = DC <= 2 ? 16 : 8;
  static constexpr int THREADS = TILE / ITEMS;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int ID_STRIDE = ITEMS / 4 + 1;  // int4 (+1 pad)
  static constexpr int CH = ITEMS * DC / 4;        // float4 of values
  static constexpr int VS = CH + 1;                // ... (+1 pad)
  static constexpr size_t SMEM = (size_t)16 * THREADS * (ID_STRIDE + VS);
  // the staged outputs: a slot per id (DC sums, a first row), after the
  // ids and values, one pad word per 32 so that threads TILE / THREADS
  // ids apart hit distinct banks
  static constexpr int OUT_WORDS = TILE * DC + TILE * DC / 32;
  static constexpr int ROW_WORDS = TILE + TILE / 32;
  static constexpr size_t OUT = (size_t)4 * (OUT_WORDS + ROW_WORDS);
};

__device__ __forceinline__ int pad32(int i) { return i + (i >> 5); }

// The first rows: keys (n, k) in; fidx (S,) and fvals (S, k) out; the
// scratch row_first / row_last (NT,) hold the row where each tile's
// first and last runs start.
struct Firsts {
  const int64_t* keys;
  int k;
  int32_t* fidx;
  int64_t* fvals;
  int32_t* row_first;
  int32_t* row_last;
};

// batch row z's first rows: its keys at kst elements a row, its fidx,
// fvals and row scratch at a call's size (S segments, NT tiles)
__device__ __forceinline__ Firsts firsts_at(Firsts f, int64_t z,
                                            int64_t kst, int64_t S,
                                            int64_t NT) {
  f.keys += z * kst;
  f.fidx += z * S;
  f.fvals += z * S * f.k;
  f.row_first += z * NT;
  f.row_last += z * NT;
  return f;
}

template <int DC>
__device__ __forceinline__ void write_run(float* __restrict__ out, int d,
                                          int j0, int nc, int s,
                                          const float* acc) {
  float* o = out + (int64_t)s * d + j0;
#pragma unroll
  for (int j = 0; j < DC; ++j)
    if (j < nc) o[j] = acc[j];
}

// segment s starts at row `row`: its first-row index and key lanes, the
// lanes spread over the warp (the carry pass's boundary runs)
__device__ __forceinline__ void write_first(const Firsts& f, int s, int row,
                                            int lane) {
  if (lane == 0) f.fidx[s] = row;
  for (int j = lane; j < f.k; j += 32)
    f.fvals[(int64_t)s * f.k + j] = f.keys[(int64_t)row * f.k + j];
}

// The key lanes of the segments [a, b), whose first rows row_of(s)
// gives (INT32_MAX: empty, lanes 0): FILL_BATCH lanes a thread at a
// time, the gathers of a batch in flight together, the writes coalesced.
// The tile pass gathers its segments' keys so, after its threads have
// found every first row, rather than one run after another in a thread.
// (Idx: the type of an offset in [0, (b - a) k), 32 bits where the ids
// fit the tile's slots: the divisions by k are then cheap.)
template <class Idx, class RowOf>
__device__ __forceinline__ void fill_keys(const Firsts& f, int a, int b,
                                          int tid, int threads,
                                          RowOf row_of) {
  const Idx k = (Idx)f.k, count = (Idx)(b - a) * k;
  int64_t* out = f.fvals + (int64_t)a * f.k;
  for (Idx e0 = tid; e0 < count; e0 += (Idx)threads * FILL_BATCH) {
    int row[FILL_BATCH];
    int64_t v[FILL_BATCH];
#pragma unroll
    for (int u = 0; u < FILL_BATCH; ++u) {
      const Idx e = e0 + (Idx)u * threads;
      row[u] = e < count ? row_of(a + (int)(e / k)) : I32_MAX;
    }
#pragma unroll
    for (int u = 0; u < FILL_BATCH; ++u) {
      const Idx e = e0 + (Idx)u * threads;
      v[u] = row[u] == I32_MAX ? 0 : f.keys[(int64_t)row[u] * k + e % k];
    }
#pragma unroll
    for (int u = 0; u < FILL_BATCH; ++u) {
      const Idx e = e0 + (Idx)u * threads;
      if (e < count) out[e] = v[u];
    }
  }
}

// the ids [a, b) hold no row (their key lanes: fill_keys)
template <int DC>
__device__ __forceinline__ void zero_ids(float* __restrict__ out, int d,
                                         int j0, int nc, bool lead,
                                         const Firsts& f, int a, int b) {
  for (int s = a; s < b; ++s) {
    float* o = out + (int64_t)s * d + j0;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (j < nc) o[j] = 0.0f;
    if (lead) f.fidx[s] = I32_MAX;
  }
}

__device__ __noinline__ void descending(const char* where, int64_t row,
                                        int after, int id) {
  printf("%s: in-range seg_ids descend (%d after %d) %s row %lld; the "
         "kernel needs them non-decreasing\n",
         "segment_sum_first", id, after, where,
         (long long)row);
  __trap();
}

// Tile pass. Writes the runs that start and end inside the tile and the
// ids skipped between them; tile_first/tile_last[t] get the tile's lowest
// and highest in-range id (-1 for a tile without one), carry_first/
// carry_last[t, :] the sums of those two runs within the tile (the same
// run when the two ids are equal), and row_first/row_last[t] the rows
// where those two runs start in the tile.
template <int DC>
__device__ __forceinline__ void tile_pass(
    const float* __restrict__ vals,
    const int32_t* __restrict__ seg, int64_t n, int d, int S,
    float* __restrict__ out, int32_t* __restrict__ tile_first,
    int32_t* __restrict__ tile_last, float* __restrict__ carry_first,
    float* __restrict__ carry_last, const Firsts& fs) {
  using T = Tile<DC>;
  constexpr int THREADS = T::THREADS, WARPS = T::WARPS, ITEMS = T::ITEMS;
  constexpr int ID_STRIDE = T::ID_STRIDE, CH = T::CH, VS = T::VS;
  extern __shared__ float4 smem4[];
  int4* sid4 = reinterpret_cast<int4*>(smem4);
  float4* sval4 = smem4 + THREADS * ID_STRIDE;
  int* sid = reinterpret_cast<int*>(sid4);
  float* sval = reinterpret_cast<float*>(sval4);
  __shared__ int w_max[WARPS], w_min[WARPS], w_flag[WARPS], w_row[WARPS];
  __shared__ float w_val[WARPS][DC];
  float* s_out = reinterpret_cast<float*>(smem4 + THREADS * (ID_STRIDE + VS));
  int* s_row = reinterpret_cast<int*>(s_out + T::OUT_WORDS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * TILE;
  const int rows = (int)min((int64_t)TILE, n - row0);
  const int j0 = blockIdx.y * DC, nc = min(DC, d - j0);
  const bool lead = blockIdx.y == 0;      // writes ids, rows and keys

  // ---- stage ids and values, thread-chunked with one pad float4 each
  if (rows == TILE && ((uintptr_t)seg & 15) == 0) {
    const int4* g = reinterpret_cast<const int4*>(seg + row0);
    for (int e = tid; e < TILE / 4; e += THREADS)
      sid4[(e / (ITEMS / 4)) * ID_STRIDE + e % (ITEMS / 4)] =
          __ldcs(g + e);
  } else {
    for (int r = tid; r < TILE; r += THREADS)
      sid[(r / ITEMS) * 4 * ID_STRIDE + r % ITEMS] =
          r < rows ? seg[row0 + r] : -1;
  }
  if (rows == TILE && nc == d && nc > 0 &&
      ((uintptr_t)vals & 15) == 0) {
    const float4* g = reinterpret_cast<const float4*>(vals + row0 * d);
    for (int e = tid; e < TILE * DC / 4; e += THREADS)
      sval4[(e / CH) * VS + e % CH] = __ldcs(g + e);
  } else {
    for (int f = tid; f < TILE * DC; f += THREADS) {
      const int r = f / DC, j = f % DC;
      sval[(r / ITEMS) * 4 * VS + (r % ITEMS) * DC + j] =
          (r < rows && j < nc) ? vals[(row0 + r) * d + j0 + j] : 0.0f;
    }
  }
  __syncthreads();

  // ---- the tile's lowest and highest in-range id, now; where the
  // ids between them fit the slots (the rule: group ids are dense), the
  // runs and gaps inside the tile go to shared memory and out together
  // at the end, coalesced, rather than 4 bytes a store from each thread
  int tfirst = INT32_MAX, tlast = -1;
  {
    __shared__ int p_min[WARPS], p_max[WARPS];
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      const int x = sid[tid * 4 * ID_STRIDE + u];
      if ((unsigned)x < (unsigned)S) {
        tfirst = min(tfirst, x);
        tlast = max(tlast, x);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      tfirst = min(tfirst, __shfl_xor_sync(FULL, tfirst, off));
      tlast = max(tlast, __shfl_xor_sync(FULL, tlast, off));
    }
    if (lane == 0) {
      p_min[warp] = tfirst;
      p_max[warp] = tlast;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < WARPS; ++u) {
      tfirst = min(tfirst, p_min[u]);
      tlast = max(tlast, p_max[u]);
    }
  }
  const bool staged = tlast >= 0 && tlast - tfirst < TILE;
  // a run that starts and ends in the tile, and the ids [a, b) between
  // two runs, which hold no row
  auto put_run = [&](int s, const float* sum, int row) {
    if (staged) {
#pragma unroll
      for (int j = 0; j < DC; ++j)
        s_out[pad32((s - tfirst) * DC + j)] = sum[j];
      s_row[pad32(s - tfirst)] = row;
    } else {
      write_run<DC>(out, d, j0, nc, s, sum);
      if (lead) fs.fidx[s] = row;
    }
  };
  auto put_gap = [&](int a, int b) {
    if (staged) {
      for (int s = a; s < b; ++s) {
#pragma unroll
        for (int j = 0; j < DC; ++j)
          s_out[pad32((s - tfirst) * DC + j)] = 0.0f;
        s_row[pad32(s - tfirst)] = I32_MAX;
      }
    } else {
      zero_ids<DC>(out, d, j0, nc, lead, fs, a, b);
    }
  };

  // ---- the thread's rows in order, BATCH at a time from shared memory:
  // head = its first run, tail = its last; *_row where each starts
  int head = -1, tail = -1, head_row = -1, tail_row = -1;
  bool single = true;
  float hsum[DC], acc[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) hsum[j] = acc[j] = 0.0f;
#pragma unroll 1
  for (int b0 = 0; b0 < ITEMS; b0 += BATCH) {
    int ids[BATCH];
    float v[BATCH * DC];
    const int4 a = sid4[tid * ID_STRIDE + b0 / 4];
    const int4 b = sid4[tid * ID_STRIDE + b0 / 4 + 1];
    ids[0] = a.x; ids[1] = a.y; ids[2] = a.z; ids[3] = a.w;
    ids[4] = b.x; ids[5] = b.y; ids[6] = b.z; ids[7] = b.w;
#pragma unroll
    for (int m = 0; m < BATCH * DC / 4; ++m) {
      const float4 x = sval4[tid * VS + b0 * DC / 4 + m];
      v[4 * m] = x.x; v[4 * m + 1] = x.y; v[4 * m + 2] = x.z;
      v[4 * m + 3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int s = ids[i];
      if ((unsigned)s >= (unsigned)S) continue;      // dropped, run goes on
      if (s != tail) {
        if (tail >= 0) {
          if (s < tail)
            descending("in a tile at", row0 + tid * ITEMS + b0 + i,
                              tail, s);
          if (single) {
#pragma unroll
            for (int j = 0; j < DC; ++j) hsum[j] = acc[j];
            single = false;
          } else {                                   // inside the thread
            put_run(tail, acc, tail_row);
          }
          put_gap(tail + 1, s);
        } else {
          head = s;
          head_row = (int)row0 + tid * ITEMS + b0 + i;
        }
        tail = s;
        tail_row = (int)row0 + tid * ITEMS + b0 + i;
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[j] += v[i * DC + j];
    }
  }
  if (single) {
#pragma unroll
    for (int j = 0; j < DC; ++j) hsum[j] = acc[j];
  }

  // ---- the tile's lowest and highest id, each thread's previous id
  int imax = tail;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(FULL, imax, off);
    if (lane >= off) imax = max(imax, up);
  }
  int imin = head >= 0 ? head : INT32_MAX;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    imin = min(imin, __shfl_xor_sync(FULL, imin, off));
  if (lane == 31) w_max[warp] = imax;
  if (lane == 0) w_min[warp] = imin;
  __syncthreads();
  int first = INT32_MAX, last = -1, wprev = -1;
#pragma unroll
  for (int u = 0; u < WARPS; ++u) {
    first = min(first, w_min[u]);
    last = max(last, w_max[u]);
    if (u < warp) wprev = max(wprev, w_max[u]);
  }
  int prev = __shfl_up_sync(FULL, imax, 1);
  prev = max(lane == 0 ? -1 : prev, wprev);           // last id before
  if (head >= 0 && head < prev)
    descending("between threads at", row0 + tid * ITEMS, prev, head);

  // ---- segmented scan of the last runs' sums across threads; a
  // max-scan of the rows where a thread's last run starts in it
  // (they rise with the thread) gives each run's first row
  const bool nonempty = tail >= 0;
  bool flag = nonempty && !(single && head == prev);  // run starts here
  int rscan = flag ? tail_row : -1;
  float val[DC];
#pragma unroll
  for (int j = 0; j < DC; ++j) val[j] = acc[j];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const bool fu = __shfl_up_sync(FULL, flag, off);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const float vu = __shfl_up_sync(FULL, val[j], off);
      if (lane >= off && !flag) val[j] = vu + val[j];
    }
    if (lane >= off) flag = flag || fu;
    const int ru = __shfl_up_sync(FULL, rscan, off);
    if (lane >= off) rscan = max(rscan, ru);
  }
  if (lane == 31) {
    w_flag[warp] = flag;
    w_row[warp] = rscan;
#pragma unroll
    for (int j = 0; j < DC; ++j) w_val[warp][j] = val[j];
  }
  __syncthreads();
  float pre[DC];                                      // warps before mine
#pragma unroll
  for (int j = 0; j < DC; ++j) pre[j] = 0.0f;
  int wrow = -1;
  for (int u = 0; u < warp; ++u) {
    const bool fl = w_flag[u];
#pragma unroll
    for (int j = 0; j < DC; ++j)
      pre[j] = fl ? w_val[u][j] : pre[j] + w_val[u][j];
    wrow = max(wrow, w_row[u]);
  }
  const bool fe = __shfl_up_sync(FULL, flag, 1);
  float before[DC];                                   // run `prev` so far
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    const float ve = __shfl_up_sync(FULL, val[j], 1);
    before[j] = lane == 0 ? pre[j] : (fe ? ve : pre[j] + ve);
  }
  // the rows where `prev`'s run and my last run start
  const int re = __shfl_up_sync(FULL, rscan, 1);
  const int row_before = max(lane == 0 ? -1 : re, wrow);
  const int row_last = max(rscan, wrow);

  const int64_t t = blockIdx.x;
  if (nonempty) {
    const bool cont = head == prev;
    if (!cont && prev >= 0) {                         // `prev` ended before
      if (prev == first) {
        write_run<DC>(carry_first, d, j0, nc, (int)t, before);
        if (lead) fs.row_first[t] = row_before;
      } else {
        put_run(prev, before, row_before);
      }
      put_gap(prev + 1, head);
    }
    if (!single) {                                    // head ends in here
      float tot[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j)
        tot[j] = cont ? before[j] + hsum[j] : hsum[j];
      const int hrow = cont ? row_before : head_row;
      if (head == first) {
        write_run<DC>(carry_first, d, j0, nc, (int)t, tot);
        if (lead) fs.row_first[t] = hrow;
      } else {
        put_run(head, tot, hrow);
      }
    }
  }
  if (tid == THREADS - 1) {          // the tile's last run: val is its sum
    if (lead) {
      tile_first[t] = last >= 0 ? first : -1;
      tile_last[t] = last;
      if (last >= 0) {
        fs.row_last[t] = row_last;
        if (first == last) fs.row_first[t] = row_last;
      }
    }
    if (last >= 0) {
      float tot[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) tot[j] = flag ? val[j] : pre[j] + val[j];
      write_run<DC>(carry_last, d, j0, nc, (int)t, tot);
      if (first == last) write_run<DC>(carry_first, d, j0, nc, (int)t, tot);
    }
  }
  // the segments (first, last), whole, and their key lanes (last >= 0:
  // any id)
  __syncthreads();
  const int a = first + 1, b = last;
  if (staged && b > a) {
    for (int e = tid; e < (b - a) * DC; e += THREADS) {
      const int s = a + e / DC, j = e % DC;
      if (j < nc)
        out[(int64_t)s * d + j0 + j] = s_out[pad32((s - first) * DC + j)];
    }
    if (lead) {
      for (int e = tid; e < b - a; e += THREADS)
        fs.fidx[a + e] = s_row[pad32(a + e - first)];
      fill_keys<uint32_t>(fs, a, b, tid, THREADS,
                          [&](int s) { return s_row[pad32(s - first)]; });
    }
  } else if (lead && last >= 0 && b > a) {
    fill_keys<int64_t>(fs, a, b, tid, THREADS,
                       [&](int s) { return fs.fidx[s]; });
  }
}

// The first tile q from `start` on, walking by `dir` (+1 or -1), for
// which hit(q) holds; -1 if there is none. The first step checks 32
// tiles (nearly every neighbour is there), each later one 32 * WIDE (a
// lane's loads in flight together), each settled by ballots; every lane
// of the warp gets the answer.
template <int WIDE, class Hit>
__device__ int scan_tiles(int NT, int start, int dir, int lane, Hit hit) {
  int width = 1;
  for (int64_t base = start; base >= 0 && base < NT;
       base += (int64_t)32 * width * dir, width = WIDE) {
    bool h[WIDE];
#pragma unroll
    for (int u = 0; u < WIDE; ++u) {
      const int64_t q = base + dir * (32 * u + lane);
      h[u] = u < width && q >= 0 && q < NT && hit((int)q);
    }
#pragma unroll
    for (int u = 0; u < WIDE; ++u) {
      const unsigned m = __ballot_sync(FULL, h[u]);
      if (m) return (int)(base + dir * (32 * u + __ffs(m) - 1));
    }
  }
  return -1;
}

// p[a, b) = x, the elements spread over `threads` threads (this one is
// `i`), 16 bytes a store between an unaligned head and tail
template <typename T, typename V>
__device__ void fill(T* p, int64_t a, int64_t b, T x, int64_t i,
                     int64_t threads) {
  constexpr int PER = 16 / sizeof(T);
  const int mis = (int)(((uintptr_t)(p + a) & 15) / sizeof(T));
  const int64_t mid = min(b, a + (mis ? PER - mis : 0));
  const int64_t nvec = (b - mid) / PER, tail = mid + nvec * PER;
  if (i < mid - a) p[a + i] = x;
  if (i < b - tail) p[tail + i] = x;
  V xv;
  T* xs = reinterpret_cast<T*>(&xv);
#pragma unroll
  for (int u = 0; u < PER; ++u) xs[u] = x;
  V* pv = reinterpret_cast<V*>(p + mid);
  for (int64_t e = i; e < nvec; e += threads) pv[e] = xv;
}

// The empty ids [a, b), their elements spread over `warps` warps (this
// one is `w`): one warp for a gap between two tiles, every warp of the
// grid for the gaps before the first in-range id and after the last.
__device__ void zero_span(float* __restrict__ out, int d, const Firsts& f,
                          int64_t a, int64_t b, int64_t w, int64_t warps,
                          int lane) {
  if (a >= b) return;
  const int64_t i = w * 32 + lane, threads = warps * 32;
  fill<float, float4>(out, a * d, b * d, 0.0f, i, threads);
  fill<int32_t, int4>(f.fidx, a, b, I32_MAX, i, threads);
  fill<int64_t, longlong2>(f.fvals, a * f.k, b * f.k, 0, i, threads);
}

// Carry pass, the work of tile t's warp (first >= 0: t holds an
// in-range id): it finds its neighbours (the next non-empty tiles each
// way); zeroes the ids between its last id and the next non-empty tile's
// first; writes its first run where it starts and ends in t; and, where
// t holds the first rows of its last run, owns that run: it walks the
// tiles after t that continue it, 32 in the first step and 32 * WIDE in
// each later one (WIDE = 16: a run over 10,000 tiles takes 20 steps;
// more registers, fewer warps an SM), each lane adding the carries of
// its tiles in order, DC columns at a time, the lanes joined by a fixed
// shuffle tree, and writes the sums. `own` holds what carry_pass loaded
// ahead for the first DC columns: t's carries and the walk's first step.
template <int DC>
struct Ahead {
  int f, l;                          // tile t + 1 + lane: first, last id
  float c[DC], first[DC], last[DC];  // its carry; t's two carries
};

template <int WIDE, int DC>
__device__ __forceinline__ void carry_tile(
    const int32_t* __restrict__ tile_first,
    const int32_t* __restrict__ tile_last,
    const float* __restrict__ carry_first,
    const float* __restrict__ carry_last, int NT, int d, int S,
    float* __restrict__ out, const Firsts& fs, int t, int lane, int first,
    int last, int prev, int next, int p0, int p1, const Ahead<DC>& own) {
  auto nonempty = [&](int q) { return tile_first[q] >= 0; };
  if (prev < 0 && t > p0) {
    const int p = scan_tiles<WIDE>(NT, t - 2, -1, lane, nonempty);
    prev = tile_last[p];
  }
  if (next < 0)
    next = t < p1
               ? tile_first[scan_tiles<WIDE>(NT, t + 2, 1, lane, nonempty)]
               : S;
  if (prev > first) {
    if (lane == 0)
      descending("at the tile of", (int64_t)t * TILE, prev, first);
    __syncwarp();
  }
  if (t < p1 && next > last + 1)
    zero_span(out, d, fs, last + 1, next, 0, 1, lane);
  if (first != last && prev != first) {    // the first run is all here
#pragma unroll
    for (int j = 0; j < DC; ++j)
      if (lane == j && j < d) out[(int64_t)first * d + j] = own.first[j];
    for (int j = DC + lane; j < d; j += 32)
      out[(int64_t)first * d + j] = carry_first[(int64_t)t * d + j];
    write_first(fs, first, fs.row_first[t], lane);
  }
  if (first == last && prev == first) return;   // an earlier tile owns it
  // own the last run s: add the carries of the tiles after t up to the
  // first that holds a later id or ends s (its carry too where it holds
  // s); an empty tile's carry is unset and skipped
  const int s = last;
  for (int j0 = 0; j0 < d; j0 += DC) {
    float x[DC];
#pragma unroll
    for (int j = 0; j < DC; ++j) x[j] = 0.0f;
    int width = next == s ? 1 : 0;
    for (int64_t base = t + 1; width > 0 && base < NT;
         base += 32 * width, width = WIDE) {
      int f[WIDE], l[WIDE];
      float c[WIDE][DC];
      const bool ahead = j0 == 0 && base == t + 1;   // own: loaded
#pragma unroll
      for (int u = 0; u < WIDE; ++u) {
        const int64_t r = base + 32 * u + lane;
        const bool ok = u < width && r < NT;
        if (u == 0 && ahead) {
          f[u] = own.f;
          l[u] = own.l;
#pragma unroll
          for (int j = 0; j < DC; ++j) c[u][j] = own.c[j];
          continue;
        }
        f[u] = ok ? tile_first[r] : I32_MAX;
        l[u] = ok ? tile_last[r] : 0;
#pragma unroll
        for (int j = 0; j < DC; ++j)
          c[u][j] = ok && j0 + j < d ? carry_first[r * d + j0 + j] : 0.0f;
      }
      int e = I32_MAX;               // the step's first tile that ends s
#pragma unroll
      for (int u = 0; u < WIDE; ++u) {
        const unsigned m = __ballot_sync(
            FULL, u < width && ((f[u] >= 0 && f[u] != s) ||
                                (f[u] == s && l[u] != s)));
        if (m && e == I32_MAX) e = 32 * u + __ffs(m) - 1;
      }
#pragma unroll
      for (int u = 0; u < WIDE; ++u)
        if (f[u] == s && 32 * u + lane <= e) {
#pragma unroll
          for (int j = 0; j < DC; ++j) x[j] += c[u][j];
        }
      if (e != I32_MAX) break;
    }
#pragma unroll
    for (int j = 0; j < DC; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x[j] += __shfl_xor_sync(FULL, x[j], off);  // the same bits in
      if (lane == 0 && j0 + j < d)                  // every lane
        out[(int64_t)s * d + j0 + j] =
            (j0 == 0 ? own.last[j] : carry_last[(int64_t)t * d + j0 + j]) +
            x[j];
    }
  }
  write_first(fs, s, fs.row_last[t], lane);
}

// Carry pass: a warp per tile, and at least one per GAP_IDS ids. Where
// the neighbouring and the end tiles hold an in-range id, which is the
// rule, every load a warp needs before its writes goes out in one round.
// The warp of a tile does carry_tile's work; then every warp takes its
// share of the ids below the first in-range id and above the last (the
// empty tail of a capacity-padded group, tens of millions of ids, spread
// over the grid). DC: value columns a step of carry_tile loads at once
// (min(d, 4)).
template <int WIDE, int DC>
__device__ __forceinline__ void carry_pass(
    const int32_t* __restrict__ tile_first,
    const int32_t* __restrict__ tile_last,
    const float* __restrict__ carry_first,
    const float* __restrict__ carry_last, int NT, int d, int S,
    float* __restrict__ out, const Firsts& fs) {
  const int lane = threadIdx.x & 31;
  const int64_t w = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int t = (int)min(w, (int64_t)NT);
  auto nonempty = [&](int q) { return tile_first[q] >= 0; };
  // one round of loads: the end tiles, this tile and its neighbours
  // (a tile's last id is -1 exactly where its first is), t's carries and
  // the first step of its walk (tiles t + 1 + lane)
  const int f0 = NT > 0 ? tile_first[0] : -1;
  const int l1 = NT > 0 ? tile_last[NT - 1] : -1;
  const int first = t < NT ? tile_first[t] : -1;
  const int last = t < NT ? tile_last[t] : -1;
  const int prev = t > 0 && t < NT ? tile_last[t - 1] : -1;
  Ahead<DC> own;
  const int64_t r1 = (int64_t)t + 1 + lane;
  own.f = r1 < NT ? tile_first[r1] : I32_MAX;
  own.l = r1 < NT ? tile_last[r1] : 0;
#pragma unroll
  for (int j = 0; j < DC; ++j) {
    own.c[j] = r1 < NT && j < d ? carry_first[r1 * d + j] : 0.0f;
    own.first[j] = t < NT && j < d ? carry_first[(int64_t)t * d + j] : 0.0f;
    own.last[j] = t < NT && j < d ? carry_last[(int64_t)t * d + j] : 0.0f;
  }
  const int next = __shfl_sync(FULL, t + 1 < NT ? own.f : -1, 0);
  int p0 = 0, p1 = NT - 1, lo_end = f0, hi_last = l1;
  if (f0 < 0) {
    p0 = scan_tiles<WIDE>(NT, 1, 1, lane, nonempty);
    lo_end = p0 < 0 ? S : tile_first[p0];
  }
  if (l1 < 0) {
    p1 = p0 < 0 ? -1 : scan_tiles<WIDE>(NT, NT - 2, -1, lane, nonempty);
    hi_last = p1 < 0 ? S - 1 : tile_last[p1];
  }
  if (first >= 0)
    carry_tile<WIDE, DC>(tile_first, tile_last, carry_first, carry_last, NT,
                         d, S, out, fs, t, lane, first, last, prev, next, p0,
                         p1, own);
  zero_span(out, d, fs, 0, lo_end, w, warps, lane);
  zero_span(out, d, fs, (int64_t)hi_last + 1, S, w, warps, lane);
}

// Grid of the carry pass: a warp per tile, at least one per GAP_IDS ids.
static inline int carry_blocks(int NT, int64_t S) {
  int64_t warps = (S + GAP_IDS - 1) / GAP_IDS;
  if (warps < NT) warps = NT;
  if (warps < 1) warps = 1;
  return (int)((warps + CARRY_THREADS / 32 - 1) / (CARRY_THREADS / 32));
}

// (batch row blockIdx.z: values at vs, ids at ss, keys at kst elements a
// row; gridDim.x is the tile count NT)
template <int DC>
__global__ void __launch_bounds__(Tile<DC>::THREADS)
    ssf_tile(const float* __restrict__ vals, const int32_t* __restrict__ seg,
             int64_t n, int d, int S, float* __restrict__ sums,
             int32_t* __restrict__ tile_first,
             int32_t* __restrict__ tile_last,
             float* __restrict__ carry_first,
             float* __restrict__ carry_last, Firsts fs, int64_t vs,
             int64_t ss, int64_t kst) {
  const int64_t z = blockIdx.z, NT = gridDim.x;
  tile_pass<DC>(vals + z * vs, seg + z * ss, n, d, S,
                sums + z * S * d, tile_first + z * NT, tile_last + z * NT,
                carry_first + z * NT * d, carry_last + z * NT * d,
                firsts_at(fs, z, kst, S, NT));
}

__global__ void __launch_bounds__(CARRY_THREADS)
    ssf_carry(const int32_t* __restrict__ tile_first,
              const int32_t* __restrict__ tile_last,
              const float* __restrict__ carry_first,
              const float* __restrict__ carry_last, int NT, int d, int S,
              float* __restrict__ sums, Firsts fs, int64_t kst) {
  // batch row blockIdx.y: its scratch, outputs and keys
  const int64_t z = blockIdx.y;
  tile_first += z * NT;
  tile_last += z * NT;
  carry_first += z * NT * d;
  carry_last += z * NT * d;
  sums += z * S * d;
  fs = firsts_at(fs, z, kst, S, NT);
  // the columns of a carry step (min(d, 4)) and its width, so that the
  // step's loads fit the registers
  const auto pass = [&](auto dc) {
    constexpr int DC = decltype(dc)::value;
    carry_pass<16 / DC, DC>(tile_first, tile_last, carry_first,
                            carry_last, NT, d, S, sums, fs);
  };
  if (d <= 1) pass(std::integral_constant<int, 1>());
  else if (d == 2) pass(std::integral_constant<int, 2>());
  else if (d == 3) pass(std::integral_constant<int, 3>());
  else pass(std::integral_constant<int, 4>());
}

// input strides of a batched launch, in elements (0: shared)
struct Strides {
  int64_t vals, seg, keys;
};

template <int DC>
static cudaError_t launch_tile(int NT, int groups, int B, cudaStream_t st,
                               const float* vals, const int32_t* seg,
                               int64_t n, int d, int S, float* sums,
                               int32_t* tf, int32_t* tl, float* cf,
                               float* cl, const Firsts& fs,
                               const Strides& bs) {
  const size_t smem = Tile<DC>::SMEM + Tile<DC>::OUT;
  cudaError_t err = cudaFuncSetAttribute(
      ssf_tile<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssf_tile<DC><<<dim3(NT, groups, B), Tile<DC>::THREADS, smem, st>>>(
      vals, seg, n, d, S, sums, tf, tl, cf, cl, fs, bs.vals, bs.seg,
      bs.keys);
  return cudaSuccess;
}

// B calls (batch rows) in one launch sequence, B = 1 and the strides 0
// for one call: batch row b reads n rows of d >= 0 f32 values at vals +
// b vs, k >= 0 int64 key lanes at keys + b ks and int32 ids at seg + b ss
// (a stride 0 for an operand the rows share); S >= 0 segments (none:
// nothing is launched). Outputs and scratch: B rows of a call's, NT =
// ceil(n / 2048) tiles (refused if `tiles` differs): tile_first,
// tile_last, row_first and row_last hold NT int32 a row, carry_first and
// carry_last NT rows of d floats. Returns cudaGetLastError() after the
// launches (nonzero: not launched).
extern "C" int segment_sum_first_launch(
    const void* vals, int64_t vs, const void* keys, int64_t ks,
    const void* seg, int64_t ss, int64_t n, int d, int k, int64_t S, int B,
    void* sums, void* fidx, void* fvals, int64_t tiles, void* tile_first,
    void* tile_last, void* row_first, void* row_last, void* carry_first,
    void* carry_last, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || d < 0 || k < 0 || S < 0 || S >= INT32_MAX ||
      n >= INT32_MAX || tiles != (n + TILE - 1) / TILE || B < 1 ||
      B > 65535 || vs < 0 || ss < 0 || ks < 0)
    return (int)cudaErrorInvalidValue;
  const Strides bs{vs, ss, ks};
  if (S == 0) return (int)cudaGetLastError();
  const int NT = (int)tiles, s = (int)S;
  const int DC = d < 1 ? 1 : (d < 4 ? d : 4);
  const int groups = d < 1 ? 1 : (d + DC - 1) / DC;
  const Firsts fs{(const int64_t*)keys, k, (int32_t*)fidx, (int64_t*)fvals,
                  (int32_t*)row_first, (int32_t*)row_last};
  const float* v = (const float*)vals;
  const int32_t* g = (const int32_t*)seg;
  float* o = (float*)sums;
  int32_t *tf = (int32_t*)tile_first, *tl = (int32_t*)tile_last;
  float *cf = (float*)carry_first, *cl = (float*)carry_last;
  if (NT > 0) {
    const cudaError_t err =
        DC == 1   ? launch_tile<1>(NT, groups, B, st, v, g, n, d, s, o, tf,
                                   tl, cf, cl, fs, bs)
        : DC == 2 ? launch_tile<2>(NT, groups, B, st, v, g, n, d, s, o, tf,
                                   tl, cf, cl, fs, bs)
        : DC == 3 ? launch_tile<3>(NT, groups, B, st, v, g, n, d, s, o, tf,
                                   tl, cf, cl, fs, bs)
                  : launch_tile<4>(NT, groups, B, st, v, g, n, d, s, o, tf,
                                   tl, cf, cl, fs, bs);
    if (err != cudaSuccess) return (int)err;
  }
  ssf_carry<<<dim3(carry_blocks(NT, S), B), CARRY_THREADS, 0, st>>>(
      tf, tl, cf, cl, NT, d, s, o, fs, bs.keys);
  return (int)cudaGetLastError();
}
