#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

It drives the port's paths — the paper's shredded route and, at the
end, the LM's prefill and serving, with the hand-written Hopper
kernels — and fails (nonzero exit, no result line) if anything is
wrong or if there is no CUDA device. Phases:

  0 device     the card's name, and nvidia-smi's name and power limit;
  1 build      nvcc builds every kernel library from the checkout;
  2 kernels    each CUDA kernel against its plain PyTorch version on
               the card, bit for bit, over the edge cases (segment_reduce's
               with its 2048-row tiles' edges, d = 1 to 5);
               flash_attention (both its tensor-core and its CUDA-core
               path, with the tensor-core kernel's tile edges) and rwkv6
               (its one path, the tensor cores, with T around multiples
               of its 16-step sub-chunk and of the chunk) within a
               first-order f32 rounding bound (+1 bf16 ulp in bf16), two
               launches bit-identical, the worst share per path;
               segment_sum_first and merge_positions also at card scale
               (the 2048-row tiles' edges, a run over 250 tiles, a
               4M-row group over an empty tail as long, r = 2^24 + 3
               keys, ascending queries), two launches bit-identical;
               pack_rows and replicate_scatter also around their
               1024-slot tiles (one, two and more tiles than the grid
               has blocks, d = 1 to 12, int64 ids beyond 2^32, views
               off a 16-byte boundary), gather_rows around its 1024-row
               tiles (the same edges, ids -1, r, INT64_MAX and
               INT64_MIN), rle_expand around its scan and row tiles
               (one run of over 2^20 rows, runs of 1, more scan tiles
               than resident blocks, r = 1, ``out`` off a 16-byte
               boundary), delta_unpack around its 4096-row tiles (every
               width with z 0-15 bytes off a 16-byte boundary, sums that
               wrap, look-backs over more than one window, ``out`` off a
               boundary), member_mask on its sorted path (sets of 0 to
               256 keys, duplicates and padding between, keys off a
               16-byte boundary) and its staged one (257 to 5,000 keys),
               two launches bit-identical;
  A quickstart examples/quickstart.py's query with use_kernel=True
               matches the port's interpreter;
  B n2n TPC-H level 2, domain elimination on, at the SF10 order count:
               jit_program cold, then warm with every launch counter
               zeroed first; the warm wall time and peak memory; the
               result against an independent numpy group-by and against
               a use_kernel=False run; every counter > 0. Then each
               kernel at the arguments of its largest call in the warm
               run: bit-exact against its plain version, and timed with
               CUDA events beside its plain version, one library call
               and the byte bound (segment_sum_first's n, d, k, S and
               runs logged; gather_rows at its largest call of each
               width d, with n, r, d, the share of ids in range and of
               rows whose id follows the previous row's within 8, and
               its time with the ids sorted, which reads the same rows
               in order); a profiled warm run; and four warm
               calls from an emptied allocator cache with the default
               allocator, then four with expandable segments;
  C the same query with domain elimination off (DeDup + general_join)
               at the SF1 order count, with the same checks. SF10 would
               need 240M-row general-join outputs (the reference's 4x
               static-capacity rule).
  D0 decode    one 2^20-row chunk per codec (rle: oparts.label, delta:
               pid, bitpack: qty as int64, dict: qty) of the SF5 data,
               decoded on the card by the storage reader's own
               _decode_device: bit-equal to the NumPy codec; each decode
               kernel timed at that shape beside its plain version, the
               byte bound and one library call where there is one;
               rle_expand also on a constant column (one run of 2^20
               rows), and the device operations of its calls by name
               with their times (two kernels and one memset), and of
               delta_unpack's (one kernel and one memset);
  D stored     the SF5 data written by DatasetWriter.write_parts with
               encoding="auto" and 2^20-row chunks (host time with no
               profiler, bytes and codecs per part), reopened on the
               card, and the query
               served by QueryService.execute_stored with use_kernel:
               cold, then warm with every launch counter zeroed (rle,
               delta and dict decode and the three join kernels launch;
               no plan rebuild); the result against the numpy group-by
               and bit-equal to an in-memory jit_program run; the warm
               split into load_env and the executable; STORAGE_STATS;
               host profiles (cProfile) of a separate write at the SF1
               order count and of one warm load_env; a profiled warm
               call;
  E streamed   execute_stored_streaming with 2^20-row morsels (two over
               the 1.875M customers): the same rows as D in another
               order, its wall time and peak memory beside D's.
  F skew       the paper's skew experiment (Fig. 8, as benchmarks/skew.py
               runs it): the SF5 order count with Zipf-2.0 part keys,
               written once by DatasetWriter in 2^20-row chunks for its
               heavy-key sketches (table_stats), then n2n TPC-H level 2
               over an 8-site virtual mesh through
               compile_program_distributed(use_kernel=True,
               cap_factor=2.0, adaptive=True) under the `auto` (planned
               SkewJoinP) and `always` (sampled heavy keys) plans: cold,
               then warm with every launch counter zeroed; metrics and
               imbalance; the result against the numpy group-by,
               bit-equal to the use_kernel=False run and equal as a bag
               to a single-device jit_program run; a warm heavy-key
               rebind with 0 retraces; segment_sum_first (held as in G)
               and the shuffle kernels at their largest calls
               (pack_rows's r, m, d, slots taken, how many take the row
               after the previous slot's, and its time with the slots
               sorted by source row; member_mask's n, m, the set's keys
               that are not padding, and its time with the set
               shuffled); a device profile. The `off` plan
               (no skew handling) runs at the SF1 order count, with `auto`
               beside it: at SF10 its exchanges would need more than
               the card's 80 GB (the reckoning is in PERF.md, section 6);
  G hypercube  benchmarks/hypercube.py's chain (Lineitem joins Part on
               the skewed pid and Orders on oid, revenue per order date)
               over the same data and 8 sites, under `hypercube` (one
               replicating round) and `cascade`: the same figures as F
               with the replication factor and bytes replicated; the
               use_kernel=False result equal to a float64 numpy group-by,
               the kernel result within n_g * 2^-24 * sum|x| of it (the
               f32 sums of segment_sum_first, whose per-segment row
               counts, summed in lanes of ones, are bit-exact); every
               other kernel bit-exact at its largest captured call
               (replicate_scatter's shape and sorted time as pack_rows's
               in F). G
               alone runs with expandable allocator segments: its
               cascade peaks near the card's 80 GB.
  M serving    over D's stored dataset and data and F's data and mesh,
               with every launch counter zeroed first: B's query with one
               liftable constant (lineitems of qty >= c), 8 bindings in
               one QueryService.execute_many, each bit-equal to its own
               execute, 0 warm plan rebuilds, the batch's time beside 8
               executes; ServingRuntime.submit_many coalescing them, and
               a fresh runtime's warm_replay (all-invalid bags on the
               card) before a request with 0 rebuilds; explain_analyze
               with and without the kernels (equal trees, bit-equal
               outputs) in memory, over D's dataset (bytes read and
               decoded on the scans) and on F's mesh (rows shipped and
               imbalance equal to F's warm auto metrics); the stats
               feedback loop (Q-error at most 4 after one round, the
               measured rows through a copy of D's footer); a
               ServingRuntime over D's dataset and one over F's mesh
               with its single-device twin under arm_chaos_schedule:
               all nine fault classes, no escaped exception, every
               answer bit-equal to the fault-free one, then warm_replay
               and a request with 0 rebuilds; the kernels of these
               paths launched.
  H fig7       the paper's Fig. 7 (repro_torch.figures.tpch_nested's
               points) at the SF1 order count: f2n, n2n and n2f at levels
               1-3, each through the shredded route (jit_program; n2f
               sums its body with sum_by), the standard route
               (run_standard) and, for f2n, the UNSHRED extra, with
               use_kernel=True: cold and warm wall time, peak memory,
               part bytes, launches; each route bit-equal to its
               use_kernel=False run (n2f: equal to a numpy float64
               group-by without kernels, within the f32 bound with them);
               the two routes give the same nested value (a hash of each
               bag, bottom-up), except where the reference's standard
               route drops rows (f2n levels 2-3: reported); a profile of
               the slowest standard-route point. Then n2n level 2's
               standard route beside its shredded route at the SF5 order
               count: at SF10 it needs more than the card's 80 GB;
  I bio        the Fig. 9 pipeline (repro_torch.figures.biomedical's four
               assignments) shredded at 10 samples x 20,000 genes, drawn
               in bulk from gen_biomedical's distributions, with
               use_kernel=True: cold and warm, peak, launches; the
               result within the f32 bound of the use_kernel=False run;
               then the figure driver at gen_biomedical(10, 30) against
               the interpreter. More samples do not fit: every general
               join sizes its output at 4x its larger input, and the
               pipeline chains five of them;
  J repr       App. E.1: row-wise dict aggregation over 2^20 rows against
               the columnar sum_by over 2^26 rows, per row; then
               segment_reduce through its dispatch at (a) 2^26 rows over
               858,994 segments (the reference's 20,000 rows per 256
               groups, scaled) and (b) SF10's 60,013,298 lineitems by
               their 7,500,000 parts, d = 1 and 4: every launch counter
               zeroed first, the kernels of one call at (a) profiled (at
               most two: the tile and carry passes); bit-exact against
               the plain version on integer values, within 2 n_s 2^-24
               sum|x| of a float64 sum on random ones with two launches
               bit-identical; timed beside torch.segment_reduce given the
               run lengths (events and device time);
  K rwkv6-7b   RWKV-6 7B at full width and depth (32 layers) in bf16
               with seeded random weights: prefill of 4 x 4096 tokens
               cold, then warm with every launch counter zeroed (rwkv6
               32 launches, by path all on the tensor cores,
               flash_attention none), peak memory; the
               logits against the same prefill with the plain versions
               swapped in (LOGIT_BOUND), and as controls the logits
               with two faults put into the kernel's calls; rwkv6 at
               its captured arguments (within its rounding bound, timed
               beside its plain version and its bound: the bytes, the
               chunked form's products on the tensor cores and its logs
               and powers of 2 on the SFU, with the earlier bound, the
               recurrence's own f32 work, beside it);
               a profiled warm
               prefill; ServeEngine for 4 requests (prompts 16-64, 16
               new) in bf16 (decode tokens/s, peak, a profiled decode
               step) and in float32 at 2 layers (its tokens equal to
               greedy decoding by repeated prefill, which runs the
               kernel; that prefill's logits within F32_LOGIT_BOUND of
               the plain-swapped one's). Serving itself runs no kernel:
               the engine decodes step by step in PyTorch;
  L gemma2-27b the same for Gemma-2 27B (46 layers) at 1 x 8192 tokens,
               so that the 4096 window masks: flash_attention 46
               launches, all on its tensor-core path, a record for a
               local and a global layer (bounds by the tensor cores'
               products and by the SFU's exponentials), with
               scaled_dot_product_attention without the softcap timed
               as a yardstick.

The last three lines: nvidia-smi's name and power limit, the per-kernel
JSON records (phase B's join kernels, gather_rows at each width; D0's
decode kernels with D's launch counts, bitunpack's from D0 since no
column of this data picks bitpack, rle_expand also at one run; F's
segment_sum_first, member_mask, pack_rows and unpack_cols;
G's replicate_scatter; J's segment_reduce at (a) and at (b) with d = 4;
K's rwkv6; L's flash_attention at a local and a global layer; each with
the library call's device time where there is one, and with its path
where it has one), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SFU_PER_S = 16 * 132 * 1.83e9  # H100 SXM transcendentals per second: 16
#   a clock per SM (CUDA C++ Programming Guide, arithmetic instructions,
#   compute capability 9.0) at the 1.83 GHz of the 989 TFLOP/s bf16 peak
SCALE_B = 15_000_000           # orders in phase B: TPC-H SF10
SCALE_C = 1_500_000            # orders in phase C: TPC-H SF1
SCALE_D = 7_500_000            # orders in phases D and E: TPC-H SF5
SCALE_F = 7_500_000            # orders in phases F and G: TPC-H SF5
#                                (cut from SF10: their host-paced writes
#                                took most of a run's time; PERF.md, sec. 4)
SCALE_F_OFF = 1_500_000        # orders of F's `off` plan: TPC-H SF1
SCALE_H = 1_500_000            # orders of phase H's Fig. 7 grid: TPC-H SF1
SCALE_H_STD = 7_500_000        # orders of H's n2n L2 standard route: SF5
#                                (SF10 needs about 134 GiB: PERF.md, section 4)
BIO_SAMPLES = 10               # phase I: cut from 1,000 (PERF.md, section 4)
BIO_GENES = 20_000             # phase I: about the human protein-coding genes
ZIPF = 2.0                     # Zipf exponent of Lineitem.pid in F and G
SITES = 8                      # sites of the virtual mesh in F and G
CHUNK_ROWS = 1 << 20           # rows per stored chunk (and per morsel):
#                                Apache Arrow's default Parquet row group
I64_MAX = np.iinfo(np.int64).max
PAYLOAD_BITS = np.array([-0.0, np.nan, 1.5]).view(np.int64).tolist() \
    + [0x7FF8_0000_0000_0ABC]      # -0.0, NaN, 1.5 and a NaN payload

KERNELS = {
    "segment_reduce": dict(
        source="src/repro_torch/kernels/csrc/segment_reduce.cu",
        replaces="src/repro/kernels/segment_reduce.py:52"),
    "segment_sum_first": dict(
        source="src/repro_torch/kernels/csrc/segment_fused.cu",
        replaces="src/repro/kernels/segment_fused.py:71"),
    "merge_positions": dict(
        source="src/repro_torch/kernels/csrc/gather_join.cu",
        replaces="src/repro/kernels/gather_join.py:61"),
    "gather_rows": dict(
        source="src/repro_torch/kernels/csrc/gather_join.cu",
        replaces="src/repro/kernels/gather_join.py:114"),
    "rle_expand": dict(
        source="src/repro_torch/kernels/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:65"),
    "delta_unpack": dict(
        source="src/repro_torch/kernels/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:117"),
    "bitunpack": dict(
        source="src/repro_torch/kernels/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:159"),
    "dict_gather": dict(
        source="src/repro_torch/kernels/csrc/decode.cu",
        replaces="src/repro/kernels/decode.py:199"),
    "member_mask": dict(
        source="src/repro_torch/kernels/csrc/shuffle_pack.cu",
        replaces="src/repro/kernels/shuffle_pack.py:172"),
    "pack_rows": dict(
        source="src/repro_torch/kernels/csrc/shuffle_pack.cu",
        replaces="src/repro/kernels/shuffle_pack.py:65"),
    "unpack_cols": dict(
        source="src/repro_torch/kernels/csrc/shuffle_pack.cu",
        replaces="src/repro/kernels/shuffle_pack.py:203"),
    "replicate_scatter": dict(
        source="src/repro_torch/kernels/csrc/shuffle_pack.cu",
        replaces="src/repro/kernels/shuffle_pack.py:124"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:78"),
    "rwkv6": dict(
        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:77"),
}
JOIN_KERNELS = ("segment_sum_first", "merge_positions", "gather_rows")
DECODE_KERNELS = ("rle_expand", "delta_unpack", "bitunpack", "dict_gather")
SHUFFLE_KERNELS = ("member_mask", "pack_rows", "unpack_cols",
                   "replicate_scatter")
# the kernels whose edge cases phase 2 also launches twice
REPEATED = ("segment_sum_first", "merge_positions", "gather_rows",
            "rle_expand", "delta_unpack", "member_mask", "pack_rows",
            "replicate_scatter")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# queries (built with the port's own NRC)
# ---------------------------------------------------------------------------

def tpch_types():
    from repro_torch.core import nrc as N
    part_t = N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL))
    ncop2_t = N.bag(N.tuple_t(
        cname=N.INT,
        corders=N.bag(N.tuple_t(
            odate=N.INT,
            oparts=N.bag(N.tuple_t(pid=N.INT, qty=N.REAL))))))
    return part_t, ncop2_t


def nested_to_nested_query(levels: int, input_name: str, input_ty):
    """Join Part at the lowest level + sumBy (Example 1 generalized):
    ``repro_torch.figures.common``'s builder."""
    from repro_torch.figures.common import nested_to_nested_query as build
    return build(levels, input_name, input_ty)


# ---------------------------------------------------------------------------
# data: gen_tpch's distributions (skew 0), vectorised, shredded directly
# ---------------------------------------------------------------------------

def zipf_pids(rng, n: int, skew: float, size: int) -> np.ndarray:
    """Part keys in [1, n] with ``repro.data.generators.zipf_choice``'s
    law (P(k) proportional to k^-skew; uniform at skew 0), drawn in one
    vectorised call."""
    if skew <= 0:
        return rng.randint(1, n + 1, size)
    probs = np.arange(1, n + 1, dtype=np.float64) ** (-skew)
    probs /= probs.sum()
    return rng.choice(np.arange(1, n + 1), size=size, p=probs)


def gen_tpch_columns(scale: int, seed: int, skew: float = 0.0) -> dict:
    """Flat TPC-H-like tables as numpy columns, with the distributions
    of ``repro.data.generators.gen_tpch(scale, skew)``: ``scale`` orders
    of 1-7 lineitems each, scale/2 parts (lineitem part keys Zipf-skewed
    by ``skew``), scale/4 customers."""
    rng = np.random.RandomState(seed)
    n_parts = max(scale // 2, 8)
    n_orders = scale
    n_cust = max(scale // 4, 4)
    price = rng.randint(1, 100, n_parts).astype(np.float64)
    per_order = rng.randint(1, 8, n_orders)
    n_items = int(per_order.sum())
    li_pid = zipf_pids(rng, n_parts, skew, n_items).astype(np.int64)
    return {
        "part_pid": np.arange(1, n_parts + 1, dtype=np.int64),
        "part_pname": 10000 + np.arange(1, n_parts + 1, dtype=np.int64),
        "part_price": price,
        "li_oid": np.repeat(np.arange(1, n_orders + 1, dtype=np.int64),
                            per_order),
        "li_pid": li_pid,
        "li_qty": rng.randint(1, 50, n_items).astype(np.float64),
        "ord_cid": rng.randint(1, n_cust + 1, n_orders).astype(np.int64),
        "ord_odate": 20200000 + rng.randint(1, 365, n_orders).astype(
            np.int64),
        "cust_cname": 20000 + np.arange(1, n_cust + 1, dtype=np.int64),
    }


def shred_ncop2(t: dict) -> dict:
    """The shredded parts of the level-2 nested input (customers ->
    orders -> lineitems) and Part__F, as ``{name: (columns, valid)}``.
    Labels are row counters per dictionary, as ``interpreter.shred_value``
    assigns them: customer i's corders label is i, the k-th corders row
    (customers in order, each customer's orders by oid) has oparts
    label k."""
    n_cust = t["cust_cname"].shape[0]
    n_orders = t["ord_cid"].shape[0]
    perm = np.argsort(t["ord_cid"], kind="stable")    # corders row order
    per_order = np.bincount(t["li_oid"] - 1, minlength=n_orders)
    li_start = np.concatenate([[0], np.cumsum(per_order)[:-1]])
    cnt = per_order[perm]
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    rows = np.repeat(li_start[perm] - first, cnt) + np.arange(cnt.sum())

    def ones(n):
        return np.ones(n, dtype=np.bool_)

    return {
        "NCOP2__F": ({"cname": t["cust_cname"],
                      "corders": np.arange(n_cust, dtype=np.int64)},
                     ones(n_cust)),
        "NCOP2__D_corders": ({"odate": t["ord_odate"][perm],
                              "oparts": np.arange(n_orders, dtype=np.int64),
                              "label": t["ord_cid"][perm] - 1},
                             ones(n_orders)),
        "NCOP2__D_corders_oparts": (
            {"pid": t["li_pid"][rows], "qty": t["li_qty"][rows],
             "label": np.repeat(np.arange(n_orders, dtype=np.int64), cnt)},
            ones(rows.shape[0])),
        "Part__F": ({"pid": t["part_pid"], "pname": t["part_pname"],
                     "price": t["part_price"]}, ones(t["part_pid"].shape[0])),
    }


def numpy_oparts_groupby(env_np: dict):
    """Independent reference for Q__D_corders_oparts: (order label,
    pname) -> sum of qty * price, as arrays sorted by (label, pname)."""
    li, _ = env_np["NCOP2__D_corders_oparts"]
    part, _ = env_np["Part__F"]
    pos = li["pid"] - 1                  # Part__F pid is 1..n_parts
    pname = part["pname"][pos]
    total = li["qty"] * part["price"][pos]
    m = int(pname.max()) + 1
    uniq, inv = np.unique(li["label"] * m + pname, return_inverse=True)
    return uniq // m, uniq % m, np.bincount(inv, weights=total)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def bags_bit_equal(a, b, what: str) -> None:
    """Same capacity and dtypes, valid equal everywhere, data equal at
    valid rows (values at invalid rows are unspecified)."""
    assert a.capacity == b.capacity, (what, a.capacity, b.capacity)
    assert set(a.data) == set(b.data), (what, a.columns, b.columns)
    assert torch.equal(a.valid, b.valid), (what, "valid")
    for c in a.data:
        x, y = a.data[c], b.data[c]
        assert x.dtype == y.dtype, (what, c, x.dtype, y.dtype)
        assert torch.equal(x[a.valid], y[a.valid]), (what, c)


def sorted_rows(bag) -> torch.Tensor:
    """The valid rows of a bag as a (rows, columns) int64 tensor of bit
    patterns (columns in name order), sorted lexicographically on the
    bag's device: equal for two bags that hold the same rows in any
    order."""
    v = bag.valid
    cols = [bag.data[c][v] for c in sorted(bag.data)]
    cols = [c.view(torch.int64) if c.dtype == torch.float64
            else c.to(torch.int64) for c in cols]
    order = torch.arange(int(v.sum()), device=v.device)
    for c in reversed(cols):          # stable sorts, last key first
        order = order[torch.sort(c[order], stable=True).indices]
    return torch.stack([c[order] for c in cols], 1)


def check_oparts(out_bag, env_np, want=None) -> int:
    """The output's valid rows equal the numpy group-by (``want``, when
    the caller computed it already)."""
    want_label, want_pname, want_total = want if want is not None \
        else numpy_oparts_groupby(env_np)
    v = out_bag.valid.cpu().numpy()
    label = out_bag.data["label"].cpu().numpy()[v]
    pname = out_bag.data["pname"].cpu().numpy()[v]
    total = out_bag.data["total"].cpu().numpy()[v]
    order = np.lexsort((pname, label))
    assert label.shape == want_label.shape, (label.shape, want_label.shape)
    assert np.array_equal(label[order], want_label)
    assert np.array_equal(pname[order], want_pname)
    assert np.array_equal(total[order], want_total)
    return int(label.shape[0])


# ---------------------------------------------------------------------------
# kernels: comparison, timing, bounds
# ---------------------------------------------------------------------------

class CaptureLargestCalls:
    """While active, keeps the arguments of each kernel dispatch's
    largest call (by element count), to compare and time the kernels at
    the shapes the main path gives them; for ``gather_rows`` also the
    largest call of each width d (``by_width``: {d: arguments})."""

    def __init__(self, names=JOIN_KERNELS):
        self.names = names

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        self.kops, self.args, self._size = kops, {}, {}
        self.by_width, self._width_size = {}, {}
        self._orig = {n: getattr(kops, n) for n in self.names}
        for n in self.names:
            setattr(kops, n, self._wrap(n, self._orig[n]))
        return self

    def _wrap(self, name, fn):
        def recorder(*args, **kw):
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            if size > self._size.get(name, -1):
                self._size[name], self.args[name] = size, args
            if name == "gather_rows":
                d = args[0].shape[1]
                if size > self._width_size.get(d, -1):
                    self._width_size[d], self.by_width[d] = size, args
            return fn(*args, **kw)
        return recorder

    def __exit__(self, *exc):
        for n, f in self._orig.items():
            setattr(self.kops, n, f)


def kernel_fns(name: str, args: tuple):
    """(kernel, plain version, library call or None, bound bytes) for
    one kernel at the given dispatch arguments."""
    from repro_torch.kernels import gather_join as G
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import segment_fused as SF
    if name == "segment_sum_first":
        vals, keys, seg, S = args
        vals = vals.to(torch.float32).contiguous()
        keys, seg = keys.contiguous(), seg.to(torch.int32).contiguous()
        n, d, k = vals.shape[0], vals.shape[1], keys.shape[1]
        # What this data needs: every id, the values of rows whose id is
        # in [0, S), the keys of each non-empty segment's first row, and
        # every output.
        inr = seg[(seg >= 0) & (seg < S)]
        groups = torch.unique_consecutive(inr).numel()
        nbytes = (4 * n + 4 * d * inr.numel() + 8 * k * groups
                  + S * (4 * d + 4 + 8 * k))
        return (lambda: SF.segment_sum_first_cuda(vals, keys, seg, S),
                lambda: R.segment_sum_first_ref(vals, keys, seg, S),
                None, nbytes)
    if name == "merge_positions":
        sk, q = (a.to(torch.int64).contiguous() for a in args)
        r, n = sk.shape[0], q.shape[0]
        return (lambda: G.merge_positions_cuda(sk, q),
                lambda: R.merge_positions_ref(sk, q),
                lambda: (torch.searchsorted(sk, q, side="left"),
                         torch.searchsorted(sk, q, side="right")),
                8 * r + 8 * n + 8 * n)
    if name == "segment_reduce":
        return reduce_fns(args)
    if name in DECODE_KERNELS:
        return decode_fns(name, args)
    if name in SHUFFLE_KERNELS:
        return shuffle_fns(name, args)
    assert name == "gather_rows", name
    vals = args[0].contiguous()
    idx = args[1].to(torch.int64).contiguous()
    n, d = idx.shape[0], vals.shape[1]
    r = vals.shape[0]

    def library():
        ok = (idx >= 0) & (idx < r)
        return torch.where(ok[:, None], vals[idx.clamp(0, r - 1)], 0)

    return (lambda: G.gather_rows_cuda(vals, idx),
            lambda: R.gather_rows_ref(vals, idx), library,
            8 * n + 16 * n * d)


def reduce_fns(args: tuple):
    """``kernel_fns`` for segment_reduce. The byte bound counts what the
    data needs: every id, the values of the rows whose id is in [0, S),
    every output. The library call, ``torch.segment_reduce`` over the
    run lengths (counted outside the timed call), exists where every id
    is in range."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import segment_reduce as SR
    vals, seg, S = args
    vals = vals.to(torch.float32).contiguous()
    seg = seg.to(torch.int32).contiguous()
    n, d = vals.shape
    ok = (seg >= 0) & (seg < S)
    in_range = int(ok.sum())
    library = None
    if in_range == n and n and bool((seg[1:] >= seg[:-1]).all()):
        lengths = torch.bincount(seg.to(torch.int64), minlength=S)
        library = lambda: torch.segment_reduce(  # noqa: E731
            vals, "sum", lengths=lengths, axis=0, unsafe=True)
    return (lambda: SR.segment_reduce_cuda(vals, seg, S),
            lambda: R.segment_reduce_ref(vals, seg, S), library,
            4 * n + 4 * d * in_range + 4 * d * S)


def decode_fns(name: str, args: tuple):
    """``kernel_fns`` for the decode kernels. The byte bound counts each
    member once at its stored width and the int64 output once."""
    from repro_torch.kernels import decode as D
    from repro_torch.kernels import ref as R
    if name == "rle_expand":
        values, lengths, n = args[:3]
        out = args[3] if len(args) > 3 else None
        r = values.shape[0]
        library = (lambda: torch.repeat_interleave(values, lengths,
                                                   output_size=n)) \
            if r else None
        return (lambda: D.rle_expand_cuda(values, lengths, n, out=out),
                lambda: R.rle_expand_ref(values, lengths, n),
                library, 8 * r + lengths.element_size() * r + 8 * n)
    if name == "delta_unpack":
        z, first = args[:2]
        out = args[2] if len(args) > 2 else None
        n = z.shape[0]
        return (lambda: D.delta_unpack_cuda(z, first, out=out),
                lambda: R.delta_unpack_ref(z, first), None,
                z.element_size() * n + 8 * n)
    if name == "bitunpack":
        words, k, vpw, n, lo = args
        return (lambda: D.bitunpack_cuda(words, k, vpw, n, lo),
                lambda: R.bitunpack_ref(words, k, vpw, n, lo), None,
                4 * words.shape[0] + 8 * n)
    assert name == "dict_gather", name
    values, codes = args
    r, n = values.shape[0], codes.shape[0]
    idx = codes.to(torch.int64)
    in_range = bool(((idx >= 0) & (idx < r)).all())
    library = (lambda: values[idx]) if in_range and r else None
    return (lambda: D.dict_gather_cuda(values, codes),
            lambda: R.dict_gather_ref(values, codes), library,
            8 * r + codes.element_size() * n + 8 * n)


def shuffle_fns(name: str, args: tuple):
    """``kernel_fns`` for the packed-shuffle kernels. The byte bound
    counts what the data needs: every index and flag, the lanes of the
    rows a slot really takes, every output lane; the heavy set once."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import shuffle_pack as S
    if name == "unpack_cols":
        buf = args[0].contiguous()
        m, d = buf.shape
        return (lambda: S.unpack_cols_cuda(buf),
                lambda: R.unpack_cols_ref(buf),
                lambda: buf.t().contiguous(), 16 * m * d)
    if name == "member_mask":
        keys = args[0].to(torch.int64).contiguous()
        heavy = args[1].to(torch.int64).contiguous()
        n, m = keys.shape[0], heavy.shape[0]
        return (lambda: S.member_mask_cuda(keys, heavy),
                lambda: R.member_mask_ref(keys, heavy),
                lambda: torch.isin(keys, heavy) & (keys != I64_MAX),
                8 * n + 8 * m + n)
    values, idx, ok = (a.contiguous() for a in args[:3])
    repl = int(args[3]) if name == "replicate_scatter" else 1
    r, d = values.shape
    m = idx.shape[0]
    v = idx.to(torch.int64)
    src = v // repl
    good = ok.to(torch.bool) & (v >= 0) & (src < r)
    taken = int(good.sum())
    nbytes = (idx.element_size() + ok.element_size()) * m \
        + 8 * d * taken + 8 * d * m

    def library():
        s = idx.to(torch.int64) // repl
        g = ok.to(torch.bool) & (s >= 0) & (s < r)
        return torch.where(g[:, None], values[s.clamp(0, r - 1)], 0)

    if name == "pack_rows":
        return (lambda: S.pack_rows_cuda(values, idx, ok),
                lambda: R.pack_rows_ref(values, idx, ok), library, nbytes)
    assert name == "replicate_scatter", name
    return (lambda: S.replicate_scatter_cuda(values, idx, ok, repl),
            lambda: R.replicate_scatter_ref(values, idx, ok, repl), library,
            nbytes)


def pack_call(name: str, args: tuple):
    """The shape of a pack_rows or replicate_scatter call: r, m, d, the
    slots that take a row, the share of those whose source row is the
    previous slot's plus 1 to 8, and whether a load moves two lanes (d
    even, 16-byte aligned bases); and the same call with its (idx, ok)
    pairs sorted by source row, checked bit-exact. It takes the same
    rows, so the bytes are the same: what it saves is what the
    scattered rows cost."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import shuffle_pack as S
    values, idx, ok = (a.contiguous() for a in args[:3])
    repl = int(args[3]) if name == "replicate_scatter" else 1
    r, d = values.shape
    v = idx.to(torch.int64)
    src = v // repl
    good = ok.to(torch.bool) & (v >= 0) & (src < r)
    taken = int(good.sum())
    step = src[1:] - src[:-1]
    near = int((good[1:] & good[:-1] & (step >= 1) & (step <= 8)).sum())
    pair = d % 2 == 0 and values.data_ptr() % 16 == 0
    order = torch.argsort(torch.where(good, src, I64_MAX), stable=True)
    s_idx, s_ok = idx[order].contiguous(), ok[order].contiguous()
    del v, src, good, step, order
    if name == "pack_rows":
        kern = lambda: S.pack_rows_cuda(values, s_idx, s_ok)  # noqa: E731
        want = R.pack_rows_ref(values, s_idx, s_ok)
    else:
        kern = lambda: S.replicate_scatter_cuda(  # noqa: E731
            values, s_idx, s_ok, repl)
        want = R.replicate_scatter_ref(values, s_idx, s_ok, repl)
    err = max_abs_err(kern(), want)
    torch.cuda.synchronize()
    assert err == 0.0, f"{name} with sorted slots: max |err| {err}"
    at = f", repl={repl}" if name == "replicate_scatter" else ""
    shape = (f"r={r}, m={idx.shape[0]}, d={d}{at}, "
             f"{taken} slots take a row, {near / max(taken, 1):.1%} of "
             f"them the previous slot's row + 1 to 8, "
             f"{'two lanes' if pair else 'one lane'} a load")
    return shape, kern


def gather_call(args: tuple):
    """The shape of a gather_rows call: n, r, d, the share of ids in
    range, the share of rows whose id is the previous row's plus 0 to 8,
    and whether a load moves two lanes (d even, 16-byte aligned bases);
    and the same call with idx sorted, checked bit-exact. It reads the
    same rows, so the bytes are the same: what it saves is what the
    random reads cost."""
    from repro_torch.kernels import gather_join as G
    from repro_torch.kernels import ref as R
    vals = args[0].contiguous()
    idx = args[1].to(torch.int64).contiguous()
    (r, d), n = vals.shape, idx.shape[0]
    inr = int(((idx >= 0) & (idx < r)).sum())
    step = idx[1:] - idx[:-1]
    near = int(((step >= 0) & (step <= 8)).sum())
    pair = d % 2 == 0 and vals.data_ptr() % 16 == 0
    s_idx = torch.sort(idx).values
    del step
    kern = lambda: G.gather_rows_cuda(vals, s_idx)  # noqa: E731
    err = max_abs_err(kern(), R.gather_rows_ref(vals, s_idx))
    torch.cuda.synchronize()
    assert err == 0.0, f"gather_rows with idx sorted: max |err| {err}"
    shape = (f"n={n}, r={r}, d={d}, {inr / max(n, 1):.1%} of ids in "
             f"range, {near / max(n - 1, 1):.1%} of rows the previous "
             f"row's id + 0 to 8, {'two lanes' if pair else 'one lane'} "
             f"a load")
    return shape, kern


def member_call(args: tuple):
    """The shape of a member_mask call: n, m, the set's keys that are not
    padding, whether the set is sorted, whether the keys start on a
    16-byte boundary and the share of keys in the set; the same keys
    against m distinct keys of the call, one in each m-th of its sorted
    distinct keys, as the set (a search of log2 m steps rounded up,
    where the planned set may hold fewer keys and take fewer), checked
    bit-exact and timed; and the call with its set shuffled, checked
    bit-exact. The kernel sorts its own copy of the set, so the
    shuffled call does the same work."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import shuffle_pack as S
    keys = args[0].to(torch.int64).contiguous()
    heavy = args[1].to(torch.int64).contiguous()
    n, m = keys.shape[0], heavy.shape[0]
    real = int((heavy != I64_MAX).sum())
    ordered = bool((heavy[1:] >= heavy[:-1]).all())
    hits = int(R.member_mask_ref(keys, heavy).sum())
    distinct = torch.unique(keys[keys != I64_MAX])
    full = distinct[torch.linspace(0, distinct.numel() - 1, m).long()
                    .to(distinct.device)].unique()
    wide = lambda: S.member_mask_cuda(keys, full)  # noqa: E731
    err = max_abs_err(wide(), R.member_mask_ref(keys, full))
    (wide_dev,), _ = device_ms([wide], [20])
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(0))
    shuffled = heavy[perm.to(heavy.device)].contiguous()
    kern = lambda: S.member_mask_cuda(keys, shuffled)  # noqa: E731
    err = max(err, max_abs_err(kern(), R.member_mask_ref(keys, heavy)))
    torch.cuda.synchronize()
    assert err == 0.0, f"member_mask at the call's keys: max |err| {err}"
    steps = max(full.numel() - 1, 0).bit_length()
    shape = (f"n={n}, m={m}, {real} keys not padding, the set "
             f"{'sorted' if ordered else 'unsorted'}, keys "
             f"{'on' if keys.data_ptr() % 16 == 0 else 'off'} a 16-byte "
             f"boundary, {hits / max(n, 1):.1%} of keys in the set; with "
             f"{full.numel()} distinct keys of the call as the set "
             f"({steps} search steps): bit-exact, {time_ms(wide):.4f} ms "
             f"({_ms(wide_dev)} on the device)")
    return shape, kern


def max_abs_err(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, \
            (g.shape, w.shape, g.dtype, w.dtype)
        if not torch.equal(g, w):
            err = max(err, float((g.double() - w.double()).abs().max()))
    return err


def time_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator grows its segments in place (rather than
    strand reserved memory between fixed segments) while active; the
    cache is emptied on entry and on exit, so that each setting starts
    from no reserved memory."""
    def setting(on: bool) -> None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.cuda.memory._set_allocator_settings(
                f"expandable_segments:{on}")
    setting(True)
    try:
        yield
    finally:
        setting(False)


def warm_calls_ms(run, calls: int = 4) -> list:
    """Wall times of ``calls`` calls in a row, each to a synchronize,
    from an emptied allocator cache."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        out.append(round((time.perf_counter() - t0) * 1e3, 1))
    return out


def profiled(run, iters: int = 1, pad_s: float = 0.0):
    """``run()`` ``iters`` times under ``torch.profiler`` (host and
    device activity), with ``pad_s`` seconds of idle time on either side
    of the calls. Returns (the device records, complete): complete when
    there is a kernel record for every kernel launch the host recorded,
    and each kernel's records come ``iters`` times over."""
    from collections import Counter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        time.sleep(pad_s)
    events = prof.events()
    launched = sum(e.device_type == DeviceType.CPU
                   and e.name.startswith(("cudaLaunch", "cuLaunch"))
                   for e in events)
    records = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = Counter(e.name for e in records
                      if not e.name.startswith(("Memcpy", "Memset")))
    complete = (bool(records) and sum(kernels.values()) >= launched
                and all(c % iters == 0 for c in kernels.values()))
    return records, complete


def complete_profile(run, iters: int = 1, tries: int = 4):
    """(device records, complete, sessions) of the first complete
    ``profiled`` session, else of the last of ``tries``. A session of
    the profiler can lose device records, more of them the longer the
    process has run (PERF.md, section 6); an incomplete one is repeated
    with 1 s, 2 s, then 3 s of idle time on either side of the calls."""
    for attempt in range(tries):
        records, complete = profiled(run, iters, pad_s=float(attempt))
        if complete:
            break
    return records, complete, attempt + 1


def device_ms(fns: list, iters: list, tries: int = 4):
    """Device time per call of each function of ``fns`` (None where a
    function is None): the time of every kernel and copy that it puts on
    the card, summed by ``torch.profiler`` over its ``iters`` calls. All
    of them run in one session, so that an incomplete session is
    repeated once for all (with idle time around it, as
    ``complete_profile`` does); a spin kernel (``torch.cuda._sleep``)
    after each function's calls splits the device records, in their
    order on the card, between the functions, and a session counts as
    complete only where each function has kernel records and each of its
    kernels comes its ``iters`` times over (the host records no launch of
    the ctypes-bound kernels, so that is what shows a lost record of
    theirs; a function whose records are all lost leaves an empty part). Unlike CUDA events
    around back-to-back calls, it leaves out the host's time between
    launches, which sets the pace of calls that take a few microseconds
    on the card. Returns (the times, or None each (not measured) when no
    session of the profiler was complete; sessions)."""
    from collections import Counter
    live = [(f, n) for f, n in zip(fns, iters) if f is not None]
    for f, _ in live:
        f()
    torch.cuda.synchronize()

    def run():
        for f, n in live:
            for _ in range(n):
                f()
            torch.cuda._sleep(1000)

    for attempt in range(tries):
        records, complete = profiled(run, pad_s=float(attempt))
        parts, us, names = [], 0.0, Counter()
        for e in sorted(records, key=lambda e: e.time_range.start):
            if "spin_kernel" in e.name:
                parts.append((us, names))
                us, names = 0.0, Counter()
            else:
                us += e.time_range.elapsed_us()
                if not e.name.startswith(("Memcpy", "Memset")):
                    names[e.name] += 1
        if complete and len(parts) == len(live) and all(
                us > 0 and cnt and all(c % n == 0 for c in cnt.values())
                for (us, cnt), (_, n) in zip(parts, live)):
            ms = iter(us / n / 1e3 for (us, _), (_, n) in zip(parts, live))
            return [None if f is None else next(ms) for f in fns], attempt + 1
    return [None] * len(fns), tries


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f}"


def sums_within_f32_bound(got: tuple, want: tuple, args: tuple) -> None:
    """``segment_sum_first``'s outputs where its f32 sums pass 2^24:
    first rows and their keys equal, and each segment's sum within
    2 * n_s * 2^-24 * sum |x| of the plain version's (two f32 sums of
    the same terms in different orders; the plain version's
    ``index_add_`` adds with float atomics, in no fixed order). That
    bound is loose enough to hide a row lost or doubled in a segment,
    so the kernel also sums ones at the same segment ids, row i in lane
    i % L, with L lanes so that no lane of a segment counts 2^24 rows
    (a segment here may hold the rows of no group, tens of millions):
    every partial sum is then an exact integer, and the counts must be
    bit-equal to the plain version's and to ``bincount``."""
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import segment_fused as SF
    vals, keys, seg, S = args
    keys, seg = keys.contiguous(), seg.to(torch.int32).contiguous()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    ok = (seg >= 0) & (seg < S)
    ids = seg[ok].to(torch.int64)
    n_s = torch.bincount(ids, minlength=S)
    lanes = max(1, -(-int(n_s.max()) // 2 ** 23))
    row = torch.arange(seg.shape[0], device=seg.device)
    ones = torch.zeros((seg.shape[0], lanes), dtype=torch.float32,
                       device=seg.device)
    ones[row, row % lanes] = 1.0
    counts = SF.segment_sum_first_cuda(ones, keys, seg, S)[0]
    torch.cuda.synchronize()
    assert max_abs_err(counts, R.segment_sum_first_ref(ones, keys, seg,
                                                       S)[0]) == 0.0
    want_counts = torch.bincount(ids * lanes + row[ok] % lanes,
                                 minlength=S * lanes).view(S, lanes)
    assert int(want_counts.max()) < 2 ** 24, int(want_counts.max())
    assert torch.equal(counts, want_counts.to(torch.float32)), \
        "segment_sum_first lost or doubled rows of a segment"
    del ones, row, counts, want_counts
    v = vals[ok].double().abs()
    abs_sum = torch.zeros((S, v.shape[1]), dtype=torch.float64,
                          device=v.device).index_add_(0, ids, v)
    n_s = n_s.double()[:, None]
    bound = 2 * n_s * 2.0 ** -24 * abs_sum
    err = (got[0].double() - want[0].double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


def segment_runs(args: tuple) -> str:
    """n, d, k and S of a segment_sum_first call, its longest run of
    rows of one in-range id, and how many runs are longer than 64 rows
    (the old kernel summed those one block each)."""
    vals, keys, seg, S = args
    inr = seg[(seg >= 0) & (seg < S)]
    counts = torch.unique_consecutive(inr, return_counts=True)[1]
    longest = int(counts.max()) if counts.numel() else 0
    return (f"n={seg.numel()}, d={vals.shape[1]}, k={keys.shape[1]}, "
            f"S={S}, {counts.numel()} runs, the longest {longest} rows, "
            f"{int((counts > 64).sum())} longer than 64 rows")


def measure_kernels(captured: dict, launches: dict, tag: str,
                    f32_sums: bool = False) -> list:
    """Bit-exact comparison and CUDA-event timings at the captured
    arguments ({kernel name: dispatch arguments}); one record per
    kernel. ``f32_sums``: segment sums may pass 2^24 (phase G), so
    ``segment_sum_first`` is held to ``sums_within_f32_bound`` where it
    is not bit-exact."""
    recs = []
    for name in [n for n in KERNELS if n in captured]:
        meta, args = KERNELS[name], captured[name]
        kern, plain, library, nbytes = kernel_fns(name, args)
        got, want = kern(), plain()
        err = max_abs_err(got, want)
        torch.cuda.synchronize()
        if err and f32_sums and name == "segment_sum_first":
            sums_within_f32_bound(got, want, args)
            log(f"  [{tag}] {name}: sums within the f32 bound of the "
                f"plain version's (max |err| {err}); first rows, keys and "
                f"the per-segment counts of rows equal")
        else:
            assert err == 0.0, f"{name}: kernel disagrees with its plain " \
                               f"version at {tag}'s shapes (max |err| " \
                               f"{err})"
        del got, want
        # the same call with its inputs reordered: (shape, call, what it
        # changed, the record's key for its times)
        shape = other = None
        if name in ("pack_rows", "replicate_scatter"):
            shape, other = pack_call(name, args)
            what, key = "(idx, ok) sorted by source row (the same rows)", \
                "sorted"
        elif name == "gather_rows":
            shape, other = gather_call(args)
            what, key = "idx sorted (the same rows)", "sorted"
        elif name == "member_mask":
            shape, other = member_call(args)
            what, key = "the set shuffled (the same keys)", "shuffled"
        (dev, plain_dev, lib_dev, other_dev), dev_s = device_ms(
            [kern, plain, library, other], [20, 20, 20, 20])
        rec = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=launches[name],
                   max_abs_err=err, ms=time_ms(kern),
                   plain_ms=time_ms(plain), device_ms=dev,
                   plain_device_ms=plain_dev,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes",
                   library_ms=time_ms(library) if library else None,
                   library_device_ms=lib_dev)
        shapes = [tuple(a.shape) if torch.is_tensor(a) else a
                  for a in args]
        if name == "segment_sum_first":
            rec["shape"] = segment_runs(args)
            log(f"  [{tag}] segment_sum_first's call: {rec['shape']}")
        if other is not None:
            rec.update({"shape": shape, f"{key}_ms": time_ms(other),
                        f"{key}_device_ms": other_dev})
            log(f"  [{tag}] {name}'s call: {shape}; with {what}: "
                f"bit-exact, {rec[f'{key}_ms']:.4f} ms ({_ms(other_dev)} "
                f"on the device)")
        log(f"  [{tag}] {name} at {shapes}: "
            f"{'bit-exact' if err == 0 else 'within bound'}; kernel "
            f"{rec['ms']:.4f} ms ({_ms(dev)} on the device, profile session "
            f"{dev_s}), plain {rec['plain_ms']:.4f} ms ({_ms(plain_dev)} on "
            f"the device), library "
            f"{rec['library_ms'] if library else 'n/a'} ms ("
            f"{_ms(lib_dev) if library else 'n/a'} on the device), bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.1%} "
            f"of bound), {rec['launches']} launches in the run")
        recs.append(rec)
    return recs


def profile_run(run, tag: str, top: int = 10) -> None:
    """One more warm run under ``torch.profiler``: the wall time, the
    device's busy and idle share, and the kernels that took the most
    device time (where the time goes), from a complete profile where
    one of three sessions gives one (``complete_profile``)."""
    wall = []

    def timed():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)

    records, complete, sessions = complete_profile(timed)
    wall_ms = wall[-1]
    by_name: dict = {}
    for e in records:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    state = "complete" if complete else "INCOMPLETE: device records lost"
    log(f"[{tag}] profiled warm run (session {sessions}, {state}): wall "
        f"{wall_ms:.1f} ms (profiler on), device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.1%}; top "
        f"device time:")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"    {t / 1e3:9.3f} ms  {n:4d}x  {name[:100]}")


def host_profile(run, tag: str, top: int = 8):
    """Run ``run()`` once under ``cProfile`` and print the functions that
    took the most host time of their own (where a host-bound call's
    time goes). Returns what ``run`` returned."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    out = prof.runcall(run)
    wall_s = time.perf_counter() - t0
    st = pstats.Stats(prof).stats
    rows = sorted(st.items(), key=lambda kv: -kv[1][2])[:top]
    log(f"[{tag}] host profile: wall {wall_s:.3f} s (cProfile on); "
        f"top own time:")
    for (path, line, fn), (_, ncalls, tt, ct, _) in rows:
        log(f"    {tt:8.3f} s own {ct:8.3f} s cum {ncalls:6d}x  "
            f"{os.path.basename(path)}:{line}({fn})")
    return out


def edge_cases(dev, large: bool = True) -> list:
    """(kernel name, dispatch arguments) over the edge cases that
    ``tests/test_torch_kernels.py`` also runs: tail empty segments, n=1,
    ids out of range, all rows invalid, runs longer than one thread
    sums, duplicate and INT64_MAX keys, r=1, idx -1 and >= r. ``large``
    adds cases with tens of thousands of rows (many blocks, giant
    runs), ``gather_tile_cases``, ``first_card_cases`` and
    ``merge_card_cases``."""
    rng = np.random.RandomState(7)
    T = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    cases = []
    for n, S, d, k, lo, hi in [(40, 50, 2, 3, 0, 30),     # empty tail segments
                               (1, 1, 1, 1, 0, 1),        # n = 1
                               (33, 7, 3, 2, -2, 9),      # ids out of range
                               (13, 5, 2, 1, -1, -1),     # every row invalid
                               (300, 120, 1, 3, 0, 120),
                               (400, 6, 2, 2, -1, 3)] + \
            ([(70000, 70000, 2, 3, 0, 30000),
              (70000, 100, 1, 3, 0, 2)] if large else []):     # giant runs
        seg = np.sort(rng.randint(lo, hi + 1, n)).astype(np.int32) \
            if hi > lo else np.full(n, lo, np.int32)
        vals = rng.randint(0, 100, (n, d)).astype(np.float32)
        keys = rng.randint(-2 ** 62, 2 ** 62, (n, k)).astype(np.int64)
        cases.append(("segment_sum_first", (T(vals, torch.float32),
                                            T(keys, torch.int64),
                                            T(seg, torch.int32), S)))
    for r, n, span in [(1, 5, 20), (40, 60, 20), (7, 1, 20), (300, 50, 3)] \
            + ([(5000, 70000, 20)] if large else []):
        sk = np.sort(rng.randint(-span, span, r)).astype(np.int64)
        sk[r // 2:] = np.maximum(sk[r // 2:], 3)               # duplicates
        if r > 2:
            sk[-2:] = I64_MAX                                   # padding
        q = rng.randint(-span - 5, span + 5, n).astype(np.int64)
        q[: max(n // 4, 1)] = I64_MAX
        cases.append(("merge_positions", (T(sk, torch.int64),
                                          T(q, torch.int64))))
    for r, n, d in [(1, 9, 1), (30, 50, 4), (17, 1, 2)] + \
            ([(4000, 90000, 3)] if large else []):
        vals = rng.randint(-2 ** 62, 2 ** 62, (r, d)).astype(np.int64)
        idx = rng.randint(-3, r + 3, n).astype(np.int64)
        idx[0] = -1
        idx[-1] = r
        cases.append(("gather_rows", (T(vals, torch.int64),
                                      T(idx, torch.int64))))
    if large:
        cases += gather_tile_cases(np.random.RandomState(9), dev)
        rng = np.random.RandomState(8)
        for vals, keys, seg, S in first_card_cases(rng):
            cases.append(("segment_sum_first", (T(vals, torch.float32),
                                                T(keys, torch.int64),
                                                T(seg, torch.int32), S)))
        for sk, q in merge_card_cases(rng):
            cases.append(("merge_positions", (T(sk, torch.int64),
                                              T(q, torch.int64))))
    return cases


def first_card_cases(rng) -> list:
    """(vals, keys, seg, S) for segment_sum_first at card scale: the
    edges of the 2048-row tiles (``reduce_tile_edges``) with d from 1 to
    4 and k from 4 to 1; a run over 250 tiles between short groups;
    sparse ids (a tile's ids wider than its slots); and the main path's
    shape: dense group ids whose last group takes a
    multi-million-row invalid tail, with S the capacity, so that the ids
    above it are as long an empty tail. Values are integers small enough
    that every sum is exact."""
    def case(seg, S, d, k, top=100):
        n = seg.shape[0]
        return (rng.randint(0, top, (n, d)).astype(np.float32),
                rng.randint(-2 ** 62, 2 ** 62, (n, k)).astype(np.int64),
                seg.astype(np.int32), S)

    out = [case(seg, S, d, 5 - d) for seg, S in reduce_tile_edges(rng)
           for d in range(1, 5)]
    from repro_torch.kernels.segment_reduce import TILE_ROWS as T
    def short(a, b):                    # ids a..b-1, 1-8 rows each
        return np.repeat(np.arange(a, b), rng.randint(1, 9, b - a))

    seg = np.concatenate([short(0, 1000), np.full(250 * T + 77, 1000),
                          short(1001, 2000)])
    out.append(case(seg, 2100, 2, 3, top=10))
    # sparse ids: a tile's ids span more than its 2048 slots (written
    # directly), with wide gaps between tiles
    out.append(case(np.sort(rng.randint(0, 10 ** 6, 9000)), 10 ** 6, 1, 2))
    n, groups = 1 << 22, 150_000
    seg = np.concatenate([np.repeat(np.arange(groups - 1),
                                    rng.randint(1, 4, groups - 1)),
                          np.full(n, groups - 1)])[:n]
    vals, keys, seg, S = case(seg, n, 2, 3)
    vals[groups * 2:] = rng.randint(0, 2, vals[groups * 2:].shape)
    out.append((vals, keys, seg, S))
    return out


def merge_card_cases(rng) -> list:
    """(sorted keys, queries) for merge_positions at card scale: r =
    2^24 + 3 keys with runs of equal keys longer than a sector of heads
    (16 keys) and than a fence bracket (2,048 keys at this r) and an
    INT64_MAX tail, probed by keys, their neighbours, random values,
    INT64_MIN and INT64_MAX; r at 16,384 fences of 16 keys and one key
    either side; ascending queries into a general join's offsets (its
    second call, ``merge_positions(offs, arange)``)."""
    i64 = np.iinfo(np.int64)
    r = (1 << 24) + 3
    sk = np.sort(rng.randint(-2 ** 40, 2 ** 40, r))
    sk[1000:1040] = sk[1000]                      # over 16 keys
    sk[5_000_000:5_003_000] = sk[5_000_000]       # longer than a bracket
    sk[-1000:] = i64.max
    hit = sk[rng.randint(0, r, 600_000)]
    q = np.concatenate([hit, hit[:200_000] + 1, hit[:200_000] - 1,
                        rng.randint(-2 ** 41, 2 ** 41, 200_000),
                        [i64.min] * 7, [i64.max] * 7, sk[[1000, 5_000_000]]])
    rng.shuffle(q)
    out = [(sk, q)]
    for r in (16384 * 16 - 1, 16384 * 16, 16384 * 16 + 1):
        sk = np.sort(rng.randint(-10 ** 6, 10 ** 6, r))
        q = np.concatenate([sk[rng.randint(0, r, 50_000)],
                            rng.randint(-11 * 10 ** 5, 11 * 10 ** 5, 50_000)])
        out.append((sk, q))
    offs = np.cumsum(rng.randint(0, 4, 1_000_000))
    out.append((offs, np.arange(offs[-1] + 10)))
    return out


def reduce_edge_cases(dev, large: bool = True) -> list:
    """(kernel name, dispatch arguments) for segment_reduce over the edge
    cases that ``tests/test_torch_kernels.py`` also runs: empty tail
    segments, n = 1, ids out of range at both ends, every row invalid,
    more segments than rows, S = 0, n = 0, an out-of-range row between
    two rows of one id (summed across), d > 1 (row-major). Values are
    integer-valued, so every order of summation is exact. ``large`` adds
    cases with tens of thousands of rows: ranges a thread, a warp and a
    block sum, with out-of-range rows scattered among them."""
    rng = np.random.RandomState(17)
    T = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    cases = []

    def case(seg, S, d):
        seg = np.asarray(seg, np.int32)
        vals = rng.randint(0, 100, (seg.shape[0], d)).astype(np.float32)
        cases.append(("segment_reduce", (T(vals, torch.float32),
                                         T(seg, torch.int32), S)))

    for n, S, d, lo, hi in [(40, 50, 2, 0, 30),       # empty tail segments
                            (1, 1, 1, 0, 0),          # n = 1
                            (33, 7, 3, -2, 9),        # out of range at ends
                            (5, 50, 3, 0, 49),        # more segments than rows
                            (300, 120, 1, 0, 119),
                            (400, 6, 4, -1, 6)]:
        case(np.sort(rng.randint(lo, hi + 1, n)), S, d)
    case(np.full(19, -1), 6, 2)                       # every row invalid
    case(np.sort(rng.randint(0, 5, 10)), 0, 2)        # S = 0
    case(np.zeros(0), 4, 3)                           # n = 0
    case([0, 0, -1, 0, 1, 1, 7, 1, 2, -1], 3, 2)      # invalid between
    if large:
        for n, S, hi in [(70000, 70000, 30000),       # short ranges
                         (200000, 3000, 2999),        # medium ranges
                         (70000, 100, 2)]:            # long ranges
            seg = np.sort(rng.randint(0, hi + 1, n))
            holes = rng.rand(n) < 0.05
            seg[holes] = rng.choice([-1, S, S + 5], int(holes.sum()))
            case(seg, S, 2)
        for seg, S in reduce_tile_edges(rng):
            for d in range(1, 6):
                case(seg, S, d)
    return cases


def reduce_tile_edges(rng) -> list:
    """(seg_ids, S) at the edges of segment_reduce's 2048-row tiles (its
    carry records join the runs that cross them): a segment ending
    exactly at a tile's end and one straddling two tiles; one spanning
    41 tiles (more than the carry pass's 32-tile batch); out-of-range
    rows at tiles' first and last rows; 35 tiles without an in-range row
    between two that have one, and such tiles first and last; empty
    segments before, between and after tiles; a tail tile."""
    from repro_torch.kernels.segment_reduce import TILE_ROWS as T

    def runs(*spec):
        return np.concatenate([np.full(n, s) for s, n in spec])

    edges = rng.randint(0, 150, 3 * T + 10)
    edges = np.sort(edges)
    for at, bad in [(0, -1), (T - 1, -1), (T, 150), (2 * T - 1, 153),
                    (2 * T, -1), (3 * T + 9, -1)]:
        edges[at] = bad
    return [(runs((2, T), (3, T - 5), (5, T + 5), (7, 300)), 10),
            (runs((0, 100), (1, 40 * T + 17), (2, 50)), 4),
            (edges, 150),
            (runs((1, 1000), (-1, 35 * T), (4, 3000)), 6),
            (runs((-1, 3 * T), (2, 10), (-1, 2 * T)), 4),
            (np.sort(rng.randint(0, 3 * T, 5 * T + 123)), 3 * T)]


def decode_edge_cases(dev, large: bool = True) -> list:
    """(kernel name, dispatch arguments) for the decode kernels over the
    edge cases that ``tests/test_torch_decode.py`` also runs: n = 0,
    r = 1, runs of length 1, float bit patterns (-0.0, NaN payloads),
    delta steps across INT64_MIN and INT64_MAX at every stored width,
    k = 1, 15 and 16 with n not a multiple of vpw and lo negative or
    near the int64 limits, codes of -1 and r, an empty dictionary.
    ``large`` adds cases with tens of thousands of rows (many blocks, a
    constant run, a dictionary too big for shared memory),
    ``rle_card_cases`` and ``delta_card_cases``."""
    from repro_torch.storage import encodings as E
    rng = np.random.RandomState(11)
    T = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    i64_min = np.iinfo(np.int64).min
    cases = []

    def rle(values, lengths):
        lengths = np.asarray(lengths, np.int32)
        cases.append(("rle_expand", (T(values, torch.int64),
                                     T(lengths, torch.int32),
                                     int(lengths.sum()))))

    def delta(a):
        enc, blob = E.encode_chunk(np.asarray(a, np.int64), "delta")
        z = E.unpack_members(enc, blob)["deltas"]
        cases.append(("delta_unpack", (torch.from_numpy(z.copy()).to(dev),
                                       int(enc["first"]))))

    def bitunpack(k, nw, lo):
        vpw = 32 // k
        words = rng.randint(0, 2 ** 32, nw, dtype=np.uint64).astype(
            np.uint32)
        cases.append(("bitunpack", (torch.from_numpy(words).to(dev), k,
                                    vpw, max(nw * vpw - 3, 0), lo)))

    def dict_(r, codes, dt):
        values = rng.randint(i64_min, I64_MAX, r, dtype=np.int64)
        cases.append(("dict_gather", (T(values, torch.int64),
                                      T(codes, dt))))

    nan_payload = np.array([0x7FF8_0000_0000_0ABC], np.int64)
    floats = np.concatenate([np.array([-0.0, np.nan, 1.5, 0.0]).view(
        np.int64), nan_payload])
    rle([], [])                                               # n = 0
    rle([i64_min], [1])                                       # r = 1, n = 1
    rle([I64_MAX], [3000])                                    # r = 1
    rle(rng.randint(i64_min, I64_MAX, 50, dtype=np.int64),
        np.ones(50))                                          # length 1
    rle(floats, [2, 3, 1, 4, 2])                              # float bits
    delta([])                                                 # n = 0
    delta([i64_min])                                          # n = 1
    delta([I64_MAX - 2, I64_MAX, i64_min, i64_min + 3, I64_MAX, 0])  # u64
    delta(np.cumsum(rng.randint(-100, 100, 300)) + I64_MAX - 5000)  # u8
    delta(np.cumsum(rng.randint(-30000, 30000, 300)))         # u16
    delta(rng.randint(0, 2 ** 30, 300))                       # u32
    for k, lo in [(1, 0), (1, -7), (15, I64_MAX - 3), (16, i64_min),
                  (16, -(2 ** 40))]:
        bitunpack(k, 37, lo)
    dict_(7, [-1, 0, 6, 7, 3, -1], torch.int32)               # -1 and r
    dict_(0, [-1, 0, 1], torch.int32)                         # r = 0
    dict_(49, rng.randint(0, 49, 200), torch.uint8)
    dict_(300, rng.randint(0, 300, 200), torch.uint16)
    dict_(5, [], torch.uint8)                                 # n = 0
    if large:
        rle([5], [70000])                                     # one run
        rle(rng.randint(i64_min, I64_MAX, 20000, dtype=np.int64),
            rng.randint(1, 8, 20000))                         # label runs
        delta(rng.randint(i64_min, I64_MAX, 70000, dtype=np.int64))
        delta(np.cumsum(rng.randint(-100, 100, 70000)))
        bitunpack(6, 14000, -1)
        dict_(5000, rng.randint(-1, 5001, 70000), torch.int32)  # global
        dict_(49, rng.randint(0, 49, 70000), torch.uint8)
        cases += rle_card_cases(np.random.RandomState(12), dev)
        cases += delta_card_cases(np.random.RandomState(14), dev)
    return cases


def rle_card_cases(rng, dev) -> list:
    """rle_expand around its 2048-run scan tiles and 1024-row tiles: one
    run of 2^20 + 12,345 rows; runs of length 1 over 9 scan tiles; runs
    of 1-2,049 rows that cross row tiles (and whole row tiles inside
    one run); 2^22 runs over 2,048 scan tiles, more than the blocks the
    card holds at once (so tiles look back on tiles that have finished);
    n an exact multiple of the row tile; r = 1 (n = 1 and n = 3); and
    ``out`` given as a slice 8 bytes off a 16-byte boundary (stored one
    row a store), and as an aligned slice. A case is (values, lengths,
    n) or (values, lengths, n, out)."""
    i64 = np.iinfo(np.int64)
    cases = []

    def rle(lengths, out_skip=None):
        lengths = np.asarray(lengths, np.int32)
        r, n = lengths.shape[0], int(lengths.sum())
        values = rng.randint(i64.min, i64.max, r, dtype=np.int64)
        values[:len(PAYLOAD_BITS)] = PAYLOAD_BITS[:r]
        args = (torch.as_tensor(values, device=dev),
                torch.as_tensor(lengths, device=dev), n)
        if out_skip is not None:
            big = torch.empty((n + out_skip,), dtype=torch.int64, device=dev)
            args += (big[out_skip:],)
        cases.append(("rle_expand", args))

    rle([(1 << 20) + 12345])                              # one run
    rle(np.ones(9 * 2048 + 5))                            # runs of 1
    rle(rng.choice([1, 2, 7, 2047, 2048, 2049], 3000))    # across tiles
    rle(rng.randint(1, 3, 1 << 22))                       # 2,048 tiles
    rle([2048] * 3 + [1] * 2048)                          # n = 4 x 2048
    rle([1])                                              # r = 1, n = 1
    rle([3])                                              # r = 1, n = 3
    rle(rng.randint(1, 8, 5000), out_skip=1)              # 8 bytes off
    rle(rng.randint(1, 8, 5000), out_skip=2)              # out aligned
    return cases


def bytes_view(a: np.ndarray, skip: int, dev) -> torch.Tensor:
    """``a`` on ``dev``, viewed ``skip`` bytes (a multiple of its item
    size) past the 16-byte boundary where a buffer of random bytes
    starts: the bytes around the view are not zeros."""
    raw = np.random.RandomState(skip).randint(
        0, 256, skip + a.nbytes + 16).astype(np.uint8)
    raw[skip:skip + a.nbytes] = np.ascontiguousarray(a).view(np.uint8)
    buf = torch.from_numpy(raw).to(dev)
    dt = torch.from_numpy(a[:0].copy()).dtype
    return buf[skip:skip + a.nbytes].view(dt)


def delta_card_cases(rng, dev) -> list:
    """delta_unpack around its 4096-row tiles and the 16-byte boundary
    below z: every stored width with z viewed at each offset from 0 to
    15 bytes that the width allows, random bytes around the view; sums
    that wrap past 2^64 and ``first`` at INT64_MIN, INT64_MAX and
    2^64 - 1; n of 1, a tile less one, a tile, a tile and one, and
    several tiles; 300,007 rows (74 tiles) and 2^20 + 12,345 rows (260
    tiles), so that look-backs cross more than one window of 32 tiles
    (and 128); ``out`` given as a slice 8 bytes off a 16-byte boundary
    and as an aligned one. A case is (z, first) or (z, first, out)."""
    i64 = np.iinfo(np.int64)
    firsts = [0, int(i64.min), int(i64.max), 2 ** 64 - 1, 12345]
    sizes = [1, 4095, 4096, 4097, 9000, 70001]
    cases = []

    def delta(dt, n, skip, out_skip=None):
        top = 2 ** (8 * np.dtype(dt).itemsize)
        z = rng.randint(0, top, n, dtype=np.uint64).astype(dt)
        args = (bytes_view(z, skip, dev), firsts[len(cases) % len(firsts)])
        if out_skip is not None:
            big = torch.empty((n + out_skip,), dtype=torch.int64, device=dev)
            args += (big[out_skip:],)
        cases.append(("delta_unpack", args))

    for dt in (np.uint8, np.uint16, np.uint32, np.uint64):
        w = np.dtype(dt).itemsize
        for skip in range(0, 16, w):
            delta(dt, sizes[(skip // w) % len(sizes)], skip)
    delta(np.uint32, 300_007, 4)                         # 74 tiles
    delta(np.uint8, (1 << 20) + 12345, 9)                # 260 tiles
    delta(np.uint64, 300_007, 8, out_skip=1)             # wraps; out off
    delta(np.uint16, 70001, 6, out_skip=2)               # out aligned
    delta(np.uint64, 9000, 0, out_skip=1)
    return cases


def member_card_cases(rng, dev) -> list:
    """member_mask around its two paths: sets of 0, 1, 2, 40 (sorted,
    padding at the end, as skew.merge_heavy gives them), 255 and 256
    keys (the largest a block sorts) with duplicates and padding between,
    and 257 and 1,000 (the staged path); keys viewed 8 bytes off a
    16-byte boundary and on one, INT64_MAX among them; n of 1, 7, 8, 9,
    70,001 and 2^21 + 3 (more keys than one round of the grid)."""
    cases = []

    def member(n, m, skip, real=None, ordered=False):
        real = m // 2 if real is None else real
        pool = np.arange(-200, 200)
        heavy = np.concatenate([rng.choice(pool, real, replace=True),
                                np.full(m - real, I64_MAX)]).astype(np.int64)
        if ordered:
            heavy.sort()
        else:
            rng.shuffle(heavy)
        keys = rng.randint(-250, 250, n).astype(np.int64)
        keys[::11] = I64_MAX
        cases.append(("member_mask", (view_at(keys, torch.int64, skip, dev),
                                      view_at(heavy, torch.int64, 0, dev))))

    for i, n in enumerate([1, 7, 8, 9, 70001]):
        member(n, 40, i % 2)
    member(5000, 0, 1)
    member(5000, 1, 0, real=1)
    member(5000, 2, 1, real=1)
    member(70001, 40, 1, real=35, ordered=True)
    member(70001, 255, 0, real=250)
    member(70001, 256, 1, real=256)
    member(70001, 257, 0)
    member(9000, 1000, 1)
    member((1 << 21) + 3, 40, 1, real=40, ordered=True)
    member((1 << 21) + 3, 40, 0, real=38)
    return cases


def shuffle_edge_cases(dev, large: bool = True) -> list:
    """(kernel name, dispatch arguments) for the packed-shuffle kernels
    over the edges ``tests/test_torch_shuffle.py`` also runs: ok all
    false, indices -1 and r, negative virtual ids, repl 1 and several,
    r = 0 and m = 1, sizes no multiple of any block, -0.0 and NaN
    payloads, int32 and int64 indices with bool and int32 flags,
    INT64_MAX on either side of member_mask and an unsorted heavy set.
    ``large`` adds cases with tens of thousands of rows, a heavy set
    larger than one shared-memory stage, ``member_card_cases`` and
    ``pack_tile_cases``."""
    rng = np.random.RandomState(13)
    T = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)  # noqa: E731
    cases = []
    sizes = [(1, 1, 1), (9, 9, 2), (30, 50, 4), (0, 5, 3), (17, 129, 6)] \
        + ([(4000, 90001, 7), (70000, 131073, 5)] if large else [])
    for i, (r, m, d) in enumerate(sizes):
        vals = rng.randint(-2 ** 62, 2 ** 62, (r, d)).astype(np.int64)
        if vals.size:
            vals.reshape(-1)[:len(PAYLOAD_BITS)] = PAYLOAD_BITS[:vals.size]
        idx = rng.randint(-3, r + 3, m)
        idx[0], idx[-1] = -1, r
        ok = rng.rand(m) < 0.7 if i else np.zeros(m, bool)
        idt = torch.int32 if i % 2 else torch.int64
        okt = torch.bool if i % 3 else torch.int32
        cases.append(("pack_rows", (T(vals, torch.int64), T(idx, idt),
                                    T(ok, okt))))
        for repl in (1, 3, 8):
            vidx = rng.randint(-3, max(r * repl, 1) + 3, m)
            vidx[0] = -1
            cases.append(("replicate_scatter",
                          (T(vals, torch.int64), T(vidx, torch.int32),
                           T(ok, torch.bool), repl)))
        cases.append(("unpack_cols", (T(vals, torch.int64),)))
    for n, m in [(1, 40), (100, 40), (7, 0), (33, 3)] + \
            ([(70000, 40), (70000, 5000)] if large else []):
        keys = rng.randint(-50, 50, n).astype(np.int64)
        keys[::7] = I64_MAX
        heavy = np.concatenate([rng.choice(np.arange(-50, 50), m // 2,
                                           replace=m // 2 > 100),
                                np.full(m - m // 2, I64_MAX)])
        rng.shuffle(heavy)                   # unsorted, padding between
        cases.append(("member_mask", (T(keys, torch.int64),
                                      T(heavy, torch.int64))))
    if large:
        cases += member_card_cases(rng, dev) + pack_tile_cases(rng, dev)
    return cases


def view_at(a, dt, skip: int, dev) -> torch.Tensor:
    """``a`` as a ``dt`` tensor on ``dev`` that starts ``skip`` items into
    a buffer (so ``skip`` items off the buffer's 16-byte boundary)."""
    t = torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    big = torch.empty((t.numel() + skip,), dtype=dt, device=dev)
    big[skip:] = t.reshape(-1)
    return big[skip:].view(t.shape)


def gather_tile_cases(rng, dev) -> list:
    """gather_rows around the kernel's 1024-row tiles: one tile, one row
    over, two and three tiles, and more tiles than the grid's blocks
    (600,001 rows: each block walks several, the next one's ids staged
    while it gathers), with d from 1 to 12, odd (one lane a load) and
    even (two); ids 0 (a row of -0.0 and NaN payloads), -1, r, INT64_MAX
    and INT64_MIN among random ones, some out of range; ``values`` viewed
    8 bytes off a 16-byte boundary (one lane a load at even d), and ids
    viewed off one (the staging's head)."""
    def inputs(r, n, d):
        vals = rng.randint(-2 ** 62, 2 ** 62, (r, d)).astype(np.int64)
        vals.reshape(-1)[:len(PAYLOAD_BITS)] = PAYLOAD_BITS
        idx = rng.randint(-3, r + 3, n).astype(np.int64)
        idx[:4] = [0, -1, r, I64_MAX]
        idx[-1] = np.iinfo(np.int64).min
        return vals, idx

    cases = []
    sizes = [1024, 1025, 2048, 3077, 9000, 600_001]
    for d in range(1, 13):
        n = sizes[d % len(sizes)]
        vals, idx = inputs(n // 2 + 7, n, d)
        cases.append(("gather_rows", (view_at(vals, torch.int64, 0, dev),
                                      view_at(idx, torch.int64, 0, dev))))
    for d, n in [(2, 5000), (4, 2100), (6, 600_001), (5, 3100)]:
        vals, idx = inputs(1500, n, d)                 # off a boundary
        cases.append(("gather_rows", (view_at(vals, torch.int64, 1, dev),
                                      view_at(idx, torch.int64, 1, dev))))
    return cases


def pack_tile_cases(rng, dev) -> list:
    """pack_rows and replicate_scatter around the kernel's 1024-slot
    tiles: one tile, one slot over, two and three tiles, and more tiles
    than the grid's blocks (each block then walks several, the next
    one's indices staged while it gathers), with d from 1 to 12, odd
    (one lane a load) and even (two); int32 and int64 ids, bool and
    int32 flags; repl 1, 3 and 8, and int64 virtual ids beyond 2^32;
    -0.0 and NaN payloads taken; ``values`` viewed 8 bytes off a 16-byte
    boundary (one lane a load at even d), and ids and flags viewed off
    one (the staging's head)."""
    def view(a, dt, skip):
        return view_at(a, dt, skip, dev)

    def inputs(r, m, d, repl):
        vals = rng.randint(-2 ** 62, 2 ** 62, (r, d)).astype(np.int64)
        vals.reshape(-1)[:len(PAYLOAD_BITS)] = PAYLOAD_BITS
        idx = rng.randint(-3, r * repl + 3, m).astype(np.int64)
        idx[:3] = [0, -1, r * repl]              # the payload row, -1, r
        return vals, idx, rng.rand(m) < 0.7

    cases = []
    sizes = [1024, 1025, 2048, 3077, 9000, 600_001]
    for d in range(1, 13):
        m = sizes[d % len(sizes)]
        vals, idx, ok = inputs(m // 2 + 7, m, d, 1)
        idt = torch.int32 if d % 2 else torch.int64
        okt = torch.bool if d % 3 else torch.int32
        cases.append(("pack_rows", (view(vals, torch.int64, 0),
                                    view(idx, idt, 0), view(ok, okt, 0))))
    for repl, idt, d in [(1, torch.int64, 4), (3, torch.int32, 5),
                         (8, torch.int64, 6), (3, torch.int64, 3)]:
        vals, vidx, ok = inputs(700, 2049 + 800 * repl, d, repl)
        cases.append(("replicate_scatter", (view(vals, torch.int64, 0),
                                            view(vidx, idt, 0),
                                            view(ok, torch.bool, 0), repl)))
    repl = 2 ** 33 + 1                       # int64 ids beyond 2^32
    vals, vidx, ok = inputs(900, 3000, 4, repl)
    assert int(vidx.max()) > 2 ** 32
    cases.append(("replicate_scatter", (view(vals, torch.int64, 0),
                                        view(vidx, torch.int64, 0),
                                        view(ok, torch.bool, 0), repl)))
    cases.append(("replicate_scatter", (view(vals, torch.int64, 0),
                                        view(vidx, torch.int64, 0),
                                        view(ok, torch.bool, 0), 7)))
    for d, m in [(4, 2100), (6, 600_001), (5, 3100)]:   # off a boundary
        vals, idx, ok = inputs(1500, m, d, 1)
        cases.append(("pack_rows", (view(vals, torch.int64, 1),
                                    view(idx, torch.int64, 1),
                                    view(ok, torch.bool, 3))))
        cases.append(("pack_rows", (view(vals, torch.int64, 1),
                                    view(idx, torch.int32, 3),
                                    view(ok, torch.int32, 1))))
        cases.append(("replicate_scatter", (
            view(vals, torch.int64, 1), view(idx * 3 + 2, torch.int64, 1),
            view(ok, torch.bool, 5), 3)))
    return cases


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False)")
    name = torch.cuda.get_device_name(0)
    log(f"[0 device] {name}; {torch.cuda.device_count()} device(s); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[0 device] nvidia-smi: {nvidia_smi()}")
    return name


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all(verbose=True)
    log(f"[1 build] {len(paths)} libraries ({', '.join(sorted(paths))}) "
        f"in {time.perf_counter() - t0:.2f} s")


def phase_kernels(dev) -> None:
    n = 0
    for name, args in edge_cases(dev) + reduce_edge_cases(dev) \
            + decode_edge_cases(dev) + shuffle_edge_cases(dev):
        kern, plain, _, _ = kernel_fns(name, args)
        got = kern()
        err = max_abs_err(got, plain())
        if name in REPEATED:
            # launches repeat (a copy: a second launch rewrites ``out``)
            got = tuple(g.clone() for g in
                        (got if isinstance(got, tuple) else (got,)))
            err = max(err, max_abs_err(got, kern()))
        torch.cuda.synchronize()
        assert err == 0.0, (name, [tuple(a.shape) if torch.is_tensor(a)
                                   else a for a in args], err)
        n += 1
    log(f"[2 kernels] {n} edge cases: every kernel bit-exact against its "
        f"plain version ({', '.join(REPEATED)}: two launches "
        f"bit-identical)")


def phase_quickstart(dev) -> None:
    from repro_torch.core import codegen as CG
    from repro_torch.core import interpreter as I
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.core.unnesting import Catalog
    from repro_torch.kernels import ops as kops
    part_t = N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL))
    cop_t = N.bag(N.tuple_t(
        cname=N.INT,
        corders=N.bag(N.tuple_t(
            odate=N.INT,
            oparts=N.bag(N.tuple_t(pid=N.INT, qty=N.REAL))))))
    COP, Part = N.Var("COP", cop_t), N.Var("Part", part_t)

    def oparts_total(co):
        joined = N.for_in("op", co.oparts, lambda op:
            N.for_in("p", Part, lambda p:
                N.IfThen(op.pid.eq(p.pid),
                         N.Singleton(N.record(pname=p.pname,
                                              total=op.qty * p.price)))))
        return N.SumBy(joined, keys=("pname",), values=("total",))

    Q = N.for_in("cop", COP, lambda cop: N.Singleton(N.record(
        cname=cop.cname,
        corders=N.for_in("co", cop.corders, lambda co: N.Singleton(
            N.record(odate=co.odate, oparts=oparts_total(co)))))))
    parts = [{"pid": i, "pname": 100 + i, "price": float(i)}
             for i in (1, 2, 3)]
    cop = [{"cname": 1, "corders": [
        {"odate": 20240101,
         "oparts": [{"pid": 1, "qty": 3.0}, {"pid": 2, "qty": 4.0},
                    {"pid": 1, "qty": 1.0}]},
        {"odate": 20240102, "oparts": []}]},
        {"cname": 2, "corders": []}]
    types = {"COP": cop_t, "Part": part_t}
    sp = M.shred_program(N.Program([N.Assignment("Q", Q)]), types,
                         domain_elimination=True)
    cp = CG.compile_program(sp, Catalog(unique_keys={"Part__F": ("pid",)}))
    env = CG.columnar_shred_inputs({"COP": cop, "Part": parts}, types,
                                   device=dev)
    kops.reset_launch_counts()
    out = CG.run_flat_program(cp, env, ExecSettings(use_kernel=True))
    counts = kops.launch_counts()
    man = sp.manifests["Q"]
    got = CG.parts_to_rows({(): out[man.top],
                            **{p: out[n] for p, n in man.dicts.items()}},
                           Q.ty)
    want = I.eval_expr(Q, {"COP": cop, "Part": parts})
    assert I.bags_equal(want, got), (want, got)
    assert all(counts[k] > 0 for k in JOIN_KERNELS), counts
    log(f"[A quickstart] matches the port's interpreter; launches {counts}")


def phase_tpch(tag: str, scale: int, seed: int, domain_elimination: bool,
               dev, widths: bool = False) -> list:
    """Phases B and C: one n2n level-2 run at ``scale`` orders; returns
    the per-kernel records. ``widths``: also measure gather_rows at its
    largest call of each other width d."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.core.unnesting import Catalog
    from repro_torch.kernels import ops as kops
    t0 = time.perf_counter()
    env_np = shred_ncop2(gen_tpch_columns(scale, seed))
    sizes = {k: int(v[1].shape[0]) for k, v in env_np.items()}
    log(f"[{tag}] scale={scale} orders, seed={seed}, domain_elimination="
        f"{domain_elimination}: {sizes} (generated in "
        f"{time.perf_counter() - t0:.1f} s)")
    part_t, ncop2_t = tpch_types()
    q = nested_to_nested_query(2, "NCOP2", ncop2_t)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]),
                         {"NCOP2": ncop2_t, "Part": part_t},
                         domain_elimination=domain_elimination)
    cp = CG.compile_program(sp, Catalog(unique_keys={"Part__F": ("pid",)}))
    env = env_from_numpy(env_np, dev)
    exe = CG.jit_program(cp, ExecSettings(use_kernel=True))

    t0 = time.perf_counter()
    exe(env)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    with CaptureLargestCalls() as cap:
        t0 = time.perf_counter()
        out = exe(env)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] jit_program use_kernel=True: cold {cold_s:.3f} s, warm "
        f"{warm_s * 1e3:.1f} ms, peak device memory {peak / 2 ** 30:.2f} "
        f"GiB, launches in the warm run {counts}")
    assert all(counts[k] > 0 for k in JOIN_KERNELS), counts

    man = sp.manifests["Q"]
    oparts = out[man.dicts[("corders", "oparts")]]
    rows = check_oparts(oparts, env_np)
    log(f"[{tag}] Q__D_corders_oparts: {rows} groups equal to the numpy "
        f"group-by (capacity {oparts.capacity})")
    plain = CG.jit_program(cp, ExecSettings(use_kernel=False))(env)
    for name in out:
        bags_bit_equal(out[name], plain[name], name)
    log(f"[{tag}] use_kernel=False run bit-equal on {sorted(out)}")
    recs = measure_kernels(cap.args, counts, tag)
    largest = cap.args["gather_rows"][0].shape[1]
    for d, args in sorted(cap.by_width.items()) if widths else ():
        if d != largest:     # the largest call of each other width
            recs += measure_kernels({"gather_rows": args}, counts,
                                    f"{tag}, gather_rows at d={d}")
    profile_run(lambda: exe(env), tag)
    del out, plain, cap
    fixed = warm_calls_ms(lambda: exe(env))
    with expandable_segments():
        grown = warm_calls_ms(lambda: exe(env))
    log(f"[{tag}] warm calls from an emptied cache (ms): {fixed} with the "
        f"default allocator, {grown} with expandable segments")
    del env
    return recs


def phase_decode(env_np: dict, dev) -> list:
    """Phase D0: one 2^20-row chunk per codec, from columns of the SF5
    data, encoded by ``encodings.encode_chunk`` and decoded on the card
    through the reader's own ``_decode_device``: bit-equal to
    ``encodings.decode_chunk``; then each kernel at that chunk's shape,
    timed. Returns the records; ``launches`` is filled in by phase D."""
    from repro_torch.kernels import ops as kops
    from repro_torch.storage import encodings as E
    from repro_torch.storage import reader as RD
    li = env_np["NCOP2__D_corders_oparts"][0]
    n = CHUNK_ROWS
    chunks = {"rle_expand": ("label", li["label"][:n], "rle"),
              "delta_unpack": ("pid", li["pid"][:n], "delta"),
              "bitunpack": ("qty as int64", li["qty"][:n].astype(np.int64),
                            "bitpack"),
              "dict_gather": ("qty", li["qty"][:n], "dict")}
    kops.reset_launch_counts()
    with CaptureLargestCalls(DECODE_KERNELS) as cap:
        for name, (col, a, codec) in chunks.items():
            enc, blob = E.encode_chunk(a, codec)
            got = RD._decode_device(enc, blob, dev)
            torch.cuda.synchronize()
            want = E.decode_chunk(enc, blob)
            got = got.cpu().numpy()
            assert got.dtype == want.dtype and \
                got.tobytes() == want.tobytes(), (name, codec)
            members = {m[0]: f"{m[2]} x {m[1]}" for m in enc["members"]}
            extra = {k: enc[k] for k in ("k", "vpw", "lo") if k in enc}
            log(f"[D0 decode] {codec} chunk of oparts.{col} ({n} rows, "
                f"{blob.nbytes} bytes encoded, {a.nbytes} raw): members "
                f"{members} {extra}; _decode_device bit-equal to "
                f"decode_chunk")
    counts = kops.launch_counts()
    assert all(counts[k] > 0 for k in DECODE_KERNELS), counts
    log(f"[D0 decode] launches {counts}")
    recs = measure_kernels(cap.args, counts, "D0")
    from repro_torch.kernels import decode as D
    values, lengths, rows = cap.args["rle_expand"][:3]
    call_kernels("rle_expand",
                 lambda: D.rle_expand_cuda(values, lengths, rows),
                 {"rle_scan_kernel", "rle_expand_kernel"}, "D0's chunk")
    z, first = cap.args["delta_unpack"][:2]
    call_kernels("delta_unpack", lambda: D.delta_unpack_cuda(z, first),
                 {"delta_scan_kernel"}, "D0's chunk")
    # a constant column, stored as one run of the chunk's rows
    enc, blob = E.encode_chunk(np.full(n, 7, np.int64), "rle")
    with CaptureLargestCalls(("rle_expand",)) as one:
        got = RD._decode_device(enc, blob, dev)
    assert bool((got == 7).all()) and enc["members"][0][2] == 1, enc
    for rec in measure_kernels(one.args, counts, "D0 one run"):
        rec["shape"] = f"one run of {n} rows (a constant column)"
        recs.append(rec)
    values, lengths, rows = one.args["rle_expand"][:3]
    call_kernels("rle_expand",
                 lambda: D.rle_expand_cuda(values, lengths, rows),
                 {"rle_scan_kernel", "rle_expand_kernel"}, "one run")
    return recs


def call_kernels(name: str, run, want: set, what: str) -> None:
    """The device operations of one call of ``name``'s dispatch, by
    name, with each one's mean device time over 10 calls, from a
    complete profile (up to 6 sessions, until every kernel of ``want``
    shows and every operation 10 times, since a session may lose the
    record of a memset; a kernel's name matches where it contains one of
    ``want``): the kernels of ``want`` and one memset a call, nothing
    else."""
    calls = 10
    for sessions in range(1, 7):
        records, complete = profiled(run, iters=calls, pad_s=sessions - 1.0)
        by: dict = {}
        for e in records:
            op = e.name.replace("(anonymous namespace)::", "")
            by.setdefault(op.split("(")[0].strip(), []).append(
                e.time_range.elapsed_us())
        kernels = [k for k in by if not k.startswith(("Memset", "Memcpy"))]
        seen = {w for w in want if any(w in k for k in kernels)}
        if complete and seen == want and \
                all(len(t) == calls for t in by.values()):
            break
    ops = {k: f"{len(t) / calls:g} a call, {sum(t) / len(t):.2f} us"
           for k, t in sorted(by.items())}
    whole = seen == want and all(len(t) == calls for t in by.values())
    log(f"[D0 decode] {name} at {what}: device operations (profile "
        f"session {sessions}, "
        f"{'every operation seen' if whole else 'INCOMPLETE'}): {ops}")
    assert seen == want and len(kernels) == len(want) \
        and len(by) - len(kernels) <= 1 \
        and all(len(t) == calls for t in by.values()), ops


def dataset_report(w) -> None:
    """Per part: raw and encoded bytes, and per column how many chunks
    each codec took."""
    from repro_torch.storage.format import dir_bytes
    for name, pm in sorted(w.meta.parts.items()):
        raw = pm.rows * sum(np.dtype(d).itemsize for d in pm.dtypes.values())
        codecs = {}
        for ch in pm.chunks:
            for col in pm.schema:
                c = ch.encodings.get(col, {}).get("codec", "raw")
                codecs.setdefault(col, {}).setdefault(c, 0)
                codecs[col][c] += 1
        log(f"[D stored] {name}: {pm.rows} rows in {len(pm.chunks)} "
            f"chunks, {raw} bytes raw, "
            f"{dir_bytes(os.path.join(w.dir, name))} on disk; chunks per "
            f"codec {codecs}")


def phase_stored(seed: int, dev):
    """Phases D and E: the SF5 data written with ``encoding="auto"``,
    reopened on the card and served by ``QueryService.execute_stored``
    (D) and ``execute_stored_streaming`` (E). Fills the decode records'
    launch counts from D's warm call; returns the records and D's data
    for phase M (``stored.tmp``, the temporary directory that holds the
    dataset, is the caller's to remove)."""
    import shutil
    import tempfile
    from types import SimpleNamespace
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.core.unnesting import Catalog
    from repro_torch.kernels import ops as kops
    from repro_torch.serve import QueryService
    from repro_torch.storage import (STORAGE_STATS, DatasetWriter,
                                     StoredDataset, reset_storage_stats)
    t0 = time.perf_counter()
    env_np = shred_ncop2(gen_tpch_columns(SCALE_D, seed))
    log(f"[D stored] scale={SCALE_D} orders, seed={seed}: "
        f"{ {k: int(v[1].shape[0]) for k, v in env_np.items()} } "
        f"(generated in {time.perf_counter() - t0:.1f} s)")
    recs = phase_decode(env_np, dev)
    part_t, ncop2_t = tpch_types()
    types = {"NCOP2": ncop2_t, "Part": part_t}
    catalog = Catalog(unique_keys={"Part__F": ("pid",)})
    prog = N.Program([N.Assignment("Q", nested_to_nested_query(
        2, "NCOP2", ncop2_t))])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        t0 = time.perf_counter()
        w = DatasetWriter(os.path.join(tmp, "sf5"), "tpch", types,
                          chunk_rows=CHUNK_ROWS, encoding="auto")
        w.write_parts(env_from_numpy(env_np, "cpu"))
        log(f"[D stored] write_parts(encoding=\"auto\", chunk_rows="
            f"{CHUNK_ROWS}): {time.perf_counter() - t0:.1f} s on the host "
            f"(no profiler)")
        dataset_report(w)
        # where a write's host time goes, on a write of C's scale apart
        # from the timed one
        small = env_from_numpy(
            shred_ncop2(gen_tpch_columns(SCALE_C, seed)), "cpu")
        w_small = DatasetWriter(os.path.join(tmp, "sf1"), "tpch", types,
                                chunk_rows=CHUNK_ROWS, encoding="auto")
        host_profile(lambda: w_small.write_parts(small),
                     f"D stored write_parts at {SCALE_C} orders", top=6)
        del small, w_small
        ds = StoredDataset(w.dir, device=dev)
        svc = QueryService(types, catalog=catalog,
                           settings=ExecSettings(use_kernel=True))

        def serve():
            out = svc.execute_stored(prog, ds)
            torch.cuda.synchronize()
            return out

        t0 = time.perf_counter()
        serve()
        cold_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launch_counts()
        reset_storage_stats()
        traces = CG.TRACE_STATS.get("traces", 0)
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out_d = serve()
        warm_s = time.perf_counter() - t0
        counts = kops.launch_counts()
        rebuilds = CG.TRACE_STATS.get("traces", 0) - traces
        peak_d = torch.cuda.max_memory_allocated() - held
        stats = dict(STORAGE_STATS)
        log(f"[D stored] execute_stored use_kernel=True: cold "
            f"{cold_s:.3f} s, warm {warm_s * 1e3:.1f} ms, peak device "
            f"memory of the call {peak_d / 2 ** 30:.2f} GiB (above "
            f"{held / 2 ** 30:.2f} GiB held before it), plan rebuilds in the "
            f"warm call {rebuilds}, launches in the warm call {counts}")
        log(f"[D stored] STORAGE_STATS of the warm call {stats}")
        assert rebuilds == 0, rebuilds
        assert all(counts[k] > 0 for k in JOIN_KERNELS + (
            "rle_expand", "delta_unpack", "dict_gather")), counts
        for rec in recs:
            if rec["name"] != "bitunpack":     # no column picks bitpack
                rec["launches"] = counts[rec["name"]]
                rec["launches_in"] = "D warm execute_stored"
            else:
                rec["launches_in"] = "D0 reader._decode_device"
        entry = next(e for e in svc._cache.values() if e.morsel is None)
        man = entry.manifest("Q")
        oparts = out_d[man.dicts[("corders", "oparts")]]
        rows = check_oparts(oparts, env_np)
        log(f"[D stored] Q__D_corders_oparts: {rows} groups equal to the "
            f"numpy group-by (capacity {oparts.capacity})")
        # the same program over the same data held in memory, at the
        # service's capacity classes
        sp = M.shred_program(prog, types, domain_elimination=True)
        cp = CG.compile_program(sp, catalog)
        env = {k: b.resize(entry.class_caps[k])
               for k, b in env_from_numpy(env_np, dev).items()}
        mem = CG.jit_program(cp, ExecSettings(use_kernel=True))(env)
        for name in out_d:
            bags_bit_equal(out_d[name], mem[name], name)
        log(f"[D stored] bit-equal to an in-memory jit_program run on "
            f"{sorted(out_d)}")
        del env, mem
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, params, env = svc._lookup_stored(prog, ds)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        entry.exe(env, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        log(f"[D stored] warm split (a sync between): load_env "
            f"{(t1 - t0) * 1e3:.1f} ms, executable {(t2 - t1) * 1e3:.1f} "
            f"ms")
        del env

        def load():
            env = svc._lookup_stored(prog, ds)[2]
            torch.cuda.synchronize()
            return env

        host_profile(load, "D stored load_env")
        profile_run(serve, "D stored")
        phase_streamed(svc, prog, ds, out_d, env_np, man, warm_s, peak_d)
    except BaseException:
        shutil.rmtree(tmp)
        raise
    return recs, SimpleNamespace(tmp=tmp, dir=w.dir, env_np=env_np,
                                 types=types, catalog=catalog)


def phase_streamed(svc, prog, ds, out_d, env_np, man, warm_d: float,
                   peak_d: int) -> None:
    """Phase E: the same query morsel-streamed over the stored data;
    the same rows as D's, in another order."""
    from repro_torch.kernels import ops as kops

    def serve():
        out = svc.execute_stored_streaming(prog, ds, morsel_rows=CHUNK_ROWS,
                                           root="NCOP2")
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    serve()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    kops.reset_launch_counts()
    held = torch.cuda.memory_allocated()      # D's outputs, still alive
    t0 = time.perf_counter()
    out_e = serve()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    entry = next(e for e in svc._cache.values() if e.morsel is not None)
    n_morsels = entry.morsel[0].n_morsels
    log(f"[E streamed] execute_stored_streaming(morsel_rows={CHUNK_ROWS}):"
        f" {n_morsels} morsels; cold {cold_s:.3f} s, warm "
        f"{warm_s * 1e3:.1f} ms (D: {warm_d * 1e3:.1f} ms), peak device "
        f"memory of the call {peak / 2 ** 30:.2f} GiB above the "
        f"{held / 2 ** 30:.2f} GiB held before it (D: "
        f"{peak_d / 2 ** 30:.2f} GiB), "
        f"launches {kops.launch_counts()}")
    rows = check_oparts(out_e[man.dicts[("corders", "oparts")]], env_np)
    assert sorted(out_e) == sorted(out_d), (sorted(out_e), sorted(out_d))
    for name in out_d:
        assert torch.equal(sorted_rows(out_e[name]),
                           sorted_rows(out_d[name])), name
    log(f"[E streamed] Q__D_corders_oparts: {rows} groups equal to the "
        f"numpy group-by; every output holds D's rows "
        f"({sorted(out_d)})")


# ---------------------------------------------------------------------------
# phases F and G: skew-aware distributed execution over 8 sites
# ---------------------------------------------------------------------------

def flat_tpch(cols: dict) -> dict:
    """Lineitem__F, Part__F and Orders__F of the generated columns."""
    n_orders = cols["ord_cid"].shape[0]
    ones = lambda n: np.ones(n, dtype=np.bool_)  # noqa: E731
    return {
        "Lineitem__F": ({"oid": cols["li_oid"], "pid": cols["li_pid"],
                         "qty": cols["li_qty"]}, ones(cols["li_oid"].size)),
        "Part__F": ({"pid": cols["part_pid"], "pname": cols["part_pname"],
                     "price": cols["part_price"]},
                    ones(cols["part_pid"].size)),
        "Orders__F": ({"oid": np.arange(1, n_orders + 1, dtype=np.int64),
                       "cid": cols["ord_cid"], "odate": cols["ord_odate"]},
                      ones(n_orders)),
    }


def skew_types():
    from repro_torch.core import nrc as N
    part_t, ncop2_t = tpch_types()
    return {"NCOP2": ncop2_t, "Part": part_t,
            "Lineitem": N.bag(N.tuple_t(oid=N.INT, pid=N.INT, qty=N.REAL)),
            "Orders": N.bag(N.tuple_t(oid=N.INT, cid=N.INT, odate=N.INT))}


def written_stats(env_np: dict, types: dict, tag: str) -> dict:
    """``table_stats`` of ``env_np`` written by ``DatasetWriter`` in
    2^20-row chunks (the heavy-key sketches and zone maps the planner
    reads). Raw chunks: the statistics do not depend on the codecs."""
    import shutil
    import tempfile
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.storage import DatasetWriter, StoredDataset, \
        table_stats
    tmp = tempfile.mkdtemp(prefix="chip_smoke_stats_")
    try:
        t0 = time.perf_counter()
        w = DatasetWriter(tmp, "skewed", types, chunk_rows=CHUNK_ROWS,
                          encoding="raw")
        w.write_parts(env_from_numpy(env_np, "cpu"))
        stats = table_stats(StoredDataset(w.dir, device="cpu"))
    finally:
        shutil.rmtree(tmp)
    log(f"[{tag}] DatasetWriter.write_parts(chunk_rows={CHUNK_ROWS}, "
        f"raw) and table_stats: {time.perf_counter() - t0:.1f} s; parts "
        f"{ {k: v.rows for k, v in sorted(stats.items())} }")
    return stats


def pad_sites(env: dict) -> dict:
    return {k: b.resize(-(-b.capacity // SITES) * SITES)
            for k, b in env.items()}


def imbalance(metrics: dict, floor: int = 64) -> float:
    """Worst max/mean receive load over the exchange sites that moved at
    least ``floor`` rows (``benchmarks/skew.py:imbalance``)."""
    worst = 1.0
    for k, v in metrics.items():
        if k.startswith("part_rows_") and v >= floor:
            site = k.rsplit("_", 1)[1]
            worst = max(worst, metrics.get(f"part_max_{site}", 0) * SITES
                        / max(v, 1))
    return worst


def dist_report(tag: str, m: dict) -> None:
    keys = ("shuffle_rows", "overflow_rows", "shuffle_collectives",
            "exchanges", "exchanges_elided", "hypercube_exchanges",
            "replication_factor_x100", "bytes_replicated",
            "replicated_rows", "broadcast_bytes", "compact_dropped_rows")
    shown = {k: m[k] for k in keys if k in m}
    log(f"[{tag}] metrics {shown}, imbalance {imbalance(m):.3f}")


def run_dist(tag: str, cp, env: dict, mesh, **kw):
    """One plan through ``compile_program_distributed(use_kernel=True)``:
    the cold call (compile attempts included), then a warm call with
    every launch counter zeroed first. Returns (runner, outputs,
    metrics, launch counts)."""
    from repro_torch.core import codegen as CG
    from repro_torch.kernels import ops as kops
    t0 = time.perf_counter()
    runner, _, _ = CG.compile_program_distributed(
        cp, env, mesh, use_kernel=True, cap_factor=2.0, adaptive=True, **kw)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    out, m = runner(env)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    log(f"[{tag}] compile_program_distributed(use_kernel=True, {SITES} "
        f"sites, cap_factor=2.0, adaptive): cold {cold_s:.3f} s, warm "
        f"{warm_s * 1e3:.1f} ms, peak device memory of the warm call "
        f"{peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f} GiB held; "
        f"launches in the warm call {counts}")
    dist_report(tag, m)
    return runner, out, m, counts


def capture_largest(runner, env: dict, names) -> dict:
    """One more warm call, keeping the arguments of the largest call of
    each kernel in ``names`` (apart from the timed call, so that the
    kept arguments do not add to its peak memory)."""
    with CaptureLargestCalls(names) as cap:
        runner(env)
    return cap.args


def outputs_bit_equal(a: dict, b: dict, what: str) -> None:
    assert sorted(a) == sorted(b), (what, sorted(a), sorted(b))
    for name in a:
        bags_bit_equal(a[name], b[name], f"{what}: {name}")


def same_outputs_bitwise(a: dict, b: dict, tag: str, what: str) -> None:
    outputs_bit_equal(a, b, tag)
    log(f"[{tag}] bit-equal to {what} on {sorted(a)}")


def same_outputs_as_bags(a: dict, b: dict, tag: str, what: str) -> None:
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for name in a:
        assert torch.equal(sorted_rows(a[name]), sorted_rows(b[name])), name
    log(f"[{tag}] equal as bags to {what} on {sorted(a)}")


def plain_dist(cp, env: dict, mesh, **kw) -> dict:
    """The same distributed run with the kernels' plain versions."""
    from repro_torch.core import codegen as CG
    _, out, _ = CG.compile_program_distributed(
        cp, env, mesh, use_kernel=False, cap_factor=2.0, adaptive=True, **kw)
    return out


def rebind_heavy(tag: str, cp, runner, env: dict, stats: dict, part: str):
    """A warm call that binds a grown heavy-key set: no retrace."""
    from repro_torch.core import codegen as CG
    from repro_torch.core import skew as SK
    from repro_torch.core.plans import collect_plan_params
    name = sorted(n for n in collect_plan_params(cp.graph)
                  if n.startswith("__hk"))[0]
    set_a = SK.decide_heavy_keys(stats[part], "pid", SITES)
    set_b = sorted(set_a) + [max(set_a) + 1, max(set_a) + 2]
    t0 = CG.TRACE_STATS.get("traces", 0)
    out, m = runner(env, params={name: SK.pad_heavy(set_b)})
    torch.cuda.synchronize()
    retraces = CG.TRACE_STATS.get("traces", 0) - t0
    log(f"[{tag}] warm rebind of {name} from {set_a} to {set_b}: "
        f"{retraces} retraces, overflow_rows {m['overflow_rows']}")
    assert retraces == 0, retraces
    return out


def phase_skew(cols: dict, stats: dict, seed: int, dev):
    """Phase F: n2n TPC-H level 2 over Zipf-2.0 part keys on 8 sites,
    under the ``auto`` (planned SkewJoinP) and ``always`` (sampled heavy
    keys) plans at SF5, then ``off`` beside ``auto`` at SF1. Returns
    the records of segment_sum_first, member_mask, pack_rows and
    unpack_cols at the largest call of each in the warm ``auto`` call
    (segment_sum_first held as in G: bit-exact, or within the f32 bound
    with its per-segment row counts bit-exact), the warm ``auto``
    call's metrics and the mesh."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings, SkewJoinP, _walk_plan
    from repro_torch.core.unnesting import Catalog
    from repro_torch.exec.dist import device_mesh_1d
    types = skew_types()
    part_t, ncop2_t = types["Part"], types["NCOP2"]
    q = nested_to_nested_query(2, "NCOP2", ncop2_t)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]),
                         {"NCOP2": ncop2_t, "Part": part_t},
                         domain_elimination=True)
    oparts = sp.manifests["Q"].dicts[("corders", "oparts")]
    catalog = Catalog(unique_keys={"Part__F": ("pid",)})
    mesh = device_mesh_1d(SITES, device=dev)
    env_np = shred_ncop2(cols)
    t0 = time.perf_counter()
    want = numpy_oparts_groupby(env_np)
    log(f"[F skew] numpy group-by of {env_np['NCOP2__D_corders_oparts'][1].size}"
        f" lineitems: {time.perf_counter() - t0:.1f} s")
    env = pad_sites(env_from_numpy(env_np, dev))
    recs = []
    for plan in ("auto", "always"):
        tag = f"F skew {plan}"
        cp = CG.compile_program(sp, catalog,
                                skew_stats=stats if plan == "auto" else None,
                                skew_partitions=SITES)
        n_skew = sum(isinstance(s, SkewJoinP) for _, p in cp.plans
                     for s in _walk_plan(p))
        log(f"[{tag}] {n_skew} SkewJoinP in the plan")
        kw = dict(skew_default=(plan == "always"))
        runner, out, m, counts = run_dist(tag, cp, env, mesh, **kw)
        if plan == "auto":
            m_auto = m
        assert all(counts[k] > 0 for k in
                   ("member_mask", "pack_rows", "unpack_cols")), counts
        rows = check_oparts(out[oparts], env_np, want)
        log(f"[{tag}] {oparts}: {rows} groups equal to the numpy group-by")
        same_outputs_bitwise(out, plain_dist(cp, env, mesh, **kw), tag,
                             "the use_kernel=False run")
        local = CG.jit_program(cp, ExecSettings(use_kernel=True))(env)
        same_outputs_as_bags(out, local, tag, "a single-device jit_program "
                             "run")
        del local
        if plan == "auto":
            assert n_skew >= 1
            again = rebind_heavy(tag, cp, runner, env, stats,
                                 "NCOP2__D_corders_oparts")
            same_outputs_as_bags(out, again, tag, "the rebound call")
            del again
            profile_run(lambda: runner(env), tag)
            out = None
            recs = measure_kernels(capture_largest(
                runner, env, ("segment_sum_first", "member_mask",
                              "pack_rows", "unpack_cols")),
                counts, tag, f32_sums=True)
            for rec in recs:
                rec["launches_in"] = "F warm auto call"
        out = runner = None
        torch.cuda.empty_cache()
    del env
    torch.cuda.empty_cache()
    phase_skew_off(seed, dev, sp, catalog, mesh, oparts)
    return recs, m_auto, mesh


def phase_skew_off(seed: int, dev, sp, catalog, mesh, oparts) -> None:
    """F's ``off`` plan (no skew handling) with ``auto`` beside it, at
    the SF1 order count: at SF10 the hot key pins each site's bucket near
    5M rows, and the exchange after it sizes on that inflated capacity
    (PERF.md, section 6)."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    types = skew_types()
    env_np = shred_ncop2(gen_tpch_columns(SCALE_F_OFF, seed, ZIPF))
    stats = written_stats(env_np, {"NCOP2": types["NCOP2"],
                                   "Part": types["Part"]}, "F skew SF1")
    want = numpy_oparts_groupby(env_np)
    env = pad_sites(env_from_numpy(env_np, dev))
    for plan in ("off", "auto"):
        tag = f"F skew {plan} SF1"
        cp = CG.compile_program(sp, catalog,
                                skew_stats=stats if plan == "auto" else None,
                                skew_partitions=SITES)
        _, out, _, _ = run_dist(tag, cp, env, mesh)
        rows = check_oparts(out[oparts], env_np, want)
        log(f"[{tag}] {oparts}: {rows} groups equal to the numpy group-by")
        same_outputs_bitwise(out, plain_dist(cp, env, mesh), tag,
                             "the use_kernel=False run")
        del out
        torch.cuda.empty_cache()


def hypercube_query(types: dict):
    """benchmarks/hypercube.py's chain: Lineitem joins Part on the skewed
    pid and Orders on oid; revenue summed per order date."""
    from repro_torch.core import nrc as N
    L = N.Var("Lineitem", types["Lineitem"])
    P = N.Var("Part", types["Part"])
    O = N.Var("Orders", types["Orders"])  # noqa: E741
    inner = N.for_in("l", L, lambda l:
        N.for_in("p", P, lambda p:
            N.IfThen(l.pid.eq(p.pid),
                N.for_in("o", O, lambda o:
                    N.IfThen(l.oid.eq(o.oid),
                        N.Singleton(N.record(odate=o.odate,
                                             total=l.qty * p.price)))))))
    return N.SumBy(inner, keys=("odate",), values=("total",))


def revenue_by_date(env_np: dict):
    """Independent float64 reference for G: odate -> (revenue, rows,
    sum of |term|), as arrays sorted by odate."""
    li = env_np["Lineitem__F"][0]
    part = env_np["Part__F"][0]
    orders = env_np["Orders__F"][0]
    term = li["qty"] * part["price"][li["pid"] - 1]
    odate = orders["odate"][li["oid"] - 1]
    dates, inv = np.unique(odate, return_inverse=True)
    return (dates, np.bincount(inv, weights=term),
            np.bincount(inv), np.bincount(inv, weights=np.abs(term)))


def check_revenue(out_bag, want, exact: bool, key: str = "odate") -> float:
    """The output's rows against ``revenue_by_date`` (or another group-by
    on ``key`` with its return shape): exactly, or within the worst-case
    bound of an f32 sum of the group's terms, n_g * 2^-24 * sum |x|.
    Returns the largest error over the bound."""
    dates, total, n_g, abs_sum = want
    v = out_bag.valid.cpu().numpy()
    got_d = out_bag.data[key].cpu().numpy()[v]
    got_t = out_bag.data["total"].cpu().numpy()[v]
    order = np.argsort(got_d)
    assert np.array_equal(got_d[order], dates), (got_d.size, dates.size)
    err = np.abs(got_t[order] - total)
    if exact:
        assert np.array_equal(got_t[order], total), float(err.max())
        return 0.0
    bound = n_g * 2.0 ** -24 * abs_sum
    assert (err <= bound).all(), float((err - bound).max())
    return float((err / np.maximum(bound, 1e-300)).max())


def phase_hypercube(cols: dict, stats: dict, dev) -> list:
    """Phase G: the HyperCube 3-relation chain over 8 sites at SF5,
    under ``hypercube`` (one replicating round) and ``cascade``. Returns
    the record of replicate_scatter at its largest call in the warm
    ``hypercube`` call."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import MultiJoinP, _walk_plan
    from repro_torch.core.unnesting import Catalog
    from repro_torch.exec.dist import device_mesh_1d
    all_types = skew_types()
    types = {k: all_types[k] for k in ("Lineitem", "Part", "Orders")}
    q = hypercube_query(types)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]), types,
                         domain_elimination=True)
    top = sp.manifests["Q"].top
    catalog = Catalog(unique_keys={"Part__F": ("pid",),
                                   "Orders__F": ("oid",)})
    mesh = device_mesh_1d(SITES, device=dev)
    env_np = flat_tpch(cols)
    want = revenue_by_date(env_np)
    env = pad_sites(env_from_numpy(env_np, dev))
    recs = []
    for plan in ("hypercube", "cascade"):
        tag = f"G hypercube {plan}"
        cp = CG.compile_program(sp, catalog, skew_stats=stats,
                                skew_partitions=SITES,
                                hypercube_mode="auto" if plan == "hypercube"
                                else "off")
        n_mj = sum(isinstance(s, MultiJoinP) for _, p in cp.plans
                   for s in _walk_plan(p))
        log(f"[{tag}] {n_mj} MultiJoinP in the plan")
        runner, out, m, counts = run_dist(tag, cp, env, mesh)
        worst = check_revenue(out[top], want, exact=False)
        log(f"[{tag}] use_kernel=True: {want[0].size} dates within the f32 "
            f"bound n_g * 2^-24 * sum|x| of the numpy float64 group-by "
            f"(largest error {worst:.3g} of it)")
        del out
        recs_all = measure_kernels(
            capture_largest(runner, env, SHUFFLE_KERNELS + JOIN_KERNELS),
            counts, tag, f32_sums=True)
        if plan == "hypercube":
            assert n_mj >= 1
            assert all(counts[k] > 0 for k in
                       ("replicate_scatter", "member_mask")), counts
            again = rebind_heavy(tag, cp, runner, env, stats, "Lineitem__F")
            check_revenue(again[top], want, exact=False)
            del again
            profile_run(lambda: runner(env), tag)
            recs = [r for r in recs_all if r["name"] == "replicate_scatter"]
            for rec in recs:
                rec["launches_in"] = "G warm hypercube call"
        else:
            assert n_mj == 0
        del runner
        torch.cuda.empty_cache()
        plain = plain_dist(cp, env, mesh)
        check_revenue(plain[top], want, exact=True)
        log(f"[{tag}] use_kernel=False: {want[0].size} dates equal to the "
            f"numpy float64 group-by")
        del plain
        torch.cuda.empty_cache()
    return recs


def phase_distributed(seed: int, dev):
    """Phases F and G over one Zipf-2.0 draw at the SF5 order count,
    written once for its statistics. Returns the records and F's data,
    statistics, warm ``auto`` metrics and mesh, for phase M."""
    from types import SimpleNamespace
    t0 = time.perf_counter()
    cols = gen_tpch_columns(SCALE_F, seed, ZIPF)
    head = cols["li_pid"][:1 << 22]
    hot = np.bincount(head, minlength=4)[1:4] / head.size
    log(f"[F/G data] scale={SCALE_F} orders, Zipf {ZIPF} part keys, seed="
        f"{seed}: {cols['li_oid'].size} lineitems, "
        f"{cols['part_pid'].size} parts ({time.perf_counter() - t0:.1f} s); "
        f"share of pid 1, 2, 3 in the first 2^22 lineitems "
        f"{np.round(hot, 4).tolist()}")
    env_np = dict(shred_ncop2(cols))
    env_np.update(flat_tpch(cols))
    stats = written_stats(env_np, skew_types(), "F/G data")
    del env_np
    recs, m_auto, mesh = phase_skew(cols, stats, seed, dev)
    torch.cuda.empty_cache()
    with expandable_segments():
        recs += phase_hypercube(cols, stats, dev)
    return recs, SimpleNamespace(cols=cols, stats=stats, metrics=m_auto,
                                 mesh=mesh)


# ---------------------------------------------------------------------------
# phase M: EXPLAIN ANALYZE, stats feedback, batched execution and the
# fault-tolerant ServingRuntime, over D's and F's data
# ---------------------------------------------------------------------------

M_MIN_QTY = (1.0, 7.0, 13.0, 19.0, 25.0, 31.0, 37.0, 43.0)  # 8 bindings
M_OPARTS = "Q__D_corders_oparts"
# the kernels phase M's paths launch: the operators', the shuffle's on F's
# mesh (member_mask where the skew hints plan a SkewJoinP) and the
# decoders' on D's chunks (bitunpack only where a chunk is bitpacked)
M_KERNELS = JOIN_KERNELS + ("member_mask", "pack_rows", "unpack_cols",
                            "rle_expand", "delta_unpack", "dict_gather")


def family_program(min_qty: float):
    """B's n2n query at level 2 with one liftable constant: only the
    lineitems of at least ``min_qty`` join Part."""
    from repro_torch.core import nrc as N
    part_t, ncop2_t = tpch_types()
    P = N.Var("Part", part_t)
    X = N.Var("NCOP2", ncop2_t)

    def agg(ops):
        inner = N.for_in("op", ops, lambda op:
            N.for_in("p", P, lambda p:
                N.IfThen(N.BoolOp("&&", op.pid.eq(p.pid),
                                  op.qty.ge(N.Const(min_qty, N.REAL))),
                         N.Singleton(N.record(pname=p.pname,
                                              total=op.qty * p.price)))))
        return N.SumBy(inner, keys=("pname",), values=("total",))

    q = N.for_in("x", X, lambda x: N.Singleton(N.record(
        cname=x.cname,
        corders=N.for_in("co", x.corders, lambda co: N.Singleton(N.record(
            odate=co.odate, oparts=agg(co.oparts)))))))
    return N.Program([N.Assignment("Q", q)])


def family_want(env_np: dict, min_qty: float):
    """The numpy group-by of ``family_program(min_qty)``'s oparts."""
    li, valid = env_np["NCOP2__D_corders_oparts"]
    keep = li["qty"] >= min_qty
    sub = dict(env_np)
    sub["NCOP2__D_corders_oparts"] = ({c: a[keep] for c, a in li.items()},
                                      valid[keep])
    return numpy_oparts_groupby(sub)


def fresh_env(env: dict) -> dict:
    """The bags of ``env`` in a new dict, each a new FlatBag of the same
    tensors: ``explain_analyze`` writes its outputs into the dict it is
    given and leaves scan memos on the bags' props, as the reference
    does."""
    from repro_torch.columnar.table import FlatBag
    return {k: FlatBag(b.data, b.valid) for k, b in env.items()}


def explain_tree(res) -> list:
    """An EXPLAIN ANALYZE result's trees as JSON, wall times aside:
    operators, labels, rows out and in, estimates, signatures, sites
    and meters."""
    def strip(node):
        node = dict(node)
        node.pop("wall_ms")
        node["children"] = [strip(c) for c in node["children"]]
        return node
    blob = json.loads(json.dumps(res.to_json()))
    return [(a["name"], strip(a["plan"])) for a in blob["assignments"]]


def explain_both(tag: str, run):
    """``run(use_kernel)`` -> an ExplainResult, with the kernels and
    without: equal trees and bit-equal outputs (each run shreds from
    the same fresh-name counter, so both name their columns alike).
    Returns the kernel run."""
    from repro_torch.core import nrc as N
    start = N._counter[0]
    t0 = time.perf_counter()
    res = run(True)
    wall = time.perf_counter() - t0
    N._counter[0] = start
    plain = run(False)
    assert explain_tree(res) == explain_tree(plain), tag
    outputs_bit_equal(res.outputs, plain.outputs, tag)
    log(f"[{tag}] explain_analyze(use_kernel=True): {len(res.nodes())} "
        f"operators in {len(res.roots)} assignments, compile "
        f"{res.compile_ms:.1f} ms, run {res.total_ms:.1f} ms ({wall:.2f} s "
        f"in all); operators, rows out and in and meters equal to the "
        f"use_kernel=False run's, every output bit-equal to it")
    return res


def explain_report(tag: str, res, head: int = 12) -> None:
    unit = "trace_ms" if res.distributed else "wall_ms"
    top = sorted(res.nodes(), key=lambda n: -n.wall_ms)[:5]
    log(f"[{tag}] the five operators with the most {unit} (a subtree's "
        f"time holds its children's): " + "; ".join(
            f"#{n.id} {n.op} {n.wall_ms:.1f} ms, rows {n.rows_out}"
            for n in top))
    for line in res.pretty().split("\n")[:head]:
        log(f"[{tag}]   {line[:200]}")


def m_execute_many(env_np: dict, types: dict, catalog, dev):
    """M execute_many: the family's 8 bindings in one ``execute_many``
    over D's data in memory, each output bit-equal to its own
    ``execute``; then ``ServingRuntime.submit_many`` coalesces them (one
    batch through ``execute_many``), and a fresh runtime's
    ``warm_replay`` builds its all-invalid bags on the card, after which
    the next request rebuilds no plan. Returns (env, answers)."""
    import shutil
    import tempfile
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core.plans import ExecSettings
    from repro_torch.serve import QueryRequest, QueryService, ServingRuntime
    tag = "M execute_many"
    env = env_from_numpy(env_np, dev)
    progs = [family_program(q) for q in M_MIN_QTY]

    def service():
        return QueryService(types, catalog=catalog,
                            settings=ExecSettings(use_kernel=True))

    svc = service()
    t0 = time.perf_counter()
    outs = svc.execute_many(progs, env)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    traces = CG.TRACE_STATS.get("traces", 0)
    t0 = time.perf_counter()
    outs = svc.execute_many(progs, env)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    rebuilds = CG.TRACE_STATS.get("traces", 0) - traces
    t0 = time.perf_counter()
    singles = [svc.execute(p, env) for p in progs]
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    stats = dict(svc.stats)
    for q, out, single in zip(M_MIN_QTY, outs, singles):
        outputs_bit_equal(out, single, f"{tag} min_qty {q}")
    for q, out in ((M_MIN_QTY[0], outs[0]), (M_MIN_QTY[-1], outs[-1])):
        rows = check_oparts(out[M_OPARTS], None, family_want(env_np, q))
        log(f"[{tag}] min_qty {q}: {M_OPARTS} {rows} groups equal to the "
            f"numpy group-by")
    log(f"[{tag}] {len(progs)} bindings (qty >= {list(M_MIN_QTY)}): cold "
        f"{cold_s:.3f} s; warm batch {batch_ms:.1f} ms against "
        f"{single_ms:.1f} ms for {len(progs)} separate execute calls "
        f"(information only: the batch runs the warm executable once a "
        f"binding); plan rebuilds in the warm batch {rebuilds}; stats "
        f"{stats}; every output bit-equal to its own execute")
    assert rebuilds == 0 and stats["batch_calls"] == 2, (rebuilds, stats)
    assert stats["misses"] == 1, stats
    del singles
    tmp = tempfile.mkdtemp(prefix="chip_smoke_manifest_")
    try:
        man = os.path.join(tmp, "plans.json")
        rt = ServingRuntime(service(), manifest_path=man, device=dev)
        rs = rt.submit_many([QueryRequest(p, env) for p in progs])
        assert all(r.ok for r in rs), [r.error for r in rs]
        for q, r, out in zip(M_MIN_QTY, rs, outs):
            outputs_bit_equal(r.outputs, out, f"{tag} submit_many {q}")
        assert rt.stats["batches"] == 1 and rt.stats["coalesced"] == 8, \
            dict(rt.stats)
        del rs
        svc2 = service()
        rt2 = ServingRuntime(svc2, manifest_path=man, device=dev)
        t0 = time.perf_counter()
        replayed = rt2.warm_replay()
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        traces = CG.TRACE_STATS.get("traces", 0)
        r = rt2.submit(QueryRequest(progs[3], env))
        rebuilt = CG.TRACE_STATS.get("traces", 0) - traces
        assert r.ok and replayed == 1 and rebuilt == 0, \
            (r.error, replayed, rebuilt)
        outputs_bit_equal(r.outputs, outs[3], f"{tag} after warm_replay")
        log(f"[{tag}] ServingRuntime.submit_many of the 8: batches "
            f"{rt.stats['batches']}, coalesced {rt.stats['coalesced']}, "
            f"every answer bit-equal to execute_many's; a fresh runtime's "
            f"warm_replay replayed {replayed} family on all-invalid bags "
            f"on {dev} in {replay_s:.2f} s, and the next request made "
            f"{rebuilt} plan rebuilds (an executable keys on each bag's "
            f"device, dtypes and capacity), its answer bit-equal")
    finally:
        shutil.rmtree(tmp)
    return env, outs


def m_explain(stored, dist, env, dev) -> None:
    """M explain: ``explain_analyze`` with and without the kernels on
    the family in memory, over D's stored dataset, and on F's mesh
    (skew ``auto``), where the exchanges' rows shipped and imbalance
    equal phase F's warm ``auto`` metrics."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import nrc as N
    from repro_torch.obs import explain_analyze
    from repro_torch.storage import StoredDataset
    prog = family_program(M_MIN_QTY[2])
    res = explain_both("M explain local", lambda k: explain_analyze(
        prog, fresh_env(env), stored.types, catalog=stored.catalog,
        use_kernel=k))
    explain_report("M explain local", res)
    del res
    ds = StoredDataset(stored.dir, device=dev)
    res = explain_both("M explain stored", lambda k: explain_analyze(
        prog, ds, stored.types, catalog=stored.catalog, use_kernel=k))
    meters = {}
    for n in res.nodes():
        if not n.children:
            for k, v in n.meters.items():
                meters[k] = meters.get(k, 0) + v
    log(f"[M explain stored] the scans' meters summed: {meters}")
    assert meters.get("storage.bytes_read", 0) > 0 \
        and meters.get("storage.bytes_decoded", 0) > 0, meters
    explain_report("M explain stored", res, head=10)
    del res
    part_t, ncop2_t = tpch_types()
    types = skew_types()
    fprog = N.Program([N.Assignment("Q", nested_to_nested_query(
        2, "NCOP2", ncop2_t))])
    fenv = pad_sites(env_from_numpy(shred_ncop2(dist.cols), dev))
    res = explain_both("M explain mesh", lambda k: explain_analyze(
        fprog, fresh_env(fenv), {"NCOP2": ncop2_t, "Part": part_t},
        catalog=stored.catalog, mesh=dist.mesh, skew_stats=dist.stats,
        skew_partitions=SITES, use_kernel=k))
    del fenv
    m = res.metrics
    shipped_keys = sorted(k for k in dist.metrics
                          if k.startswith(("part_rows_", "part_max_")))
    assert {k: m.get(k) for k in shipped_keys} \
        == {k: dist.metrics[k] for k in shipped_keys}, (m, dist.metrics)
    assert m.get("overflow_rows", 0) == 0 \
        and m.get("compact_dropped_rows", 0) == 0, m
    shipped = sum(r.meters.get("rows_shipped", 0) for r in res.roots)
    want_shipped = sum(v for k, v in dist.metrics.items()
                       if k.startswith("part_rows_"))
    worst = max(n.meters.get("imbalance", 1.0) for n in res.nodes())
    want_worst = max([round(dist.metrics[f"part_max_{k[10:]}"] * SITES / v, 2)
                      for k, v in dist.metrics.items()
                      if k.startswith("part_rows_") and v] + [1.0])
    assert shipped == want_shipped and worst == want_worst, \
        (shipped, want_shipped, worst, want_worst)
    skew = res.find("SkewJoinP")
    log(f"[M explain mesh] {len(skew)} SkewJoinP; the exchange nodes "
        f"shipped {shipped} rows in all, the worst imbalance {worst}, "
        f"equal to phase F's warm auto metrics (part_rows_*/part_max_* "
        f"{ {k: dist.metrics[k] for k in shipped_keys} }); no row "
        f"dropped at cap_factor 2.0 without the adaptive sizing")
    assert skew, "no SkewJoinP on F's mesh"
    explain_report("M explain mesh", res, head=10)
    del res
    torch.cuda.empty_cache()


def m_feedback(stored, env, dev) -> None:
    """M feedback: a ``QueryService(feedback=StatsFeedback(),
    cost_mode="auto")`` compiles cold and measures its inputs; the
    explain result's per-operator rows go back into the estimator, and
    one round lands the Q-error; the measured rows go into a copy of D's
    footer, which surfaces them through ``TableStats.meters``."""
    import shutil
    from repro_torch.core.plans import ExecSettings
    from repro_torch.obs import (StatsFeedback, explain_analyze,
                                 record_observed_stats)
    from repro_torch.serve import QueryService
    from repro_torch.storage import StoredDataset, table_stats
    from repro_torch.storage.format import FOOTER
    tag = "M feedback"
    prog = family_program(M_MIN_QTY[2])
    ds = StoredDataset(stored.dir, device=dev)
    stats = table_stats(ds)
    fb = StatsFeedback()
    svc = QueryService(stored.types, catalog=stored.catalog,
                       settings=ExecSettings(use_kernel=True), feedback=fb,
                       cost_mode="auto")
    t0 = time.perf_counter()
    svc.execute(prog, env)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    assert fb.rows == {k: ds.parts[k].rows for k in fb.rows}, fb.rows
    kw = dict(catalog=stored.catalog, skew_stats=stats, cost_mode="auto",
              hypercube_mode="off", use_kernel=True)
    r1 = explain_analyze(prog, fresh_env(env), stored.types, **kw)
    harvested = fb.record_explain(r1)
    r2 = explain_analyze(prog, fresh_env(env), stored.types,
                         observed_rows=fb.node_rows, **kw)
    s1, s2 = r1.qerror_summary(), r2.qerror_summary()
    outputs_bit_equal(r1.outputs, r2.outputs, tag)
    svc.evict()
    svc.execute(prog, env)             # re-compiles from the observed rows
    est = next(iter(svc._cache.values())).estimates
    log(f"[{tag}] QueryService(feedback=StatsFeedback(), cost_mode=auto) "
        f"cold in {cold_s:.3f} s measured {fb.rows}; record_explain "
        f"harvested {harvested} operators; Q-error before {s1}, after one "
        f"round {s2}; the re-compile from the observed rows holds "
        f"{sum(v is not None for v in est.values())} estimates")
    assert harvested > 0 and s2["qerr_max"] is not None \
        and s2["qerr_max"] <= 4.0, (harvested, s2)
    copy = os.path.join(stored.tmp, "footer_copy")
    os.makedirs(copy)
    shutil.copy(os.path.join(stored.dir, FOOTER), copy)
    n = record_observed_stats(copy, fb.part_meters())
    reopened = StoredDataset(copy, device=dev)
    meters = {p: reopened.parts[p].stats().meters for p in sorted(fb.rows)}
    assert n == len(fb.rows) and all(
        meters[p]["rows"] == fb.rows[p] for p in fb.rows), meters
    log(f"[{tag}] record_observed_stats into a copy of D's footer: {n} "
        f"parts; reopened, TableStats.meters {meters}")


def chunk_calls_of(run) -> int:
    """How often ``run`` reaches the ``storage.chunk`` fault site (a
    rule that never fires makes the registry count calls)."""
    from repro_torch.faults import FAULTS
    FAULTS.reset()
    FAULTS.arm("storage.chunk", "count_only", first=1 << 62)
    run()
    n = FAULTS.calls.get("storage.chunk", 0)
    FAULTS.reset()
    return n


def m_chaos(stored, dist, answers: list, dev) -> None:
    """M chaos (``benchmarks/serving.py``'s chaos run at SF5): a
    ``ServingRuntime`` over D's stored dataset and another over F's mesh
    with its single-device twin, under ``arm_chaos_schedule``: every
    class fires, no request escapes, every answer is bit-equal to the
    fault-free one; then a fresh runtime warm-replays the manifest and
    the next request rebuilds no plan."""
    import shutil
    import tempfile
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import skew as SK
    from repro_torch.core.plans import ExecSettings
    from repro_torch.errors import FooterError
    from repro_torch.faults import FAULTS
    from repro_torch.serve import QueryRequest, QueryService, ServingRuntime
    from repro_torch.serve.faults import arm_chaos_schedule, chaos_coverage
    from repro_torch.storage import StoredDataset
    tag = "M chaos"
    progs = [family_program(q) for q in M_MIN_QTY]
    types = stored.types

    def service(**kw):
        return QueryService(types, catalog=stored.catalog,
                            settings=ExecSettings(use_kernel=True), **kw)

    # fault-free: D's answers are execute_many's (in memory, the same
    # capacity classes); F's from a clean mesh service and a clean twin
    clean_ds = StoredDataset(stored.dir, device=dev)
    clean = service()
    outputs_bit_equal(clean.execute_stored(progs[0], clean_ds), answers[0],
                      f"{tag} fault-free stored")
    n_chunks = chunk_calls_of(lambda: clean.execute_stored(progs[1],
                                                           clean_ds))
    del clean
    heavy = SK.decide_heavy_keys(dist.stats["NCOP2__D_corders_oparts"],
                                 "pid", SITES)
    hints = {"NCOP2__D_corders_oparts": {"pid": heavy}}
    fenv = pad_sites(env_from_numpy(shred_ncop2(dist.cols), dev))
    mesh_kw = dict(mesh=dist.mesh, skew_partitions=SITES,
                   dist_kwargs=dict(adaptive=True, cap_factor=2.0))
    want_f = [service(**mesh_kw).execute(progs[0], fenv, skew_hints=hints)]
    twin_clean = service()
    want_f += [twin_clean.execute(p, fenv, skew_hints=hints)
               for p in progs[1:3]]
    del twin_clean
    rows = check_oparts(want_f[0][M_OPARTS], None,
                        family_want(shred_ncop2(dist.cols), M_MIN_QTY[0]))
    log(f"[{tag}] fault-free: D's first answer bit-equal to execute_many's; "
        f"F's on the mesh ({len(heavy)} heavy keys hinted) {rows} groups "
        f"equal to the numpy group-by; one stored request reaches the "
        f"storage.chunk site {n_chunks} times")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_chaos_")
    try:
        man = os.path.join(tmp, "plans.json")
        arm_chaos_schedule(0, chunk_calls=n_chunks)
        try:
            StoredDataset(stored.dir, device=dev)
            raise AssertionError("the injected footer corruption was not hit")
        except FooterError:
            pass
        ds = StoredDataset(stored.dir, device=dev)
        rt = ServingRuntime(service(), manifest_path=man, seed=0,
                            verify_reads=True, device=dev)
        t0 = time.perf_counter()
        stored_resp = []
        for q, p, want in zip(M_MIN_QTY, progs, answers):
            r = rt.submit(QueryRequest(p, ds))
            assert r.ok, (q, r.error)
            outputs_bit_equal(r.outputs, want, f"{tag} stored {q}")
            stored_resp.append((r.retries, r.degraded))
            r.outputs = None
        stored_s = time.perf_counter() - t0
        twin = service()
        rt_d = ServingRuntime(service(**mesh_kw), local_fallback=twin,
                              seed=0)
        t0 = time.perf_counter()
        dist_resp = []
        for q, p, want in zip(M_MIN_QTY, progs[:3], want_f):
            r = rt_d.submit(QueryRequest(p, fenv, skew_hints=hints))
            assert r.ok, (q, r.error)
            outputs_bit_equal(r.outputs, want, f"{tag} mesh {q}")
            dist_resp.append((r.retries, r.degraded))
            r.outputs = None
        dist_s = time.perf_counter() - t0
        coverage = chaos_coverage()
        fired = dict(FAULTS.stats)
        FAULTS.reset()
        log(f"[{tag}] arm_chaos_schedule(0, chunk_calls={n_chunks}): "
            f"{sum(n > 0 for n in coverage.values())} of "
            f"{len(coverage)} classes injected "
            f"{ {f'{s}:{k}': n for (s, k), n in coverage.items()} }; "
            f"0 escaped exceptions; every answer bit-equal to the "
            f"fault-free one")
        log(f"[{tag}] stored runtime, 8 requests in {stored_s:.2f} s "
            f"((retries, degraded) each: {stored_resp}): stats "
            f"{dict(rt.stats)}, latency {rt.latency_percentiles()}")
        log(f"[{tag}] mesh runtime, 3 requests in {dist_s:.2f} s "
            f"({dist_resp}): stats {dict(rt_d.stats)}, latency "
            f"{rt_d.latency_percentiles()}; FAULTS.stats {fired}")
        assert all(n > 0 for n in coverage.values()), coverage
        assert rt_d.stats["degraded_imbalance"] >= 1, dict(rt_d.stats)
        del rt_d, twin, fenv, want_f
        torch.cuda.empty_cache()
        rt2 = ServingRuntime(service(), manifest_path=man, seed=0,
                             device=dev)
        t0 = time.perf_counter()
        replayed = rt2.warm_replay()
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        traces = CG.TRACE_STATS.get("traces", 0)
        r = rt2.submit(QueryRequest(progs[5], StoredDataset(stored.dir,
                                                            device=dev)))
        rebuilt = CG.TRACE_STATS.get("traces", 0) - traces
        assert r.ok and replayed >= 1 and rebuilt == 0, \
            (r.error, replayed, rebuilt)
        outputs_bit_equal(r.outputs, answers[5], f"{tag} after warm_replay")
        log(f"[{tag}] restart: warm_replay replayed {replayed} family in "
            f"{replay_s:.2f} s; the next request made {rebuilt} plan "
            f"rebuilds, its answer bit-equal; chaos_coverage "
            f"{ {f'{s}:{k}': n for (s, k), n in coverage.items()} }")
    finally:
        FAULTS.reset()
        shutil.rmtree(tmp)


def phase_serving(stored, dist, dev) -> None:
    """Phase M: batched execution, EXPLAIN ANALYZE, stats feedback and
    the fault-tolerant runtime over D's and F's SF5 data, with every
    launch counter zeroed first; the kernels of its paths launched."""
    import gc
    from repro_torch.kernels import ops as kops
    from repro_torch.storage.format import read_footer
    held = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    env, answers = m_execute_many(stored.env_np, stored.types,
                                  stored.catalog, dev)
    m_explain(stored, dist, env, dev)
    m_feedback(stored, env, dev)
    del env
    torch.cuda.empty_cache()
    m_chaos(stored, dist, answers, dev)
    counts = kops.launch_counts()
    packed = any(e.get("codec") == "bitpack" for pm in read_footer(
        stored.dir).parts.values() for ch in pm.chunks
        for e in ch.encodings.values())
    log(f"[M launches] phase M's paths (counters zeroed before them, read "
        f"after): {counts}; bitunpack {'expected' if packed else 'not expected: no chunk of D is bitpacked'}, "
        f"replicate_scatter not expected (no family of M plans a "
        f"HyperCube join)")
    want = M_KERNELS + (("bitunpack",) if packed else ())
    assert all(counts[k] > 0 for k in want), counts
    # the retried requests' tracebacks and the operators' cached sorts
    # keep device tensors in reference cycles until a collection
    del answers
    gc.collect()
    left = torch.cuda.memory_allocated() - held
    log(f"[M memory] device memory held after phase M, after a garbage "
        f"collection: {left / 2 ** 20:.1f} MiB above the "
        f"{held / 2 ** 30:.2f} GiB held before it")
    assert left < 1 << 30, left


# ---------------------------------------------------------------------------
# phase H: Fig. 7, STANDARD vs SHRED (+UNSHRED)
# ---------------------------------------------------------------------------

def tpch_hierarchy(cols: dict, seed: int) -> dict:
    """``gen_tpch_columns``' tables plus what Fig. 7's level 3 needs, with
    ``gen_tpch``'s distributions: each customer's nation key uniform in
    1..25 (drawn from a second stream, so the other columns stay those
    of phases B-G), and the 25-row Nation table."""
    rng = np.random.RandomState(seed + 1)
    t = dict(cols)
    t["cust_nid"] = rng.randint(1, 26, cols["cust_cname"].size).astype(
        np.int64)
    nid = np.arange(1, 26, dtype=np.int64)
    t.update(nat_nid=nid, nat_rid=nid % 5 + 1, nat_nname=30000 + nid)
    return t


def _ones(n: int) -> np.ndarray:
    return np.ones(n, dtype=np.bool_)


def fig7_flat(t: dict) -> dict:
    """The flat tables of Fig. 7's f2n family (and Part) as numpy
    columns, named as ``columnar_shred_inputs`` names them."""
    env = flat_tpch(t)
    n_cust = t["cust_cname"].size
    env["Customer__F"] = ({"cid": np.arange(1, n_cust + 1, dtype=np.int64),
                           "nid": t["cust_nid"], "cname": t["cust_cname"]},
                          _ones(n_cust))
    env["Nation__F"] = ({"nid": t["nat_nid"], "rid": t["nat_rid"],
                         "nname": t["nat_nname"]}, _ones(25))
    return env


def shred_nested(t: dict, levels: int) -> dict:
    """The shredded parts of NCOP<levels>, the value f2n at ``levels``
    gives (orders -> lineitems; customers -> ...; nations -> customers ->
    ...), labelled as ``interpreter.shred_value`` labels them: each
    dictionary's rows in depth-first order, a bag's label the row counter
    of its dictionary (``shred_ncop2`` is level 2)."""
    n_orders, n_cust = t["ord_cid"].size, t["cust_cname"].size
    cust_perm = np.argsort(t["cust_nid"], kind="stable")
    if levels == 1:
        ord_perm = np.arange(n_orders)
        ord_label = None
    elif levels == 2:
        ord_perm = np.argsort(t["ord_cid"], kind="stable")
        ord_label = t["ord_cid"][ord_perm] - 1
    else:
        cust_pos = np.empty(n_cust, np.int64)
        cust_pos[cust_perm] = np.arange(n_cust)
        key = cust_pos[t["ord_cid"] - 1]
        ord_perm = np.argsort(key, kind="stable")
        ord_label = key[ord_perm]
    per_order = np.bincount(t["li_oid"] - 1, minlength=n_orders)
    li_start = np.concatenate([[0], np.cumsum(per_order)[:-1]])
    cnt = per_order[ord_perm]
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    rows = np.repeat(li_start[ord_perm] - first, cnt) + np.arange(cnt.sum())
    name = f"NCOP{levels}"
    items = ({"pid": t["li_pid"][rows], "qty": t["li_qty"][rows],
              "label": np.repeat(np.arange(n_orders, dtype=np.int64), cnt)},
             _ones(rows.size))
    orders = {"odate": t["ord_odate"][ord_perm],
              "oparts": np.arange(n_orders, dtype=np.int64)}
    if levels == 1:
        return {f"{name}__F": (orders, _ones(n_orders)),
                f"{name}__D_oparts": items}
    orders["label"] = ord_label
    if levels == 2:
        return {f"{name}__F": ({"cname": t["cust_cname"],
                                "corders": np.arange(n_cust, dtype=np.int64)},
                               _ones(n_cust)),
                f"{name}__D_corders": (orders, _ones(n_orders)),
                f"{name}__D_corders_oparts": items}
    return {f"{name}__F": ({"nname": t["nat_nname"],
                            "ncusts": np.arange(25, dtype=np.int64)},
                           _ones(25)),
            f"{name}__D_ncusts": ({"cname": t["cust_cname"][cust_perm],
                                   "corders": np.arange(n_cust,
                                                        dtype=np.int64),
                                   "label": t["cust_nid"][cust_perm] - 1},
                                  _ones(n_cust)),
            f"{name}__D_ncusts_corders": (orders, _ones(n_orders)),
            f"{name}__D_ncusts_corders_oparts": items}


def n2f_groupby(t: dict, levels: int):
    """Independent float64 reference of n2f at ``levels``: key (odate,
    cname or nname) -> (sum of qty * price, rows, sum |term|), as arrays
    sorted by key."""
    term = t["li_qty"] * t["part_price"][t["li_pid"] - 1]
    order = t["li_oid"] - 1
    if levels == 1:
        key = t["ord_odate"][order]
    else:
        cust = t["ord_cid"][order] - 1
        key = t["cust_cname"][cust] if levels == 2 \
            else t["nat_nname"][t["cust_nid"][cust] - 1]
    keys, inv = np.unique(key, return_inverse=True)
    return (keys, np.bincount(inv, weights=term), np.bincount(inv),
            np.bincount(inv, weights=np.abs(term)))


def _bits64(a: torch.Tensor) -> torch.Tensor:
    return a.view(torch.int64) if a.dtype == torch.float64 \
        else a.to(torch.int64)


def nested_digest(parts: dict, ty) -> torch.Tensor:
    """A canonical form of the nested value held in ``parts`` ({path:
    FlatBag}, labels linking each dictionary to its parent), on the
    parts' device: every bag's rows hash bottom-up, a bag attribute
    standing for the order-free sum of its rows' hashes (0 for an empty
    bag), so that two routes that label their bags differently compare
    equal when they hold the same value. Returns the sorted hashes of
    the top-level rows."""
    from repro_torch.core import nrc as N
    from repro_torch.exec.hashing import GOLDEN, combine64, mix64

    def elem_of(path):
        cur = ty.elem
        for a in path:
            cur = dict(cur.fields)[a].elem
        return cur

    digests = {}                   # path -> (sorted labels, bag hashes)
    for path in sorted(parts, key=len, reverse=True):
        bag, elem = parts[path], elem_of(path)
        cols = []
        for name, fty in elem.fields:
            col = _bits64(bag.data[name])
            if isinstance(fty, N.BagT):
                labels, sums = digests[path + (name,)]
                if labels.numel() == 0:
                    col = torch.zeros_like(col)
                else:
                    pos = torch.searchsorted(labels, col)
                    pos_c = pos.clamp(max=labels.numel() - 1)
                    hit = (pos < labels.numel()) & (labels[pos_c] == col)
                    col = torch.where(hit, sums[pos_c], 0)
            cols.append(col)
        h = combine64(cols)[bag.valid]
        if path == ():
            return torch.sort(h).values
        lab = bag.data["label"].to(torch.int64)[bag.valid]
        labels, inv = torch.unique(lab, return_inverse=True)
        sums = torch.zeros_like(labels).index_add_(0, inv, mix64(h + GOLDEN))
        digests[path] = (labels, sums)
    raise AssertionError("no top-level part")


def parts_bytes(parts: dict) -> int:
    from repro_torch.figures.common import bag_bytes
    return sum(bag_bytes(b) for b in parts.values())


def timed_calls(run):
    """``run()`` cold, then warm with every launch counter zeroed and the
    peak memory reset first: (warm output, cold s, warm ms, peak bytes of
    the warm call above what was held before it, launch counts)."""
    from repro_torch.kernels import ops as kops
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    counts = kops.launch_counts()
    return (out, cold_s, warm_ms, torch.cuda.max_memory_allocated() - held,
            {k: counts[k] for k in JOIN_KERNELS})


def fig7_program(family: str, levels: int):
    """(query, nested input name or None, its type, input types) of one
    Fig. 7 point, built with ``repro_torch.figures.common``."""
    from repro_torch.data.generators import TPCH_TYPES
    from repro_torch.figures import common as FC
    if family == "f2n":
        return FC.flat_to_nested_query(levels), None, None, dict(TPCH_TYPES)
    nty = FC.flat_to_nested_query(levels).ty
    name = f"NCOP{levels}"
    build = FC.nested_to_nested_query if family == "n2n" \
        else FC.nested_to_flat_query
    return (build(levels, name, nty), name, nty,
            {**TPCH_TYPES, name: nty})


# Fig. 7 points where the reference's standard route drops rows: its
# outer joins of flat tables size their output at max(left, right)
# capacity, with no room for the rows of empty bags (a customer without
# orders, a nation without customers), and the overflow is discarded
# (ROADMAP.md queue 3). The port gives the reference's parts there
# (tests/test_torch_standard.py); the phase reports the difference.
STANDARD_GAP = {("f2n", 2), ("f2n", 3)}


def fig7_point(tag: str, family: str, levels: int, env_np: dict, t: dict,
               dev) -> dict:
    """One Fig. 7 point: the shredded route (``jit_program``; n2f sums
    its body's output with ``sum_by``), the standard route
    (``run_standard``) and, for f2n, the UNSHRED extra, each with
    use_kernel=True cold and warm; each route against its use_kernel=False
    run; the two routes against each other. Returns the warm times."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.exec import ops as X
    from repro_torch.figures.common import CATALOG
    from repro_torch.figures.tpch_nested import standard_plan
    q, name, nty, types = fig7_program(family, levels)
    n2f = family == "n2f"
    sp = M.shred_program(N.Program([N.Assignment(
        "QB" if n2f else "Q", q.bag_expr if n2f else q)]), types,
        domain_elimination=True)
    cp = CG.compile_program(sp, CATALOG)
    splan = standard_plan(q, name, nty)
    env = env_from_numpy(env_np, dev)
    exes = {uk: CG.jit_program(cp, ExecSettings(use_kernel=uk))
            for uk in (True, False)}

    def shred(uk):
        out = exes[uk](env)
        if n2f:
            return {(): X.sum_by(out["QB"], q.keys, q.values,
                                 use_kernel=uk)}
        man = sp.manifests["Q"]
        return {(): out[man.top], **{p: out[n] for p, n in
                                     man.dicts.items()}}

    def standard(uk):
        return CG.run_standard(splan, env, ExecSettings(use_kernel=uk))

    fields = f"assignments={len(sp.program.names())}"
    if family == "n2n":
        leaf = [n for n in sp.program.names() if "oparts" in n][-1]
        fields += f";localized_leaf={leaf}"
    res = {}
    for route, fn in (("shred", shred), ("standard", standard)):
        out, cold_s, warm_ms, peak, counts = timed_calls(lambda: fn(True))
        if (family, route) != ("f2n", "shred"):   # f2n's parts: no join
            assert all(counts.values()), (tag, route, counts)
        plain = fn(False)
        if n2f:
            key = q.keys[0]
            want = n2f_groupby(t, levels)
            worst = check_revenue(out[()], want, exact=False, key=key)
            check_revenue(plain[()], want, exact=True, key=key)
            check = (f"{int(want[0].size)} groups: use_kernel=False equal to "
                     f"the numpy float64 group-by, use_kernel=True within "
                     f"n_g 2^-24 sum|x| of it ({worst:.3g} of the bound)")
        else:
            assert list(out) == list(plain)
            for path in out:
                bags_bit_equal(out[path], plain[path], f"{tag} {path}")
            check = "bit-equal to the use_kernel=False run"
        res[route] = dict(out=plain, warm_ms=warm_ms, run=fn)
        log(f"[{tag}] {route}: cold {cold_s:.3f} s, warm {warm_ms:.1f} ms, "
            f"peak {peak / 2 ** 30:.2f} GiB, parts {parts_bytes(out)} bytes"
            f" ({ {str(p): b.capacity for p, b in out.items()} } rows), "
            f"launches {counts}; {check}")
        del out
    if family == "f2n":
        parts = res["shred"]["out"]
        torch.cuda.synchronize()
        _, _, warm_ms, peak, _ = timed_calls(lambda: CG.unshred_parts(parts))
        log(f"[{tag}] unshred_extra: warm {warm_ms:.1f} ms, peak "
            f"{peak / 2 ** 30:.2f} GiB")
    std, shr = res["standard"]["out"], res["shred"]["out"]
    log(f"[{tag}] {fields};out_bytes={parts_bytes(std)} (standard), "
        f"{parts_bytes(shr)} (shredded parts)")
    if n2f:
        assert torch.equal(sorted_rows(std[()]), sorted_rows(shr[()]))
        same = "the same rows"
    else:
        a, b = nested_digest(std, q.ty), nested_digest(shr, q.ty)
        equal = a.shape == b.shape and bool(torch.equal(a, b))
        if (family, levels) in STANDARD_GAP:
            same = ("the same nested value" if equal else
                    f"DIFFERENT values (the reference's known gap): "
                    f"{a.numel()} top-level rows against {b.numel()}; "
                    f"valid rows per part "
                    f"{ {str(p): int(x.valid.sum()) for p, x in std.items()} }"
                    f" against "
                    f"{ {str(p): int(x.valid.sum()) for p, x in shr.items()} }")
        else:
            assert equal, (tag, a.numel(), b.numel())
            same = "the same nested value"
    log(f"[{tag}] standard and shredded routes (use_kernel=False) give "
        f"{same}")
    return {r: res[r]["warm_ms"] for r in res}


def phase_fig7(seed: int, dev, scale: int = None, points=None) -> None:
    """Phase H: every Fig. 7 point at ``scale`` orders (SF1), then n2n
    level 2's standard route at phase B's order count beside its
    shredded route; a profile of the slowest standard-route point."""
    scale = scale or SCALE_H
    t0 = time.perf_counter()
    t = tpch_hierarchy(gen_tpch_columns(scale, seed), seed)
    log(f"[H fig7] scale={scale} orders, seed={seed}: "
        f"{t['li_oid'].size} lineitems, {t['part_pid'].size} parts, "
        f"{t['cust_cname'].size} customers, 25 nations (generated in "
        f"{time.perf_counter() - t0:.1f} s)")
    flat = fig7_flat(t)
    part = flat["Part__F"]
    slowest = (0.0, None)
    for family, levels in points or [(f, lv) for f in ("f2n", "n2n", "n2f")
                                     for lv in (1, 2, 3)]:
        tag = f"H {family}-L{levels}"
        env_np = flat if family == "f2n" else {**shred_nested(t, levels),
                                                "Part__F": part}
        ms = fig7_point(tag, family, levels, env_np, t, dev)
        log(f"[{tag}] standard / shredded warm: "
            f"{ms['standard'] / ms['shred']:.2f}x")
        if ms["standard"] > slowest[0]:
            slowest = (ms["standard"], (family, levels, env_np))
        torch.cuda.empty_cache()
    family, levels, env_np = slowest[1]
    profile_standard(f"H {family}-L{levels} standard", family, levels,
                     env_np, dev)


def profile_standard(tag: str, family: str, levels: int, env_np: dict,
                     dev) -> None:
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core.plans import ExecSettings
    from repro_torch.figures.tpch_nested import standard_plan
    q, name, nty, _ = fig7_program(family, levels)
    splan = standard_plan(q, name, nty)
    env = env_from_numpy(env_np, dev)

    def run():
        return CG.run_standard(splan, env, ExecSettings(use_kernel=True))

    run()
    profile_run(run, tag)
    del env
    torch.cuda.empty_cache()


def phase_fig7_large(cols: dict, dev, scale: int) -> None:
    """Phase H, n2n level 2 at ``scale`` orders (``cols``, phase B's
    distributions): ``run_standard`` beside the shredded
    ``jit_program``, use_kernel=True, the same nested value."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core.plans import ExecSettings
    from repro_torch.figures.common import CATALOG
    from repro_torch.figures.tpch_nested import standard_plan
    tag = f"H n2n-L2 at {scale} orders"
    q, name, nty, types = fig7_program("n2n", 2)
    env_np = shred_ncop2(cols)
    env = env_from_numpy(env_np, dev)
    sp = M.shred_program(N.Program([N.Assignment("Q", q)]), types,
                         domain_elimination=True)
    exe = CG.jit_program(CG.compile_program(sp, CATALOG),
                         ExecSettings(use_kernel=True))
    man = sp.manifests["Q"]
    out, cold_s, shred_ms, peak, counts = timed_calls(lambda: exe(env))
    shr = {(): out[man.top], **{p: out[n] for p, n in man.dicts.items()}}
    want = nested_digest(shr, q.ty)
    assert all(counts.values()), counts
    log(f"[{tag}] shredded jit_program: cold {cold_s:.3f} s, warm "
        f"{shred_ms:.1f} ms, peak {peak / 2 ** 30:.2f} GiB, parts "
        f"{parts_bytes(shr)} bytes, launches {counts}")
    del out, shr
    torch.cuda.empty_cache()
    splan = standard_plan(q, name, nty)
    std, cold_s, std_ms, peak, counts = timed_calls(
        lambda: CG.run_standard(splan, env, ExecSettings(use_kernel=True)))
    assert torch.equal(nested_digest(std, q.ty), want), tag
    assert all(counts.values()), counts
    log(f"[{tag}] run_standard: cold {cold_s:.3f} s, warm {std_ms:.1f} ms "
        f"({std_ms / shred_ms:.2f}x the shredded route), peak "
        f"{peak / 2 ** 30:.2f} GiB, out_bytes={parts_bytes(std)}, "
        f"launches {counts}; the same nested value as the shredded route")
    del std, env
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase I: Fig. 9, the biomedical pipeline
# ---------------------------------------------------------------------------

def gen_bio_shredded(n_samples: int, n_genes: int, seed: int,
                     n_conseq: int = 10) -> dict:
    """The shredded inputs of the biomedical pipeline, drawn in bulk from
    ``repro.data.generators.gen_biomedical``'s distributions (skew 0):
    1-5 mutations per sample, 0-4 candidate genes per mutation, 1-3
    consequences per candidate; CopyNumber and GeneExpression over every
    (sample, gene); 1-5 network edges per gene. Labels as
    ``interpreter.shred_value`` gives them (row counters, depth-first)."""
    rng = np.random.RandomState(seed)
    S, G = n_samples, n_genes
    i64 = lambda a: np.asarray(a, dtype=np.int64)  # noqa: E731
    sample = np.arange(1, S + 1, dtype=np.int64)
    n_mut = rng.randint(1, 6, S)
    M_ = int(n_mut.sum())
    n_cand = rng.randint(0, 5, M_)
    C = int(n_cand.sum())
    n_cons = rng.randint(1, 4, C)
    K = int(n_cons.sum())
    n_edge = rng.randint(1, 6, G)
    E = int(n_edge.sum())
    pair_s = np.repeat(sample, G)
    pair_g = np.tile(np.arange(1, G + 1, dtype=np.int64), S)
    return {
        "Occurrences__F": ({"sample": np.repeat(sample, n_mut),
                            "mutationId": np.arange(1, M_ + 1, dtype=np.int64),
                            "candidates": np.arange(M_, dtype=np.int64)},
                           _ones(M_)),
        "Occurrences__D_candidates": (
            {"gene": i64(rng.randint(1, G + 1, C)), "impact": rng.rand(C),
             "sift": rng.rand(C), "poly": rng.rand(C),
             "consequences": np.arange(C, dtype=np.int64),
             "label": np.repeat(np.arange(M_, dtype=np.int64), n_cand)},
            _ones(C)),
        "Occurrences__D_candidates_consequences": (
            {"conseq": i64(rng.randint(1, n_conseq + 1, K)),
             "label": np.repeat(np.arange(C, dtype=np.int64), n_cons)},
            _ones(K)),
        "CopyNumber__F": ({"aliquot": 100 + pair_s, "gene": pair_g,
                           "cnum": i64(rng.randint(0, 6, S * G))},
                          _ones(S * G)),
        "Samples__F": ({"sample": sample, "aliquot": 100 + sample},
                       _ones(S)),
        "SOImpact__F": ({"conseq": np.arange(1, n_conseq + 1, dtype=np.int64),
                         "value": rng.rand(n_conseq)}, _ones(n_conseq)),
        "Network__F": ({"nodeProtein": 500 + np.arange(1, G + 1,
                                                       dtype=np.int64),
                        "edges": np.arange(G, dtype=np.int64)}, _ones(G)),
        "Network__D_edges": (
            {"edgeProtein": 500 + i64(rng.randint(1, G, E)),
             "distance": i64(rng.randint(1, 10, E)),
             "label": np.repeat(np.arange(G, dtype=np.int64), n_edge)},
            _ones(E)),
        "Biomart__F": ({"gene": np.arange(1, G + 1, dtype=np.int64),
                        "protein": 500 + np.arange(1, G + 1, dtype=np.int64)},
                       _ones(G)),
        "GeneExpression__F": ({"aliquot": 100 + pair_s, "gene": pair_g,
                               "fpkm": rng.rand(S * G) * 10}, _ones(S * G)),
    }


def bio_bound(got, want, paths) -> float:
    """``got`` (use_kernel=True) against ``want`` (use_kernel=False)
    Connectivity bags: the same genes, and each score within
    (4 T + 16) 2^-24 of the exact one, relatively, where T is the gene's
    count of product paths (the pipeline over all-ones scores, ``paths``).
    Every term is a product of nonnegative numbers, so each f32 rounding
    of a term or a partial sum adds at most 2^-24 of the final value,
    and a path passes through fewer than 4 T sums over the four steps.
    Returns the largest error over its bound."""
    def rows(bag):
        v = bag.valid.cpu().numpy()
        g = bag.data["gene"].cpu().numpy()[v]
        s = bag.data["score"].cpu().numpy()[v]
        o = np.argsort(g)
        return g[o], s[o]
    g1, s1 = rows(got)
    g0, s0 = rows(want)
    gp, tp = rows(paths)
    assert np.array_equal(g1, g0) and np.array_equal(gp, g0), \
        (g1.size, g0.size, gp.size)
    bound = (4 * tp + 16) * 2.0 ** -24 * np.abs(s0)
    err = np.abs(s1 - s0)
    assert (err <= bound).all(), float((err - bound).max())
    return float((err / np.maximum(bound, 1e-300)).max())


def phase_bio(seed: int, dev, n_samples: int = None,
              n_genes: int = None) -> None:
    """Phase I: the Fig. 9 pipeline shredded (``jit_program``) at
    ``n_samples`` x ``n_genes``, use_kernel=True cold and warm, held to
    the use_kernel=False run within the f32 bound; then the figure
    driver at gen_biomedical(10, 30) on the card, against the
    interpreter."""
    from repro_torch.columnar.table import env_from_numpy
    from repro_torch.core import codegen as CG
    from repro_torch.core import materialization as M
    from repro_torch.core.plans import ExecSettings
    from repro_torch.data.generators import BIO_TYPES
    from repro_torch.figures import biomedical as FB
    n_samples, n_genes = n_samples or BIO_SAMPLES, n_genes or BIO_GENES
    tag = "I bio"
    t0 = time.perf_counter()
    env_np = gen_bio_shredded(n_samples, n_genes, seed)
    log(f"[{tag}] n_samples={n_samples}, n_genes={n_genes}, seed={seed}: "
        f"{ {k: int(v[1].size) for k, v in env_np.items()} } (generated "
        f"in {time.perf_counter() - t0:.1f} s)")
    prog = FB.build_pipeline()
    sp = M.shred_program(prog, BIO_TYPES, domain_elimination=True)
    cp = CG.compile_program(sp, FB.CATALOG)
    top = sp.manifests["Connectivity"].top
    env = env_from_numpy(env_np, dev)
    exe = CG.jit_program(cp, ExecSettings(use_kernel=True))
    out, cold_s, warm_ms, peak, counts = timed_calls(lambda: exe(env))
    log(f"[{tag}] jit_program use_kernel=True (steps=4;assignments="
        f"{len(sp.program.names())}): cold {cold_s:.3f} s, warm "
        f"{warm_ms:.1f} ms, peak {peak / 2 ** 30:.2f} GiB, launches "
        f"{counts}")
    assert all(counts.values()), counts
    got = out[top]
    del out
    plain = CG.jit_program(cp, ExecSettings(use_kernel=False))(env)[top]
    ones_np = {k: ({c: (np.ones_like(a) if a.dtype == np.float64 else a)
                    for c, a in cols.items()}, valid)
               for k, (cols, valid) in env_np.items()}
    paths = CG.jit_program(cp, ExecSettings(use_kernel=False))(
        env_from_numpy(ones_np, dev))[top]
    worst = bio_bound(got, plain, paths)
    log(f"[{tag}] Connectivity: {int(plain.valid.sum())} genes, within the "
        f"f32 bound of the use_kernel=False run ({worst:.3g} of it)")
    del got, plain, paths, env
    torch.cuda.empty_cache()
    rows = FB.run(10, 30, device=dev)
    assert rows[0].endswith("match=True"), rows
    log(f"[{tag}] figures.biomedical at gen_biomedical(10, 30) on the card: "
        f"{rows[0]}")


# ---------------------------------------------------------------------------
# phase J: App. E.1 and segment_reduce
# ---------------------------------------------------------------------------

def reduce_bound_check(vals, seg, S: int, tag: str) -> None:
    """The kernel on ``rand`` values: each segment within 2 n_s 2^-24
    sum|x| of a float64 sum, and two launches bit-identical."""
    from repro_torch.kernels import segment_reduce as SR
    a = SR.segment_reduce_cuda(vals, seg, S)
    b = SR.segment_reduce_cuda(vals, seg, S)
    ids = seg.to(torch.int64)
    exact = torch.zeros((S, vals.shape[1]), dtype=torch.float64,
                        device=vals.device).index_add_(0, ids, vals.double())
    n_s = torch.bincount(ids, minlength=S).double()[:, None]
    err = (a.double() - exact).abs()
    bound = 2 * n_s * 2.0 ** -24 * exact            # rand values are >= 0
    assert torch.equal(a, b), f"{tag}: repeated launches differ"
    assert bool((err <= bound).all()), float((err - bound).max())
    log(f"  [{tag}] rand values: within 2 n_s 2^-24 sum|x| of a float64 sum "
        f"({float((err / bound.clamp(min=1e-300)).max()):.3g} of it); two "
        f"launches bit-identical")


def phase_representation(cols: dict, seed: int, dev,
                         n_a: int = 1 << 26) -> list:
    """Phase J: App. E.1 — row-wise dict aggregation (2^20 rows) against
    the columnar ``sum_by`` on the card — and ``segment_reduce`` through
    its dispatch at (a) the reference's rows-per-group ratio scaled to
    2^26 rows and (b) SF10's lineitems grouped by part, d = 1 and 4:
    launched with every counter zeroed first; bit-exact against its
    plain version on integer values, within the f32 bound on random
    ones; timed. Returns the kernel records of (a) and (b) d = 4."""
    from repro_torch.columnar.table import FlatBag
    from repro_torch.exec import ops as X
    from repro_torch.kernels import ops as kops
    rng = np.random.RandomState(seed)
    S_a = -(-n_a * 256 // 20000)                # 858,993 at 2^26 rows
    seg_a = torch.sort(torch.as_tensor(rng.randint(0, S_a, n_a), device=dev)
                       ).values.to(torch.int32)
    ints_a = torch.as_tensor(rng.randint(0, 100, (n_a, 1)).astype(np.float32),
                             device=dev)
    # App. E.1: row-wise (AoS) against columnar (SoA)
    n_row = min(1 << 20, n_a)
    keys = seg_a[:: n_a // n_row].cpu().numpy()
    vs = rng.rand(n_row)
    rows = [{"k": int(k), "v": float(v)} for k, v in zip(keys, vs)]
    t0 = time.perf_counter()
    acc = {}
    for r in rows:
        acc[r["k"]] = acc.get(r["k"], 0.0) + r["v"]
    row_ns = (time.perf_counter() - t0) / n_row * 1e9
    del rows, acc
    bag = FlatBag({"k": seg_a.to(torch.int64), "v": ints_a[:, 0].double()},
                  torch.ones(n_a, dtype=torch.bool, device=dev))
    _, cold_s, warm_ms, peak, _ = timed_calls(
        lambda: X.sum_by(bag, ("k",), ("v",), use_kernel=True))
    log(f"[J repr] row-wise dict aggregation: {row_ns:.1f} ns per row over "
        f"{n_row} rows (host); columnar sum_by on the card: warm "
        f"{warm_ms:.1f} ms over {n_a} rows, {warm_ms * 1e6 / n_a:.2f} ns "
        f"per row ({row_ns / (warm_ms * 1e6 / n_a):.0f}x), peak "
        f"{peak / 2 ** 30:.2f} GiB")
    del bag
    # (b): SF10's lineitems grouped by part
    S_b = int(cols["part_pid"].size)
    seg_b = torch.sort(torch.as_tensor(cols["li_pid"] - 1, device=dev)
                       ).values.to(torch.int32)
    n_b = seg_b.numel()
    ints_b = torch.as_tensor(rng.randint(0, 100, (n_b, 4)).astype(np.float32),
                             device=dev)
    shapes = {"a": (ints_a, seg_a, S_a), "b d=1": (ints_b[:, :1].contiguous(),
                                                   seg_b, S_b),
              "b d=4": (ints_b, seg_b, S_b)}
    kops.reset_launch_counts()
    for vals, seg, S in shapes.values():
        kops.segment_reduce(vals, seg, S)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    log(f"[J segment_reduce] dispatch at (a) n={n_a}, S={S_a}, d=1 and (b) "
        f"n={n_b}, S={S_b}, d=1 and 4: launches {counts}")
    assert counts["segment_reduce"] == len(shapes), counts
    # at most two kernels a call: a session counts only where both of
    # them show (the host records no launch of a ctypes-bound kernel, so
    # a lost record can hide only in the kernels' own names)
    vals, seg, S = shapes["a"]
    for sessions in range(1, 7):
        records, complete = profiled(
            lambda: kops.segment_reduce(vals, seg, S), pad_s=sessions - 1.0)
        launched = sorted(e.name.split("(")[0] for e in records
                          if not e.name.startswith(("Memcpy", "Memset")))
        seen = complete and {"sr_carry", "void sr_tile<1>"} <= set(launched)
        if seen:
            break
    log(f"[J segment_reduce] kernels of one call at (a) (profile session "
        f"{sessions}, {'both seen' if seen else 'INCOMPLETE'}): "
        f"{launched}")
    assert seen and len(launched) <= 2, launched
    recs = []
    for label, (vals, seg, S) in shapes.items():
        tag = f"J segment_reduce ({label})"
        reduce_bound_check(torch.rand(vals.shape, device=dev), seg, S, tag)
        got = measure_kernels({"segment_reduce": (vals, seg, S)}, counts,
                              tag)
        for rec in got:
            rec["path"] = "cuda_cores"
            rec["launches_in"] = "J segment_reduce dispatch"
            rec["shape"] = f"({label}) n={seg.numel()}, d={vals.shape[1]}, S={S}"
        if label != "b d=1":
            recs += got
    return recs


# ---------------------------------------------------------------------------
# phases K and L: LM prefill and serving (flash_attention, rwkv6)
# ---------------------------------------------------------------------------

U_F32 = 2.0 ** -24             # f32 unit roundoff
ATTN_VARIANTS = [              # tests/test_kernels.py's flash variants
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=5),
    dict(causal=True, softcap=20.0),
    dict(causal=True, window=9, softcap=30.0),
]


# the tensor-core kernel's tiles: 64 query rows, 64 keys
ATTN_TILE_VARIANTS = [
    dict(causal=True),
    dict(causal=False),
    dict(causal=True, window=17),                  # within a tile
    dict(causal=True, window=17, softcap=30.0),
    dict(causal=True, window=100),                 # across tiles
    dict(causal=False, window=100, softcap=50.0),
    # scores large enough for tanh's exponential branch (|s / softcap|
    # of 0.6 and more)
    dict(causal=True, softcap=20.0, scale=1.0),
    dict(causal=False, window=100, softcap=10.0, scale=1.0),
]


def attention_tile_shapes() -> list:
    """(B, H, Hkv, Sq, Sk, D) at the tensor-core kernel's tile edges: Sq
    and Sk at 64 and 128 +- 1 (and apart), D in {16, 64, 128, 256}, GQA
    groups 1, 2 and 4."""
    sizes = [(63, 63), (64, 64), (65, 65), (127, 127), (129, 129),
             (65, 129), (129, 65)]
    shapes = []
    for i, (Sq, Sk) in enumerate(sizes):
        for j, D in enumerate((16, 64, 128, 256)):
            group = (1, 2, 4)[(i + j) % 3]
            shapes.append((1 + (i + j) % 2, 2 * group, 2, Sq, Sk, D))
    return shapes


def attention_edge_cases(dev, large: bool = True) -> list:
    """(q, k, v, kwargs) for ``flash_attention``: the five variants of
    ``tests/test_kernels.py`` at its two shapes, f32 and bf16; with
    ``large``, each variant with GQA (8 query heads over 2 KV heads) at
    Sq = Sk = 97 for D in {64, 128, 256}, and Sq != Sk, window 1, one
    KV head and multi-tile windows with a softcap; and the tile edges of
    ``attention_tile_shapes`` under ``ATTN_TILE_VARIANTS``."""
    rng = np.random.RandomState(11)
    shapes = [(1, 2, 2, 24, 24, 16), (2, 4, 2, 33, 33, 8)]
    extra = []
    if large:
        shapes += [(2, 8, 2, 97, 97, d) for d in (64, 128, 256)]
        extra = [((1, 4, 1, 70, 130, 128), dict(causal=True)),
                 ((1, 4, 2, 130, 70, 64), dict(causal=True)),
                 ((1, 4, 2, 130, 70, 64), dict(causal=False, window=80)),
                 ((1, 2, 2, 200, 200, 128), dict(causal=True, window=1)),
                 ((2, 4, 2, 300, 300, 128),
                  dict(causal=True, window=100, softcap=50.0))]
        extra += [(s, kw) for s in attention_tile_shapes()
                  for kw in ATTN_TILE_VARIANTS
                  if not (kw.get("window") and s[3] - kw["window"] > s[4] - 1)]
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        todo = [(s, kw) for s in shapes for kw in ATTN_VARIANTS] + extra
        for (B, H, Hkv, Sq, Sk, D), kw in todo:
            q, k, v = (torch.as_tensor(rng.randn(B, h, s, D), dtype=dt,
                                       device=dev)
                       for h, s in ((H, Sq), (Hkv, Sk), (Hkv, Sk)))
            cases.append((q, k, v, dict(kw)))
    return cases


def rwkv6_edge_cases(dev, large: bool = True) -> list:
    """(r, k, v, w, u, chunk) for ``rwkv6``: T a multiple of the chunk
    and not, T below the chunk, K != V, decays near 0 and near 1, f32
    and bf16; with ``large``, K = V = 128, a longer T, T around
    multiples of 16 (the kernel's sub-chunk) and of the chunk, chunks
    of 16, 32 and 48, and K, V not multiples of 16 (rows of 24 and 40
    bytes: not copied 16 bytes at a time)."""
    rng = np.random.RandomState(12)
    shapes = [(1, 2, 40, 8, 8, 16), (2, 2, 37, 8, 8, 4),
              (1, 2, 100, 64, 64, 64), (1, 1, 10, 16, 16, 64),
              (1, 2, 70, 32, 16, 64), (1, 2, 70, 16, 48, 16)]
    if large:
        shapes += [(2, 3, 300, 64, 64, 64), (1, 2, 130, 128, 128, 64),
                   (1, 2, 130, 128, 32, 32)]
        # T around multiples of the 16-step sub-chunk and of the chunk
        shapes += [(1, 2, T, 64, 64, 64) for T in (15, 16, 17, 63, 64, 65,
                                                   129)]
        shapes += [(1, 2, 33, 64, 32, 32), (1, 2, 47, 16, 16, 16),
                   (1, 2, 40, 24, 40, 48), (1, 1, 21, 12, 20, 16)]
    decays = {"mid": lambda s: 0.2 + 0.79 * rng.rand(*s),
              "near0": lambda s: 10.0 ** rng.uniform(-9, -3, s),
              "near1": lambda s: 1.0 - 10.0 ** rng.uniform(-6, -3, s)}
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for B, H, T, K, V, chunk in shapes:
            for name, draw in decays.items():
                if name != "mid" and K > 64:
                    continue
                r, k, v, w = (torch.as_tensor(a, dtype=dt, device=dev)
                              for a in (rng.randn(B, H, T, K) * 0.5,
                                        rng.randn(B, H, T, K) * 0.5,
                                        rng.randn(B, H, T, V),
                                        draw((B, H, T, K))))
                u = torch.as_tensor(rng.randn(H, K) * 0.3,
                                    dtype=torch.float32, device=dev)
                cases.append((r, k, v, w, u, chunk))
    return cases


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """Elementwise size of one bf16 unit in the last place at |x|."""
    a = x.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def within(got: torch.Tensor, want: torch.Tensor, bound) -> float:
    """Raise unless |got - want| <= bound (+ one bf16 ulp of the larger
    of the two in bf16) elementwise; returns the largest |got - want| as
    a share of what is allowed."""
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    err = (got.double() - want.double()).abs()
    allowed = torch.as_tensor(bound, dtype=torch.float64, device=got.device)
    if got.dtype == torch.bfloat16:
        allowed = allowed + bf16_ulp(torch.maximum(got.float().abs(),
                                                   want.float().abs()))
    assert bool(torch.isfinite(got).all()), "non-finite output"
    share = float((err / allowed.clamp(min=1e-300)).max())
    assert share <= 1.0, f"outside the bound: {share:.3g} of it"
    return share


def attention_bound(q, k, v, scale=None) -> float:
    """f32 rounding bound of ``flash_attention`` against its plain
    version, first order. Each score is a D-term dot product (error at
    most D u scale ||q|| ||k||, Cauchy-Schwarz; the softcap's tanh does
    not enlarge it), and a score error d moves the weighted mean by at
    most 2 d max |v|; each output sums at most Sk terms in f32 in the
    numerator and the denominator (2 Sk u), and exp and tanh add a few
    ulps. Two versions each within that differ by twice it:
    u max|v| (4 D scale ||q|| ||k|| + 4 (Sk + D) + 16)."""
    D, Sk = q.shape[-1], k.shape[-2]
    scale = scale if scale is not None else D ** -0.5
    qn = float(q.float().norm(dim=-1).max())
    kn = float(k.float().norm(dim=-1).max())
    return U_F32 * float(v.float().abs().max()) * (
        4 * D * scale * qn * kn + 4 * (Sk + D) + 16)


def rwkv6_bound(r, k, v, w, u, chunk: int) -> torch.Tensor:
    """Elementwise f32 rounding bound of ``rwkv6`` (chunked) against its
    plain version (sequential), first order: every term of o_t passes
    through at most 2T + 2K f32 operations in either version, and the
    chunked form's exponents carry the rounding of at most T/C + C
    cumulative sums of log-decays, each at most L = the largest sum of
    |log w| over a chunk in a channel. The bound is that relative error
    times M, the recurrence run on |r|, |k|, |v|, |u| (the sum of the
    terms' magnitudes)."""
    from repro_torch.kernels import ref as R
    B, H, T, K = r.shape
    C = min(chunk, T)
    lw = torch.log(w.float().clamp(min=1e-12)).abs()
    pad = (-T) % C
    lw = torch.nn.functional.pad(lw, (0, 0, 0, pad))
    L = float(lw.view(B, H, -1, C, K).sum(dim=3).max())
    rel = U_F32 * (2 * T + 2 * K + 4 * (T / C + C) * (1 + L))
    M = R.rwkv6_ref(r.float().abs(), k.float().abs(), v.float().abs(),
                    w.float(), u.float().abs())
    return rel * M.double()


def attention_work(q, k, causal=True, window=None) -> tuple:
    """(unmasked pairs, flops, SFU results) of one attention call on this
    data: 4 D flops per unmasked pair and head (Q.K^T and P.V), and one
    exp per pair on the SFU. The softcap's tanh is not counted: it needs
    no SFU (an odd polynomial on the FMA units, as the tensor-core kernel
    computes it below 0.6), so counting it would flatter a kernel."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    rows = torch.arange(Sq, dtype=torch.int64)
    hi = torch.clamp(rows, max=Sk - 1) if causal \
        else torch.full_like(rows, Sk - 1)
    lo = torch.clamp(rows - window + 1, min=0) if window \
        else torch.zeros_like(rows)
    pairs = B * H * int(torch.clamp(hi - lo + 1, min=0).sum())
    return pairs, 4 * D * pairs, pairs


def rwkv6_earlier_bound_ms(r, v) -> float:
    """The earlier bound of ``rwkv6``, kept beside the new one: the larger of
    the bytes and the recurrence's own f32 work, 5 K V + 3 K + 2 V per
    step and head, at 67 TFLOP/s."""
    B, H, T, K = r.shape
    V = v.shape[3]
    nbytes = r.element_size() * (3 * r.numel() + 2 * v.numel()) + 4 * H * K
    return max(B * H * T * (5 * K * V + 3 * K + 2 * V) / 67e12,
               nbytes / HBM_BYTES_PER_S) * 1e3


def rwkv6_work(T: int, K: int, V: int, chunk: int) -> tuple:
    """(flops, SFU results) of the chunked RWKV-6 form the kernel runs,
    for one (b, h), each product counted once. A chunk of c steps is cut
    into sub-chunks of 16 (s_a steps each): A's blocks below the
    diagonal (2 s_b s_a K each), the diagonal blocks' pairs with i <= t
    (2 K each), o = A v over A's lower blocks (2 s_b s_a V), r~ S and
    the state's update (2 c K V each). Its SFU results (its own cost, not
    the function's; noted, not bounded): a log and two
    powers of 2 per (step, channel) (the scaled r and k; the
    sub-chunks' per-channel factors are left out), and one power per
    pair i < t and channel of a diagonal block."""
    C = min(chunk, T)
    flops = exps = 0
    for c0 in range(0, T, C):
        c = min(C, T - c0)
        sizes = [min(16, c - a) for a in range(0, c, 16)]
        for b, sb in enumerate(sizes):
            for sa in sizes[:b]:
                flops += 2 * sb * sa * (K + V)
            flops += sb * (sb + 1) * (K + V)
            exps += sb * (sb - 1) // 2 * K
        flops += 4 * c * K * V
        exps += 3 * c * K
    return flops, exps


def lm_kernel_fns(name: str, args: tuple, kw: dict):
    """(kernel, plain version, library call or None, library label,
    bound ms, 'bytes' or 'operations', bound note, tolerance) for one LM
    kernel at its dispatch arguments. The bound is the larger of the
    bytes moved (each input read once, the output written once) over
    3.35 TB/s and the operations the function needs on this data over
    the peak for their type: for attention 4 D flops per unmasked pair
    and head at 989 TFLOP/s bf16 (495 f32) on the tensor cores, and its
    exponentials on the SFU (``SFU_PER_S``); for RWKV-6 the chunked
    form's products counted once (``rwkv6_work``) at TF32's 495 TFLOP/s
    on the tensor cores (the kernel's products are TF32). Its logs and
    powers of 2 are the chunked form's own cost, not the function's (w
    is given, the recurrence needs no transcendental), and the earlier
    bound (the recurrence's own f32 work at 67 TFLOP/s) is only noted."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rwkv6_scan as RW
    if name == "flash_attention":
        q, k, v = (a.contiguous() for a in args[:3])
        causal = kw.get("causal", True)
        window, softcap = kw.get("window"), kw.get("softcap")
        scale = kw.get("scale")
        B, H, Sq, D = q.shape
        Sk, Hkv = k.shape[2], k.shape[1]
        rows = torch.arange(Sq, dtype=torch.int64)
        pairs, flops, exps = attention_work(q, k, causal, window)
        peak = 989e12 if q.dtype == torch.bfloat16 else 495e12
        nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        kern = lambda: FA.flash_attention_cuda(  # noqa: E731
            q, k, v, causal, window, softcap, scale)
        plain = lambda: R.attention_ref(  # noqa: E731
            q, k, v, causal, window, softcap, scale)
        lib_mask = None
        if window:
            rr, cc = rows[:, None], torch.arange(Sk)[None, :]
            lib_mask = cc > rr - window
            if causal:
                lib_mask &= cc <= rr
            lib_mask = lib_mask.to(q.device)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library = lambda: sdpa(  # noqa: E731
            q, k, v, attn_mask=lib_mask,
            is_causal=bool(causal and lib_mask is None), scale=scale,
            enable_gqa=Hkv != H)
        label = ("scaled_dot_product_attention on the same shape and masks "
                 "without the softcap (a yardstick: no PyTorch call has "
                 "the softcap)")
        bound_ops = max(flops / peak, exps / SFU_PER_S)
        bound_bytes = nbytes / HBM_BYTES_PER_S
        tol = attention_bound(q, k, v, scale)
        note = (f"{pairs} unmasked pairs, {flops / 1e9:.1f} GFLOP: "
                f"{flops / peak * 1e3:.4f} ms on the tensor cores, "
                f"{exps / 1e9:.3f}G exponentials: "
                f"{exps / SFU_PER_S * 1e3:.4f} ms on the SFU")
    else:
        r, k, v, w = (a.contiguous() for a in args[:4])
        u = args[4].float().contiguous()
        chunk = int(kw.get("chunk", args[5] if len(args) > 5 else 64))
        B, H, T, K = r.shape
        V = v.shape[3]
        flops, exps = rwkv6_work(T, K, V, chunk)
        flops, exps = B * H * flops, B * H * exps
        nbytes = r.element_size() * (3 * r.numel() + 2 * v.numel()) \
            + 4 * u.numel()
        kern = lambda: RW.rwkv6_cuda(r, k, v, w, u, chunk)  # noqa: E731
        plain = lambda: R.rwkv6_ref(r, k, v, w, u)  # noqa: E731
        library, label = None, ("none: no PyTorch call computes the "
                                "RWKV-6 recurrence")
        bound_ops = flops / 495e12
        bound_bytes = nbytes / HBM_BYTES_PER_S
        tol = rwkv6_bound(r, k, v, w, u, chunk)
        earlier = rwkv6_earlier_bound_ms(r, v)
        note = (f"the chunked form: {flops / 1e9:.1f} GFLOP of products, "
                f"{flops / 495e12 * 1e3:.4f} ms on the tensor cores in "
                f"TF32; its own {exps / 1e9:.3f}G logs and powers of 2, "
                f"{exps / SFU_PER_S * 1e3:.4f} ms on the SFU, not in the "
                f"bound (the recurrence needs none); earlier bound "
                f"{earlier:.4f} ms (the recurrence at 67 TFLOP/s)")
    by = "operations" if bound_ops >= bound_bytes else "bytes"
    return (kern, plain, library, label, max(bound_ops, bound_bytes) * 1e3,
            by, note, tol)


def check_lm_kernel(name: str, args: tuple, kw: dict) -> tuple:
    """The kernel twice (bit-identical) and its plain version on the same
    inputs, held to the stated bound. Returns (max |err|, share of the
    bound, the fns)."""
    fns = lm_kernel_fns(name, args, kw)
    kern, plain, tol = fns[0], fns[1], fns[7]
    a, b = kern(), kern()
    want = plain()
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a.view(torch.int32),
                       b.view(torch.int16) if b.dtype == torch.bfloat16
                       else b.view(torch.int32)), \
        f"{name}: two launches differ"
    share = within(a, want, tol)
    err = float((a.double() - want.double()).abs().max())
    del a, b, want
    return err, share, fns


def phase_lm_kernels(dev) -> None:
    """Phase 2's LM part: ``flash_attention`` and ``rwkv6`` over their
    edge cases against their plain versions: within the f32 rounding
    bound (``attention_bound``, ``rwkv6_bound``) plus one bf16 ulp of
    the output in bf16, and two launches bit-identical."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RW
    worst, n = {}, {}
    for q, k, v, kw in attention_edge_cases(dev):
        _, share, _ = check_lm_kernel("flash_attention", (q, k, v), kw)
        key = ("flash_attention "
               f"({FA.kernel_path(q.dtype, q.shape[-1]).replace('_', ' ')})")
        worst[key] = max(worst.get(key, 0), share)
        n[key] = n.get(key, 0) + 1
    assert len(worst) == 2, worst         # both paths ran
    key = f"rwkv6 ({RW.PATH.replace('_', ' ')})"
    for args in rwkv6_edge_cases(dev):
        _, share, _ = check_lm_kernel("rwkv6", args[:5],
                                      dict(chunk=args[5]))
        worst[key] = max(worst.get(key, 0), share)
        n[key] = n.get(key, 0) + 1
    log(f"[2 kernels] LM edge cases within the f32 rounding bound of their "
        f"plain versions (+1 bf16 ulp in bf16), two launches "
        f"bit-identical: "
        + ", ".join(f"{k} {n[k]} cases, worst {worst[k]:.3g} of it"
                    for k in worst))


@contextlib.contextmanager
def patched_lm_kernels(fa=None, rw=None):
    """The model's LM kernel dispatch replaced while active, and restored
    after: ``kops.flash_attention`` by ``fa(orig, q, k, v, causal, window,
    softcap, scale)`` and ``kops.rwkv6_scan`` by ``rw(orig, r, k, v, w, u,
    chunk)`` where given, ``orig`` being the dispatch replaced. The
    script's own switch, for captures, comparisons and controls; the
    package has none."""
    from repro_torch.kernels import ops as kops
    orig = kops.flash_attention, kops.rwkv6_scan
    if fa is not None:
        kops.flash_attention = (
            lambda q, k, v, causal=True, window=None, softcap=None,
            scale=None: fa(orig[0], q, k, v, causal, window, softcap, scale))
    if rw is not None:
        kops.rwkv6_scan = (lambda r, k, v, w, u, chunk=64:
                           rw(orig[1], r, k, v, w, u, chunk))
    try:
        yield
    finally:
        kops.flash_attention, kops.rwkv6_scan = orig


@contextlib.contextmanager
def capture_lm_calls():
    """While active, keeps (in the dict it yields) the arguments of the
    first ``flash_attention`` call of each window (the local and the
    global layers) and of the first ``rwkv6_scan`` call."""
    calls = {}

    def fa(f, q, k, v, causal, window, softcap, scale):
        kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
        calls.setdefault(("flash_attention", window), ((q, k, v), kw))
        return f(q, k, v, **kw)

    def rw(f, r, k, v, w, u, chunk):
        calls.setdefault(("rwkv6", None), ((r, k, v, w, u),
                                           dict(chunk=chunk)))
        return f(r, k, v, w, u, chunk=chunk)

    with patched_lm_kernels(fa, rw):
        yield calls


def plain_lm_kernels():
    """The model's kernel dispatch swapped for the plain versions (on the
    card) while active."""
    from repro_torch.kernels import ref as R
    return patched_lm_kernels(
        lambda f, q, k, v, causal, window, softcap, scale:
        R.attention_ref(q, k, v, causal, window, softcap, scale),
        lambda f, r, k, v, w, u, chunk: R.rwkv6_ref(r, k, v, w, u))


def _gqa_mismapped(f, q, k, v, causal, window, softcap, scale):
    """The kernel with query head h reading KV head h % Hkv, not
    h // (H / Hkv): the query heads reordered so that the kernel's
    grouping pairs them so, and the output put back in order."""
    H, Hkv = q.shape[1], k.shape[1]
    order = [kv + j * Hkv for kv in range(Hkv) for j in range(H // Hkv)]
    out = torch.empty_like(q)
    out[:, order] = f(q[:, order], k, v, causal=causal, window=window,
                      softcap=softcap, scale=scale)
    return out


def _state_not_carried(f, r, k, v, w, u, chunk):
    """The kernel launched chunk by chunk, each from a zero state."""
    T = r.shape[2]
    return torch.cat([f(r[:, :, s:s + chunk], k[:, :, s:s + chunk],
                        v[:, :, s:s + chunk], w[:, :, s:s + chunk], u,
                        chunk=chunk) for s in range(0, T, chunk)], dim=2)


# Faults a kernel could plausibly have, each run through the real kernel
# in every layer: how far each moves the full-depth logits shows what the
# end-to-end LOGIT_BOUND can see (the captured-argument checks decide).
LM_CONTROLS = {
    "rwkv6": [
        ("the u bonus dropped", None,
         lambda f, r, k, v, w, u, chunk: f(r, k, v, w, torch.zeros_like(u),
                                           chunk=chunk)),
        ("the state not carried across chunks", None, _state_not_carried)],
    "flash_attention": [
        ("the window dropped",
         lambda f, q, k, v, causal, window, softcap, scale: f(
             q, k, v, causal=causal, window=None, softcap=softcap,
             scale=scale), None),
        ("query head h reading KV head h % Hkv", _gqa_mismapped, None)],
}


def measure_lm_kernel(name: str, args: tuple, kw: dict, launches: int,
                      tag: str, label: str) -> dict:
    """One JSON record of an LM kernel at its captured arguments: held to
    its bound against the plain version (two launches bit-identical),
    timed by CUDA events and by the profiler beside the plain version,
    the library yardstick and the bound."""
    err, share, fns = check_lm_kernel(name, args, kw)
    kern, plain, library, lib_label, bound_ms, by, note, _ = fns
    # rwkv6's plain version is a loop of four launches per step over T:
    # host-paced, and too many launches for a complete profile
    (dev_ms, plain_dev, lib_dev), dev_s = device_ms(
        [kern, plain if name == "flash_attention" else None, library],
        [3, 1, 3])
    meta = KERNELS[name]
    rec = dict(name=name, route="cuda", source=meta["source"],
               replaces=meta["replaces"], launches=launches,
               max_abs_err=err, ms=time_ms(kern, iters=5),
               plain_ms=time_ms(plain, iters=2), device_ms=dev_ms,
               plain_device_ms=plain_dev, bound_ms=bound_ms, bound_by=by,
               library_ms=time_ms(library, iters=5) if library else None,
               library_device_ms=lib_dev, shape=label)
    if name == "flash_attention":
        from repro_torch.kernels import flash_attention as FA
        rec.update(path=FA.kernel_path(args[0].dtype, args[0].shape[-1]))
    else:
        from repro_torch.kernels import rwkv6_scan as RW
        rec.update(path=RW.PATH)
    shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
    lib = (f"{_ms(rec['library_ms'])} ms, {_ms(lib_dev)} on the device, "
           if library else "")
    log(f"  [{tag}] {name} ({label}) at {shapes} {args[0].dtype}, "
        f"{ {k: v for k, v in kw.items() if v is not None} }: within the "
        f"bound of the plain version ({share:.3g} of it, max |err| "
        f"{err:.3g}), two launches bit-identical; kernel {rec['ms']:.4f} ms "
        f"({_ms(dev_ms)} on the device, profile session {dev_s}), plain "
        f"{rec['plain_ms']:.4f} ms ({_ms(plain_dev)} on the device), bound "
        f"{bound_ms:.4f} ms by {by} ({note}; "
        f"{bound_ms / rec['ms']:.1%} of bound; path "
        f"{rec['path']}), library {lib}({lib_label}); "
        f"{launches} launches in the warm prefill")
    return rec


LOGIT_BOUND = 0.1              # |logits - plain logits| / max |logits|
#   in bf16 at full depth: the two runs' rounding differs in every layer
#   (no derived bound holds through 32-46 layers of random weights). A
#   coarse check: LM_CONTROLS measure which faults it sees, and the
#   kernel checks at the captured arguments decide
F32_LOGIT_BOUND = 1e-4         # the same in float32 at 2 layers, as the
#                                CPU tests hold the port to the reference


def serve_requests(seed: int, vocab: int) -> list:
    """Four requests with prompts of 16 to 64 tokens, 16 new each."""
    from repro_torch.serve import Request
    rng = np.random.RandomState(seed)
    return [Request(prompt=[int(t) for t in rng.randint(0, vocab, n)],
                    max_new_tokens=16) for n in (16, 32, 48, 64)]


def serve_bf16(tag: str, cfg, params, seed: int, dev) -> None:
    """``ServeEngine.generate`` at full width in bf16: wall time, decode
    tokens per second (prompt steps and new tokens, all B rows, over the
    wall time) and peak memory; then one decode step profiled."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.serve import Request, ServeEngine
    reqs = serve_requests(seed, cfg.vocab)
    eng = ServeEngine(cfg, params, max_len=128, device=dev)
    eng.generate([Request(prompt=r.prompt[:1], max_new_tokens=1)
                  for r in reqs])                # warm the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = max(len(r.prompt) for r in reqs) + 16   # decode_step calls
    new = sum(len(o) for o in outs)
    assert [len(o) for o in outs] == [16] * 4, outs
    assert all(0 <= t < cfg.vocab for o in outs for t in o)
    counts = kops.launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    log(f"[{tag} serve bf16] ServeEngine.generate, 4 requests (prompts "
        f"16-64, 16 new each, max_len 128): {wall:.3f} s, {steps} decode "
        f"steps of batch 4 ({steps * 4 / wall:.1f} tokens/s, "
        f"{wall / steps * 1e3:.2f} ms per step; {new / wall:.1f} new "
        f"tokens/s), peak {peak / 2 ** 30:.2f} GiB above the weights; "
        f"flash_attention {counts['flash_attention']} and rwkv6 "
        f"{counts['rwkv6']} launches (the engine prefills by decode steps, "
        f"as the reference does)")
    caches = T.init_cache(cfg, len(reqs), 128, device=dev)
    tok = torch.zeros(len(reqs), dtype=torch.int64, device=dev)
    profile_run(lambda: T.decode_step(cfg, params, caches, tok, 64),
                f"{tag} decode step (batch 4, position 64)")


def serve_f32(tag: str, cfg, kernel: str, seed: int, dev) -> None:
    """``ServeEngine.generate`` in float32 at 2 layers and full width.
    The engine fills its caches and decodes by decode steps, which run no
    kernel (decode attention and ``rwkv6_step`` stay PyTorch, as the
    reference keeps them in XLA); so its greedy tokens are held to greedy
    decoding by repeated ``prefill`` over each padded prompt and the
    tokens so far (padded on the right with 0 to the longest prompt, as
    the engine feeds it), which launches ``kernel`` in every layer of
    every call. Then that prefill's logits against the plain-swapped
    prefill's, within F32_LOGIT_BOUND."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    n_layers, n_new = 2, 16
    cfg32 = cfg.reduced(n_layers=n_layers, dtype="float32")
    params = T.init_params(cfg32, seed + 1, device=dev)
    reqs = serve_requests(seed + 1, cfg.vocab)
    eng = ServeEngine(cfg32, params, max_len=128, device=dev)
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    longest = max(len(r.prompt) for r in reqs)
    toks = torch.zeros((len(reqs), longest), dtype=torch.int64, device=dev)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = torch.as_tensor(r.prompt)
    kops.reset_launch_counts()
    seq = toks
    for _ in range(n_new):
        nxt = torch.argmax(T.prefill(cfg32, params, seq), dim=-1)
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    launched = kops.launch_counts()[kernel]
    by_prefill = seq[:, longest:].tolist()
    assert launched == n_new * n_layers, (kernel, launched)
    assert by_prefill == outs, (by_prefill, outs)
    logits = T.prefill(cfg32, params, toks)
    with plain_lm_kernels():
        plain = T.prefill(cfg32, params, toks)
    rel = float((logits - plain).abs().max() / plain.abs().max())
    assert rel <= F32_LOGIT_BOUND, rel
    log(f"[{tag} serve f32] {n_layers} layers at full width in float32: "
        f"generate {wall:.3f} s (decode steps only, no kernel); its "
        f"{n_new} greedy tokens per request equal to greedy decoding by "
        f"repeated prefill ({kernel} {launched} launches; first tokens "
        f"{[o[0] for o in outs]}); that prefill's logits within {rel:.3g} "
        f"x max |logit| of the plain-swapped prefill's (bound "
        f"{F32_LOGIT_BOUND})")
    del params


def _leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    return [t for v in tree.values() for t in _leaves(v)]


def phase_lm(tag: str, arch: str, B: int, S: int, kernel: str,
             expect: int, seed: int, dev) -> list:
    """Phases K and L: ``arch`` at full width and depth in bf16 with
    seeded random weights: ``prefill`` of B x S random tokens cold, then
    warm with every launch counter zeroed (``kernel`` launches
    ``expect`` times, the other LM kernel never);
    the logits finite, of shape (B, vocab), within LOGIT_BOUND x max
    |logit| of the same call with the plain versions swapped in, and
    how far each of LM_CONTROLS' faults moves them; the kernel at its
    captured arguments (``measure_lm_kernel``); a profiled warm call;
    then serving in bf16 and float32. Returns the kernel records."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} KV) of {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: {n_par / 1e9:.3f}B "
        f"parameters ({torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB), "
        f"seeded random, drawn in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RW
    with capture_lm_calls() as calls:
        logits, cold_s, warm_ms, peak, _ = timed_calls(
            lambda: T.prefill(cfg, params, tokens))
        counts = kops.launch_counts()
        paths = dict(FA.PATH_LAUNCHES)
    other = "rwkv6" if kernel == "flash_attention" else "flash_attention"
    log(f"[{tag}] prefill B={B} x S={S}: cold {cold_s:.3f} s, warm "
        f"{warm_ms:.1f} ms ({B * S / warm_ms * 1e3:.0f} tokens/s), peak "
        f"{peak / 2 ** 30:.2f} GiB above the weights; launches {kernel} "
        f"{counts[kernel]}, {other} {counts[other]}; flash_attention by "
        f"path: tensor cores {paths['tensor_cores']}, CUDA cores "
        f"{paths['cuda_cores']}; rwkv6 by path: {RW.PATH.replace('_', ' ')} "
        f"{counts['rwkv6']}")
    assert counts[kernel] == expect and counts[other] == 0, counts
    if kernel == "flash_attention":
        assert paths == {"tensor_cores": expect, "cuda_cores": 0}, paths
    assert logits.shape == (B, cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    with plain_lm_kernels():
        t0 = time.perf_counter()
        plain = T.prefill(cfg, params, tokens)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    scale = float(logits.abs().max())
    diff = float((logits - plain).abs().max())
    agree = int((logits.argmax(-1) == plain.argmax(-1)).sum())
    log(f"[{tag}] logits against the plain-swapped prefill ({plain_s:.2f} s):"
        f" max |d| {diff:.4g} = {diff / scale:.3g} of max |logit| "
        f"{scale:.4g} (bound {LOGIT_BOUND}: two bf16 runs whose kernel "
        f"outputs differ by f32 rounding and a bf16 ulp in each of "
        f"{cfg.n_layers} layers); argmax equal in {agree} of {B} rows")
    assert diff <= LOGIT_BOUND * scale, (diff, scale)
    for what, fa, rw in LM_CONTROLS[kernel]:
        with patched_lm_kernels(fa, rw):
            bad = T.prefill(cfg, params, tokens)
        moved = float((bad - plain).abs().max()) / scale
        agree = int((bad.argmax(-1) == plain.argmax(-1)).sum())
        log(f"[{tag}] control, {kernel} with {what} in every layer: logits "
            f"{moved:.3g} of max |logit| from the plain-swapped prefill's "
            f"({'beyond' if moved > LOGIT_BOUND else 'within'} the bound "
            f"{LOGIT_BOUND}); argmax equal in {agree} of {B} rows")
        del bad
    del plain, logits
    recs = []
    for (name, window), (args, kw) in sorted(
            calls.items(), key=lambda kv: str(kv[0])):
        label = ("layer 0" if name == "rwkv6" else
                 f"{'local (window ' + str(window) + ')' if window else 'global'} layer")
        recs.append(measure_lm_kernel(name, args, kw, counts[name], tag,
                                      label))
    del calls
    torch.cuda.empty_cache()
    profile_run(lambda: T.prefill(cfg, params, tokens), f"{tag} prefill")
    serve_bf16(tag, cfg, params, seed, dev)
    del params, tokens
    torch.cuda.empty_cache()
    serve_f32(tag, cfg, kernel, seed, dev)
    torch.cuda.empty_cache()
    return recs



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()

    def lap(phase: str) -> None:
        torch.cuda.empty_cache()
        log(f"[time] {phase} done {time.perf_counter() - t0:.1f} s after "
            f"the start")

    kind = phase_device()
    dev = torch.device("cuda")
    # float32 products in full float32 on the card (PyTorch's defaults
    # for matmul; cuDNN's default is TF32): the f32 serving checks of K
    # and L compare two f32 runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[0 device] torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    phase_build()
    phase_kernels(dev)
    phase_lm_kernels(dev)
    phase_quickstart(dev)
    lap("0-A")
    recs_b = phase_tpch("B n2n-L2 domain-elim", SCALE_B, args.seed,
                        True, dev, widths=True)
    lap("B")
    phase_tpch("C n2n-L2 no-domain-elim", SCALE_C, args.seed, False,
               dev)
    lap("C")
    recs_d, stored = phase_stored(args.seed, dev)
    try:
        lap("D0-E")
        recs_fg, dist = phase_distributed(args.seed, dev)
        lap("F-G")
        phase_serving(stored, dist, dev)
        lap("M")
    finally:
        shutil.rmtree(stored.tmp)
    del stored, dist
    phase_fig7(args.seed, dev)
    lap("H")
    phase_fig7_large(gen_tpch_columns(SCALE_H_STD, args.seed), dev,
                     SCALE_H_STD)
    lap("H at SF5")
    phase_bio(args.seed, dev)
    lap("I")
    recs_j = phase_representation(gen_tpch_columns(SCALE_B, args.seed),
                                  args.seed, dev)
    lap("J")
    recs_k = phase_lm("K rwkv6-7b", "rwkv6_7b", 4, 4096, "rwkv6", 32,
                      args.seed, dev)
    lap("K")
    recs_l = phase_lm("L gemma2-27b", "gemma2_27b", 1, 8192,
                      "flash_attention", 46, args.seed, dev)
    lap("L")
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": recs_b + recs_d + recs_fg + recs_j
                      + recs_k + recs_l}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
