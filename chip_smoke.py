#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed 0]

It drives the port's main path — the paper's shredded route, with the
hand-written Hopper kernels — and fails (nonzero exit, no result line)
if anything is wrong or if there is no CUDA device. Phases:

  0 device     the card's name, and nvidia-smi's name and power limit;
  1 build      nvcc builds every kernel library from the checkout;
  2 kernels    each CUDA kernel against its plain PyTorch version on
               the card, bit for bit, over the edge cases;
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
               and the byte bound; and a profiled warm run;
  C the same query with domain elimination off (DeDup + general_join)
               at the SF1 order count, with the same checks. SF10 would
               need 240M-row general-join outputs (the reference's 4x
               static-capacity rule).
  D0 decode    one 2^20-row chunk per codec (rle: oparts.label, delta:
               pid, bitpack: qty as int64, dict: qty) of the SF10 data,
               decoded on the card by the storage reader's own
               _decode_device: bit-equal to the NumPy codec; each decode
               kernel timed at that shape beside its plain version, the
               byte bound and one library call where there is one;
  D stored     the SF10 data written by DatasetWriter.write_parts with
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
  E streamed   execute_stored_streaming with 2^20-row morsels (four over
               the 3.75M customers): the same rows as D in another
               order, its wall time and peak memory beside D's.

The last three lines: nvidia-smi's name and power limit, the per-kernel
JSON records (phase B's join kernels; D0's decode kernels with D's
launch counts, bitunpack's from D0 since no column of this data picks
bitpack), and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
SCALE_B = 15_000_000           # orders in phase B: TPC-H SF10
SCALE_C = 1_500_000            # orders in phase C: TPC-H SF1
SCALE_D = 15_000_000           # orders in phases D and E: TPC-H SF10
CHUNK_ROWS = 1 << 20           # rows per stored chunk (and per morsel):
#                                Apache Arrow's default Parquet row group
I64_MAX = np.iinfo(np.int64).max

KERNELS = {
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
}
JOIN_KERNELS = ("segment_sum_first", "merge_positions", "gather_rows")
DECODE_KERNELS = ("rle_expand", "delta_unpack", "bitunpack", "dict_gather")


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


def nested_to_nested_query(levels: int, input_name: str, input_ty,
                           part_t):
    """Join Part at the lowest level + sumBy (Example 1 generalized)."""
    from repro_torch.core import nrc as N
    P = N.Var("Part", part_t)
    X = N.Var(input_name, input_ty)

    def agg(op_bag_holder):
        inner = N.for_in("op", op_bag_holder, lambda op:
            N.for_in("p", P, lambda p:
                N.IfThen(op.pid.eq(p.pid),
                         N.Singleton(N.record(pname=p.pname,
                                              total=op.qty * p.price)))))
        return N.SumBy(inner, keys=("pname",), values=("total",))

    if levels == 1:
        return N.for_in("x", X, lambda x: N.Singleton(N.record(
            odate=x.odate, oparts=agg(x.oparts))))
    if levels == 2:
        return N.for_in("x", X, lambda x: N.Singleton(N.record(
            cname=x.cname,
            corders=N.for_in("co", x.corders, lambda co:
                N.Singleton(N.record(odate=co.odate,
                                     oparts=agg(co.oparts)))))))
    if levels == 3:
        return N.for_in("x", X, lambda x: N.Singleton(N.record(
            nname=x.nname,
            ncusts=N.for_in("c", x.ncusts, lambda c:
                N.Singleton(N.record(
                    cname=c.cname,
                    corders=N.for_in("co", c.corders, lambda co:
                        N.Singleton(N.record(odate=co.odate,
                                             oparts=agg(co.oparts))))))))))
    raise ValueError(levels)


# ---------------------------------------------------------------------------
# data: gen_tpch's distributions (skew 0), vectorised, shredded directly
# ---------------------------------------------------------------------------

def gen_tpch_columns(scale: int, seed: int) -> dict:
    """Flat TPC-H-like tables as numpy columns, with the distributions
    of ``repro.data.generators.gen_tpch(scale, skew=0)``: ``scale``
    orders of 1-7 lineitems each, scale/2 parts, scale/4 customers."""
    rng = np.random.RandomState(seed)
    n_parts = max(scale // 2, 8)
    n_orders = scale
    n_cust = max(scale // 4, 4)
    price = rng.randint(1, 100, n_parts).astype(np.float64)
    per_order = rng.randint(1, 8, n_orders)
    n_items = int(per_order.sum())
    return {
        "part_pid": np.arange(1, n_parts + 1, dtype=np.int64),
        "part_pname": 10000 + np.arange(1, n_parts + 1, dtype=np.int64),
        "part_price": price,
        "li_oid": np.repeat(np.arange(1, n_orders + 1, dtype=np.int64),
                            per_order),
        "li_pid": rng.randint(1, n_parts + 1, n_items).astype(np.int64),
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


def check_oparts(out_bag, env_np) -> int:
    want_label, want_pname, want_total = numpy_oparts_groupby(env_np)
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
    the shapes the main path gives them."""

    def __init__(self, names=JOIN_KERNELS):
        self.names = names

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        self.kops, self.args, self._size = kops, {}, {}
        self._orig = {n: getattr(kops, n) for n in self.names}
        for n in self.names:
            setattr(kops, n, self._wrap(n, self._orig[n]))
        return self

    def _wrap(self, name, fn):
        def recorder(*args, **kw):
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            if size > self._size.get(name, -1):
                self._size[name], self.args[name] = size, args
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
    if name in DECODE_KERNELS:
        return decode_fns(name, args)
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


def decode_fns(name: str, args: tuple):
    """``kernel_fns`` for the decode kernels. The byte bound counts each
    member once at its stored width and the int64 output once."""
    from repro_torch.kernels import decode as D
    from repro_torch.kernels import ref as R
    if name == "rle_expand":
        values, lengths, n = args
        r = values.shape[0]
        library = (lambda: torch.repeat_interleave(values, lengths,
                                                   output_size=n)) \
            if r else None
        return (lambda: D.rle_expand_cuda(values, lengths, n),
                lambda: R.rle_expand_ref(values, lengths, n),
                library, 8 * r + lengths.element_size() * r + 8 * n)
    if name == "delta_unpack":
        z, first = args
        n = z.shape[0]
        return (lambda: D.delta_unpack_cuda(z, first),
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


def device_ms(fn, iters: int = 20) -> float:
    """Device time per call: the time of every kernel and copy that
    ``fn`` puts on the card, summed by ``torch.profiler`` over ``iters``
    calls. Unlike CUDA events around back-to-back calls, it leaves out
    the host's time between launches, which sets the pace of calls
    that take a few microseconds on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / iters / 1e3


def measure_kernels(captured: dict, launches: dict, tag: str) -> list:
    """Bit-exact comparison and CUDA-event timings at the captured
    arguments ({kernel name: dispatch arguments}); one record per
    kernel."""
    recs = []
    for name in [n for n in KERNELS if n in captured]:
        meta, args = KERNELS[name], captured[name]
        kern, plain, library, nbytes = kernel_fns(name, args)
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        assert err == 0.0, f"{name}: kernel disagrees with its plain " \
                           f"version at {tag}'s shapes (max |err| {err})"
        rec = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=launches[name],
                   max_abs_err=err, ms=time_ms(kern),
                   plain_ms=time_ms(plain), device_ms=device_ms(kern),
                   plain_device_ms=device_ms(plain),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes",
                   library_ms=time_ms(library) if library else None)
        shapes = [tuple(a.shape) if torch.is_tensor(a) else a
                  for a in args]
        log(f"  [{tag}] {name} at {shapes}: bit-exact; kernel "
            f"{rec['ms']:.4f} ms ({rec['device_ms']:.4f} on the device), "
            f"plain {rec['plain_ms']:.4f} ms ({rec['plain_device_ms']:.4f}"
            f" on the device), library "
            f"{rec['library_ms'] if library else 'n/a'} ms, bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.1%} "
            f"of bound), {rec['launches']} launches in the run")
        recs.append(rec)
    return recs


def profile_run(run, tag: str, top: int = 10) -> None:
    """One more warm run under ``torch.profiler``: the wall time, the
    device's busy and idle share, and the kernels that took the most
    device time (where the time goes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"[{tag}] profiled warm run: wall {wall_ms:.1f} ms (profiler on), "
        f"device busy {busy_ms:.1f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.1%}; top device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  "
            f"{e.key[:100]}")


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
    runs)."""
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
    return cases


def decode_edge_cases(dev, large: bool = True) -> list:
    """(kernel name, dispatch arguments) for the decode kernels over the
    edge cases that ``tests/test_torch_decode.py`` also runs: n = 0,
    r = 1, runs of length 1, float bit patterns (-0.0, NaN payloads),
    delta steps across INT64_MIN and INT64_MAX at every stored width,
    k = 1, 15 and 16 with n not a multiple of vpw and lo negative or
    near the int64 limits, codes of -1 and r, an empty dictionary.
    ``large`` adds cases with tens of thousands of rows (many blocks, a
    constant run, a dictionary too big for shared memory)."""
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
    for name, args in edge_cases(dev) + decode_edge_cases(dev):
        kern, plain, _, _ = kernel_fns(name, args)
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        assert err == 0.0, (name, [tuple(a.shape) if torch.is_tensor(a)
                                   else a for a in args], err)
        n += 1
    log(f"[2 kernels] {n} edge cases: every kernel bit-exact against its "
        f"plain version")


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
               dev) -> list:
    """Phases B and C: one n2n level-2 run at ``scale`` orders; returns
    the per-kernel records."""
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
    q = nested_to_nested_query(2, "NCOP2", ncop2_t, part_t)
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
    profile_run(lambda: exe(env), tag)
    del out, plain, env, cap
    return recs


def phase_decode(env_np: dict, dev) -> list:
    """Phase D0: one 2^20-row chunk per codec, from columns of the SF10
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
    return measure_kernels(cap.args, counts, "D0")


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


def phase_stored(seed: int, dev) -> list:
    """Phases D and E: the SF10 data written with ``encoding="auto"``,
    reopened on the card and served by ``QueryService.execute_stored``
    (D) and ``execute_stored_streaming`` (E). Fills the decode records'
    launch counts from D's warm call; returns the records."""
    import shutil
    import tempfile
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
        2, "NCOP2", ncop2_t, part_t))])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_store_")
    try:
        t0 = time.perf_counter()
        w = DatasetWriter(os.path.join(tmp, "sf10"), "tpch", types,
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
    finally:
        shutil.rmtree(tmp)
    return recs


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    kind = phase_device()
    dev = torch.device("cuda")
    phase_build()
    phase_kernels(dev)
    phase_quickstart(dev)
    recs_b = phase_tpch("B n2n-L2 domain-elim", SCALE_B, args.seed,
                        True, dev)
    torch.cuda.empty_cache()
    phase_tpch("C n2n-L2 no-domain-elim", SCALE_C, args.seed, False,
               dev)
    torch.cuda.empty_cache()
    recs_d = phase_stored(args.seed, dev)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": recs_b + recs_d}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
