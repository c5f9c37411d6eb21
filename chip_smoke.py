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

The last three lines: nvidia-smi's name and power limit, the per-kernel
JSON record of phase B, and ``{"ok": true, "device": ...}``.
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
}


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

    def __enter__(self):
        from repro_torch.kernels import ops as kops
        self.kops, self.args, self._size = kops, {}, {}
        self._orig = {n: getattr(kops, n) for n in KERNELS}
        for n in KERNELS:
            setattr(kops, n, self._wrap(n, self._orig[n]))
        return self

    def _wrap(self, name, fn):
        def recorder(*args):
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            if size > self._size.get(name, -1):
                self._size[name], self.args[name] = size, args
            return fn(*args)
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


def measure_kernels(captured: dict, launches: dict, tag: str) -> list:
    """Bit-exact comparison and CUDA-event timings at the captured
    arguments; one record per kernel."""
    recs = []
    for name, meta in KERNELS.items():
        kern, plain, library, nbytes = kernel_fns(name, captured[name])
        err = max_abs_err(kern(), plain())
        torch.cuda.synchronize()
        assert err == 0.0, f"{name}: kernel disagrees with its plain " \
                           f"version at {tag}'s shapes (max |err| {err})"
        rec = dict(name=name, route="cuda", source=meta["source"],
                   replaces=meta["replaces"], launches=launches[name],
                   max_abs_err=err, ms=time_ms(kern),
                   plain_ms=time_ms(plain),
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes",
                   library_ms=time_ms(library) if library else None)
        shapes = [tuple(a.shape) if torch.is_tensor(a) else a
                  for a in captured[name]]
        log(f"  [{tag}] {name} at {shapes}: bit-exact; kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
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
    for name, args in edge_cases(dev):
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
    assert all(v > 0 for v in counts.values()), counts
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
    assert all(v > 0 for v in counts.values()), counts

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
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": recs_b}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
