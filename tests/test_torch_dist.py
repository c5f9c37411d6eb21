"""The port's distributed route over an 8-site virtual mesh against the
reference on 8 virtual XLA devices.

One subprocess (the reference's distributed half needs 8 virtual XLA
devices, set before JAX starts, as ``tests/test_dist.py`` does) runs
every case of ``run_cases`` through the reference and writes its outputs
(npz) and counters (JSON); the port runs the same cases in-process on
the CPU. Each case is compared under the ROADMAP.md rule (equal
capacities and dtypes, ``valid`` equal everywhere, data equal at valid
rows), every device metric and merged host counter exactly, and the
facts each case records (SHUFFLE_STATS, retraces, cache stats) exactly.

The cases: those of ``tests/test_dist.py``; the distributed lane of
``tests/test_differential.py`` (storage-derived skew statistics, 8
sites); the ``benchmarks/skew.py`` auto/off/always scenario and the
``benchmarks/hypercube.py`` hypercube/cascade scenario at scale=48, each
with its warm heavy-key rebind and its QueryService call.

The virtual-mesh tests at the end run the port alone: host counters
count once per run, a failing site fails the run with its own exception
and no hang, an injected exchange fault stays an ``ExchangeError``,
sites that diverge in their collectives raise, and a mesh without a
device raises where there is no GPU.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_env import assert_np_bag_equal
from test_torch_queries import (build_query, diff_catalog, diff_types,
                                flat_to_nested_query, float_key_data,
                                float_key_query, fresh_start,
                                nested_to_nested_query, quickstart,
                                tpch_catalog, tpch_types)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
PN = 8


# ---------------------------------------------------------------------------
# one namespace per package, so one text drives both
# ---------------------------------------------------------------------------

def ref_ns():
    from repro.columnar.table import FlatBag
    from repro.core import codegen as CG
    from repro.core import interpreter as I
    from repro.core import materialization as M
    from repro.core import nrc as N
    from repro.core import plans as P
    from repro.core import skew as SK
    from repro.core.unnesting import Catalog
    from repro.exec import dist as D
    from repro.serve import QueryService
    from repro.storage import StorageCatalog, table_stats
    return SimpleNamespace(
        N=N, M=M, CG=CG, I=I, P=P, SK=SK, D=D, Catalog=Catalog,
        QueryService=QueryService, table_stats=table_stats,
        mesh=lambda n: D.device_mesh_1d(n),
        shred=lambda inputs, types: CG.columnar_shred_inputs(inputs, types),
        from_rows=lambda rows, schema, cap: FlatBag.from_rows(
            rows, schema, capacity=cap),
        catalog=lambda root: StorageCatalog(root), to_np=np.asarray)


def port_ns():
    from repro_torch.columnar.table import FlatBag
    from repro_torch.core import codegen as CG
    from repro_torch.core import interpreter as I
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core import plans as P
    from repro_torch.core import skew as SK
    from repro_torch.core.unnesting import Catalog
    from repro_torch.exec import dist as D
    from repro_torch.serve import QueryService
    from repro_torch.storage import StorageCatalog, table_stats
    return SimpleNamespace(
        N=N, M=M, CG=CG, I=I, P=P, SK=SK, D=D, Catalog=Catalog,
        QueryService=QueryService, table_stats=table_stats,
        mesh=lambda n: D.device_mesh_1d(n, device="cpu"),
        shred=lambda inputs, types: CG.columnar_shred_inputs(
            inputs, types, device="cpu"),
        from_rows=lambda rows, schema, cap: FlatBag.from_rows(
            rows, schema, capacity=cap, device="cpu"),
        catalog=lambda root: StorageCatalog(root, device="cpu"),
        to_np=lambda t: t.cpu().numpy())


# ---------------------------------------------------------------------------
# the cases (run by the reference in the subprocess, by the port here)
# ---------------------------------------------------------------------------

def _pad(env):
    return {k: b.resize(((b.capacity + PN - 1) // PN) * PN)
            for k, b in env.items()}


def _parts(out, man):
    return {(): out[man.top], **{p: out[n] for p, n in man.dicts.items()}}


class Recorder:
    def __init__(self, ns):
        self.ns = ns
        self.arrays = {}
        self.facts = {}

    def bags(self, case, out):
        for name, bag in out.items():
            for c, a in bag.data.items():
                self.arrays[f"{case}/{name}/{c}"] = self.ns.to_np(a)
            self.arrays[f"{case}/{name}/__valid"] = self.ns.to_np(bag.valid)

    def fact(self, case, **kw):
        self.facts.setdefault(case, {}).update(
            {k: _plain(v) for k, v in kw.items()})


def _plain(v):
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in sorted(v.items())}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return v


def case_running(ns, rec):
    """test_dist: the running example, skew_default False and True."""
    from helpers import gen_cop, gen_parts
    fresh_start(ns.N)
    q, types = quickstart(ns.N)
    data = {"COP": gen_cop(n_cust=16, seed=2, zipf=0.6),
            "Part": gen_parts(29)}
    direct = ns.I.eval_expr(q, data)
    sp = ns.M.shred_program(ns.N.Program([ns.N.Assignment("Q", q)]), types,
                            domain_elimination=True)
    cp = ns.CG.compile_program(
        sp, ns.Catalog(unique_keys={"Part__F": ("pid",)}))
    env = _pad(ns.shred(data, types))
    man = sp.manifests["Q"]
    names = [man.top] + list(man.dicts.values())
    for skew in (False, True):
        def fn(env_local, ctx):
            o = ns.CG.run_flat_program(cp, env_local,
                                       ns.P.ExecSettings(dist=ctx))
            return {k: o[k] for k in names}
        out, m = ns.D.run_distributed(fn, env, ns.mesh(PN),
                                      skew_default=skew, cap_factor=16.0)
        ok = ns.I.bags_equal(direct, ns.CG.parts_to_rows(_parts(out, man),
                                                         q.ty))
        rec.bags(f"running_skew{int(skew)}", out)
        rec.fact(f"running_skew{int(skew)}", metrics=m, oracle=ok)


def _kv_bag(ns, rows, cap):
    return ns.from_rows(rows, {"k": "int", "v": "real"}, cap)


def case_exchange(ns, rec):
    """test_dist: rows preserved, overflow detected, the overflow edge,
    adaptive sizing, and the packed kernel path."""
    rows = [{"k": i % 13, "v": float(i)} for i in range(64)]
    hot = [{"k": 0, "v": float(i)} for i in range(64)]

    def fn(env, ctx):
        return {"out": ctx.exchange(env["bag"], ("k",))}

    for case, data, kw in (
            ("exchange_cap16", rows, dict(cap_factor=16.0)),
            ("exchange_hot_cap1", hot, dict(cap_factor=1.0)),
            ("exchange_hot_cap8", hot, dict(cap_factor=8.0)),
            ("exchange_hot_cap7", hot, dict(cap_factor=7.0)),
            ("exchange_hot_adaptive", hot, dict(cap_factor=1.0,
                                                adaptive=True)),
            ("exchange_kernel", rows, dict(cap_factor=4.0,
                                           use_kernel=True))):
        out, m = ns.D.run_distributed(fn, {"bag": _kv_bag(ns, data, 64)},
                                      ns.mesh(PN), **kw)
        rec.bags(case, out)
        rec.fact(case, metrics=m)


def case_sum_dedup(ns, rec):
    """test_dist: distributed sum_by and dedup."""
    bag = _kv_bag(ns, [{"k": i % 5, "v": 1.0} for i in range(40)], 40)

    def fn(env, ctx):
        return {"s": ctx.sum_by(env["bag"], ("k",), ("v",)),
                "d": ctx.dedup(env["bag"], ("k",))}

    out, m = ns.D.run_distributed(fn, {"bag": bag}, ns.mesh(PN),
                                  cap_factor=16.0)
    rec.bags("sum_dedup", out)
    rec.fact("sum_dedup", metrics=m)


def case_elision(ns, rec):
    """test_dist: elision and SHUFFLE_STATS, packed and legacy."""
    L = ns.from_rows([{"k": i % 7, "v": float(i)} for i in range(64)],
                     {"k": "int", "v": "real"}, 64)
    R = ns.from_rows([{"k": i, "w": float(10 * i)} for i in range(8)],
                     {"k": "int", "w": "real"}, 8)
    env = {"L": L, "R": R}
    mesh = ns.mesh(PN)

    def fn(env, ctx):
        j = ctx.join(env["L"], env["R"], ("k",), ("k",))
        return {"out": ctx.sum_by(j, ("k",), ("v",), local_preagg=False)}

    def fn2(env, ctx):
        a = ctx.exchange(env["L"], ("k",))
        s = ctx.sum_by(a, ("k",), ("v",), local_preagg=False)
        return {"out": ctx.dedup(s, ("k",))}

    def fn3(env, ctx):
        a = ctx.exchange(env["L"], ("k",))
        b = ctx.exchange(env["R"], ("k",))
        j = ctx.join(a, b, ("k",), ("k",))
        return {"out": ctx.sum_by(j, ("k",), ("v",), local_preagg=False)}

    def fn4(env, ctx):
        return {"a": ctx.exchange(env["L"], ("k",)),
                "b": ctx.exchange(env["L"], ("k",))}

    for case, f, kw in (("elision_packed", fn, {}),
                        ("elision_legacy", fn, dict(shuffle_mode="legacy")),
                        ("elision_pipeline", fn2, {}),
                        ("elision_copartitioned", fn3, {}),
                        ("elision_route_reuse", fn4, {})):
        out, m = ns.D.run_distributed(f, env, mesh, cap_factor=16.0, **kw)
        rec.bags(case, out)
        rec.fact(case, metrics=m, shuffle_stats=dict(ns.D.SHUFFLE_STATS))


def case_join_sum_by(ns, rec):
    """benchmarks/fused_pipeline.py's distributed join -> sum_by on the
    same key (n=2000), legacy and packed: the published 14 -> 2
    collectives."""
    n, n_parts = 2000, 512
    rng = np.random.RandomState(0)
    li = ns.from_rows([{"pid": int(rng.randint(0, n_parts)),
                        "odate": int(rng.randint(0, 365)),
                        "qty": float(rng.randint(1, 50))} for _ in range(n)],
                      {"pid": "int", "odate": "int", "qty": "real"}, None)
    part = ns.from_rows([{"pid": i, "price": float(rng.randint(1, 100))}
                         for i in range(n_parts)],
                        {"pid": "int", "price": "real"}, None)
    env = _pad({"L": li, "R": part})

    def fn(env_local, ctx):
        j = ctx.join(env_local["L"], env_local["R"], ("pid",), ("pid",))
        j = j.with_columns(total=j.col("qty") * j.col("price"))
        s = ctx.sum_by(j, ("pid", "odate"), ("total",), local_preagg=True)
        return {"out": s}

    for mode, kw in (("legacy", dict(shuffle_mode="legacy", cap_factor=8.0)),
                     ("packed", dict(shuffle_mode="packed", cap_factor=2.0,
                                     adaptive=True))):
        runner, out, m = ns.D.compile_distributed(fn, env, ns.mesh(PN), **kw)
        out, m = runner(env)
        rec.bags(f"join_sum_by_{mode}", out)
        rec.fact(f"join_sum_by_{mode}", metrics=m)


def case_differential(ns, rec):
    """test_differential's distributed lane: random specs, storage-derived
    skew statistics, 8 sites."""
    import test_differential as TD
    rng = np.random.RandomState(20260731)
    types = diff_types(ns.N)
    for i in range(5):
        spec = TD.random_spec(rng)
        inputs = TD.gen_inputs(spec)
        fresh_start(ns.N)
        q = build_query(ns.N, spec)
        with tempfile.TemporaryDirectory() as td:
            cat = ns.catalog(td)
            cat.writer("d8", types, chunk_rows=16).append(inputs)
            stats = ns.table_stats(cat.open("d8"))
        sp = ns.M.shred_program(ns.N.Program([ns.N.Assignment("Q", q)]),
                                types, domain_elimination=True)
        cp = ns.CG.compile_program(sp, diff_catalog(ns.Catalog),
                                   skew_stats=stats, skew_partitions=PN)
        env = _pad(ns.shred(inputs, types))
        _, out, m = ns.CG.compile_program_distributed(cp, env, ns.mesh(PN),
                                                      cap_factor=16.0)
        man = sp.manifests["Q"]
        ok = ns.I.bags_equal(ns.I.eval_expr(q, inputs),
                             ns.CG.parts_to_rows(_parts(out, man), q.ty))
        rec.bags(f"differential{i}", out)
        rec.fact(f"differential{i}", metrics=m, oracle=ok,
                 plan=cp.pretty())


def _n_nodes(ns, cp, cls):
    return sum(1 for _, p in cp.plans for s in ns.P._walk_plan(p)
               if isinstance(s, cls))


def case_skew_bench(ns, rec):
    """benchmarks/skew.py's automatic scenario at scale=48, Zipf 2.0:
    auto / off / always, the warm rebind and the QueryService call."""
    from repro.data.generators import gen_tpch
    from benchmarks.common import materialize_nested_input
    db = gen_tpch(scale=48, skew=2.0, seed=0)
    nested, _ = materialize_nested_input(db, 2)
    fresh_start(ns.N)
    nty = flat_to_nested_query(ns.N, 2).ty
    types = {"NCOP": nty, "Part": tpch_types(ns.N)["Part"]}
    inputs = {"NCOP": nested, "Part": db["Part"]}
    catalog = tpch_catalog(ns.Catalog)
    mesh = ns.mesh(PN)
    with tempfile.TemporaryDirectory() as td:
        cat = ns.catalog(td)
        cat.writer("skewbench", types, chunk_rows=512).append(inputs)
        ds = cat.open("skewbench")
        stats = ns.table_stats(ds)
        env = _pad(ds.load_env())
    fresh_start(ns.N)
    q = nested_to_nested_query(ns.N, 2, "NCOP", nty)
    prog = ns.N.Program([ns.N.Assignment("Q", q)])
    sp = ns.M.shred_program(prog, types, domain_elimination=True)
    man = sp.manifests["Q"]
    direct = ns.I.eval_expr(q, inputs)
    runners = {}
    for mode in ("auto", "off", "always"):
        cp = ns.CG.compile_program(
            sp, catalog, skew_stats=stats if mode == "auto" else None,
            skew_partitions=PN)
        ns.CG.reset_trace_stats()
        runner, out, m = ns.CG.compile_program_distributed(
            cp, env, mesh, cap_factor=2.0, adaptive=True,
            skew_default=(mode == "always"))
        out, m = runner(env)
        runners[mode] = (cp, runner)
        ok = ns.I.bags_equal(direct, ns.CG.parts_to_rows(_parts(out, man),
                                                         q.ty))
        rec.bags(f"skew_{mode}", out)
        rec.fact(f"skew_{mode}", metrics=m, oracle=ok,
                 skew_nodes=_n_nodes(ns, cp, ns.P.SkewJoinP),
                 traces=ns.CG.TRACE_STATS.get("traces", 0),
                 runner_stats=runner.stats)
    cp, runner = runners["auto"]
    names = sorted(ns.P.collect_plan_params(cp.graph))
    set_a = ns.SK.decide_heavy_keys(stats["NCOP__D_corders_oparts"], "pid",
                                    PN)
    set_b = set_a + [max(set_a) + 1, max(set_a) + 2]
    t0 = ns.CG.TRACE_STATS.get("traces", 0)
    out, m = runner(env, params={names[0]: ns.SK.pad_heavy(set_b)})
    rec.bags("skew_rebind", out)
    rec.fact("skew_rebind", metrics=m, set_a=set_a, set_b=set_b,
             retraces=ns.CG.TRACE_STATS.get("traces", 0) - t0,
             oracle=ns.I.bags_equal(direct, ns.CG.parts_to_rows(
                 _parts(out, man), q.ty)))
    svc = ns.QueryService(types, catalog=catalog, mesh=mesh,
                          dist_kwargs=dict(cap_factor=2.0, adaptive=True))
    svc.execute(prog, env, skew_hints={"NCOP__D_corders_oparts":
                                       {"pid": set_a}})
    t0 = ns.CG.TRACE_STATS.get("traces", 0)
    out = svc.execute(prog, env, skew_hints={"NCOP__D_corders_oparts":
                                             {"pid": set_b}})
    rec.bags("skew_service", out)
    rec.fact("skew_service", metrics=svc.last_metrics, stats=svc.stats,
             retraces=ns.CG.TRACE_STATS.get("traces", 0) - t0)


def hypercube_query(N, types):
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


def case_hypercube_bench(ns, rec):
    """benchmarks/hypercube.py at scale=48: hypercube / cascade, the warm
    rebind and the QueryService call."""
    from repro.data.generators import gen_tpch
    db = gen_tpch(scale=48, skew=2.0, seed=0)
    fresh_start(ns.N)
    tt = tpch_types(ns.N)
    types = {k: tt[k] for k in ("Lineitem", "Part", "Orders")}
    inputs = {k: db[k] for k in types}
    q = hypercube_query(ns.N, types)
    prog = ns.N.Program([ns.N.Assignment("Q", q)])
    sp = ns.M.shred_program(prog, types, domain_elimination=True)
    man = sp.manifests["Q"]
    direct = ns.I.eval_expr(q, inputs)
    catalog = tpch_catalog(ns.Catalog)
    mesh = ns.mesh(PN)
    with tempfile.TemporaryDirectory() as td:
        cat = ns.catalog(td)
        cat.writer("hcbench", types, chunk_rows=512).append(inputs)
        ds = cat.open("hcbench")
        stats = ns.table_stats(ds)
        env = _pad(ds.load_env())
    runners = {}
    for mode in ("hypercube", "cascade"):
        cp = ns.CG.compile_program(
            sp, catalog, skew_stats=stats, skew_partitions=PN,
            hypercube_mode="auto" if mode == "hypercube" else "off")
        ns.CG.reset_trace_stats()
        runner, out, m = ns.CG.compile_program_distributed(
            cp, env, mesh, cap_factor=2.0, adaptive=True)
        out, m = runner(env)
        runners[mode] = (cp, runner)
        rec.bags(f"hc_{mode}", out)
        rec.fact(f"hc_{mode}", metrics=m, plan=cp.pretty(),
                 multijoin=_n_nodes(ns, cp, ns.P.MultiJoinP),
                 traces=ns.CG.TRACE_STATS.get("traces", 0),
                 oracle=ns.I.bags_equal(direct, ns.CG.parts_to_rows(
                     _parts(out, man), q.ty)))
    cp, runner = runners["hypercube"]
    hk = sorted(n for n in ns.P.collect_plan_params(cp.graph)
                if n.startswith("__hk"))
    set_a = ns.SK.decide_heavy_keys(stats["Lineitem__F"], "pid", PN)
    set_b = sorted(set_a) + [max(set_a) + 1, max(set_a) + 2]
    t0 = ns.CG.TRACE_STATS.get("traces", 0)
    out, m = runner(env, params={hk[0]: ns.SK.pad_heavy(set_b)})
    rec.bags("hc_rebind", out)
    rec.fact("hc_rebind", metrics=m, n_params=len(hk),
             retraces=ns.CG.TRACE_STATS.get("traces", 0) - t0,
             oracle=ns.I.bags_equal(direct, ns.CG.parts_to_rows(
                 _parts(out, man), q.ty)))
    svc = ns.QueryService(types, catalog=catalog, mesh=mesh,
                          dist_kwargs=dict(cap_factor=2.0, adaptive=True))
    svc.execute(prog, env, skew_hints={"Lineitem__F": {"pid": set_a}})
    t0 = ns.CG.TRACE_STATS.get("traces", 0)
    out = svc.execute(prog, env, skew_hints={"Lineitem__F": {"pid": set_b}})
    rec.bags("hc_service", out)
    rec.fact("hc_service", metrics=svc.last_metrics, stats=svc.stats,
             retraces=ns.CG.TRACE_STATS.get("traces", 0) - t0)


def case_float_key(ns, rec):
    """A join on a float key (pid, w REAL) through QueryService(mesh=...):
    both sides are routed by mix64(key) % P, so a site sees the rows
    whose keys the reference's casts make equal (NaN, -0.0 and every
    negative w to 0, values beyond the range saturated)."""
    fresh_start(ns.N)
    q, types = float_key_query(ns.N)
    data = float_key_data(48, seed=5)
    prog = ns.N.Program([ns.N.Assignment("Q", q)])
    env = _pad(ns.shred(data, types))
    svc = ns.QueryService(types, catalog=ns.Catalog(), mesh=ns.mesh(PN),
                          dist_kwargs=dict(cap_factor=16.0))
    out = svc.execute(prog, env)
    rows = svc.unshred(prog, env, out, "Q")
    rec.bags("float_key_service", out)
    # the reference's answer is not the oracle's; the port gives the same
    rec.fact("float_key_service", metrics=svc.last_metrics,
             shuffle_stats=dict(ns.D.SHUFFLE_STATS),
             matches_oracle=ns.I.bags_equal(ns.I.eval_expr(q, data), rows))


GROUPS = (case_running, case_exchange, case_sum_dedup, case_elision,
          case_join_sum_by, case_differential, case_skew_bench,
          case_hypercube_bench, case_float_key)
CASES = (["running_skew0", "running_skew1", "exchange_cap16",
          "exchange_hot_cap1", "exchange_hot_cap8", "exchange_hot_cap7",
          "exchange_hot_adaptive", "exchange_kernel", "sum_dedup",
          "elision_packed", "elision_legacy", "elision_pipeline",
          "elision_copartitioned", "elision_route_reuse",
          "join_sum_by_legacy", "join_sum_by_packed"]
         + [f"differential{i}" for i in range(5)]
         + ["skew_auto", "skew_off", "skew_always", "skew_rebind",
            "skew_service", "hc_hypercube", "hc_cascade", "hc_rebind",
            "hc_service", "float_key_service"])


def run_cases(ns, reset) -> Recorder:
    rec = Recorder(ns)
    for group in GROUPS:
        reset()
        group(ns, rec)
    return rec


_CHILD = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys, json
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
sys.path.insert(0, {root!r})
import numpy as np
import repro
from repro.obs import reset_telemetry
import test_torch_dist as T
rec = T.run_cases(T.ref_ns(), reset_telemetry)
np.savez({npz!r}, **rec.arrays)
with open({js!r}, "w") as f:
    json.dump(rec.facts, f)
print("OK")
"""


@pytest.fixture(scope="module")
def both():
    """(reference Recorder-like (arrays, facts), port Recorder)."""
    from repro_torch.obs import reset_telemetry
    with tempfile.TemporaryDirectory() as td:
        npz, js = os.path.join(td, "ref.npz"), os.path.join(td, "ref.json")
        script = _CHILD.format(src=os.path.abspath(SRC), tests=TESTS,
                               root=os.path.abspath(os.path.join(TESTS,
                                                                 "..")),
                               npz=npz, js=js)
        proc = subprocess.Popen([sys.executable, "-c", script],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        # the port runs while the reference subprocess compiles
        sys.path.insert(0, os.path.abspath(os.path.join(TESTS, "..")))
        port = run_cases(port_ns(), reset_telemetry)
        reset_telemetry()
        out, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"STDOUT:{out}\nSTDERR:{err}"
        with np.load(npz) as z:
            arrays = {k: z[k] for k in z.files}
        with open(js) as f:
            facts = json.load(f)
    return SimpleNamespace(arrays=arrays, facts=facts), port


def _bags_of(arrays, case):
    bags = {}
    for key, a in arrays.items():
        c, name, col = key.split("/", 2)
        if c == case:
            cols, valid = bags.setdefault(name, ({}, None))
            if col == "__valid":
                bags[name] = (cols, a)
            else:
                cols[col] = a
    return bags


@pytest.mark.parametrize("case", CASES)
def test_case_matches_reference(both, case):
    ref, port = both
    want, got = _bags_of(ref.arrays, case), _bags_of(port.arrays, case)
    assert want and set(want) == set(got), (sorted(want), sorted(got))
    for name in want:
        assert_np_bag_equal(want[name], got[name], f"{case}/{name}")
    assert port.facts[case] == ref.facts[case], \
        (case, ref.facts[case], port.facts[case])
    for key in ("oracle",):
        if key in ref.facts[case]:
            assert ref.facts[case][key] is True, case


def test_published_counters(both):
    """The reference's published facts hold in the port: packed
    join->sum_by ships in 2 collectives with one exchange elided (14 in
    the legacy per-column path); the HyperCube chain takes 2 collectives
    against the cascade's 6; warm heavy-key rebinds retrace nothing."""
    _, port = both
    f = port.facts
    assert f["join_sum_by_packed"]["metrics"]["shuffle_collectives"] == 2
    assert f["join_sum_by_packed"]["metrics"]["exchanges_elided"] == 1
    assert f["join_sum_by_legacy"]["metrics"]["shuffle_collectives"] == 14
    assert f["hc_hypercube"]["metrics"]["shuffle_collectives"] == 2
    assert f["hc_cascade"]["metrics"]["shuffle_collectives"] == 6
    assert f["hc_hypercube"]["multijoin"] >= 1
    for case in ("skew_rebind", "skew_service", "hc_rebind", "hc_service"):
        assert f[case]["retraces"] == 0, case
    assert f["skew_auto"]["skew_nodes"] >= 1
    assert f["skew_auto"]["metrics"]["shuffle_rows"] \
        < f["skew_off"]["metrics"]["shuffle_rows"]


# ---------------------------------------------------------------------------
# the virtual mesh itself (port only)
# ---------------------------------------------------------------------------

def _port_kv(n=64):
    from repro_torch.columnar.table import FlatBag
    return FlatBag.from_rows([{"k": i % 13, "v": float(i)}
                              for i in range(n)],
                             {"k": "int", "v": "real"}, capacity=n,
                             device="cpu")


def test_host_counters_count_once_per_run():
    """SHUFFLE_STATS, SORT_STATS and the size gauges move once per run,
    not once per site; a warm call moves none of them."""
    from repro_torch.exec import dist as D
    from repro_torch.exec import ops as X
    from repro_torch.obs import reset_telemetry

    def fn(env, ctx):
        s = ctx.sum_by(env["bag"], ("k",), ("v",))
        return {"s": s, "h": ctx.gather_all(env["bag"])}

    reset_telemetry()
    runner, _, m = D.compile_distributed(fn, {"bag": _port_kv()},
                                         D.device_mesh_1d(PN, device="cpu"),
                                         cap_factor=16.0)
    stats = dict(D.SHUFFLE_STATS)
    assert stats["exchanges"] == 1 and stats["collectives"] == 2, stats
    assert stats["size_used_0"] == 64 * 16 // PN // PN, stats
    sorts = dict(X.SORT_STATS)
    assert sum(sorts.values()) > 0
    runner({"bag": _port_kv()})
    assert dict(D.SHUFFLE_STATS) == stats
    assert dict(X.SORT_STATS) == sorts
    assert m["shuffle_collectives"] == 2 and m["exchanges"] == 1


def test_failing_site_raises_its_own_exception_without_hang():
    from repro_torch.exec import dist as D

    class Boom(RuntimeError):
        pass

    def fn(env, ctx):
        if ctx.site == 3:
            raise Boom("site 3 fails before its first collective")
        return {"out": ctx.exchange(env["bag"], ("k",))}

    mesh = D.device_mesh_1d(PN, device="cpu")
    t0 = time.perf_counter()
    with pytest.raises(Boom, match="site 3"):
        D.run_distributed(fn, {"bag": _port_kv()}, mesh, cap_factor=16.0)
    assert time.perf_counter() - t0 < 20.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesh-site-")]


def test_injected_exchange_fault_stays_exchange_error():
    from repro_torch.errors import ExchangeError
    from repro_torch.exec import dist as D
    from repro_torch.faults import FAULTS

    def fn(env, ctx):
        return {"out": ctx.exchange(env["bag"], ("k",))}

    FAULTS.reset()
    rule = FAULTS.arm("dist.exchange", "fail")
    try:
        with pytest.raises(ExchangeError, match="injected"):
            D.run_distributed(fn, {"bag": _port_kv()},
                              D.device_mesh_1d(PN, device="cpu"),
                              cap_factor=16.0)
        # consulted once for the run (on site 0), as at the single trace
        assert FAULTS.calls["dist.exchange"] == 1 and rule.fired == 1
    finally:
        FAULTS.reset()


@pytest.mark.parametrize("how", ["other_collective", "skipped"])
def test_diverging_sites_raise(how):
    from repro_torch.exec import dist as D

    def fn(env, ctx):
        if ctx.site == 5:
            if how == "skipped":
                return {"out": env["bag"]}
            return {"out": ctx.gather_all(env["bag"])}
        return {"out": ctx.exchange(env["bag"], ("k",))}

    mesh = D.device_mesh_1d(PN, device="cpu")
    t0 = time.perf_counter()
    with pytest.raises(D.CollectiveMismatchError):
        D.run_distributed(fn, {"bag": _port_kv()}, mesh, cap_factor=16.0)
    assert time.perf_counter() - t0 < 20.0


def test_collective_wait_times_out(monkeypatch):
    from repro_torch.exec import dist as D
    monkeypatch.setattr(D, "_WAIT_S", 0.2)
    rv = D._Rendezvous(2)
    with pytest.raises(D.CollectiveTimeout):
        rv.gather(0, ("psum", 0), 1)


def test_mesh_without_device_needs_a_gpu():
    from repro_torch.exec import dist as D
    if torch.cuda.is_available():
        assert D.device_mesh_1d(PN).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            D.device_mesh_1d(PN)
    assert D.device_mesh_1d(PN, device="cpu").shape == {"data": PN}


def test_rendezvous_under_fast_thread_switching():
    """More sites than cores, with the interpreter switching threads
    every few microseconds: every run gives the same rows, metrics and
    counters as the first."""
    from repro_torch.exec import dist as D

    def fn(env, ctx):
        s = ctx.sum_by(env["bag"], ("k",), ("v",))
        return {"s": s, "x": ctx.exchange(env["bag"], ("k",))}

    mesh = D.device_mesh_1d(16, device="cpu")
    bag = _port_kv(128)
    want, want_m = D.run_distributed(fn, {"bag": bag}, mesh,
                                     cap_factor=16.0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            got, m = D.run_distributed(fn, {"bag": bag}, mesh,
                                       cap_factor=16.0)
            assert m == want_m
            for name in want:
                assert torch.equal(got[name].valid, want[name].valid)
                for c in want[name].data:
                    assert torch.equal(got[name].data[c],
                                       want[name].data[c]), (name, c)
    finally:
        sys.setswitchinterval(old)
