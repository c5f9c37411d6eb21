"""Statistics-driven planning in the port against the reference: the
heavy-key helpers of ``core/skew.py`` (sampling, merging, membership,
the light/heavy split), the plan-time decisions (``decide_heavy_keys``,
the HyperCube share planner and its wire-cost arithmetic), the copy
``core/cost.py``, and the skew, HyperCube and cost passes.

Every case of ``tests/test_skew_plan.py``, ``tests/test_hypercube_plan.py``
and ``tests/test_cost.py`` that compiles or rewrites a plan is built here
with each package (one function, the NRC/plan modules passed in) and must
give the same ``plan_pretty`` text, the same heavy-key sets and
parameters, and the same estimates. The reference runs in this process
on its single CPU device; the distributed runs are in
``tests/test_torch_dist.py``."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_queries import fresh_start, quickstart

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
I64_MAX = np.iinfo(np.int64).max
OPARTS = "COP__D_corders_oparts"


def _ref():
    from repro.core import codegen as CG
    from repro.core import cost as C
    from repro.core import materialization as M
    from repro.core import nrc as N
    from repro.core import plans as P
    from repro.core import skew as SK
    from repro.core.unnesting import Catalog
    from repro.columnar.table import FlatBag
    return SimpleNamespace(CG=CG, C=C, M=M, N=N, P=P, SK=SK, Catalog=Catalog,
                           arr=jnp.asarray, np=np.asarray,
                           from_rows=FlatBag.from_rows)


def _port():
    from repro_torch.core import codegen as CG
    from repro_torch.core import cost as C
    from repro_torch.core import materialization as M
    from repro_torch.core import nrc as N
    from repro_torch.core import plans as P
    from repro_torch.core import skew as SK
    from repro_torch.core.unnesting import Catalog
    from repro_torch.columnar.table import FlatBag
    return SimpleNamespace(CG=CG, C=C, M=M, N=N, P=P, SK=SK, Catalog=Catalog,
                           arr=lambda a: torch.as_tensor(np.asarray(a)),
                           np=lambda t: t.numpy(),
                           from_rows=lambda *a, **k: FlatBag.from_rows(
                               *a, device="cpu", **k))


def both(fn, *args):
    """``fn(ns, *args)`` for each package; asserts equal results."""
    want, got = fn(_ref(), *args), fn(_port(), *args)
    assert got == want, (want, got)
    return got


def _plain(v):
    """Heavy arrays, tuples and dicts as comparable plain values."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------

KEY_CASES = {
    "zipf_hot": (lambda rng: np.concatenate([np.full(900, 7),
                                             np.arange(100)]), 1000),
    "uniform": (lambda rng: rng.randint(0, 5000, 1000), 1000),
    "two_hot_invalid": (lambda rng: np.where(rng.rand(700) < 0.5, 3,
                                             np.where(rng.rand(700) < 0.5,
                                                      -9, rng.randint(
                                                          0, 99, 700))), 700),
    "tiny": (lambda rng: np.array([5, 5, 5, 1]), 4),
    "ties": (lambda rng: np.repeat(np.arange(30), 40), 1200),
}


@pytest.mark.parametrize("case", sorted(KEY_CASES))
@pytest.mark.parametrize("sample,threshold", [(256, 0.025), (64, 0.1)])
def test_heavy_key_helpers_match_reference(case, sample, threshold):
    make, n = KEY_CASES[case]
    rng = np.random.RandomState(3)
    key = np.asarray(make(rng), np.int64)
    valid = rng.rand(n) < (0.8 if "invalid" in case else 1.0)

    def run(ns):
        hk = ns.SK.heavy_keys_local(ns.arr(key), ns.arr(valid),
                                    sample=sample, threshold=threshold)
        merged = ns.SK.merge_heavy(ns.arr(np.concatenate(
            [ns.np(hk), ns.np(hk)[::-1], np.array([I64_MAX, 7, -9])])))
        probe = np.concatenate([key[:50], [I64_MAX, 7, 3, -9, 424242]])
        member = ns.SK.is_member(ns.arr(probe), merged)
        return ns.np(hk).tolist(), ns.np(merged).tolist(), \
            ns.np(member).tolist()

    both(run)


def test_split_skew_matches_reference():
    def run(ns):
        bag = ns.from_rows([{"k": i % 6, "v": float(i)} for i in range(30)],
                           {"k": "int", "v": "real"}, capacity=32)
        heavy = ns.arr(ns.SK.pad_heavy([2, 5]))
        light, hv = ns.SK.split_skew(bag, ("k",), heavy)
        return ns.np(light.valid).tolist(), ns.np(hv.valid).tolist()

    both(run)


# ---------------------------------------------------------------------------
# plan-time decisions and the wire-cost arithmetic
# ---------------------------------------------------------------------------

DECIDE = [
    (1000, {}, {"pid": [(7, 300), (3, 10)]}, "pid", 8),
    (1000, {}, {"pid": [(7, 300), (3, 10)]}, "pid", 1),
    (1000, {}, {"pid": [(7, 300)]}, "qty", 8),
    (1000, {}, {"pid": [(7, 30)]}, "pid", 8),
    (1000, {"rows": 100}, {"pid": [(7, 30)]}, "pid", 8),
    (100, {"rows": 5000}, {"pid": [(7, 30)]}, "pid", 8),
    (500, {}, {"pid": [(k, 400 - k) for k in range(60)]}, "pid", 4),
]


@pytest.mark.parametrize("i", range(len(DECIDE)))
def test_decide_heavy_keys_matches_reference(i):
    rows, meters, heavy, col, parts = DECIDE[i]

    def run(ns):
        ts = ns.SK.TableStats(rows=rows, distinct={"pid": 50}, heavy=heavy,
                              meters=dict(meters))
        arr = ns.SK.stats_heavy_array({"T": ts}, "T", col, parts)
        return ns.SK.decide_heavy_keys(ts, col, parts), _plain(arr)

    both(run)


SHARES = [
    ([(0, 1), (0,), (1,)], [1000, 50, 60], 8),
    ([(0, 1), (0,), (1,)], [1000, 50, 60], 1),
    ([(0, 1), (0,), (1,)], [1000, 50, 60], 7),
    ([(0,), (0,)], [100, 100], 8),
    ([(0, 1, 2), (0,), (1,), (2,)], [5000, 10, 2000, 30], 16),
    ([(0,), (0, 1), (1,)], [100, 10, 50], 8),
]


@pytest.mark.parametrize("i", range(len(SHARES)))
def test_hypercube_planning_matches_reference(i):
    rel_dims, rows, P = SHARES[i]

    def run(ns):
        shares, load = ns.SK.plan_hypercube_shares(rel_dims, rows, P)
        inters = [float(r) / 3 for r in rows[1:]]
        return (list(shares), load,
                ns.SK.hypercube_send_rows(rel_dims, rows, shares),
                ns.SK.cascade_send_rows(rows),
                ns.SK.cascade_send_rows_est(rows, inters),
                len(ns.SK._share_assignments(len(rel_dims), P)))

    both(run)


def test_cost_copy_is_the_reference_text():
    """``core/cost.py`` is a copy: the reference's text outside its import
    lines (its imports are relative, so the text is the same)."""
    with open(os.path.join(ROOT, "src", "repro", "core", "cost.py")) as f:
        want = f.read()
    with open(os.path.join(ROOT, "src", "repro_torch", "core",
                           "cost.py")) as f:
        got = f.read()
    assert got == want


# ---------------------------------------------------------------------------
# test_skew_plan.py: the running example under the skew pass
# ---------------------------------------------------------------------------

def _running(ns, heavy, cost_mode="off", hypercube_mode="auto"):
    fresh_start(ns.N)
    q, types = quickstart(ns.N)
    sp = ns.M.shred_program(ns.N.Program([ns.N.Assignment("Q", q)]), types,
                            domain_elimination=True)
    stats = None
    if heavy is not None:
        stats = {OPARTS: ns.SK.TableStats(
            rows=500, distinct={"pid": 29},
            heavy={"pid": [(int(k), 500) for k in heavy]})}
    cp = ns.CG.compile_program(
        sp, ns.Catalog(unique_keys={"Part__F": ("pid",)}),
        skew_stats=stats, skew_partitions=8, cost_mode=cost_mode,
        hypercube_mode=hypercube_mode)
    return (cp.pretty(), cp.skew_params,
            _plain(ns.P.collect_plan_params(cp.graph)), cp.estimates)


@pytest.mark.parametrize("heavy", [None, [], [7], list(range(1, 30)),
                                   [424242]],
                         ids=["no_stats", "zero", "one", "all", "absent"])
@pytest.mark.parametrize("cost_mode", ["off", "auto"])
def test_skew_pass_on_running_example(heavy, cost_mode):
    both(_running, heavy, cost_mode)


def test_fused_join_agg_unfuses_under_skew():
    def run(ns):
        P = ns.P
        join = P.JoinP(P.ScanP("L", "l"), P.ScanP("R", "r"),
                       ("l.k",), ("r.k",))
        fused = P.push_order(P.SumAggP(join, keys=("l.g",),
                                       vals=("l.v",)))
        graph = P.build_program_graph([("Q", fused)], outputs=("Q",))
        stats = {"L": ns.SK.TableStats(rows=64, distinct={"k": 8},
                                       heavy={"k": [(7, 32)]})}
        info = P.apply_skew_program(graph, stats, n_partitions=8)
        return _plain(info), P.plan_pretty(graph.nodes[0].plan)

    both(run)


# ---------------------------------------------------------------------------
# test_hypercube_plan.py: chain recognition and rewrite
# ---------------------------------------------------------------------------

def _chain_plan(P, how="inner", unique_b=True):
    j1 = P.JoinP(P.ScanP("A", "a"), P.ScanP("B", "b"), ("a.k",), ("b.k",),
                 how=how, unique_right=unique_b,
                 expansion=1.0 if unique_b else 4.0)
    return P.JoinP(j1, P.ScanP("C", "c"), ("a.c",), ("c.c",))


def _chain_stats(SK, n=64, heavy=(), big=False, drop=None):
    st = {"A": SK.TableStats(rows=10 if big else n, distinct={"k": 16},
                             heavy={"k": [(int(k), n // 2)
                                          for k in heavy]}),
          "B": SK.TableStats(rows=10000 if big else 16, distinct={"k": 16},
                             heavy={}),
          "C": SK.TableStats(rows=10000 if big else 8, distinct={"c": 8},
                             heavy={})}
    if drop:
        del st[drop]
    return st


HC_CASES = {
    "chain_p8": dict(parts=8),
    "chain_p3": dict(parts=3),
    "chain_p1": dict(parts=1),
    "single_join": dict(parts=8, single=True),
    "outer_breaks": dict(parts=8, how="left_outer"),
    "missing_stats": dict(parts=8, drop="C"),
    "star_refused": dict(parts=8, big=True),
    "idempotent": dict(parts=8, twice=True),
    "fused_unfuses": dict(parts=8, fused=True),
    "skew_absorbed": dict(parts=8, heavy=[7], skew=True),
    "duplicate_build": dict(parts=8, unique_b=False),
    "cost_estimated": dict(parts=8, heavy=[7], skew=True, cost=True),
}


@pytest.mark.parametrize("case", sorted(HC_CASES))
def test_hypercube_pass_matches_reference(case):
    kw = HC_CASES[case]

    def run(ns):
        P, SK = ns.P, ns.SK
        if kw.get("single"):
            plan = P.JoinP(P.ScanP("A", "a"), P.ScanP("B", "b"),
                           ("a.k",), ("b.k",))
        else:
            plan = _chain_plan(P, kw.get("how", "inner"),
                               kw.get("unique_b", True))
        if kw.get("fused"):
            plan = P.push_order(P.SumAggP(plan, keys=("b.w",),
                                          vals=("a.v",)))
        g = P.build_program_graph([("Q", plan)], outputs=("Q",))
        stats = _chain_stats(SK, heavy=kw.get("heavy", ()),
                             big=kw.get("big", False), drop=kw.get("drop"))
        est = ns.C.CardinalityEstimator(stats, kw["parts"]) \
            if kw.get("cost") else None
        info = P.apply_skew_program(g, stats, n_partitions=kw["parts"],
                                    estimator=est) \
            if kw.get("skew") else {}
        n = [P.apply_hypercube_program(g, stats, kw["parts"],
                                       estimator=est)]
        if kw.get("twice"):
            n.append(P.apply_hypercube_program(g, stats, kw["parts"]))
        sig = P._plan_sig(g.nodes[0].plan, P._Canon())
        return (n, _plain(info), P.plan_pretty(g.nodes[0].plan),
                _plain(P.collect_plan_params(g)), str(sig))

    both(run)


def test_shared_relation_sketched_once():
    def run(ns):
        P = ns.P
        j1 = P.JoinP(P.ScanP("A", "a"), P.ScanP("B", "b"),
                     ("a.k",), ("b.k",))
        j2 = P.JoinP(P.ScanP("A", "a2"), P.ScanP("C", "c"),
                     ("a2.k",), ("c.c",))
        g = P.build_program_graph([("Q1", j1), ("Q2", j2)],
                                  outputs=("Q1", "Q2"))
        info = P.apply_skew_program(g, _chain_stats(ns.SK, heavy=[7]),
                                    n_partitions=8)
        return _plain(info), [P.plan_pretty(nd.plan) for nd in g.nodes]

    both(run)


# ---------------------------------------------------------------------------
# test_cost.py: the estimator and the costed decisions
# ---------------------------------------------------------------------------

class _Node:
    def __init__(self, name, plan):
        self.name, self.plan = name, plan


class _Graph:
    def __init__(self, nodes):
        self.nodes = nodes


def _cost_stats(SK, part_rows=30, part_distinct=30, heavy=None, o_rows=500):
    return {
        "L": SK.TableStats(rows=1000, distinct={"pid": 100, "oid": 500},
                           heavy={"pid": list(heavy or [])}),
        "Pt": SK.TableStats(rows=part_rows,
                            distinct={"pid": part_distinct}),
        "O": SK.TableStats(rows=o_rows, distinct={"oid": o_rows}),
    }


def _cost_chain(P, order=("O", "Pt")):
    plan = P.ScanP("L", "l")
    on = {"O": ("l.oid", "o.oid", "o"), "Pt": ("l.pid", "p.pid", "p")}
    for bag in order:
        lcol, rcol, alias = on[bag]
        plan = P.JoinP(plan, P.ScanP(bag, alias), (lcol,), (rcol,))
    return plan


COST_CASES = {
    "order_flips": dict(part_rows=30, part_distinct=30),
    "order_ties_keep": dict(part_rows=100, part_distinct=100),
    "order_no_stats": dict(no_stats=True),
    "order_key_dependency": dict(part_rows=100, part_distinct=100,
                                 dependent=True, o_rows=2),
    "fused_mild_kept": dict(part_rows=100, part_distinct=100,
                            heavy=[(7, 130)], fused=True),
    "fused_heavy_unfused": dict(part_rows=100, part_distinct=100,
                                heavy=[(7, 300)], fused=True),
    "fused_rule_based": dict(part_rows=100, part_distinct=100,
                             heavy=[(7, 130)], fused=True, rule=True),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_decisions_match_reference(case):
    kw = COST_CASES[case]

    def run(ns):
        P, C = ns.P, ns.C
        stats = {} if kw.get("no_stats") else _cost_stats(
            ns.SK, kw.get("part_rows", 30), kw.get("part_distinct", 30),
            kw.get("heavy"), kw.get("o_rows", 500))
        est = C.CardinalityEstimator(stats, 8)
        if kw.get("fused"):
            j = P.JoinP(P.ScanP("L", "l"), P.ScanP("Pt", "p"),
                        ("l.pid",), ("p.pid",))
            g = _Graph([_Node("T", P.FusedJoinAggP(j, keys=("l.oid",),
                                                   vals=("l.qty",)))])
            out = P.apply_skew_program(
                g, stats, 8, estimator=None if kw.get("rule") else est)
            return _plain(out), P.plan_pretty(g.nodes[0].plan)
        if kw.get("dependent"):
            l = P.ScanP("L", "l")
            j1 = P.JoinP(l, P.ScanP("Pt", "p"), ("l.pid",), ("p.pid",))
            plan = P.JoinP(j1, P.ScanP("O", "o"), ("p.pid",), ("o.oid",))
        else:
            plan = _cost_chain(P)
        g = _Graph([_Node("T", plan)])
        n = C.order_join_chains(g, est)
        root = est.estimate(g.nodes[0].plan)
        base = P.ScanP("L", "l")
        j1 = P.JoinP(base, P.ScanP("Pt", "p"), ("l.pid",), ("p.pid",))
        j2 = P.JoinP(j1, P.ScanP("O", "o"), ("l.oid",), ("o.oid",))
        return (n, P.plan_pretty(g.nodes[0].plan), root.rows, root.known,
                est.chain_intermediates(base, [j1, j2]),
                C.choose_unfuse(1000, [300], 8),
                C.choose_unfuse(1000, [130], 8))

    both(run)


def test_compile_program_cost_mode_matches_reference():
    def run(ns):
        N = ns.N
        fresh_start(N)
        types = {"R": N.bag(N.tuple_t(a=N.INT, b=N.INT))}
        R = N.Var("R", types["R"])
        q = N.for_in("x", R, lambda x: N.Singleton(N.record(a=x.a, b=x.b)))
        sp = ns.M.shred_program(N.Program([N.Assignment("Q", q)]), types,
                                domain_elimination=True)
        out = []
        for mode in ("off", "auto"):
            cp = ns.CG.compile_program(sp, cost_mode=mode)
            out.append((cp.pretty(), cp.estimates,
                        [getattr(s, "est_rows", None) for _, p in cp.plans
                         for s in ns.P._walk_plan(p)]))
        return out

    both(run)


def test_query_service_cost_mode_and_skew_partitions():
    """The service now accepts ``cost_mode="auto"`` and
    ``skew_partitions > 1`` (a local service: the skew pass plans, the
    plan runs as plain joins) and caches the estimates."""
    from repro_torch.core import nrc as N
    from repro_torch.serve import QueryService
    types = {"R": N.bag(N.tuple_t(a=N.INT, b=N.INT))}
    R = N.Var("R", types["R"])
    q = N.for_in("x", R, lambda x: N.Singleton(N.record(a=x.a)))
    prog = N.Program([N.Assignment("Q", q)])
    svc = QueryService(types, cost_mode="auto", skew_partitions=8)
    env = svc.shred_inputs({"R": [{"a": 1, "b": 2}, {"a": 3, "b": 4}]},
                           device="cpu")
    svc.execute(prog, env)
    (entry,) = svc._cache.values()
    assert entry.estimates and set(entry.estimates) == \
        {n for n, _ in entry.cp.plans}
    svc.execute(prog, env)
    assert svc.stats["hits"] == 1 and svc.stats["misses"] == 1
