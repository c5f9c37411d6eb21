"""The port's ``QueryService.execute_many`` against the reference's, on
the CPU: ``tests/test_query_service.py``'s two ``execute_many`` cases
through both packages, its ``batch_calls`` and plan-cache counters held
to the reference's, and each batched program's outputs bit-equal to its
own ``execute`` and to the reference's batch (data and ``valid``)."""

import numpy as np
import pytest
import torch

from repro.core import codegen as RCG
from repro.core import nrc as RN
from repro.core.unnesting import Catalog as RCatalog
from repro.serve import QueryService as RService
from repro_torch.core import codegen as TCG
from repro_torch.core import nrc as TN
from repro_torch.core.unnesting import Catalog as TCatalog
from repro_torch.obs import reset_telemetry
from repro_torch.serve import QueryService as TService

from test_torch_env import assert_env_parity
from test_torch_queries import fresh_start

THRESHOLDS = (3.0, 7.0, 15.0)


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def types(N) -> dict:
    part_t = N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL))
    ord_t = N.bag(N.tuple_t(odate=N.INT,
                            oparts=N.bag(N.tuple_t(pid=N.INT, qty=N.REAL))))
    return {"Ord": ord_t, "Part": part_t}


def family(N, min_price: float):
    """``tests/test_query_service.py``'s family, built with ``N``."""
    fresh_start(N)
    T = types(N)
    Part = N.Var("Part", T["Part"])
    Ord = N.Var("Ord", T["Ord"])

    def tops(x):
        inner = N.for_in("op", x.oparts, lambda op:
            N.for_in("p", Part, lambda p:
                N.IfThen(N.BoolOp("&&", op.pid.eq(p.pid),
                                  p.price.ge(N.Const(min_price, N.REAL))),
                         N.Singleton(N.record(pname=p.pname,
                                              total=op.qty * p.price)))))
        return N.SumBy(inner, keys=("pname",), values=("total",))

    q = N.for_in("x", Ord, lambda x: N.Singleton(N.record(
        odate=x.odate, tops=tops(x))))
    return N.Program([N.Assignment("Q", q)])


def flat(N):
    """A family with no liftable constant."""
    fresh_start(N)
    Ord = N.Var("Ord", types(N)["Ord"])
    return N.Program([N.Assignment("Q", N.SumBy(
        N.for_in("x", Ord, lambda x:
            N.for_in("op", x.oparts, lambda op:
                N.Singleton(N.record(odate=x.odate, qty=op.qty)))),
        keys=("odate",), values=("qty",)))])


def gen_data(n_orders=10, seed=0, max_items=4):
    rng = np.random.RandomState(seed)
    orders = [{"odate": 20200000 + i,
               "oparts": [{"pid": int(rng.randint(1, 10)),
                           "qty": float(rng.randint(1, 5))}
                          for _ in range(rng.randint(0, max_items + 1))]}
              for i in range(n_orders)]
    parts = [{"pid": i, "pname": 100 + i,
              "price": float(rng.randint(1, 20))}
             for i in range(1, 11)]
    return {"Ord": orders, "Part": parts}


SIDES = ((RN, RCatalog, RService, RCG, {}),
         (TN, TCatalog, TService, TCG, {"device": "cpu"}))


def services():
    """(N, service, env, codegen) for each package, on the same data."""
    out = []
    for N, C, Service, CG, dev in SIDES:
        svc = Service(types(N), catalog=C(unique_keys={"Part__F": ("pid",)}))
        out.append((N, svc, svc.shred_inputs(gen_data(), **dev), CG))
    return out


def _bits(t):
    return {torch.float64: lambda: t.view(torch.int64),
            torch.float32: lambda: t.view(torch.int32)}.get(
                t.dtype, lambda: t)()


def assert_bit_equal(a: dict, b: dict) -> None:
    """Every column and ``valid`` of every output, bit for bit."""
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name].valid, b[name].valid), name
        assert sorted(a[name].data) == sorted(b[name].data), name
        for c in a[name].data:
            assert torch.equal(_bits(a[name].data[c]),
                               _bits(b[name].data[c])), (name, c)


def test_execute_many_batches_one_family():
    """test_query_service.py::test_execute_many_batches_one_family on
    both packages: each batched output equals the program's own
    ``execute`` bit for bit, and the reference's batch."""
    got = []
    for N, svc, env, CG in services():
        outs = svc.execute_many([family(N, t) for t in THRESHOLDS], env)
        assert len(outs) == len(THRESHOLDS)
        singles = [svc.execute(family(N, t), env) for t in THRESHOLDS]
        got.append((outs, singles, dict(svc.stats)))
    (r_outs, r_singles, r_stats), (t_outs, t_singles, t_stats) = got
    assert r_stats == t_stats == {"hits": 3, "misses": 1, "evictions": 0,
                                  "batch_calls": 1}
    for t, out, single, ref in zip(THRESHOLDS, t_outs, t_singles, r_outs):
        assert_bit_equal(out, single)
        assert_env_parity(ref, out)
    for r_single, t_single in zip(r_singles, t_singles):
        assert_env_parity(r_single, t_single)


def test_execute_many_rejects_mixed_families():
    got = []
    for N, svc, env, _ in services():
        with pytest.raises(AssertionError, match="family"):
            svc.execute_many([family(N, 3.0), flat(N)], env)
        with pytest.raises(AssertionError, match="empty batch"):
            svc.execute_many([], env)
        got.append(dict(svc.stats))
    assert got[0] == got[1]


def test_batch_calls_and_plan_cache_counters_match_reference():
    """A cold batch, a warm batch of another size, an execute between
    them and a constant-free family: the same ``stats`` after each step,
    and the reference's traces: one for the cold batch, and one for the
    batch of another size (a batched body is built per batch size)."""
    steps = []
    for N, svc, env, CG in services():
        trace = []
        CG.reset_trace_stats()
        svc.execute_many([family(N, t) for t in THRESHOLDS], env)
        trace.append((dict(svc.stats), CG.TRACE_STATS.get("traces", 0)))
        svc.execute(family(N, 2.0), env)
        trace.append((dict(svc.stats), None))
        warm = CG.TRACE_STATS.get("traces", 0)
        svc.execute_many([family(N, t) for t in (1.0, 9.0)], env)
        rebuilt = CG.TRACE_STATS.get("traces", 0) - warm
        trace.append((dict(svc.stats), None))
        outs = svc.execute_many([flat(N), flat(N)], env)
        assert outs[0] is outs[1]         # identical invocations run once
        trace.append((dict(svc.stats), None))
        steps.append((trace, rebuilt))
    (r_trace, r_rebuilt), (t_trace, t_rebuilt) = steps
    assert r_trace == t_trace
    assert t_trace[-1][0] == {"hits": 2, "misses": 2, "evictions": 0,
                              "batch_calls": 3}
    assert t_trace[0][1] == 1 and t_rebuilt == r_rebuilt == 1


def test_execute_many_is_a_local_path_feature():
    from repro_torch.exec.dist import device_mesh_1d
    svc = TService(types(TN), mesh=device_mesh_1d(2, device="cpu"))
    with pytest.raises(AssertionError, match="local-path"):
        svc.execute_many([family(TN, 3.0)], {})
    assert svc.stats["batch_calls"] == 0
