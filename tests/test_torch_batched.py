"""The port's batched family execution against the reference's, on the
CPU: ``QueryService.execute_many`` runs the program body once over a
batch axis of the stacked parameter bindings (``codegen.vmap_program``,
``torch.func.vmap``), as the reference's ``jax.jit(jax.vmap(raw_fn))``
does.

* Each batched output is bit-equal (data and ``valid``) to its own
  ``execute`` in the port, and to the reference's ``jax.vmap`` batch at
  its valid rows (data and ``valid``, as every parity test of the port
  compares), with ``use_kernel`` off and on (the reference's Pallas
  kernels in interpret mode, as its own tests run them), over
  ``test_torch_query_service.py``'s family and lifted-constant families
  of ``test_torch_queries``' specs that reach ``dedup``,
  ``general_join`` and ``union_all``. ``nest_level``, which only the
  standard route runs, is held under both packages' vmap directly.
* The body runs once per call, and the counters move as the reference's
  over batches of 3, 2 and 3. A batch beyond the family's ``batch_cap``,
  or one whose pass runs out of memory, runs in smaller passes.
* The three kernels' custom ops: their vmap rules give the loop's
  result for every layout of shared and batched operands, and a call
  outside the batched pass does not reach them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codegen as RCG
from repro.core import nrc as RN
from repro.core import plans as RP
from repro.core.plans import ExecSettings as RSettings
from repro.core.unnesting import Catalog as RCatalog
from repro.exec import ops as RX
from repro.serve import QueryService as RService
from repro_torch.columnar.table import FlatBag as TFlatBag
from repro_torch.core import codegen as TCG
from repro_torch.core import nrc as TN
from repro_torch.core import plans as TP
from repro_torch.core.plans import ExecSettings as TSettings
from repro_torch.core.unnesting import Catalog as TCatalog
from repro_torch.exec import ops as TX
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR
from repro_torch.obs import reset_telemetry
from repro_torch.serve import QueryService as TService

import chip_smoke
import test_torch_query_service as QS
from test_torch_env import assert_bag_parity, assert_env_parity, port_env
from test_torch_queries import build_query, diff_catalog, diff_types, \
    fresh_start


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


# ---------------------------------------------------------------------------
# the families: (types, catalog, domain elimination, program of constants,
# three bindings)
# ---------------------------------------------------------------------------

def spec_family(spec: dict):
    def program(N, c):
        fresh_start(N)
        return N.Program([N.Assignment("Q", build_query(
            N, dict(spec, selc=c)))])
    return program


def union_family(N, c):
    """The lineitems of at least ``c`` units or of a part id at most
    ``2 c``, deduplicated: union_all and dedup under one constant."""
    fresh_start(N)
    Ord = N.Var("Ord", diff_types(N)["Ord"])

    def side(pred):
        return N.for_in("x", Ord, lambda x: N.for_in(
            "op", x.oparts, lambda op: N.IfThen(pred(op), N.Singleton(
                N.record(odate=x.odate, pid=op.pid)))))

    q = N.DeDup(N.UnionE(
        side(lambda op: op.qty.ge(N.Const(float(c), N.REAL))),
        side(lambda op: op.pid.le(N.Const(int(2 * c), N.INT)))))
    return N.Program([N.Assignment("Q", q)])


FAMILIES = {
    # fk_join and sum_by (test_query_service.py's family)
    "service": (QS.types, True, lambda N, c: QS.family(N, c),
                (3.0, 7.0, 15.0)),
    # dedup, general_join, fk_join, sum_by
    "nested_agg": (diff_types, False,
                   spec_family({"shape": "nested_agg", "sel": "qty_ge"}),
                   (1, 2, 3)),
    # dedup and general_join over two lifted constants
    "nested_map": (diff_types, False,
                   spec_family({"shape": "nested_map", "sel": "pid_le"}),
                   (2, 5, 9)),
    # union_all, dedup and the label join
    "union": (diff_types, True, union_family, (1, 2, 3)),
}


def family_service(N, C, Service, Settings, name, use_kernel, **dev):
    types, de, program, consts = FAMILIES[name]
    svc = Service(types(N), catalog=diff_catalog(C),
                  domain_elimination=de, settings=Settings(use_kernel))
    env = svc.shred_inputs(QS.gen_data(), **dev)
    return svc, env, [program(N, c) for c in consts]


def test_families_reach_the_operators_they_are_named_for():
    """Each family runs the operators its comment names, in the port's
    batch as in the reference's."""
    want = {"service": {"join", "sum_by"},
            "nested_agg": {"dedup", "join", "sum_by"},
            "nested_map": {"dedup", "join"},
            "union": {"union", "dedup", "join"}}
    for name, ops in want.items():
        seen = []
        for N, C, Service, Settings, P, dev in (
                (RN, RCatalog, RService, RSettings, RP, {}),
                (TN, TCatalog, TService, TSettings, TP, {"device": "cpu"})):
            P.reset_eval_stats()
            svc, env, progs = family_service(N, C, Service, Settings, name,
                                             False, **dev)
            svc.execute_many(progs, env)
            seen.append(dict(P.EVAL_STATS))
        assert seen[0] == seen[1], (name, seen)
        assert ops <= set(seen[1]), (name, seen[1])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_execute_many_bit_equal_to_reference_batch_and_own_execute(
        name, use_kernel):
    r_svc, r_env, r_progs = family_service(RN, RCatalog, RService,
                                           RSettings, name, use_kernel)
    t_svc, t_env, t_progs = family_service(TN, TCatalog, TService,
                                           TSettings, name, use_kernel,
                                           device="cpu")
    r_outs = r_svc.execute_many(r_progs, r_env)
    t_outs = t_svc.execute_many(t_progs, t_env)
    assert len(t_outs) == len(r_outs) == 3
    assert t_svc.stats == r_svc.stats
    for r_out, t_out, prog in zip(r_outs, t_outs, t_progs):
        assert_env_parity(r_out, t_out)
        QS.assert_bit_equal(t_out, t_svc.execute(prog, t_env))


def test_body_runs_once_per_execute_many():
    """A spy on the executable's body: one call for a batch of three,
    one for the next batch, on the program's own bags."""
    svc, env, progs = family_service(TN, TCatalog, TService, TSettings,
                                     "service", True, device="cpu")
    svc.execute(progs[0], env)                # compiles the family
    (entry,) = svc._cache.values()
    calls = []
    raw = entry.exe.raw_fn

    def spy(env_, params):
        calls.append(sorted(params))
        return raw(env_, params)

    entry.exe.raw_fn = spy
    try:
        svc.execute_many(progs, env)
        assert calls == [["__p0"]]
        svc.execute_many(progs[:2], env)
        assert len(calls) == 2
    finally:
        entry.exe.raw_fn = raw


def _five_bindings():
    svc, env, _ = family_service(TN, TCatalog, TService, TSettings,
                                 "service", True, device="cpu")
    program = FAMILIES["service"][2]
    return svc, env, [program(TN, c) for c in (3.0, 7.0, 15.0, 2.0, 9.0)]


def test_execute_many_runs_a_batch_beyond_batch_cap_in_passes():
    """A batch of five for a family whose ``batch_cap`` is 2: passes of
    2, 2 and 1 (one callable a size), every output bit-equal to its own
    execute, one ``batch_calls``; on the CPU the cap is not re-learned."""
    svc, env, progs = _five_bindings()
    svc.execute(progs[0], env)                # compiles the family
    (entry,) = svc._cache.values()
    entry.batch_cap = 2
    outs = svc.execute_many(progs, env)
    assert sorted(entry.batch_fns) == [1, 2]
    assert svc.stats["batch_calls"] == 1 and entry.batch_cap == 2
    for out, prog in zip(outs, progs):
        QS.assert_bit_equal(out, svc.execute(prog, env))


def test_execute_many_halves_its_passes_after_running_out_of_memory(
        monkeypatch):
    """A pass of more than two bindings that runs out of memory: the
    family's ``batch_cap`` halves (5 -> 2) and the batch goes on in
    passes of 2, 2 and 1, bit-equal to executes; a pass of one binding
    that runs out raises."""
    svc, env, progs = _five_bindings()
    real = TCG.vmap_program
    limit = {"bindings": 2}

    def tight(exe):
        fn = real(exe)

        def call(env_, stacked):
            if next(iter(stacked.values())).shape[0] > limit["bindings"]:
                raise torch.cuda.OutOfMemoryError("out of memory (test)")
            return fn(env_, stacked)
        return call

    monkeypatch.setattr(TCG, "vmap_program", tight)
    outs = svc.execute_many(progs, env)
    (entry,) = svc._cache.values()
    assert entry.batch_cap == 2 and sorted(entry.batch_fns) == [1, 2, 5]
    for out, prog in zip(outs, progs):
        QS.assert_bit_equal(out, svc.execute(prog, env))
    limit["bindings"] = 0
    entry.batch_fns.clear()
    with pytest.raises(torch.cuda.OutOfMemoryError):
        svc.execute_many(progs, env)
    assert entry.batch_cap == 1


def _counters(RX_or_TX, P, CG) -> dict:
    return {"sort": dict(RX_or_TX.SORT_STATS), "eval": dict(P.EVAL_STATS),
            "traces": CG.TRACE_STATS.get("traces", 0)}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_counters_match_reference_over_batches_of_3_2_3(use_kernel):
    """TRACE_STATS, SORT_STATS, EVAL_STATS and the plan-cache stats
    (``batch_calls`` among them) after each of three batches: a cold
    batch traces and records, a batch of a new size traces again, a
    warm batch of a size seen before moves none of them."""
    steps = []
    for N, C, Service, Settings, X, P, CG, dev in (
            (RN, RCatalog, RService, RSettings, RX, RP, RCG, {}),
            (TN, TCatalog, TService, TSettings, TX, TP, TCG,
             {"device": "cpu"})):
        svc, env, progs = family_service(N, C, Service, Settings,
                                         "nested_agg", use_kernel, **dev)
        X.reset_sort_stats()
        P.reset_eval_stats()
        CG.reset_trace_stats()
        trace = []
        for batch in (progs, progs[:2], progs[::-1]):
            svc.execute_many(batch, env)
            trace.append((_counters(X, P, CG), dict(svc.stats)))
        steps.append(trace)
    assert steps[0] == steps[1], steps
    (c1, s1), (c2, _), (c3, s3) = steps[1]
    assert c1["traces"] == 1 and c2["traces"] == 2 and c3 == c2
    assert sum(c1["sort"].values()) > 0 and c2["sort"] != c1["sort"]
    assert s3 == {"hits": 2, "misses": 1, "evictions": 0, "batch_calls": 3}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_nest_level_under_vmap_matches_reference(use_kernel):
    """The standard route's Gamma_u under both packages' vmap: a bag
    whose validity depends on a batched threshold, regrouped by
    ``nest_level`` (its kernel route is segment_sum_first's custom op)."""
    rng = np.random.RandomState(5)
    n = 64
    cols = {"g": rng.randint(0, 6, n).astype(np.int64),
            "h": rng.randint(0, 3, n).astype(np.int64),
            "x": rng.randint(0, 50, n).astype(np.float64)}
    valid = rng.rand(n) < 0.8
    th = np.array([5.0, 20.0, 35.0])

    def ref(th_):
        from repro.columnar.table import FlatBag
        bag = FlatBag({k: jnp.asarray(v) for k, v in cols.items()},
                      jnp.asarray(valid) & (jnp.asarray(cols["x"]) >= th_))
        p, c = RX.nest_level(bag, ("g", "h"), ("x",), "lbl",
                             use_kernel=use_kernel)
        return (p.data, p.valid), (c.data, c.valid)

    def port(th_):
        bag = TFlatBag({k: torch.from_numpy(v) for k, v in cols.items()},
                       torch.from_numpy(valid)
                       & (torch.from_numpy(cols["x"]) >= th_))
        p, c = TX.nest_level(bag, ("g", "h"), ("x",), "lbl",
                             use_kernel=use_kernel)
        return (p.data, p.valid), (c.data, c.valid)

    from repro.columnar.table import FlatBag as RFlatBag
    r_out = jax.vmap(ref)(jnp.asarray(th))
    with TK.batched_pass():
        t_out = torch.func.vmap(port)(torch.from_numpy(th))
    for b in range(len(th)):
        for (rd, rv), (td, tv) in zip(r_out, t_out):
            assert_bag_parity(RFlatBag({k: a[b] for k, a in rd.items()},
                                       rv[b]),
                              TFlatBag({k: a[b] for k, a in td.items()},
                                       tv[b]))
        single = port(torch.tensor(th[b]))
        for (td, tv), (sd, sv) in zip(t_out, single):
            assert torch.equal(tv[b], sv)
            assert all(torch.equal(td[k][b], sd[k]) for k in sd)


# ---------------------------------------------------------------------------
# the custom ops and their vmap rules
# ---------------------------------------------------------------------------

def _rule_cases():
    """(name, operands, batched) from chip_smoke's batched cases, on the
    CPU (segment_sum_first's up to 3,000 rows)."""
    cases = chip_smoke.batched_cases(np.random.RandomState(29), "cpu")
    return [c for c in cases
            if c[0] != "segment_sum_first" or c[1][0].shape[-2] <= 3000]


@pytest.mark.parametrize("layout", [(True, True), (False, True),
                                    (True, False)])
@pytest.mark.parametrize("name", ["segment_sum_first", "merge_positions",
                                  "gather_rows"])
def test_vmap_rule_gives_the_loops_result(name, layout):
    """Each kernel's custom op under ``torch.func.vmap`` (in_dims 0 for a
    batched operand, None for a shared one) against the plain version a
    slice at a time; segment_sum_first's seg_ids follow its values."""
    fn = getattr(TK, name)
    plain = {"segment_sum_first": TR.segment_sum_first_ref,
             "merge_positions": TR.merge_positions_ref,
             "gather_rows": TR.gather_rows_ref}[name]
    seen = 0
    for n, args, batched in _rule_cases():
        want_layout = layout if name != "segment_sum_first" else \
            (layout[0], layout[1], layout[0])
        if n != name or batched != want_layout:
            continue
        tensors = [a for a in args if torch.is_tensor(a)]
        rest = tuple(a for a in args if not torch.is_tensor(a))
        dims = tuple(0 if f else None for f in batched) + (None,) * len(rest)
        with TK.batched_pass():
            got = torch.func.vmap(fn, in_dims=dims)(*tensors, *rest)
        got = got if isinstance(got, tuple) else (got,)
        for b in range(chip_smoke.BATCH):
            want = plain(*(t[b] if f else t
                           for t, f in zip(tensors, batched)), *rest)
            want = want if isinstance(want, tuple) else (want,)
            assert all(torch.equal(g[b], w) for g, w in zip(got, want)), \
                (name, batched, b)
        seen += 1
    assert seen >= 3, (name, layout, seen)


def test_unbatched_calls_do_not_reach_the_custom_ops(monkeypatch):
    """Outside the batched pass the wrappers call their own functions
    (no dispatcher between); inside it, a call whose operands carry no
    batch axis runs the custom op's own function, once."""
    hits = []
    monkeypatch.setattr(TK, "_batched_ops", lambda: hits.append(1))
    vals = torch.arange(10, dtype=torch.int64).reshape(5, 2)
    idx = torch.tensor([4, 0, 9])
    keys, q = torch.tensor([1, 3, 3, 8]), torch.tensor([0, 3, 9])
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    TK.gather_rows(vals, idx)
    TK.merge_positions(keys, q)
    TK.segment_sum_first(vals[:3].float(), vals[:3], seg, 2)
    assert hits == []
    monkeypatch.undo()
    with TK.batched_pass():
        got = TK.gather_rows(vals, idx)
    assert torch.equal(got, TR.gather_rows_ref(vals, idx))
    assert TK.batched_launch_counts() == {"segment_sum_first": 0,
                                          "merge_positions": 0,
                                          "gather_rows": 0}


def test_batched_pass_is_per_thread_and_restored():
    import threading
    seen = []
    with TK.batched_pass():
        t = threading.Thread(target=lambda: seen.append(
            TK._in_batched_pass()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        seen.append(TK._in_batched_pass())
    seen.append(TK._in_batched_pass())
    assert seen == [False, True, False]


def test_plain_versions_map_under_vmap():
    """The three plain versions themselves under ``torch.func.vmap``,
    slice by slice equal to their unbatched calls: segment_sum_first's
    with ids out of range on both sides and empty segments."""
    rng = np.random.RandomState(3)
    B, n, S = 4, 50, 12
    seg = torch.from_numpy(np.sort(rng.randint(-2, S + 2, (B, n)), 1)
                           .astype(np.int32))
    vals = torch.from_numpy(rng.randint(0, 9, (B, n, 2)).astype(np.float32))
    keys = torch.from_numpy(rng.randint(-99, 99, (n, 3)))
    got = torch.func.vmap(TR.segment_sum_first_ref,
                          in_dims=(0, None, 0, None))(vals, keys, seg, S)
    sk = torch.from_numpy(np.sort(rng.randint(0, 9, (B, 20)), 1))
    q = torch.from_numpy(rng.randint(-1, 11, 30))
    lo, hi = torch.func.vmap(TR.merge_positions_ref,
                             in_dims=(0, None))(sk, q)
    gat = torch.func.vmap(TR.gather_rows_ref, in_dims=(None, 0))(
        keys, torch.from_numpy(rng.randint(-2, n + 2, (B, 7))))
    for b in range(B):
        want = TR.segment_sum_first_ref(vals[b], keys, seg[b], S)
        assert all(torch.equal(g[b], w) for g, w in zip(got, want))
        wlo, whi = TR.merge_positions_ref(sk[b], q)
        assert torch.equal(lo[b], wlo) and torch.equal(hi[b], whi)
    assert gat.shape == (B, 7, 3)
    assert torch.equal(TR.segment_sum_first_ref(vals[0], keys, seg[0], 0)[1],
                       torch.zeros(0, dtype=torch.int32))


def test_operators_stay_bit_identical_to_the_reference_eagerly():
    """The out-of-place rewrites in the local operators keep their eager
    results: sum_by, dedup and nest_level on a bag with interleaved
    invalid rows, both packages, both routes."""
    rng = np.random.RandomState(11)
    n = 40
    cols = {"k": rng.randint(0, 5, n).astype(np.int64),
            "v": rng.randint(0, 9, n).astype(np.float64)}
    valid = rng.rand(n) < 0.7
    from repro.columnar.table import FlatBag as RFlatBag
    rbag = RFlatBag({k: jnp.asarray(v) for k, v in cols.items()},
                    jnp.asarray(valid))
    tbag = port_env({"b": rbag})["b"]
    for use_kernel in (False, True):
        assert_bag_parity(RX.sum_by(rbag, ("k",), ("v",), use_kernel),
                          TX.sum_by(tbag, ("k",), ("v",), use_kernel))
        assert_bag_parity(RX.dedup(rbag, ("k",)), TX.dedup(tbag, ("k",)))
        for r, t in zip(RX.nest_level(rbag, ("k",), ("v",), "l",
                                      use_kernel=use_kernel),
                        TX.nest_level(tbag, ("k",), ("v",), "l",
                                      use_kernel=use_kernel)):
            assert_bag_parity(r, t)


def test_batch_stride_of_shared_and_batched_operands():
    """The batched wrappers' operand rule (``build.batch_stride``): an
    operand with one call's dims is shared (stride 0), one with a
    leading axis of B is read a slice a call; anything else, and a B
    beyond the kernels' grid axis, is refused."""
    from repro_torch.kernels import build
    x = torch.zeros((8, 5, 3))
    assert build.batch_stride("t", x[0], 2, 8) == 0
    assert build.batch_stride("t", x, 2, 8) == 15
    with pytest.raises(ValueError, match="leading batch of 4"):
        build.batch_stride("t", x, 2, 4)
    with pytest.raises(ValueError, match="want 2 dims"):
        build.batch_stride("t", x[0, 0], 2, 8)
    for B in (0, 65536, True):
        with pytest.raises(ValueError, match="batch of"):
            build.batch_stride("t", x[0], 2, B)
