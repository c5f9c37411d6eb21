"""The port's shredded route end to end, against the reference on the
same inputs: the quickstart, nested TPC-H (f2n and n2n, levels 1-3,
domain elimination on and off) through ``run_flat_program`` and
``jit_program``, lane 2 of the differential suite, and the counters
(``SORT_STATS``, ``EVAL_STATS``, ``TRACE_STATS``).

Inputs are built once by the reference and carried into the port with
``env_from_numpy`` (the port's own ingest is pinned in
``test_torch_env.py``). With ``use_kernel=True`` the reference runs its
jnp kernel oracles, except in the tests marked "interpret", which run
its Pallas kernels in interpret mode once per kernel.
"""

import numpy as np
import pytest
from hypothesis import given, settings

import benchmarks.common as BC
import test_differential as TD
from repro.core import codegen as RCG
from repro.core import interpreter as RI
from repro.core import materialization as RM
from repro.core import nrc as RN
from repro.core import plans as RP
from repro.core.unnesting import Catalog as RCatalog
from repro.data.generators import gen_tpch
from repro.exec import ops as RX
from repro.kernels import ops as RK
from repro_torch.core import codegen as TCG
from repro_torch.core import interpreter as TI
from repro_torch.core import materialization as TM
from repro_torch.core import nrc as TN
from repro_torch.core import plans as TP
from repro_torch.core.unnesting import Catalog as TCatalog
from repro_torch.exec import ops as TX
from repro_torch.obs import reset_telemetry

from test_torch_env import assert_env_parity, port_env
from test_torch_queries import (FK_ORD, FK_PARTS, FK_REFERENCE_ROWS, QS_COP,
                                QS_PARTS, build_query, build_query3,
                                diff_catalog, diff_types, diff_types3,
                                flat_to_nested_query, float_key_data,
                                float_key_query, fresh_start,
                                nested_to_nested_query, quickstart,
                                tpch_catalog, tpch_types)


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


@pytest.fixture
def reference_kernels():
    """``"oracle"``: the reference's jnp kernel oracles (fast);
    ``"interpret"``: its Pallas kernels in interpret mode."""
    prev = RK.USE_REF
    modes = {"oracle": True, "interpret": False}

    def use(mode):
        RK.USE_REF = modes[mode]

    try:
        yield use
    finally:
        RK.USE_REF = prev


def compile_both(build, types, catalog_of, de=True, **kw):
    """(reference sp, cp), (port sp, cp) of one query, from the same
    fresh-name state."""
    out = []
    for N, M, CG, Catalog in ((RN, RM, RCG, RCatalog),
                              (TN, TM, TCG, TCatalog)):
        fresh_start(N, value=500)
        q = build(N)
        sp = M.shred_program(N.Program([N.Assignment("Q", q)]), types(N),
                             domain_elimination=de)
        out.append((q, sp, CG.compile_program(sp, catalog_of(Catalog),
                                              **kw)))
    assert out[0][2].pretty() == out[1][2].pretty()
    return out


def outputs_equal(ref_out, port_out, names) -> None:
    assert_env_parity(ref_out, port_out, names)


def nested_rows(CG, sp, out, q):
    man = sp.manifests["Q"]
    return CG.parts_to_rows({(): out[man.top],
                             **{p: out[n] for p, n in man.dicts.items()}},
                            q.ty)


def counters_equal() -> None:
    assert dict(TX.SORT_STATS) == dict(RX.SORT_STATS), \
        (dict(TX.SORT_STATS), dict(RX.SORT_STATS))
    assert dict(TP.EVAL_STATS) == dict(RP.EVAL_STATS), \
        (dict(TP.EVAL_STATS), dict(RP.EVAL_STATS))


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
def test_quickstart_end_to_end(reference_kernels, use_kernel):
    """interpret: with use_kernel the reference runs all three Pallas
    kernels (fk_join + sum_by) in interpret mode."""
    reference_kernels("interpret")
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(
        lambda N: quickstart(N)[0], lambda N: quickstart(N)[1],
        lambda C: C(unique_keys={"Part__F": ("pid",)}))
    inputs = {"COP": QS_COP, "Part": QS_PARTS}
    renv = RCG.columnar_shred_inputs(inputs, quickstart(RN)[1])
    tenv = TCG.columnar_shred_inputs(inputs, quickstart(TN)[1],
                                     device="cpu")
    assert_env_parity(renv, tenv)
    rout = RCG.run_flat_program(rcp, renv, RP.ExecSettings(use_kernel))
    tout = TCG.run_flat_program(tcp, tenv, TP.ExecSettings(use_kernel))
    outputs_equal(rout, tout, rcp.outputs)
    counters_equal()
    got = nested_rows(TCG, tsp, tout, tq)
    assert TI.bags_equal(TI.eval_expr(tq, inputs), got)
    assert RI.bags_equal(RI.eval_expr(rq, inputs), got)


def test_jit_program_donates_the_env_as_the_reference_accepts():
    """``jit_program(cp, donate_env=True)``, the reference's call: the
    outputs equal the reference's, and the executable drops the env it
    was given (an emptied dict), where the reference deletes the donated
    buffers."""
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(
        lambda N: quickstart(N)[0], lambda N: quickstart(N)[1],
        lambda C: C(unique_keys={"Part__F": ("pid",)}))
    inputs = {"COP": QS_COP, "Part": QS_PARTS}
    rout = RCG.jit_program(rcp, donate_env=True)(
        RCG.columnar_shred_inputs(inputs, quickstart(RN)[1]))
    tenv = TCG.columnar_shred_inputs(inputs, quickstart(TN)[1],
                                     device="cpu")
    names = set(tenv)
    tout = TCG.jit_program(tcp, donate_env=True)(tenv)
    outputs_equal(rout, tout, rcp.outputs)
    assert names and tenv == {}
    kept = TCG.columnar_shred_inputs(inputs, quickstart(TN)[1],
                                     device="cpu")
    TCG.jit_program(tcp)(kept)
    assert set(kept) == names


# ---------------------------------------------------------------------------
# nested TPC-H, levels 1-3
# ---------------------------------------------------------------------------

_DB = {}


def tpch_db():
    if not _DB:
        _DB.update(gen_tpch(scale=20, skew=0.0, seed=0))
    return _DB


def tpch_case(kind, levels):
    """(builder, types, inputs) of one nested TPC-H query."""
    db = tpch_db()
    if kind == "f2n":
        return (lambda N: flat_to_nested_query(N, levels), tpch_types,
                dict(db))
    nested, _ = BC.materialize_nested_input(db, levels)

    def types(N):
        return {"NCOP": flat_to_nested_query(N, levels).ty,
                "Part": tpch_types(N)["Part"]}

    return (lambda N: nested_to_nested_query(
                N, levels, "NCOP", flat_to_nested_query(N, levels).ty),
            types, {"NCOP": nested, "Part": db["Part"]})


@pytest.mark.parametrize("de", [True, False], ids=["de", "no-de"])
@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("kind", ["f2n", "n2n"])
def test_tpch_matches_reference(reference_kernels, kind, levels, de):
    reference_kernels("oracle")
    build, types, inputs = tpch_case(kind, levels)
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(build, types,
                                                  tpch_catalog, de)
    renv = RCG.columnar_shred_inputs(inputs, types(RN))
    for use_kernel in (False, True):
        # eager scheduler: outputs and counters
        reset_telemetry()
        RX.reset_sort_stats()
        RP.reset_eval_stats()
        rout = RCG.run_flat_program(rcp, renv, RP.ExecSettings(use_kernel))
        tout = TCG.run_flat_program(tcp, port_env(renv),
                                    TP.ExecSettings(use_kernel))
        outputs_equal(rout, tout, rcp.outputs)
        counters_equal()
    # the whole-program executable (reference: one jax.jit)
    rout = RCG.jit_program(rcp, RP.ExecSettings(use_kernel=True))(renv)
    tout = TCG.jit_program(tcp, TP.ExecSettings(use_kernel=True))(
        port_env(renv))
    outputs_equal(rout, tout, rcp.outputs)
    got = nested_rows(TCG, tsp, tout, tq)
    assert TI.bags_equal(TI.eval_expr(tq, inputs), got)


def test_tpch_general_join_interpret(reference_kernels):
    """interpret: domain elimination off runs DeDup and general_join,
    whose merge_positions (twice) and gather_rows run as Pallas kernels
    in the reference."""
    reference_kernels("interpret")
    build, types, inputs = tpch_case("n2n", 1)
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(build, types,
                                                  tpch_catalog, de=False)
    renv = RCG.columnar_shred_inputs(inputs, types(RN))
    rout = RCG.run_flat_program(rcp, renv, RP.ExecSettings(use_kernel=True))
    tout = TCG.run_flat_program(tcp, port_env(renv),
                                TP.ExecSettings(use_kernel=True))
    outputs_equal(rout, tout, rcp.outputs)


# ---------------------------------------------------------------------------
# a float join key: the reference's casts (astype(int64) on the first key
# column, astype(uint64) on the later ones), and so its answer
# ---------------------------------------------------------------------------

def _run_float_key(inputs, catalog_of, use_kernel):
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(
        lambda N: float_key_query(N)[0], lambda N: float_key_query(N)[1],
        catalog_of)
    renv = RCG.columnar_shred_inputs(inputs, float_key_query(RN)[1])
    tenv = TCG.columnar_shred_inputs(inputs, float_key_query(TN)[1],
                                     device="cpu")
    assert_env_parity(renv, tenv)
    rout = RCG.run_flat_program(rcp, renv, RP.ExecSettings(use_kernel))
    tout = TCG.run_flat_program(tcp, tenv, TP.ExecSettings(use_kernel))
    outputs_equal(rout, tout, rcp.outputs)
    counters_equal()
    return tq, nested_rows(TCG, tsp, tout, tq)


@pytest.mark.parametrize("unique", [False, True],
                         ids=["general_join", "fk_join"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_float_key_spec_matches_reference(reference_kernels, use_kernel,
                                          unique):
    """Parts (1, -5.0, 100), (1, 2.0, 101) joined on (pid, w) by an
    order's parts (1, -3.0), (1, 2.0): the reference casts w to uint64,
    so -3.0 and -5.0 both become 0 and join. The port gives the
    reference's answer, which is not the oracle's (a gap of the
    reference, matched as the f2n gap is)."""
    reference_kernels("oracle")
    inputs = {"Ord": FK_ORD, "Part": FK_PARTS}
    tq, got = _run_float_key(
        inputs, lambda C: C(unique_keys={"Part__F": ("pid", "w")}
                            if unique else {}), use_kernel)
    assert TI.bags_equal(got, FK_REFERENCE_ROWS)
    assert not TI.bags_equal(TI.eval_expr(tq, inputs), got)


# A gap of the reference, matched: with domain elimination off, the filter
# inside a correlated sumBy becomes a predicate of the outer plan, applied
# after the Gamma+, and its column joins the group keys, so one order's
# parts (2, 2.0) and (2, 3.0) of part 102 (price 3.0) sum in two groups.
GAP_SPEC = {"shape": "nested_agg", "sel": "qty_ge", "selc": 2}
GAP_INPUTS = {"Ord": [{"odate": 1, "oparts": [{"pid": 2, "qty": 2.0},
                                               {"pid": 2, "qty": 3.0}]}],
              "Part": [{"pid": 2, "pname": 102, "price": 3.0}]}
GAP_REFERENCE_ROWS = [{"odate": 1, "tops": [{"pname": 102, "total": 6.0},
                                            {"pname": 102, "total": 9.0}]}]
GAP_ORACLE_ROWS = [{"odate": 1, "tops": [{"pname": 102, "total": 15.0}]}]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_filtered_sum_by_without_domain_elimination_matches_reference(
        reference_kernels, use_kernel):
    """``build_query``'s nested_agg with ``qty >= 2`` at
    ``domain_elimination=False``: the plan keys the Gamma+ by
    ``op__F.qty`` and selects after it. The port's plan text and rows
    equal the reference's, and both differ from the interpreter's."""
    reference_kernels("oracle")
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(
        lambda N: build_query(N, GAP_SPEC), diff_types, diff_catalog,
        de=False)
    plan = tcp.pretty()
    assert plan == rcp.pretty()
    assert "Select[op__F.qty >= 2.0]" in plan and "'op__F.qty'" in plan
    renv = RCG.columnar_shred_inputs(GAP_INPUTS, diff_types(RN))
    tenv = TCG.columnar_shred_inputs(GAP_INPUTS, diff_types(TN),
                                     device="cpu")
    rout = RCG.run_flat_program(rcp, renv, RP.ExecSettings(use_kernel))
    tout = TCG.run_flat_program(tcp, tenv, TP.ExecSettings(use_kernel))
    outputs_equal(rout, tout, rcp.outputs)
    got = nested_rows(TCG, tsp, tout, tq)
    assert TI.bags_equal(got, GAP_REFERENCE_ROWS)
    assert RI.bags_equal(nested_rows(RCG, rsp, rout, rq), GAP_REFERENCE_ROWS)
    assert TI.bags_equal(TI.eval_expr(tq, GAP_INPUTS), GAP_ORACLE_ROWS)
    assert RI.bags_equal(RI.eval_expr(rq, GAP_INPUTS), GAP_ORACLE_ROWS)
    assert not TI.bags_equal(got, GAP_ORACLE_ROWS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_float_keys_with_edge_values_match_reference(reference_kernels,
                                                     seed):
    """Orders whose part keys hold NaN, +-0.0, negatives, +-1e30, the
    infinities, values in [2^63, 2^64) and 2.1 beside 2.9."""
    reference_kernels("oracle")
    _run_float_key(float_key_data(24, seed), lambda C: C(), True)


# ---------------------------------------------------------------------------
# lane 2 of the differential suite (interpreter vs whole-program run)
# ---------------------------------------------------------------------------

def _lane2(build, types, catalog_of, inputs):
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(build, types, catalog_of)
    assert TN.pretty(tq) == RN.pretty(rq)
    direct = RI.eval_expr(rq, inputs)
    env = TCG.columnar_shred_inputs(inputs, types(TN), device="cpu")
    got = nested_rows(TCG, tsp, TCG.jit_program(tcp)(env), tq)
    assert TD.equal(direct, got)
    assert TI.bags_equal(TI.eval_expr(tq, inputs), got, float_digits=12)


@settings(max_examples=8, deadline=None, derandomize=True)
@given(TD.spec_st())
def test_differential_lane2_against_port(spec):
    _lane2(lambda N: build_query(N, spec), diff_types, diff_catalog,
           TD.gen_inputs(spec))


@settings(max_examples=6, deadline=None, derandomize=True)
@given(TD.spec3_st())
def test_differential3_lane2_against_port(spec):
    _lane2(lambda N: build_query3(N, spec), diff_types3,
           lambda C: diff_catalog(C, spec), TD.gen_inputs3(spec))


# ---------------------------------------------------------------------------
# counters: the CSE program (test_cse.py) and the plan cache
# ---------------------------------------------------------------------------

def shared_join_query(N):
    """test_cse.shared_join_query: two dictionaries materialize from
    the same oparts-Part join."""
    T = diff_types(N)
    Part, Ord = N.Var("Part", T["Part"]), N.Var("Ord", T["Ord"])

    def joined(x, mk):
        return N.for_in("op", x.oparts, lambda op:
            N.for_in("p", Part, lambda p:
                N.IfThen(op.pid.eq(p.pid), N.Singleton(mk(op, p)))))

    def tops(x):
        inner = joined(x, lambda op, p: N.record(pname=p.pname,
                                                 total=op.qty * p.price))
        return N.SumBy(inner, keys=("pname",), values=("total",))

    def lines(x):
        return joined(x, lambda op, p: N.record(pname=p.pname,
                                                qty=op.qty))

    return N.for_in("x", Ord, lambda x: N.Singleton(N.record(
        odate=x.odate, tops=tops(x), lines=lines(x))))


def test_shared_join_query_pinned():
    import test_cse
    fresh_start(RN, TN)
    want = RN.pretty(test_cse.shared_join_query())
    fresh_start(RN, TN)
    assert TN.pretty(shared_join_query(TN)) == want


@pytest.mark.parametrize("cse", [True, False])
def test_cse_eval_stats_match_reference(cse):
    import test_cse
    data = test_cse.gen_data()
    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(
        shared_join_query, diff_types, diff_catalog, cse=cse)
    renv = RCG.columnar_shred_inputs(data, diff_types(RN))
    RP.reset_eval_stats()
    RX.reset_sort_stats()
    rout = RCG.run_flat_program(rcp, renv)
    tout = TCG.run_flat_program(tcp, port_env(renv))
    counters_equal()
    assert TP.EVAL_STATS.get("join", 0) == (1 if cse else 2)
    outputs_equal(rout, tout, rcp.outputs)


def test_trace_stats_cold_then_warm_with_new_params():
    import test_cse
    data = test_cse.gen_data()

    def build(N):
        T = diff_types(N)
        Part, Ord = N.Var("Part", T["Part"]), N.Var("Ord", T["Ord"])
        th = N.Param("th", N.REAL, default=5.0)

        def tops(x):
            inner = N.for_in("op", x.oparts, lambda op:
                N.for_in("p", Part, lambda p:
                    N.IfThen(N.BoolOp("&&", op.pid.eq(p.pid),
                                      p.price.ge(th)),
                             N.Singleton(N.record(pname=p.pname,
                                                  total=op.qty * p.price)))))
            return N.SumBy(inner, keys=("pname",), values=("total",))

        return N.for_in("x", Ord, lambda x: N.Singleton(N.record(
            odate=x.odate, tops=tops(x))))

    (rq, rsp, rcp), (tq, tsp, tcp) = compile_both(build, diff_types,
                                                  diff_catalog)
    renv = RCG.columnar_shred_inputs(data, diff_types(RN))
    tenv = port_env(renv)
    rexe, texe = RCG.jit_program(rcp), TCG.jit_program(tcp)
    assert texe.param_defaults == rexe.param_defaults == {"th": 5.0}
    seen = []
    for val in (3.0, 12.0, 7):
        outputs_equal(rexe(renv, {"th": val}), texe(tenv, {"th": val}),
                      rcp.outputs)
        seen.append((RCG.TRACE_STATS.get("traces", 0),
                     TCG.TRACE_STATS.get("traces", 0)))
    # cold: one trace each; warm with a new float: none; an int binding
    # changes the parameter's dtype, which both count as a new trace
    assert seen == [(1, 1), (1, 1), (2, 2)], seen
    with pytest.raises(AssertionError, match="unknown parameter"):
        texe(tenv, {"thresh": 3.0})
    # jit=False: every call is a "trace"
    plain = TCG.jit_program(tcp, jit=False)
    plain(tenv)
    plain(tenv)
    assert TCG.TRACE_STATS.get("traces", 0) == 4
    np.testing.assert_equal(sorted(texe.bind({"th": 1.0})), ["th"])
