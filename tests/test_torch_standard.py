"""The port's standard (flattening) route against the reference's:
``codegen.run_standard`` on the same StandardPlan over the same inputs
gives the same parts bit for bit (capacities, dtypes, ``valid``
everywhere, data at valid rows), on ``test_system.py``'s standard-route
cases and on all nine Fig. 7 points at ``gen_tpch(scale=40, seed=0)``.

Where the reference's standard route differs from the oracle (f2n at
level 3 at this scale: 21 top-level rows against the oracle's 25), the
port reproduces the same parts, and both differ from the oracle alike.
"""

import pytest

from repro.core import codegen as RCG
from repro.core import interpreter as RI
from repro.core import nrc as RN
from repro.core.materialization import mat_input_name as r_mat_input_name
from repro.core.plans import ExecSettings as RSettings
from repro.core.unnesting import Catalog as RCatalog
from repro.core.unnesting import compile_standard as r_compile_standard
from repro.data.generators import TPCH_TYPES as R_TPCH_TYPES
from repro.data.generators import gen_tpch as r_gen_tpch
from repro_torch.core import codegen as TCG
from repro_torch.core import interpreter as TI
from repro_torch.core import nrc as TN
from repro_torch.core.materialization import mat_input_name
from repro_torch.core.plans import ExecSettings
from repro_torch.core.unnesting import Catalog as TCatalog
from repro_torch.core.unnesting import compile_standard
from repro_torch.data.generators import TPCH_TYPES, gen_tpch
from repro_torch.figures import common as FC
from repro_torch.obs import reset_telemetry

from test_torch_env import assert_env_parity
from test_torch_queries import fresh_start, quickstart

SCALE = 40


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


@pytest.fixture(scope="module")
def ref_runs():
    """The reference's runs, by case: each is made once for both
    ``use_kernel`` settings of the port."""
    return {}


def _run(N, CG, compile_std, mat, Cat, settings, dev, build, roots_of,
         flat_of, catalog_of, inputs_of):
    fresh_start(N)
    q = build(N)
    splan = compile_std(q, input_roots=roots_of(N), flat_inputs=flat_of(N),
                        parts_name=mat, catalog=catalog_of(Cat))
    inputs, types = inputs_of(N)
    env = CG.columnar_shred_inputs(inputs, types, **dev)
    return CG.run_standard(splan, env, settings), q, env


def _both_parts(build, roots_of, flat_of, catalog_of, inputs_of,
                use_kernel, ref_runs=None, key=None):
    """(reference parts, port parts, reference query, port query) of one
    standard-route run in each package from the same builders."""
    builders = (build, roots_of, flat_of, catalog_of, inputs_of)
    ref_runs = {} if ref_runs is None else ref_runs
    if key not in ref_runs:
        ref_runs[key] = _run(RN, RCG, r_compile_standard, r_mat_input_name,
                             RCatalog, RSettings(), {}, *builders)
    ref, rq, renv = ref_runs[key]
    port, tq, tenv = _run(TN, TCG, compile_standard, mat_input_name,
                          TCatalog, ExecSettings(use_kernel=use_kernel),
                          {"device": "cpu"}, *builders)
    assert_env_parity(renv, tenv)
    assert list(port) == list(ref)
    for path in ref:
        assert list(port[path].data) == list(ref[path].data), path
    assert_env_parity({str(p): b for p, b in ref.items()},
                      {str(p): b for p, b in port.items()})
    return ref, port, rq, tq


# ---------------------------------------------------------------------------
# test_system.py's standard-route cases (the running example, and its
# nested-to-flat sumBy by customer)
# ---------------------------------------------------------------------------

def _running_example_n2f(N):
    _, types = quickstart(N)
    COP = N.Var("COP", types["COP"])
    Part = N.Var("Part", types["Part"])
    return N.SumBy(
        N.for_in("cop", COP, lambda cop:
            N.for_in("co", cop.corders, lambda co:
                N.for_in("op", co.oparts, lambda op:
                    N.for_in("p", Part, lambda p:
                        N.IfThen(op.pid.eq(p.pid),
                                 N.Singleton(N.record(
                                     cname=cop.cname,
                                     total=op.qty * p.price))))))),
        keys=("cname",), values=("total",))


def _system_data():
    from helpers import gen_cop, gen_parts
    return {"COP": gen_cop(n_cust=12, seed=3), "Part": gen_parts()}


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("case", ["running_example", "nested_to_flat"])
def test_system_standard_cases_match_reference(ref_runs, case, use_kernel):
    data = _system_data()
    build = (lambda N: quickstart(N)[0]) if case == "running_example" \
        else _running_example_n2f
    ref, port, rq, tq = _both_parts(
        build,
        roots_of=lambda N: {"COP": quickstart(N)[1]["COP"]},
        flat_of=lambda N: {"Part": quickstart(N)[1]["Part"]},
        catalog_of=lambda C: C(unique_keys={"Part__F": ("pid",)}),
        inputs_of=lambda N: (data, quickstart(N)[1]),
        use_kernel=use_kernel, ref_runs=ref_runs, key=case)
    want = TI.eval_expr(tq, data)
    if case == "running_example":
        got = TCG.parts_to_rows(port, tq.ty)
    else:
        got = port[()].to_rows()
    assert TI.bags_equal(want, got)


# ---------------------------------------------------------------------------
# the nine Fig. 7 points at scale 40
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch_db():
    ref_db = r_gen_tpch(scale=SCALE, skew=0.0, seed=0)
    port_db = gen_tpch(scale=SCALE, skew=0.0, seed=0)
    assert port_db == ref_db
    nested = {lv: FC.materialize_nested_input(port_db, lv)[0]
              for lv in (1, 2, 3)}
    return port_db, nested


def _flat_types(N):
    return dict(TPCH_TYPES) if N is TN else dict(R_TPCH_TYPES)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("family", ["f2n", "n2n", "n2f"])
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_fig7_standard_route_matches_reference(tpch_db, ref_runs, family,
                                               levels, use_kernel):
    db, nested = tpch_db
    name = f"NCOP{levels}"

    def nty(N):
        return FC.flat_to_nested_query(levels, N).ty

    if family == "f2n":
        def build(N):
            return FC.flat_to_nested_query(levels, N)

        def roots_of(N):
            return {}

        def inputs_of(N):
            return db, _flat_types(N)
    else:
        maker = FC.nested_to_nested_query if family == "n2n" \
            else FC.nested_to_flat_query

        def build(N):
            return maker(levels, name, nty(N), N)

        def roots_of(N):
            return {name: nty(N)}

        def inputs_of(N):
            return ({**db, name: nested[levels]},
                    {**_flat_types(N), name: nty(N)})

    ref, port, rq, tq = _both_parts(build, roots_of, _flat_types,
                                    FC.tpch_catalog, inputs_of, use_kernel,
                                    ref_runs, (family, levels))
    # what the oracle says of each route: the same for both packages
    inputs, _ = inputs_of(TN)
    want = TI.eval_expr(tq, inputs)
    if family == "n2f":
        got_ref, got_port = ref[()].to_rows(), port[()].to_rows()
    else:
        got_ref = RCG.parts_to_rows(ref, rq.ty)
        got_port = TCG.parts_to_rows(port, tq.ty)
    match_ref = RI.bags_equal(RI.eval_expr(rq, inputs), got_ref)
    match_port = TI.bags_equal(want, got_port)
    assert match_port == match_ref
    # the reference's known gap: f2n at level 3 (ROADMAP.md queue 3)
    assert match_port == ((family, levels) != ("f2n", 3))
    if (family, levels) == ("f2n", 3):
        assert (len(got_port), len(want)) == (21, 25)
