"""The port's storage-backed serving against the reference's, on the
CPU: ``examples/persist_and_query.py`` side by side (rows, chunks read
and skipped, cache hits and misses, zero warm plan rebuilds), the
stored, compressed-storage and morsel-streamed lanes of
``tests/test_differential.py`` (interpreter, reference and port on the
same seeded inputs), and ``plans.morsel_fold``'s fold specs. Outputs
are compared bit for bit (data and ``valid``) where the two run the
same plan at the same capacities, and as bags where morsels reorder
rows."""

import numpy as np
import pytest

import test_differential as TD
from repro.core import codegen as RCG
from repro.core import interpreter as RI
from repro.core import materialization as RM
from repro.core import nrc as RN
from repro.core import plans as RP
from repro.core.unnesting import Catalog as RCatalog
from repro.errors import StreamingUnsupportedError as RStreamErr
from repro.serve import QueryService as RService
from repro.storage import STORAGE_STATS as RSTATS
from repro.storage import StorageCatalog as RStorage
from repro.storage import reset_storage_stats as r_reset_storage
from repro_torch.core import codegen as TCG
from repro_torch.core import materialization as TM
from repro_torch.core import nrc as TN
from repro_torch.core import plans as TP
from repro_torch.core.unnesting import Catalog as TCatalog
from repro_torch.errors import StreamingUnsupportedError as TStreamErr
from repro_torch.obs import reset_telemetry
from repro_torch.serve import QueryService as TService
from repro_torch.storage import STORAGE_STATS as TSTATS
from repro_torch.storage import StorageCatalog as TStorage
from repro_torch.storage import reset_storage_stats as t_reset_storage

from test_torch_env import assert_env_parity
from test_torch_queries import (build_query, build_query3, diff_catalog,
                                diff_types, diff_types3, fresh_start,
                                nested_to_nested_query, tpch_catalog,
                                tpch_types)

SIDES = ((RN, RCatalog, RService, RStorage),
         (TN, TCatalog, TService, TStorage))


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def open_both(tmp_path, types, inputs, chunk_rows=16, encoding="auto",
              name="d"):
    """The same rows written and reopened by each package; the port's
    dataset loads onto the CPU."""
    out = []
    for N, _, _, Storage in SIDES:
        kw = {"device": "cpu"} if Storage is TStorage else {}
        cat = Storage(str(tmp_path / ("port" if kw else "ref")), **kw)
        w = cat.writer(name, types(N), chunk_rows=chunk_rows,
                       encoding=encoding)
        w.append(inputs)
        out.append(cat.open(name))
    return out


def program(N, build):
    fresh_start(N, value=700)
    return N.Program([N.Assignment("Q", build(N))])


def bag_rows(bag) -> list:
    """Sorted tuples of the valid rows' bit patterns (columns in name
    order) — a bag, whatever the row order."""
    valid = np.asarray(bag.valid.cpu() if hasattr(bag.valid, "cpu")
                       else bag.valid)
    cols = []
    for c in sorted(bag.data):
        a = bag.data[c]
        a = np.asarray(a.cpu() if hasattr(a, "cpu") else a)[valid]
        cols.append(a.view(np.int64) if a.dtype == np.float64 else a)
    return sorted(zip(*[c.tolist() for c in cols]))


# ---------------------------------------------------------------------------
# examples/persist_and_query.py, side by side
# ---------------------------------------------------------------------------

def shop_types(N) -> dict:
    return {"Ord": N.bag(N.tuple_t(
        odate=N.INT, oparts=N.bag(N.tuple_t(pid=N.INT, qty=N.REAL)))),
        "Part": N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL))}


def spend_over(N, min_price: float):
    T = shop_types(N)
    Part, Ord = N.Var("Part", T["Part"]), N.Var("Ord", T["Ord"])

    def tops(x):
        inner = N.for_in("op", x.oparts, lambda op:
            N.for_in("p", Part, lambda p:
                N.IfThen(N.BoolOp("&&", op.pid.eq(p.pid),
                                  p.price.ge(N.Const(min_price, N.REAL))),
                         N.Singleton(N.record(pname=p.pname,
                                              total=op.qty * p.price)))))
        return N.SumBy(inner, keys=("pname",), values=("total",))

    return N.Program([N.Assignment("Q", N.for_in("x", Ord, lambda x:
        N.Singleton(N.record(odate=x.odate, tops=tops(x)))))])


def test_persist_and_query_example_matches_reference(tmp_path):
    rng = np.random.RandomState(7)
    orders = [{"odate": 20260000 + d,
               "oparts": [{"pid": int(rng.randint(1, 65)),
                           "qty": float(rng.randint(1, 9))}
                          for _ in range(rng.randint(0, 6))]}
              for d in range(200)]
    parts = [{"pid": i, "pname": 100 + i, "price": float(i)}
             for i in range(1, 65)]
    runs = []
    for (N, Catalog, Service, Storage), stats, reset in zip(
            SIDES, (RSTATS, TSTATS), (r_reset_storage, t_reset_storage)):
        CG = TCG if N is TN else RCG
        kw = {"device": "cpu"} if Storage is TStorage else {}
        cat = Storage(str(tmp_path / ("port" if kw else "ref")), **kw)
        w = cat.writer("shop", shop_types(N), chunk_rows=16)
        w.append({"Ord": orders[:100], "Part": parts})
        w.append({"Ord": orders[100:]})
        ds = cat.open("shop")
        svc = Service(shop_types(N),
                      catalog=Catalog(unique_keys={"Part__F": ("pid",)}))
        calls = []
        for threshold in (8.0, 32.0, 56.0):
            reset()
            CG.reset_trace_stats()
            prog = spend_over(N, threshold)
            out = svc.execute_stored(prog, ds)
            rows = svc.unshred_stored(prog, ds, out, "Q")
            calls.append((rows, stats["chunks_read"],
                          stats["chunks_skipped"],
                          CG.TRACE_STATS.get("traces", 0),
                          dict(svc.stats), out))
        runs.append((ds.bytes_on_disk(), calls))
    (ref_bytes, ref_calls), (port_bytes, port_calls) = runs
    assert port_bytes == ref_bytes
    for want, got in zip(ref_calls, port_calls):
        assert TD.equal(want[0], got[0])
        assert got[1:5] == want[1:5]
        assert_env_parity(want[5], got[5])
    # chunks skipped grows with the threshold; warm calls rebuild nothing
    assert [c[2] for c in port_calls] == sorted(c[2] for c in port_calls)
    assert port_calls[-1][2] > 0
    assert [c[3] for c in port_calls] == [1, 0, 0]
    assert port_calls[-1][4]["hits"] == 2


# ---------------------------------------------------------------------------
# lanes of tests/test_differential.py
# ---------------------------------------------------------------------------

SPECS = [TD.random_spec(np.random.RandomState(s)) for s in range(4)]


def _stored_both(tmp_path, spec, encoding="auto"):
    inputs = TD.gen_inputs(spec)
    outs, rows = [], []
    for (N, Catalog, Service, _), ds in zip(
            SIDES, open_both(tmp_path / encoding, diff_types, inputs,
                             encoding=encoding)):
        svc = Service(diff_types(N), catalog=diff_catalog(Catalog))
        prog = program(N, lambda N: build_query(N, spec))
        out = svc.execute_stored(prog, ds)
        outs.append(out)
        rows.append(svc.unshred_stored(prog, ds, out, "Q"))
    direct = RI.eval_expr(TD.build_query(spec), inputs)
    return direct, outs, rows


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_differential_stored_against_port(tmp_path, case):
    direct, (ref_out, port_out), (_, port_rows) = _stored_both(
        tmp_path, SPECS[case])
    assert TD.equal(direct, port_rows), SPECS[case]
    assert_env_parity(ref_out, port_out)


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_differential_compressed_storage_against_port(tmp_path, case):
    """raw-written and auto-encoded datasets serve identical results
    in the port, and equal the reference's bit for bit."""
    spec = SPECS[case]
    direct, (r_raw, p_raw), (_, raw_rows) = _stored_both(tmp_path, spec,
                                                          "raw")
    _, (r_enc, p_enc), (_, enc_rows) = _stored_both(tmp_path, spec, "auto")
    assert TD.equal(direct, raw_rows) and TD.equal(direct, enc_rows), spec
    assert_env_parity(r_raw, p_raw)
    assert_env_parity(r_enc, p_enc)
    assert_env_parity(r_raw, p_enc)


def test_differential3_stored_against_port(tmp_path):
    spec = TD.random_spec3(np.random.RandomState(5))
    inputs = TD.gen_inputs3(spec)
    outs = []
    for (N, Catalog, Service, _), ds in zip(
            SIDES, open_both(tmp_path, diff_types3, inputs)):
        svc = Service(diff_types3(N), catalog=diff_catalog(Catalog, spec))
        outs.append(svc.execute_stored(
            program(N, lambda N: build_query3(N, spec)), ds))
    assert_env_parity(*outs)


def _streamed(N, Service, Catalog, ds, spec):
    svc = Service(diff_types(N), catalog=diff_catalog(Catalog))
    prog = program(N, lambda N: build_query(N, spec))
    try:
        out = svc.execute_stored_streaming(prog, ds, morsel_rows=4,
                                           root="Ord")
    except (RStreamErr, TStreamErr) as e:
        return type(e).__name__, None
    return out, svc.unshred_stored(prog, ds, out, "Q")


@pytest.mark.parametrize("case", range(len(SPECS)))
def test_differential_morsel_streamed_against_port(tmp_path, case):
    """Tiny chunks and a tiny morsel budget force a multi-morsel stream;
    the port streams (or refuses to) exactly where the reference does,
    and its outputs are the reference's bags."""
    spec = SPECS[case]
    inputs = TD.gen_inputs(spec)
    (ref_out, _), (port_out, port_rows) = [
        _streamed(N, Service, Catalog, ds, spec)
        for (N, Catalog, Service, _), ds in zip(
            SIDES, open_both(tmp_path, diff_types, inputs, chunk_rows=4))]
    if isinstance(ref_out, str):
        assert port_out == ref_out
        return
    assert TD.equal(RI.eval_expr(TD.build_query(spec), inputs), port_rows)
    assert sorted(port_out) == sorted(ref_out)
    for name in ref_out:
        assert bag_rows(port_out[name]) == bag_rows(ref_out[name]), name


def test_stored_streaming_equals_one_shot_as_bags(tmp_path):
    """The n2n TPC-H query over a small shredded dataset: the streamed
    run (four morsels) gives the one-shot run's rows in another order."""
    import chip_smoke
    from repro_torch.columnar.table import env_from_numpy
    env_np = chip_smoke.shred_ncop2(chip_smoke.gen_tpch_columns(600, 2))
    part_t, ncop2_t = chip_smoke.tpch_types()
    types = {"NCOP2": ncop2_t, "Part": part_t}
    cat = TStorage(str(tmp_path), device="cpu")
    cat.writer("tpch", types, chunk_rows=40).write_parts(
        env_from_numpy(env_np, "cpu"))
    ds = cat.open("tpch")
    q = chip_smoke.nested_to_nested_query(2, "NCOP2", ncop2_t, part_t)
    prog = TN.Program([TN.Assignment("Q", q)])
    svc = TService(types, catalog=TCatalog(unique_keys={"Part__F": ("pid",)}))
    one = svc.execute_stored(prog, ds)
    TCG.reset_trace_stats()
    streamed = svc.execute_stored_streaming(prog, ds, morsel_rows=40,
                                            root="NCOP2")
    entry = next(e for k, e in svc._cache.items() if len(k) == 4)
    assert entry.morsel[0].n_morsels == 4
    assert TCG.TRACE_STATS.get("traces", 0) == 1    # one signature
    for name in one:
        assert bag_rows(streamed[name]) == bag_rows(one[name]), name
    man = entry.manifest("Q")
    chip_smoke.check_oparts(streamed[man.dicts[("corders", "oparts")]],
                            env_np)


# ---------------------------------------------------------------------------
# morsel_fold specs
# ---------------------------------------------------------------------------

def _fold_programs():
    """(name, build(N), types(N), catalog(C), streamed root)."""
    out = []
    for shape in TD.SHAPES:
        for sel in TD.SELS:
            spec = dict(seed=1, n_orders=5, n_parts=4, zipf=0.0,
                        shape=shape, sel=sel, selc=2)
            out.append((f"{shape}-{sel}",
                        lambda N, spec=spec: build_query(N, spec),
                        diff_types, diff_catalog, "Ord"))
    for levels in (1, 2, 3):
        def build(N, levels=levels):
            from test_torch_queries import flat_to_nested_query
            return nested_to_nested_query(
                N, levels, "NCOP", flat_to_nested_query(N, levels).ty)

        def types(N, levels=levels):
            from test_torch_queries import flat_to_nested_query
            return {"NCOP": flat_to_nested_query(N, levels).ty,
                    "Part": tpch_types(N)["Part"]}
        out.append((f"n2n-{levels}", build, types, tpch_catalog, "NCOP"))
    return out


FOLDS = _fold_programs()


@pytest.mark.parametrize("de", [True, False])
@pytest.mark.parametrize("case", range(len(FOLDS)),
                         ids=[f[0] for f in FOLDS])
def test_morsel_fold_specs_match_reference(case, de):
    _, build, types, catalog_of, root = FOLDS[case]
    got = []
    for N, M, CG, P, Catalog in ((RN, RM, RCG, RP, RCatalog),
                                 (TN, TM, TCG, TP, TCatalog)):
        sp = M.shred_program(program(N, build), types(N),
                             domain_elimination=de)
        cp = CG.compile_program(sp, catalog_of(Catalog))
        streamed = {n for n in (M.mat_input_name(root, p)
                                for p in ((), ("oparts",), ("corders",),
                                          ("corders", "oparts"),
                                          ("ncusts",),
                                          ("ncusts", "corders"),
                                          ("ncusts", "corders", "oparts")))}
        try:
            got.append(P.morsel_fold(cp.plans, cp.outputs, streamed))
        except (RStreamErr, TStreamErr) as e:
            got.append(type(e).__name__)
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# the service's own surface
# ---------------------------------------------------------------------------

def test_in_memory_execute_and_cache_match_reference():
    """``execute`` over an in-memory environment: the same outputs,
    cache statistics and capacity classes as the reference."""
    spec = SPECS[0]
    inputs = TD.gen_inputs(spec)
    outs, stats = [], []
    for N, Catalog, Service, _ in SIDES:
        svc = Service(diff_types(N), catalog=diff_catalog(Catalog))
        kw = {"device": "cpu"} if Service is TService else {}
        env = svc.shred_inputs(inputs, **kw)
        prog = program(N, lambda N: build_query(N, spec))
        svc.execute(prog, env)
        outs.append(svc.execute(prog, env))
        assert svc.evict() == 1
        stats.append(dict(svc.stats))
    assert_env_parity(*outs)
    assert stats[1] == stats[0]
