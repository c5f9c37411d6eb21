"""Query builders shared by the port's parity tests, and the tests that
pin them.

The reference's builders (``benchmarks/common.py``, ``tests/
test_differential.py``, ``examples/quickstart.py``) construct objects of
``repro.core.nrc``; the port needs the same queries built with
``repro_torch.core.nrc``. Each builder here takes the NRC module ``N`` as
its first argument, so one text builds both; the TPC-H family is the
port's ``figures/common.py``. The tests below pin every builder: built
with the reference's ``N``, its ``N.pretty`` text equals that of the
reference's own builder.
"""

import contextlib
import io
import os
import runpy

import numpy as np
import pytest

from repro.core import nrc as RN
from repro_torch.obs import reset_telemetry
from repro_torch.core import nrc as TN
from repro_torch.figures import common as FC

from test_torch_cuda import (FK_ORD, FK_PARTS, FK_REFERENCE_ROWS,  # noqa: F401
                             FLOAT_KEY_VALUES, float_key_data,
                             float_key_query)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(autouse=True)
def _reset_port_telemetry():
    reset_telemetry()
    yield


def fresh_start(*mods, value: int = 0) -> None:
    """Reset the fresh-name counter of each NRC module, so that two
    builds that make the same calls get the same generated names."""
    for N in mods:
        N._counter[0] = value


# ---------------------------------------------------------------------------
# TPC-H (benchmarks/common.py, repro/data/generators.py): the port's own
# builders in ``repro_torch.figures.common``, which take the NRC module
# as ``N`` too, in this file's argument order
# ---------------------------------------------------------------------------

def tpch_types(N) -> dict:
    return FC.tpch_types(N)


def tpch_catalog(C):
    """``benchmarks.common.CATALOG`` from a Catalog class."""
    return FC.tpch_catalog(C)


def flat_to_nested_query(N, levels: int):
    return FC.flat_to_nested_query(levels, N)


def nested_to_nested_query(N, levels: int, input_name: str, input_ty):
    return FC.nested_to_nested_query(levels, input_name, input_ty, N)


def nested_to_flat_query(N, levels: int, input_name: str, input_ty):
    return FC.nested_to_flat_query(levels, input_name, input_ty, N)


# ---------------------------------------------------------------------------
# the quickstart (examples/quickstart.py)
# ---------------------------------------------------------------------------

QS_PARTS = [{"pid": i, "pname": 100 + i, "price": float(i)}
            for i in (1, 2, 3)]
QS_COP = [
    {"cname": 1, "corders": [
        {"odate": 20240101,
         "oparts": [{"pid": 1, "qty": 3.0}, {"pid": 2, "qty": 4.0},
                    {"pid": 1, "qty": 1.0}]},
        {"odate": 20240102, "oparts": []}]},
    {"cname": 2, "corders": []},
]


def quickstart(N):
    """(query, input types) of the quickstart."""
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
        corders=N.for_in("co", cop.corders, lambda co: N.Singleton(N.record(
            odate=co.odate, oparts=oparts_total(co)))))))
    return Q, {"COP": cop_t, "Part": part_t}


# ---------------------------------------------------------------------------
# the differential suite's builders (tests/test_differential.py)
# ---------------------------------------------------------------------------

def diff_types(N) -> dict:
    part_t = N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL))
    ord_t = N.bag(N.tuple_t(
        odate=N.INT, oparts=N.bag(N.tuple_t(pid=N.INT, qty=N.REAL))))
    return {"Ord": ord_t, "Part": part_t}


def diff_types3(N) -> dict:
    part_t = diff_types(N)["Part"]
    supp_t = N.bag(N.tuple_t(sid=N.INT, sname=N.INT, fee=N.REAL))
    ord3_t = N.bag(N.tuple_t(
        odate=N.INT,
        oparts=N.bag(N.tuple_t(pid=N.INT, sid=N.INT, qty=N.REAL))))
    return {"Ord": ord3_t, "Part": part_t, "Supp": supp_t}


def diff_catalog(C, spec3=None):
    """CATALOG (2-relation lane) or catalog3(spec) from a Catalog class."""
    if spec3 is None:
        return C(unique_keys={"Part__F": ("pid",)})
    if spec3["dup_supp"]:
        return C(unique_keys={"Part__F": ("pid",)})
    return C(unique_keys={"Part__F": ("pid",), "Supp__F": ("sid",)})


def build_query(N, spec):
    T = diff_types(N)
    Ord = N.Var("Ord", T["Ord"])
    Part = N.Var("Part", T["Part"])
    sel, selc = spec["sel"], spec["selc"]

    def guard(op, base):
        if sel == "qty_ge":
            return N.IfThen(op.qty.ge(N.Const(float(selc), N.REAL)), base)
        if sel == "pid_le":
            return N.IfThen(op.pid.le(N.Const(int(selc), N.INT)), base)
        return base

    def joined(op, body):
        return N.for_in("p", Part, lambda p:
            N.IfThen(op.pid.eq(p.pid), body(p)))

    shape = spec["shape"]
    if shape == "nested_agg":
        def tops(x):
            inner = N.for_in("op", x.oparts, lambda op: guard(op,
                joined(op, lambda p: N.Singleton(N.record(
                    pname=p.pname, total=op.qty * p.price)))))
            return N.SumBy(inner, keys=("pname",), values=("total",))
        return N.for_in("x", Ord, lambda x: N.Singleton(N.record(
            odate=x.odate, tops=tops(x))))
    if shape == "flat_agg":
        inner = N.for_in("x", Ord, lambda x:
            N.for_in("op", x.oparts, lambda op: guard(op,
                joined(op, lambda p: N.Singleton(N.record(
                    odate=x.odate, total=op.qty * p.price))))))
        return N.SumBy(inner, keys=("odate",), values=("total",))
    if shape == "nested_map":
        return N.for_in("x", Ord, lambda x: N.Singleton(N.record(
            odate=x.odate,
            items=N.for_in("op", x.oparts, lambda op: guard(op,
                N.Singleton(N.record(pid2=op.pid + N.Const(3, N.INT),
                                     q=op.qty)))))))
    assert shape == "nested_join_plain", shape
    return N.for_in("x", Ord, lambda x: N.Singleton(N.record(
        odate=x.odate,
        items=N.for_in("op", x.oparts, lambda op: guard(op,
            joined(op, lambda p: N.Singleton(N.record(
                pname=p.pname, s=op.qty * p.price))))))))


def build_query3(N, spec):
    T = diff_types3(N)
    Ord = N.Var("Ord", T["Ord"])
    Part = N.Var("Part", T["Part"])
    Supp = N.Var("Supp", T["Supp"])

    def chain(op, body):
        return N.for_in("p", Part, lambda p:
            N.IfThen(op.pid.eq(p.pid),
                N.for_in("s", Supp, lambda s:
                    N.IfThen(op.sid.eq(s.sid), body(p, s)))))

    shape = spec["shape"]
    if shape == "flat3_agg":
        inner = N.for_in("x", Ord, lambda x:
            N.for_in("op", x.oparts, lambda op:
                chain(op, lambda p, s: N.Singleton(N.record(
                    odate=x.odate, total=op.qty * p.price + s.fee)))))
        return N.SumBy(inner, keys=("odate",), values=("total",))
    if shape == "nested3_agg":
        def tops(x):
            inner = N.for_in("op", x.oparts, lambda op:
                chain(op, lambda p, s: N.Singleton(N.record(
                    pname=p.pname, total=op.qty * p.price + s.fee))))
            return N.SumBy(inner, keys=("pname",), values=("total",))
        return N.for_in("x", Ord, lambda x: N.Singleton(N.record(
            odate=x.odate, tops=tops(x))))
    assert shape == "flat3_plain", shape
    return N.for_in("x", Ord, lambda x: N.Singleton(N.record(
        odate=x.odate,
        items=N.for_in("op", x.oparts, lambda op:
            chain(op, lambda p, s: N.Singleton(N.record(
                pname=p.pname, sname=s.sname,
                v=op.qty * p.price + s.fee)))))))


# ---------------------------------------------------------------------------
# pins: the copies build the reference's queries
# ---------------------------------------------------------------------------

def _same_text(build_ref, build_copy) -> None:
    """Both builds from the same fresh-name state give the same text,
    and the copy built with the port's NRC gives it too."""
    fresh_start(RN, TN)
    want = RN.pretty(build_ref())
    fresh_start(RN, TN)
    got_ref_n = RN.pretty(build_copy(RN))
    fresh_start(RN, TN)
    got_port_n = TN.pretty(build_copy(TN))
    assert got_ref_n == want
    assert got_port_n == want


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_tpch_builders_pinned(levels):
    import benchmarks.common as BC
    from repro.data.generators import TPCH_TYPES
    _same_text(lambda: BC.flat_to_nested_query(levels),
               lambda N: flat_to_nested_query(N, levels))
    for name, ty in tpch_types(TN).items():
        assert repr(ty) == repr(TPCH_TYPES[name])
    nty_ref = BC.flat_to_nested_query(levels).ty
    _same_text(lambda: BC.nested_to_nested_query(levels, "NCOP", nty_ref),
               lambda N: nested_to_nested_query(
                   N, levels, "NCOP", flat_to_nested_query(N, levels).ty))
    _same_text(lambda: BC.nested_to_flat_query(levels, "NCOP", nty_ref),
               lambda N: nested_to_flat_query(
                   N, levels, "NCOP", flat_to_nested_query(N, levels).ty))
    assert repr(flat_to_nested_query(RN, levels).ty) == repr(nty_ref)
    assert repr(flat_to_nested_query(TN, levels).ty) == repr(nty_ref)


def test_quickstart_builder_pinned():
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ns = runpy.run_path(os.path.join(ROOT, "examples", "quickstart.py"))
    assert "matches oracle: True" in out.getvalue()
    for N in (RN, TN):
        q, types = quickstart(N)
        assert N.pretty(q) == RN.pretty(ns["Q"])
        assert repr(types["COP"]) == repr(ns["cop_t"])
    assert QS_PARTS == ns["parts"] and QS_COP == ns["cop"]


def test_differential_builders_pinned():
    import test_differential as TD
    rng = np.random.RandomState(11)
    specs = [TD.random_spec(rng) for _ in range(40)]
    assert {s["shape"] for s in specs} == set(TD.SHAPES)
    for spec in specs:
        _same_text(lambda: TD.build_query(spec),
                   lambda N: build_query(N, spec))
    specs3 = [TD.random_spec3(rng) for _ in range(30)]
    assert {s["shape"] for s in specs3} == set(TD.SHAPES3)
    for spec in specs3:
        _same_text(lambda: TD.build_query3(spec),
                   lambda N: build_query3(N, spec))
    for name, ty in diff_types3(TN).items():
        assert repr(ty) == repr(TD.TYPES3[name])
    for name, ty in diff_types(TN).items():
        assert repr(ty) == repr(TD.TYPES[name])
