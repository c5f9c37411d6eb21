"""Shared machinery of the figure drivers (PyTorch twin of the parts of
``benchmarks/common.py`` that Fig. 7, Fig. 9, App. D and App. E.1 use):
timing, the CSV rows, and the nested TPC-H query family of the paper's
§6 / Appendix B.

The query builders take the NRC module as ``N`` (the port's by default),
so that a test can build the same text with the reference's module and
pin it against ``benchmarks/common.py``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.columnar.table import FlatBag, resolve_device
from repro_torch.core import codegen as CG
from repro_torch.core import interpreter as I
from repro_torch.core import materialization as M
from repro_torch.core import nrc
from repro_torch.core.plans import ExecSettings
from repro_torch.core.unnesting import Catalog


def emit(name: str, us_per_call: float, derived: str = "") -> str:
    """Print one benchmark row in the reference's CSV format
    (``name,us_per_call,derived``) and return it."""
    line = f"{name},{us_per_call:.1f},{derived}"
    print(line, flush=True)
    return line


def time_fn(fn: Callable, warmup: int = 1, iters: int = 3,
            device=None) -> float:
    """Mean microseconds per call of ``fn``; each call ends in a
    synchronize of ``device`` (None = the GPU) when it is a CUDA device,
    as ``jax.block_until_ready`` waits for the reference's outputs."""
    dev = resolve_device(device)

    def call():
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out

    for _ in range(warmup):
        call()
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return (time.perf_counter() - t0) / iters * 1e6  # us


# ---------------------------------------------------------------------------
# nested TPC-H query family (levels 0..3), narrow variant
# ---------------------------------------------------------------------------

LEVEL_KEYS = [("Lineitem", None),
              ("Orders", "oid"), ("Customer", "cid"), ("Nation", "nid")]


def tpch_types(N=nrc) -> dict:
    """``repro.data.generators.TPCH_TYPES`` built with ``N``."""
    return {
        "Part": N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL)),
        "Lineitem": N.bag(N.tuple_t(oid=N.INT, pid=N.INT, qty=N.REAL)),
        "Orders": N.bag(N.tuple_t(oid=N.INT, cid=N.INT, odate=N.INT)),
        "Customer": N.bag(N.tuple_t(cid=N.INT, nid=N.INT, cname=N.INT)),
        "Nation": N.bag(N.tuple_t(nid=N.INT, rid=N.INT, nname=N.INT)),
        "Region": N.bag(N.tuple_t(rid=N.INT, rname=N.INT)),
    }


def tpch_catalog(C=Catalog):
    """``CATALOG`` from a Catalog class."""
    return C(unique_keys={
        "Part__F": ("pid",), "Orders__F": ("oid",), "Customer__F": ("cid",),
        "Nation__F": ("nid",), "Region__F": ("rid",)})


CATALOG = tpch_catalog()


def flat_to_nested_query(levels: int, N=nrc):
    """Group Lineitem under Orders/Customer/Nation (levels deep)."""
    T = tpch_types(N)
    L = N.Var("Lineitem", T["Lineitem"])
    O = N.Var("Orders", T["Orders"])  # noqa: E741
    C = N.Var("Customer", T["Customer"])
    Na = N.Var("Nation", T["Nation"])

    def items_of(o):
        return N.for_in("l", L, lambda l:
            N.IfThen(o.oid.eq(l.oid),
                     N.Singleton(N.record(pid=l.pid, qty=l.qty))))

    def orders_of(c):
        return N.for_in("o", O, lambda o:
            N.IfThen(c.cid.eq(o.cid),
                     N.Singleton(N.record(odate=o.odate,
                                          oparts=items_of(o)))))

    def custs_of(n):
        return N.for_in("c", C, lambda c:
            N.IfThen(n.nid.eq(c.nid),
                     N.Singleton(N.record(cname=c.cname,
                                          corders=orders_of(c)))))

    if levels == 1:
        return N.for_in("o", O, lambda o: N.Singleton(N.record(
            odate=o.odate, oparts=items_of(o))))
    if levels == 2:
        return N.for_in("c", C, lambda c: N.Singleton(N.record(
            cname=c.cname, corders=orders_of(c))))
    if levels == 3:
        return N.for_in("n", Na, lambda n: N.Singleton(N.record(
            nname=n.nname, ncusts=custs_of(n))))
    raise ValueError(levels)


def nested_to_nested_query(levels: int, input_name: str, input_ty, N=nrc):
    """Join Part at the lowest level + sumBy (Example 1 generalized)."""
    P = N.Var("Part", tpch_types(N)["Part"])
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


def nested_to_flat_query(levels: int, input_name: str, input_ty, N=nrc):
    P = N.Var("Part", tpch_types(N)["Part"])
    X = N.Var(input_name, input_ty)
    if levels == 1:
        inner = N.for_in("x", X, lambda x:
            N.for_in("op", x.oparts, lambda op:
                N.for_in("p", P, lambda p:
                    N.IfThen(op.pid.eq(p.pid),
                             N.Singleton(N.record(odate=x.odate,
                                                  total=op.qty * p.price))))))
        return N.SumBy(inner, keys=("odate",), values=("total",))
    if levels == 2:
        inner = N.for_in("x", X, lambda x:
            N.for_in("co", x.corders, lambda co:
                N.for_in("op", co.oparts, lambda op:
                    N.for_in("p", P, lambda p:
                        N.IfThen(op.pid.eq(p.pid),
                                 N.Singleton(N.record(
                                     cname=x.cname,
                                     total=op.qty * p.price)))))))
        return N.SumBy(inner, keys=("cname",), values=("total",))
    if levels == 3:
        inner = N.for_in("x", X, lambda x:
            N.for_in("c", x.ncusts, lambda c:
                N.for_in("co", c.corders, lambda co:
                    N.for_in("op", co.oparts, lambda op:
                        N.for_in("p", P, lambda p:
                            N.IfThen(op.pid.eq(p.pid),
                                     N.Singleton(N.record(
                                         nname=x.nname,
                                         total=op.qty * p.price))))))))
        return N.SumBy(inner, keys=("nname",), values=("total",))
    raise ValueError(levels)


def materialize_nested_input(db: Dict[str, list], levels: int):
    """Run flat-to-nested (oracle) to build the nested input value."""
    q = flat_to_nested_query(levels)
    val = I.eval_expr(q, db)
    return val, q.ty


def run_shred_columnar(prog, input_types, inputs,
                       settings: Optional[ExecSettings] = None,
                       device=None):
    """(shredded program, a callable that runs it over ``inputs`` value-
    shredded onto ``device``)."""
    sp = M.shred_program(prog, input_types, domain_elimination=True)
    cp = CG.compile_program(sp, CATALOG)
    env = CG.columnar_shred_inputs(inputs, input_types, device=device)

    def run():
        return CG.run_flat_program(cp, env, settings or ExecSettings())

    return sp, run


def bag_bytes(bag: FlatBag) -> int:
    return sum(a.numel() * a.element_size() for a in bag.data.values())
