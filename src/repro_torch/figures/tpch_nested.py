"""Nested TPC-H micro-benchmark (paper Fig. 7) on the port:
flat-to-nested, nested-to-nested, nested-to-flat at nesting levels 1-3,
STANDARD vs SHRED (+UNSHRED), reporting wall time and materialized
intermediate bytes (the flattening-width signal). The rows and derived
fields are ``benchmarks/tpch_nested.py``'s.

    python -m repro_torch.figures.tpch_nested [--scale 60] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core import codegen as CG
from repro_torch.core import interpreter as I
from repro_torch.core import materialization as M
from repro_torch.core import nrc as N
from repro_torch.core.materialization import mat_input_name
from repro_torch.core.plans import ExecSettings
from repro_torch.core.unnesting import compile_standard
from repro_torch.data.generators import TPCH_TYPES, gen_tpch
from repro_torch.exec import ops as X

from .common import (CATALOG, bag_bytes, emit, flat_to_nested_query,
                     materialize_nested_input, nested_to_flat_query,
                     nested_to_nested_query, time_fn)


def standard_plan(q, nested_name: Optional[str], nested_ty):
    """The StandardPlan of ``q`` over the TPC-H tables and, for the
    nested families, the nested input ``nested_name``."""
    roots = {nested_name: nested_ty} if nested_ty is not None else {}
    return compile_standard(q, input_roots=roots,
                            flat_inputs=dict(TPCH_TYPES),
                            parts_name=mat_input_name, catalog=CATALOG)


def _standard(q, nested_name, nested_ty, env, settings):
    splan = standard_plan(q, nested_name, nested_ty)
    return lambda: CG.run_standard(splan, env, settings)


def nested_inputs(db: dict, levels: int):
    """(name, type, inputs, input types) of the level-``levels`` nested
    input NCOP<levels> beside the flat tables."""
    nested, nty = materialize_nested_input(db, levels)
    name = f"NCOP{levels}"
    types = dict(TPCH_TYPES)
    types[name] = nty
    inputs = dict(db)
    inputs[name] = nested
    return name, nty, inputs, types


def run(scale: int = 60, device=None) -> List[str]:
    """Every row of Fig. 7 at ``scale`` orders on ``device`` (None = the
    GPU), with the operators routed through the kernels (their plain
    versions on the CPU); returns the rows."""
    db = gen_tpch(scale=scale, skew=0.0, seed=0)
    settings = ExecSettings(use_kernel=True)
    rows = []

    def timed(fn):
        return time_fn(fn, device=device)

    # ---------------- flat-to-nested ----------------
    for lv in (1, 2, 3):
        q = flat_to_nested_query(lv)
        prog = N.Program([N.Assignment("Q", q)])
        # SHRED
        sp = M.shred_program(prog, TPCH_TYPES, domain_elimination=True)
        cp = CG.compile_program(sp, CATALOG)
        env = CG.columnar_shred_inputs(db, TPCH_TYPES, device=device)
        us = timed(lambda: CG.run_flat_program(cp, env, settings))
        rows.append(emit(f"f2n_L{lv}_shred", us,
                         f"assignments={len(sp.program.names())}"))
        # STANDARD (wide flatten + nest rebuild)
        run_std = _standard(q, None, None, env, settings)
        us_std = timed(run_std)
        # intermediate width: bytes of the wide bag vs shredded parts
        out_parts = run_std()
        wide_bytes = sum(bag_bytes(b) for b in out_parts.values())
        rows.append(emit(f"f2n_L{lv}_standard", us_std,
                         f"out_bytes={wide_bytes}"))
        # UNSHRED cost (cogroup clustering of dictionaries)
        outs = CG.run_flat_program(cp, env, settings)
        man = sp.manifests["Q"]
        parts = {(): outs[man.top],
                 **{p: outs[n] for p, n in man.dicts.items()}}
        us_unshred = timed(lambda: CG.unshred_parts(parts))
        rows.append(emit(f"f2n_L{lv}_unshred_extra", us_unshred, ""))

    # ---------------- nested-to-nested ----------------
    for lv in (1, 2, 3):
        name, nty, inputs, types = nested_inputs(db, lv)
        q = nested_to_nested_query(lv, name, nty)
        prog = N.Program([N.Assignment("Q", q)])
        sp = M.shred_program(prog, types, domain_elimination=True)
        cp = CG.compile_program(sp, CATALOG)
        env = CG.columnar_shred_inputs(inputs, types, device=device)
        us = timed(lambda: CG.run_flat_program(cp, env, settings))
        # localized aggregation: leaf dict computed w/o touching ancestors
        leaf = [n for n in sp.program.names() if "oparts" in n][-1]
        rows.append(emit(f"n2n_L{lv}_shred", us, f"localized_leaf={leaf}"))
        run_std = _standard(q, name, nty, env, settings)
        rows.append(emit(f"n2n_L{lv}_standard", timed(run_std), ""))

    # ---------------- nested-to-flat ----------------
    for lv in (1, 2, 3):
        name, nty, inputs, types = nested_inputs(db, lv)
        q = nested_to_flat_query(lv, name, nty)
        # shredded route: shred the *body*, apply sumBy on its flat output
        prog = N.Program([N.Assignment("QB", q.bag_expr)])
        sp = M.shred_program(prog, types, domain_elimination=True)
        cp = CG.compile_program(sp, CATALOG)
        env0 = CG.columnar_shred_inputs(inputs, types, device=device)

        def run_shred():
            env = CG.run_flat_program(cp, env0, settings)
            return X.sum_by(env["QB"], q.keys, q.values, use_kernel=True)

        rows.append(emit(f"n2f_L{lv}_shred", timed(run_shred), ""))
        run_std = _standard(q, name, nty, env0, settings)
        rows.append(emit(f"n2f_L{lv}_standard", timed(run_std), ""))

        # correctness cross-check at each level
        want = I.eval_expr(q, inputs)
        got = run_std()[()].to_rows()
        assert I.bags_equal(want, got), f"n2f_L{lv} standard mismatch"
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    run(args.scale, args.device)


if __name__ == "__main__":
    main()
