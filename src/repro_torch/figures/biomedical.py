"""Biomedical E2E pipeline (paper Fig. 9 / Appendix C) on the port:
5-step driver gene analysis as a sequence of NRC queries over the
shredded engine — the output of each step feeds the next WITHOUT
unshredding. The rows are ``benchmarks/biomedical.py``'s.

    python -m repro_torch.figures.biomedical [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List

from repro_torch.core import codegen as CG
from repro_torch.core import interpreter as I
from repro_torch.core import materialization as M
from repro_torch.core import nrc as N
from repro_torch.core.plans import ExecSettings
from repro_torch.core.unnesting import Catalog
from repro_torch.data.generators import BIO_TYPES, gen_biomedical

from .common import emit, time_fn

CATALOG = Catalog(unique_keys={
    "SOImpact__F": ("conseq",), "Biomart__F": ("protein",),
    "Samples__F": ("sample",)})


def build_pipeline() -> N.Program:
    Occ = N.Var("Occurrences", BIO_TYPES["Occurrences"])
    CN = N.Var("CopyNumber", BIO_TYPES["CopyNumber"])
    Sam = N.Var("Samples", BIO_TYPES["Samples"])
    SO = N.Var("SOImpact", BIO_TYPES["SOImpact"])
    Net = N.Var("Network", BIO_TYPES["Network"])
    Bio = N.Var("Biomart", BIO_TYPES["Biomart"])
    Expr = N.Var("GeneExpression", BIO_TYPES["GeneExpression"])

    # Step 1: hybrid scores — flatten Occurrences, join CopyNumber at the
    # candidate level and SOImpact at the consequence level, aggregate
    # per (sample, gene). (§C.2.1, simplified impact formula)
    def scores_q(s):
        inner = N.for_in("o", Occ, lambda o:
            N.IfThen(o.sample.eq(s.sample),
                N.for_in("t", o.candidates, lambda t:
                    N.for_in("n", CN, lambda n:
                        N.IfThen(N.BoolOp("&&", s.aliquot.eq(n.aliquot),
                                          n.gene.eq(t.gene)),
                            N.for_in("c", t.consequences, lambda c:
                                N.for_in("v", SO, lambda v:
                                    N.IfThen(c.conseq.eq(v.conseq),
                                        N.Singleton(N.record(
                                            gene=t.gene,
                                            score=t.impact * v.value
                                            * t.sift * t.poly))))))))))
        return N.SumBy(inner, keys=("gene",), values=("score",))

    hybrid = N.for_in("s", Sam, lambda s: N.Singleton(N.record(
        sample=s.sample, aliquot=s.aliquot, scores=scores_q(s))))

    # Step 2: by-sample network effect (join hybrid scores into edges)
    HM = N.Var("HybridMatrix", hybrid.ty)

    def nodes_q(h):
        inner = N.for_in("n", Net, lambda n:
            N.for_in("e", n.edges, lambda e:
                N.for_in("b", Bio, lambda b:
                    N.IfThen(e.edgeProtein.eq(b.protein),
                        N.for_in("y", h.scores, lambda y:
                            N.IfThen(y.gene.eq(b.gene),
                                N.Singleton(N.record(
                                    node=n.nodeProtein,
                                    score=y.score))))))))
        return N.SumBy(inner, keys=("node",), values=("score",))

    sample_net = N.for_in("h", HM, lambda h: N.Singleton(N.record(
        sample=h.sample, aliquot=h.aliquot, nodes=nodes_q(h))))

    # Step 3+4: connection scores (effect x expression), per sample
    SN = N.Var("SampleNetwork", sample_net.ty)

    def conn_q(sn):
        inner = N.for_in("nd", sn.nodes, lambda nd:
            N.for_in("b", Bio, lambda b:
                N.IfThen(nd.node.eq(b.protein),
                    N.for_in("g", Expr, lambda g:
                        N.IfThen(N.BoolOp("&&", g.gene.eq(b.gene),
                                          g.aliquot.eq(sn.aliquot)),
                            N.Singleton(N.record(
                                gene=g.gene,
                                score=nd.score * g.fpkm)))))))
        return N.SumBy(inner, keys=("gene",), values=("score",))

    connect = N.for_in("sn", SN, lambda sn: N.Singleton(N.record(
        sample=sn.sample, scores=conn_q(sn))))

    # Step 5: gene connectivity across all samples (flat output)
    CM = N.Var("ConnectMatrix", connect.ty)
    connectivity = N.SumBy(
        N.for_in("s", CM, lambda s:
            N.for_in("c", s.scores, lambda c:
                N.Singleton(N.record(gene=c.gene, score=c.score)))),
        keys=("gene",), values=("score",))

    return N.Program([
        N.Assignment("HybridMatrix", hybrid),
        N.Assignment("SampleNetwork", sample_net),
        N.Assignment("ConnectMatrix", connect),
        N.Assignment("Connectivity", connectivity),
    ])


def run(n_samples: int = 10, n_genes: int = 30, device=None) -> List[str]:
    """The pipeline over ``gen_biomedical(n_samples, n_genes)`` on
    ``device`` (None = the GPU), checked against the interpreter to 6
    digits; returns the rows. The operators take the exact path
    (``use_kernel=False``, as the reference's driver runs): the kernels
    sum floats in f32, and these scores are not integer-valued
    (``chip_smoke.py`` phase I runs the pipeline through the kernels and
    holds it to the f32 bound)."""
    db = gen_biomedical(n_samples=n_samples, n_genes=n_genes, seed=0)
    prog = build_pipeline()
    settings = ExecSettings()

    # oracle (direct nested evaluation of the whole pipeline)
    direct_env = I.eval_program(prog, dict(db))
    want = direct_env["Connectivity"]

    # shredded engine: whole pipeline over dictionaries, no unshredding
    sp = M.shred_program(prog, BIO_TYPES, domain_elimination=True)
    cp = CG.compile_program(sp, CATALOG)
    env0 = CG.columnar_shred_inputs(db, BIO_TYPES, device=device)
    us = time_fn(lambda: CG.run_flat_program(cp, env0, settings),
                 device=device)
    env = CG.run_flat_program(cp, env0, settings)
    man = sp.manifests["Connectivity"]
    got = env[man.top].to_rows()
    ok = I.bags_equal(want, got)
    assert ok, "E2E pipeline mismatch vs oracle"
    rows = [emit("bio_e2e_shred", us,
                 f"steps=4;assignments={len(sp.program.names())};"
                 f"match={ok}")]

    # interpreter route for scale reference
    us_interp = time_fn(
        lambda: I.eval_program(prog, dict(db))["Connectivity"],
        warmup=0, iters=1, device="cpu")
    rows.append(emit("bio_e2e_interpreter", us_interp, ""))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-samples", type=int, default=10)
    ap.add_argument("--n-genes", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    run(args.n_samples, args.n_genes, args.device)


if __name__ == "__main__":
    main()
