"""Seeded synthetic datasets for the benchmark suite.

* TPC-H-like nested hierarchy (Lineitem/Orders/Customer/Nation/Region +
  Part) with a Zipf skew knob — the paper's micro-benchmark §6;
* biomedical-like inputs (Occurrences/CopyNumber/Network/...) — §C;
* a nested web-corpus (documents -> sections -> tokens) feeding LM
  training through the query engine (pipeline.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import nrc as N

# ---------------------------------------------------------------------------
# TPC-H-like schema (integer-coded strings; DESIGN.md §7)
# ---------------------------------------------------------------------------

PART_T = N.bag(N.tuple_t(pid=N.INT, pname=N.INT, price=N.REAL))
LINEITEM_T = N.bag(N.tuple_t(oid=N.INT, pid=N.INT, qty=N.REAL))
ORDERS_T = N.bag(N.tuple_t(oid=N.INT, cid=N.INT, odate=N.INT))
CUSTOMER_T = N.bag(N.tuple_t(cid=N.INT, nid=N.INT, cname=N.INT))
NATION_T = N.bag(N.tuple_t(nid=N.INT, rid=N.INT, nname=N.INT))
REGION_T = N.bag(N.tuple_t(rid=N.INT, rname=N.INT))

TPCH_TYPES = {"Part": PART_T, "Lineitem": LINEITEM_T, "Orders": ORDERS_T,
              "Customer": CUSTOMER_T, "Nation": NATION_T,
              "Region": REGION_T}


def zipf_choice(rng, n: int, skew: float, size: int) -> np.ndarray:
    """Zipf-ish keys in [1, n]; skew=0 -> uniform (paper's generator)."""
    if skew <= 0:
        return rng.randint(1, n + 1, size=size)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-skew)
    probs /= probs.sum()
    return rng.choice(np.arange(1, n + 1), size=size, p=probs)


def gen_tpch(scale: int = 100, skew: float = 0.0, seed: int = 0
             ) -> Dict[str, list]:
    """Scaled-down TPC-H-like database. ``scale`` ~ number of orders."""
    rng = np.random.RandomState(seed)
    n_parts = max(scale // 2, 8)
    n_orders = scale
    n_cust = max(scale // 4, 4)
    n_nation = 25
    n_region = 5
    parts = [{"pid": i, "pname": 10000 + i,
              "price": float(rng.randint(1, 100))}
             for i in range(1, n_parts + 1)]
    lineitem = []
    for oid in range(1, n_orders + 1):
        for _ in range(rng.randint(1, 8)):
            pid = int(zipf_choice(rng, n_parts, skew, 1)[0])
            lineitem.append({"oid": oid, "pid": pid,
                             "qty": float(rng.randint(1, 50))})
    orders = [{"oid": oid, "cid": int(rng.randint(1, n_cust + 1)),
               "odate": 20200000 + int(rng.randint(1, 365))}
              for oid in range(1, n_orders + 1)]
    customer = [{"cid": c, "nid": int(rng.randint(1, n_nation + 1)),
                 "cname": 20000 + c} for c in range(1, n_cust + 1)]
    nation = [{"nid": n_, "rid": (n_ % n_region) + 1, "nname": 30000 + n_}
              for n_ in range(1, n_nation + 1)]
    region = [{"rid": r, "rname": 40000 + r} for r in range(1, n_region + 1)]
    return {"Part": parts, "Lineitem": lineitem, "Orders": orders,
            "Customer": customer, "Nation": nation, "Region": region}


# ---------------------------------------------------------------------------
# biomedical-like inputs (paper §C.1, scaled down, integer-coded)
# ---------------------------------------------------------------------------

OCCURRENCES_T = N.bag(N.tuple_t(
    sample=N.INT, mutationId=N.INT,
    candidates=N.bag(N.tuple_t(
        gene=N.INT, impact=N.REAL, sift=N.REAL, poly=N.REAL,
        consequences=N.bag(N.tuple_t(conseq=N.INT))))))
COPYNUMBER_T = N.bag(N.tuple_t(aliquot=N.INT, gene=N.INT, cnum=N.INT))
SAMPLES_T = N.bag(N.tuple_t(sample=N.INT, aliquot=N.INT))
SOIMPACT_T = N.bag(N.tuple_t(conseq=N.INT, value=N.REAL))
NETWORK_T = N.bag(N.tuple_t(
    nodeProtein=N.INT,
    edges=N.bag(N.tuple_t(edgeProtein=N.INT, distance=N.INT))))
BIOMART_T = N.bag(N.tuple_t(gene=N.INT, protein=N.INT))
EXPRESSION_T = N.bag(N.tuple_t(aliquot=N.INT, gene=N.INT, fpkm=N.REAL))

BIO_TYPES = {"Occurrences": OCCURRENCES_T, "CopyNumber": COPYNUMBER_T,
             "Samples": SAMPLES_T, "SOImpact": SOIMPACT_T,
             "Network": NETWORK_T, "Biomart": BIOMART_T,
             "GeneExpression": EXPRESSION_T}


def gen_biomedical(n_samples: int = 12, n_genes: int = 40,
                   n_conseq: int = 10, skew: float = 0.0,
                   seed: int = 0) -> Dict[str, list]:
    rng = np.random.RandomState(seed)
    samples = [{"sample": s, "aliquot": 100 + s}
               for s in range(1, n_samples + 1)]
    occurrences = []
    mid = 0
    for s in range(1, n_samples + 1):
        for _ in range(rng.randint(1, 6)):
            mid += 1
            cands = []
            for _ in range(rng.randint(0, 5)):
                gene = int(zipf_choice(rng, n_genes, skew, 1)[0])
                cons = [{"conseq": int(rng.randint(1, n_conseq + 1))}
                        for _ in range(rng.randint(1, 4))]
                cands.append({"gene": gene,
                              "impact": float(rng.rand()),
                              "sift": float(rng.rand()),
                              "poly": float(rng.rand()),
                              "consequences": cons})
            occurrences.append({"sample": s, "mutationId": mid,
                                "candidates": cands})
    copynumber = [{"aliquot": 100 + s, "gene": g,
                   "cnum": int(rng.randint(0, 6))}
                  for s in range(1, n_samples + 1)
                  for g in range(1, n_genes + 1)]
    soimpact = [{"conseq": c, "value": float(rng.rand())}
                for c in range(1, n_conseq + 1)]
    network = [{"nodeProtein": 500 + p,
                "edges": [{"edgeProtein": 500 + int(rng.randint(1, n_genes)),
                           "distance": int(rng.randint(1, 10))}
                          for _ in range(rng.randint(1, 6))]}
               for p in range(1, n_genes + 1)]
    biomart = [{"gene": g, "protein": 500 + g}
               for g in range(1, n_genes + 1)]
    expression = [{"aliquot": 100 + s, "gene": g,
                   "fpkm": float(rng.rand() * 10)}
                  for s in range(1, n_samples + 1)
                  for g in range(1, n_genes + 1)]
    return {"Occurrences": occurrences, "CopyNumber": copynumber,
            "Samples": samples, "SOImpact": soimpact, "Network": network,
            "Biomart": biomart, "GeneExpression": expression}


# ---------------------------------------------------------------------------
# nested web corpus for LM training (pipeline.py consumes this)
# ---------------------------------------------------------------------------

CORPUS_T = N.bag(N.tuple_t(
    doc_id=N.INT, lang=N.INT, quality=N.REAL,
    sections=N.bag(N.tuple_t(
        sec_id=N.INT, kind=N.INT,
        tokens=N.bag(N.tuple_t(pos=N.INT, tok=N.INT))))))

LANGSCORE_T = N.bag(N.tuple_t(lang=N.INT, weight=N.REAL))

CORPUS_TYPES = {"Corpus": CORPUS_T, "LangScore": LANGSCORE_T}


def gen_corpus(n_docs: int = 64, vocab: int = 1000, max_secs: int = 4,
               max_toks: int = 64, skew: float = 1.2, seed: int = 0
               ) -> Dict[str, list]:
    """Documents -> sections -> tokens with Zipf-ish section lengths (the
    inner-collection skew the paper targets)."""
    rng = np.random.RandomState(seed)
    docs = []
    for d in range(1, n_docs + 1):
        secs = []
        for s in range(rng.randint(1, max_secs + 1)):
            ln = int(zipf_choice(rng, max_toks, skew, 1)[0])
            toks = [{"pos": p, "tok": int(rng.randint(2, vocab))}
                    for p in range(ln)]
            secs.append({"sec_id": d * 100 + s,
                         "kind": int(rng.randint(0, 3)), "tokens": toks})
        docs.append({"doc_id": d, "lang": int(rng.randint(0, 4)),
                     "quality": float(rng.rand()), "sections": secs})
    langscore = [{"lang": l, "weight": 1.0 if l < 3 else 0.0}
                 for l in range(4)]
    return {"Corpus": docs, "LangScore": langscore}
