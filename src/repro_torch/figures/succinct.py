"""Succinct-representation microbenchmark (paper Appendix D) on the
port: when many outer tuples share inner bags, the shredded
representation stores each inner bag once (shared label) while
flattening replicates it. Host-side value shredding with the copied
``interpreter.shred_value``; the rows are ``benchmarks/succinct.py``'s.

    python -m repro_torch.figures.succinct
"""

from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import interpreter as I
from repro_torch.core import nrc as N

from .common import emit

# mutations shared across samples: Occurrences-like join
MUT_T = N.bag(N.tuple_t(
    mid=N.INT,
    annos=N.bag(N.tuple_t(gene=N.INT, impact=N.REAL))))


def run(n_samples: int = 50, n_mutations: int = 40, annos_per: int = 25,
        muts_per_sample: int = 30) -> List[str]:
    rng = np.random.RandomState(0)
    annotations = [
        {"mid": m,
         "annos": [{"gene": int(rng.randint(0, 500)),
                    "impact": float(rng.rand())}
                   for _ in range(annos_per)]}
        for m in range(n_mutations)]

    # value-shred the annotation table once: inner bags get labels
    parts = I.shred_value(annotations, MUT_T, root="Ann")
    shred_inner = len(parts[("annos",)])

    # per-sample mutation lists referencing shared mutations
    total_flat = 0
    for s in range(n_samples):
        mids = rng.randint(0, n_mutations, muts_per_sample)
        for m in mids:
            total_flat += annos_per   # flattening copies the inner bag

    ratio = total_flat / max(shred_inner, 1)
    rows = [emit("succinct_flat_inner_tuples", 0.0, str(total_flat)),
            emit("succinct_shred_inner_tuples", 0.0, str(shred_inner)),
            emit("succinct_sharing_ratio", 0.0, f"x{ratio:.1f}")]
    assert shred_inner < total_flat
    return rows


if __name__ == "__main__":
    run()
