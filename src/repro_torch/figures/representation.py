"""Representation benchmark (paper Appendix E.1 analogue) on the port:
row-at-a-time Python dict processing (AoS, the paper's RDDs of case
classes) vs the columnar FlatBag engine (SoA, its Datasets), and the
Hopper ``segment_reduce`` kernel vs its plain version for the Gamma+
hot spot. The rows are ``benchmarks/representation.py``'s, with the
kernel's in place of the Pallas kernel's.

    python -m repro_torch.figures.representation [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.columnar.table import FlatBag, resolve_device
from repro_torch.exec import ops as X
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R

from .common import emit, time_fn


def run(n: int = 20000, groups: int = 256, device=None) -> List[str]:
    """The comparison at ``n`` rows over ``groups`` keys on ``device``
    (None = the GPU); returns the rows."""
    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    rows = [{"k": int(rng.randint(0, groups)), "v": float(rng.rand())}
            for _ in range(n)]
    out = []

    # AoS: row-at-a-time dict aggregation (the RDD analogue)
    def aos():
        acc = {}
        for r in rows:
            acc[r["k"]] = acc.get(r["k"], 0.0) + r["v"]
        return acc

    us_aos = time_fn(aos, warmup=0, iters=3, device="cpu")
    out.append(emit("repr_rowwise_sumby", us_aos, f"n={n}"))

    # SoA: columnar sum_by through the kernels
    bag = FlatBag.from_rows(rows, {"k": "int", "v": "real"}, device=dev)
    us_soa = time_fn(lambda: X.sum_by(bag, ("k",), ("v",), use_kernel=True),
                     device=dev)
    out.append(emit("repr_columnar_sumby", us_soa,
                    f"speedup=x{us_aos / us_soa:.1f}"))

    # Gamma+ kernel path: segment_reduce (the kernel on the card) vs its
    # plain version
    seg = torch.as_tensor(np.sort(rng.randint(0, groups, n)).astype(np.int32),
                          device=dev)
    vals = torch.as_tensor(rng.rand(n, 1).astype(np.float32), device=dev)
    us_ref = time_fn(lambda: R.segment_reduce_ref(vals, seg, groups),
                     device=dev)
    out.append(emit("repr_segment_reduce_plain", us_ref, ""))
    us_kern = time_fn(lambda: K.segment_reduce(vals, seg, groups), device=dev)
    out.append(emit("repr_segment_reduce_kernel", us_kern, ""))
    got = K.segment_reduce(vals, seg, groups)
    want = R.segment_reduce_ref(vals, seg, groups)
    ok = bool(torch.allclose(got, want, atol=1e-3))
    out.append(emit("repr_segment_reduce_kernel_matches", 0.0, str(ok)))
    assert ok
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
