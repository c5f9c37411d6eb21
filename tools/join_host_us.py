"""Host time of one unbatched call of each join kernel's CUDA wrapper on
one checkout's port.

    python3 tools/join_host_us.py [--tree DIR] [--label NAME]

DIR is the root of a checkout (default: this one): its
``src/repro_torch`` is imported and its kernels are built into its own
``build/``, so that two checkouts (a parent and its change) can be
timed in turns, one process each, on the same card. At small shapes,
where the host's time is the call's, each of ``merge_positions_cuda``
(1,024 sorted keys, 1,024 queries), ``gather_rows_cuda`` (1,024 x 4
values, 1,024 ids) and ``segment_sum_first_cuda`` (1,024 rows, d = 1,
k = 3, 64 segments, integer values) is first held bit-equal to its
plain version, then timed on the host: us a call over 1,000 calls made
10 at a time (``chip_smoke.host_us``). These are the wrappers that
``kernels/ops.py`` calls outside the batched pass. Prints the card's
name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (puts this checkout's src first)


def calls(dev) -> dict:
    """{kernel: (the wrapper's call, its plain version's call)}."""
    from repro_torch.kernels import gather_join as G
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import segment_fused as SF
    rng = np.random.RandomState(30)
    n = 1024

    def T(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sk = T(np.sort(rng.randint(-50, 50, n)).astype(np.int64))
    q = T(rng.randint(-60, 60, n).astype(np.int64))
    vals = T(rng.randint(-2 ** 62, 2 ** 62, (n, 4)).astype(np.int64))
    idx = T(rng.randint(-2, n + 2, n).astype(np.int64))
    x = T(rng.randint(-9, 9, (n, 1)).astype(np.float32))
    keys = T(rng.randint(-2 ** 62, 2 ** 62, (n, 3)).astype(np.int64))
    seg = T(np.sort(rng.randint(-1, 65, n)).astype(np.int32))
    return {
        "merge_positions": (lambda: G.merge_positions_cuda(sk, q),
                            lambda: R.merge_positions_ref(sk, q)),
        "gather_rows": (lambda: G.gather_rows_cuda(vals, idx),
                        lambda: R.gather_rows_ref(vals, idx)),
        "segment_sum_first": (
            lambda: SF.segment_sum_first_cuda(x, keys, seg, 64),
            lambda: R.segment_sum_first_ref(x, keys, seg, 64)),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("join_host_us: no CUDA device")
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import gather_join as G
    assert G.__file__.startswith(os.path.abspath(args.tree)), G.__file__
    print(chip_smoke.nvidia_smi())
    us = {}
    for name, (kern, plain) in calls(torch.device("cuda", 0)).items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        assert chip_smoke.bits_equal(got, want), name
        us[name] = chip_smoke.host_us(kern)
    print(json.dumps({"tree": args.label, "host_us_a_call": us}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
