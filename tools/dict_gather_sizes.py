"""Time dict_gather at several dictionary sizes on one checkout's port.

    python3 tools/dict_gather_sizes.py [--tree DIR] [--label NAME]
                                       [--sizes 49,4096,65536]

DIR is the root of a checkout (default: this one): its
``src/repro_torch`` is imported and its kernels are built into its own
``build/``, so that two checkouts (a parent and its change) can be
timed in turns in one process each on the same card. Each size r gives
a 2^20-row chunk on the card: r = 49 with uint8 codes, the shape of
``chip_smoke.py`` phase D0's qty chunk (random entries, codes drawn
uniformly); any other r with uint16 codes, D0's ``dict_chunk`` (r
distinct int64 values from [0, 2^40)) encoded by the checkout's own
codec. At each: ``dict_gather_cuda`` bit-equal to the plain version,
its time a call (CUDA events over 10 back-to-back calls,
``chip_smoke.time_ms``) and device time (``chip_smoke.device_ms``,
``torch.profiler``) beside the byte bound 8 r + code bytes n + 8 n
over 3.35 TB/s and the library call ``values[idx]``; then the host time
of one call at the first size by step, over 1,000 calls each
(``chip_smoke.host_us``; the steps of the checkout's own wrapper).
Prints the card's name and power limit, then one JSON line.
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


def chunk(r: int, dev):
    """(values, codes) on ``dev`` for a 2^20-row chunk of r entries."""
    n = chip_smoke.CHUNK_ROWS
    if r == 49:
        rng = np.random.RandomState(49)
        values = rng.randint(-2 ** 63, 2 ** 63 - 1, r, dtype=np.int64)
        codes = rng.randint(0, r, n).astype(np.uint8)
    else:
        from repro_torch.storage import encodings as E
        enc, blob = E.encode_chunk(chip_smoke.dict_chunk(r, 0), "dict")
        m = E.unpack_members(enc, blob)
        values, codes = m["values"], m["codes"]
    return (torch.from_numpy(np.ascontiguousarray(values)).to(dev),
            torch.from_numpy(np.ascontiguousarray(codes)).to(dev))


def parent_split(values, codes, calls: int = 1000) -> dict:
    """Host time by step of a wrapper that checks, allocates, enters a
    device context and builds a stream object for its handle on every
    call (the steps of the port before its launch helper)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode as D
    n, r = codes.shape[0], values.shape[0]
    dev = values.device
    kinds = ((torch.int64,), tuple(D._CODE_KIND))
    fn = D._fn("dict_gather_launch", [D._P, D._I64, D._P, D._I, D._I64,
                                      D._P, D._P])
    out = D._out("dict_gather_cuda", None, n, dev)
    stream = build.stream_handle(dev)
    idx = codes.to(torch.int64)
    counts = {"n": 0}

    def context():
        with torch.cuda.device(dev):
            pass

    def check_and_bump():
        build.check(0, "dict_gather")
        build.bump(counts, "n")

    steps = {
        "_check": lambda: D._check("dict_gather_cuda", kinds, values,
                                   codes),
        "_out": lambda: D._out("dict_gather_cuda", None, n, dev),
        "torch.cuda.device context": context,
        "stream_handle (a torch.cuda.Stream object)":
            lambda: build.stream_handle(dev),
        "ctypes call with the launch":
            lambda: fn(values.data_ptr(), r, codes.data_ptr(),
                       D._CODE_KIND[codes.dtype], n, out.data_ptr(), stream),
        "check and locked bump": check_and_bump,
        "the whole call": lambda: D.dict_gather_cuda(values, codes),
        "the library call values[idx]": lambda: values[idx],
    }
    return {name: chip_smoke.host_us(step, calls)
            for name, step in steps.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--sizes", default="49,4096,65536")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import decode as D
    from repro_torch.kernels import ref as R
    assert D.__file__.startswith(os.path.abspath(args.tree)), D.__file__
    dev = torch.device("cuda")
    rows, split = [], None
    for r in (int(x) for x in args.sizes.split(",")):
        values, codes = chunk(r, dev)
        n = codes.shape[0]
        idx = codes.to(torch.int64)
        kern = lambda: D.dict_gather_cuda(values, codes)  # noqa: E731
        library = lambda: values[idx]  # noqa: E731
        got, want = kern(), R.dict_gather_ref(values, codes)
        assert torch.equal(got, want) and torch.equal(got, kern()), r
        del got, want
        (dev_ms, lib_dev_ms), _ = chip_smoke.device_ms([kern, library],
                                                       [20, 20])
        bound = (8 * r + codes.element_size() * n + 8 * n) \
            / chip_smoke.HBM_BYTES_PER_S * 1e3
        row = dict(r=r, codes=str(codes.dtype).replace("torch.", ""), n=n,
                   ms=chip_smoke.time_ms(kern), device_ms=dev_ms,
                   bound_ms=bound, library_ms=chip_smoke.time_ms(library),
                   library_device_ms=lib_dev_ms)
        row["share_of_bound"] = None if dev_ms is None else bound / dev_ms
        rows.append(row)
        print(f"[{args.label}] {row}", flush=True)
        if split is None:
            split = chip_smoke.dict_host_split(values, codes) \
                if hasattr(D, "_args") else parent_split(values, codes)
            print(f"[{args.label}] host time a call by step at r={r} (us): "
                  f"{ {k: round(v, 2) for k, v in split.items()} }",
                  flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    print(json.dumps({"tree": args.label, "sizes": rows,
                      "host_split_us": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
