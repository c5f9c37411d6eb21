"""The join inner loop on Hopper (``csrc/gather_join.cu``):

* ``merge_positions_cuda`` — for each probe key, its left/right
  insertion points into the sorted build keys (fences in shared memory,
  then the first keys of the sectors, copied to a compact array that
  stays in L2, then one sector of keys);
* ``gather_rows_cuda`` — ``out[i] = values[idx[i]]`` over int64
  bit-view lanes, 0 for an index outside ``[0, r)``.

Both are exact integer work; the design note is in the CUDA source.
``MERGE_LAUNCHES`` / ``GATHER_LAUNCHES`` count the calls that launched
each kernel (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MERGE_LAUNCHES = 0
GATHER_LAUNCHES = 0
_FNS = {}


def _fn(name: str, argtypes):
    f = _FNS.get(name)
    if f is None:
        f = getattr(build.load("gather_join"), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[name] = f
    return f


_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _check_1d_i64(what: str, *ts):
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors must share one CUDA device; "
                             f"got {[str(x.device) for x in ts]}")
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{what}: want contiguous 1-d int64 tensors; "
                            f"got {t.dtype} {tuple(t.shape)}")
    return dev


def merge_positions_cuda(sorted_keys: torch.Tensor, queries: torch.Tensor
                         ) -> tuple:
    """(lo, hi) int32 = searchsorted(sorted_keys, queries, left/right).
    Both inputs int64, 1-d and contiguous; ``sorted_keys`` ascending."""
    dev = _check_1d_i64("merge_positions_cuda", sorted_keys, queries)
    r, n = sorted_keys.shape[0], queries.shape[0]
    if r >= 2 ** 31:
        raise ValueError(f"merge_positions_cuda: r={r} exceeds int32 "
                         "positions")
    lo = torch.empty((n,), dtype=torch.int32, device=dev)
    hi = torch.empty((n,), dtype=torch.int32, device=dev)
    fn = _fn("merge_positions_launch",
             [_P, _I64, _P, _I64, _P, _P, _P, _P])
    # scratch: the first key of each sector of 4 (the kernel's pre-pass)
    heads = torch.empty(((r + 3) // 4,), dtype=torch.int64, device=dev)
    build.launch(fn, dev.index,
                 (sorted_keys.data_ptr(), r, queries.data_ptr(), n,
                  lo.data_ptr(), hi.data_ptr(), heads.data_ptr() or None),
                 "merge_positions", globals(), "MERGE_LAUNCHES")
    return lo, hi


def gather_rows_cuda(values: torch.Tensor, idx: torch.Tensor
                     ) -> torch.Tensor:
    """out (n, d) int64 = values[idx] with out-of-range rows 0.
    ``values`` (r, d) int64 and ``idx`` (n,) int64, contiguous."""
    dev = _check_1d_i64("gather_rows_cuda", idx)
    if values.device != dev or values.dtype != torch.int64 \
            or values.dim() != 2 or not values.is_contiguous():
        raise TypeError("gather_rows_cuda: want contiguous (r, d) int64 "
                        f"values on {dev}; got {values.dtype} "
                        f"{tuple(values.shape)} on {values.device}")
    r, d = values.shape
    n = idx.shape[0]
    out = torch.empty((n, d), dtype=torch.int64, device=dev)
    fn = _fn("gather_rows_launch", [_P, _I64, _I, _P, _I64, _P, _P])
    build.launch(fn, dev.index,
                 (values.data_ptr(), r, d, idx.data_ptr(), n, out.data_ptr()),
                 "gather_rows", globals(), "GATHER_LAUNCHES")
    return out
