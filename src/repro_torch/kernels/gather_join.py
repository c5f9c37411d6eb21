"""The join inner loop on Hopper (``csrc/gather_join.cu``):

* ``merge_positions_cuda`` — for each probe key, its left/right
  insertion points into the sorted build keys (fences in shared memory,
  then the first keys of the sectors, copied to a compact array that
  stays in L2, then one sector of keys);
* ``gather_rows_cuda`` — ``out[i] = values[idx[i]]`` over int64
  bit-view lanes, 0 for an index outside ``[0, r)``.

Both are exact integer work; the design note is in the CUDA source.
Given a batch size ``B``, either wrapper runs B calls in one launch (the
batched family execution): an operand with a leading batch axis is read
a slice a call, one without it is shared by all B (batch stride 0, not
copied); one call is the same launch with B = 1. ``MERGE_LAUNCHES`` /
``GATHER_LAUNCHES`` count the calls that launched each kernel, batched
or not (and nothing else); ``MERGE_BATCHED_LAUNCHES`` /
``GATHER_BATCHED_LAUNCHES`` the launches among them given a ``B``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

MERGE_LAUNCHES = 0
GATHER_LAUNCHES = 0
MERGE_BATCHED_LAUNCHES = 0
GATHER_BATCHED_LAUNCHES = 0
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


def _operands(what: str, B, *specs) -> tuple:
    """(device, batch strides) of a launch's operands ``specs``, pairs
    (tensor, dims of one call's operand): int64 and contiguous on one
    CUDA device. ``B`` None: one call, each operand with exactly its
    dims (stride 0); else ``build.batch_stride``."""
    dev = specs[0][0].device
    strides = []
    for t, dims in specs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors must share one CUDA device; "
                             f"got {[str(x.device) for x, _ in specs]}")
        if t.dtype != torch.int64 or not t.is_contiguous() \
                or (B is None and t.dim() != dims):
            raise TypeError(f"{what}: want contiguous int64 operands of "
                            f"{dims} dims a call; got {t.dtype} "
                            f"{tuple(t.shape)}")
        strides.append(0 if B is None else build.batch_stride(what, t, dims,
                                                              B))
    return dev, strides


def merge_positions_cuda(sorted_keys: torch.Tensor, queries: torch.Tensor,
                         B: Optional[int] = None) -> tuple:
    """(lo, hi) int32 = searchsorted(sorted_keys, queries, left/right).
    Both inputs int64 and contiguous: ``sorted_keys`` (r,) ascending,
    ``queries`` (n,); (lo, hi) (n,).

    ``B``: B calls in one launch, (lo, hi) (B, n), row b the call on row
    b of each operand that has a leading batch axis of B (``(B, r)``,
    each row ascending, or ``(B, n)``); an operand without it is shared.
    Shared keys build their heads once."""
    what = "merge_positions_cuda"
    dev, (ks, qs) = _operands(what, B, (sorted_keys, 1), (queries, 1))
    r, n = sorted_keys.shape[-1], queries.shape[-1]
    if r >= 2 ** 31:
        raise ValueError(f"{what}: r={r} exceeds int32 positions")
    shape = (n,) if B is None else (B, n)
    lo = torch.empty(shape, dtype=torch.int32, device=dev)
    hi = torch.empty(shape, dtype=torch.int32, device=dev)
    fn = _fn("merge_positions_launch",
             [_P, _I64, _I64, _P, _I64, _I64, _I, _P, _P, _P, _I64, _P])
    # scratch: the first key of each sector of 4 (the kernel's pre-pass),
    # a row a keys row, each row 16-byte aligned
    hs = (r + 3) // 4 + ((r + 3) // 4) % 2
    heads = torch.empty(((B if ks else 1), hs), dtype=torch.int64,
                        device=dev)
    build.launch(fn, dev.index,
                 (sorted_keys.data_ptr(), r, ks, queries.data_ptr(), n, qs,
                  B or 1, lo.data_ptr(), hi.data_ptr(),
                  heads.data_ptr() or None, hs),
                 "merge_positions", globals(), "MERGE_LAUNCHES",
                 None if B is None else "MERGE_BATCHED_LAUNCHES")
    return lo, hi


def gather_rows_cuda(values: torch.Tensor, idx: torch.Tensor,
                     B: Optional[int] = None) -> torch.Tensor:
    """out (n, d) int64 = values[idx] with out-of-range rows 0.
    ``values`` (r, d) int64 and ``idx`` (n,) int64, contiguous.

    ``B``: B calls in one launch, out (B, n, d), row b the call on row b
    of each operand that has a leading batch axis of B (``(B, r, d)`` or
    ``(B, n)``); an operand without it is shared."""
    what = "gather_rows_cuda"
    dev, (vs, ids) = _operands(what, B, (values, 2), (idx, 1))
    r, d = values.shape[-2:]
    n = idx.shape[-1]
    out = torch.empty((n, d) if B is None else (B, n, d), dtype=torch.int64,
                      device=dev)
    fn = _fn("gather_rows_launch",
             [_P, _I64, _I, _I64, _P, _I64, _I64, _I, _P, _P])
    build.launch(fn, dev.index,
                 (values.data_ptr(), r, d, vs, idx.data_ptr(), n, ids,
                  B or 1, out.data_ptr()),
                 "gather_rows", globals(), "GATHER_LAUNCHES",
                 None if B is None else "GATHER_BATCHED_LAUNCHES")
    return out
