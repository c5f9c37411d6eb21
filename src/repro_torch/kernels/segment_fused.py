"""Fused sorted-segment sum + first-row gather on Hopper
(``csrc/segment_fused.cu``).

``sum_by`` and ``nest_level`` share a tail: per segment they need (a)
the sum of the value columns, (b) the index of the segment's first row
and (c) that row's key-column values. This kernel produces all three in
one launch sequence; the design note is in the CUDA source.

``LAUNCHES`` counts the calls that launched the kernel (and nothing
else), so a run can show that its path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .segment_reduce import TILE_ROWS

LAUNCHES = 0
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("segment_fused").segment_sum_first_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                      ctypes.c_int64] + [ctypes.c_void_p] * 3 \
            + [ctypes.c_int64] + [ctypes.c_void_p] * 7
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def segment_sum_first_cuda(values: torch.Tensor, keys: torch.Tensor,
                           seg_ids: torch.Tensor, num_segments: int) -> tuple:
    """(sums (S, d) f32, firstidx (S,) i32, firstvals (S, k) i64).

    ``values`` (n, d) float32, ``keys`` (n, k) int64 bit-views and
    ``seg_ids`` (n,) int32, all contiguous on one CUDA device.
    Precondition: the in-range ``seg_ids`` are NON-DECREASING (the dense
    group ids of a sorted bag, as ``exec.ops._segment_firsts`` delivers
    them): the kernel traps on a descending pair, so that the next
    synchronisation raises. Rows with ids outside [0, num_segments) are
    dropped."""
    n = seg_ids.shape[0]
    S = int(num_segments)
    dev = seg_ids.device
    if dev.type != "cuda":
        raise ValueError(f"segment_sum_first_cuda: tensors on {dev}")
    if values.dtype != torch.float32 or keys.dtype != torch.int64 \
            or seg_ids.dtype != torch.int32:
        raise TypeError("segment_sum_first_cuda: want float32 values, "
                        "int64 keys, int32 seg_ids; got "
                        f"{values.dtype}, {keys.dtype}, {seg_ids.dtype}")
    if values.dim() != 2 or keys.dim() != 2 or seg_ids.dim() != 1 \
            or values.shape[0] != n or keys.shape[0] != n:
        raise ValueError("segment_sum_first_cuda: want values (n, d), keys "
                         f"(n, k), seg_ids (n,); got {tuple(values.shape)}, "
                         f"{tuple(keys.shape)}, {tuple(seg_ids.shape)}")
    if not (values.is_contiguous() and keys.is_contiguous()
            and seg_ids.is_contiguous()):
        raise ValueError("segment_sum_first_cuda: inputs must be contiguous")
    if values.device != dev or keys.device != dev:
        raise ValueError("segment_sum_first_cuda: inputs on different "
                         "devices")
    if n >= 2 ** 31 or S >= 2 ** 31 or S < 0:
        raise ValueError(f"segment_sum_first_cuda: n={n}, S={S} out of the "
                         "int32 index range")
    d, k = values.shape[1], keys.shape[1]
    sums = torch.empty((S, d), dtype=torch.float32, device=dev)
    fidx = torch.empty((S,), dtype=torch.int32, device=dev)
    fvals = torch.empty((S, k), dtype=torch.int64, device=dev)
    fn = _fn()
    # scratch: each tile's lowest and highest in-range id, the rows where
    # those two runs start and their sums within it (the carries the
    # second pass joins)
    tiles = -(-n // TILE_ROWS)
    ids = torch.empty((4, tiles), dtype=torch.int32, device=dev)
    carry = torch.empty((2, tiles, d), dtype=torch.float32, device=dev)
    build.launch(fn, dev.index,
                 (values.data_ptr(), keys.data_ptr(), seg_ids.data_ptr(), n,
                  d, k, S, sums.data_ptr(), fidx.data_ptr(),
                  fvals.data_ptr(), tiles, *(r.data_ptr() for r in ids),
                  carry[0].data_ptr(), carry[1].data_ptr()),
                 "segment_sum_first", globals(), "LAUNCHES")
    return sums, fidx, fvals
