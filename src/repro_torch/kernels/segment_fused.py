"""Fused sorted-segment sum + first-row gather on Hopper
(``csrc/segment_fused.cu``).

``sum_by`` and ``nest_level`` share a tail: per segment they need (a)
the sum of the value columns, (b) the index of the segment's first row
and (c) that row's key-column values. This kernel produces all three in
one launch sequence; the design note is in the CUDA source.

Given a batch size ``B``, ``segment_sum_first_cuda`` runs B calls in one
launch sequence (the batched family execution): an operand with a
leading batch axis is read a slice a call, one without it is shared by
all B (batch stride 0, not copied); one call is the same launch with
B = 1.

``LAUNCHES`` counts the calls that launched the kernel, batched or not
(and nothing else), so a run can show that its path went through it;
``BATCHED_LAUNCHES`` the launches among them given a ``B``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build
from .segment_reduce import TILE_ROWS

LAUNCHES = 0
BATCHED_LAUNCHES = 0
_FN = None
_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _fn():
    global _FN
    if _FN is None:
        f = build.load("segment_fused").segment_sum_first_launch
        f.argtypes = [_P, _I64, _P, _I64, _P, _I64, _I64, _I, _I, _I64, _I] \
            + [_P] * 3 + [_I64] + [_P] * 7
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def segment_sum_first_cuda(values: torch.Tensor, keys: torch.Tensor,
                           seg_ids: torch.Tensor, num_segments: int,
                           B: Optional[int] = None) -> tuple:
    """(sums (S, d) f32, firstidx (S,) i32, firstvals (S, k) i64).

    ``values`` (n, d) float32, ``keys`` (n, k) int64 bit-views and
    ``seg_ids`` (n,) int32, all contiguous on one CUDA device.
    Precondition: the in-range ``seg_ids`` are NON-DECREASING (the dense
    group ids of a sorted bag, as ``exec.ops._segment_firsts`` delivers
    them): the kernel traps on a descending pair, so that the next
    synchronisation raises. Rows with ids outside [0, num_segments) are
    dropped.

    ``B``: B calls in one launch sequence, outputs (B, S, d), (B, S) and
    (B, S, k), row b the call on row b of each operand that has a
    leading batch axis of B (``(B, n, d)``, ``(B, n, k)`` or ``(B, n)``);
    an operand without it is shared."""
    S = int(num_segments)
    what = "segment_sum_first_cuda"
    dev = seg_ids.device
    if dev.type != "cuda" or values.device != dev or keys.device != dev:
        raise ValueError(f"{what}: tensors must share one CUDA device; got "
                         f"{values.device}, {keys.device}, {dev}")
    if values.dtype != torch.float32 or keys.dtype != torch.int64 \
            or seg_ids.dtype != torch.int32:
        raise TypeError(f"{what}: want float32 values, int64 keys, int32 "
                        f"seg_ids; got {values.dtype}, {keys.dtype}, "
                        f"{seg_ids.dtype}")
    if not (values.is_contiguous() and keys.is_contiguous()
            and seg_ids.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    n = seg_ids.shape[-1]
    if B is None:
        if values.dim() != 2 or keys.dim() != 2 or seg_ids.dim() != 1:
            raise ValueError(f"{what}: want values (n, d), keys (n, k), "
                             f"seg_ids (n,); got {tuple(values.shape)}, "
                             f"{tuple(keys.shape)}, {tuple(seg_ids.shape)}")
        vs = ks = ss = 0
    else:
        vs, ks, ss = (build.batch_stride(what, t, dims, B) for t, dims in
                      ((values, 2), (keys, 2), (seg_ids, 1)))
    if values.shape[-2] != n or keys.shape[-2] != n:
        raise ValueError(f"{what}: want values (n, d), keys (n, k), seg_ids "
                         f"(n,) a call; got {tuple(values.shape)}, "
                         f"{tuple(keys.shape)}, {tuple(seg_ids.shape)}")
    if n >= 2 ** 31 or S >= 2 ** 31 or S < 0:
        raise ValueError(f"{what}: n={n}, S={S} out of the int32 index "
                         "range")
    d, k = values.shape[-1], keys.shape[-1]
    rows = () if B is None else (B,)
    sums = torch.empty(rows + (S, d), dtype=torch.float32, device=dev)
    fidx = torch.empty(rows + (S,), dtype=torch.int32, device=dev)
    fvals = torch.empty(rows + (S, k), dtype=torch.int64, device=dev)
    # scratch, a row a call: each tile's lowest and highest in-range id,
    # the rows where those two runs start and their sums within it (the
    # carries the second pass joins)
    tiles = -(-n // TILE_ROWS)
    ids = torch.empty((4, B or 1, tiles), dtype=torch.int32, device=dev)
    carry = torch.empty((2, B or 1, tiles, d), dtype=torch.float32,
                        device=dev)
    build.launch(_fn(), dev.index,
                 (values.data_ptr(), vs, keys.data_ptr(), ks,
                  seg_ids.data_ptr(), ss, n, d, k, S, B or 1,
                  sums.data_ptr(), fidx.data_ptr(), fvals.data_ptr(), tiles,
                  *(r.data_ptr() for r in ids), carry[0].data_ptr(),
                  carry[1].data_ptr()),
                 "segment_sum_first", globals(), "LAUNCHES",
                 None if B is None else "BATCHED_LAUNCHES")
    return sums, fidx, fvals
