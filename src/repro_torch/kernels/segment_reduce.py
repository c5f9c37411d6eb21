"""Sorted-segment sum on Hopper (``csrc/segment_reduce.cu``).

The paper's sumBy reduce over sorted keys, on its own: per segment the
f32 sum of the value columns. The design note is in the CUDA source.

``LAUNCHES`` counts the calls that launched the kernel (and nothing
else), so a run can show that its path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = 0
TILE_ROWS = 2048      # rows per tile of the kernel (it refuses others)
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("segment_reduce").segment_reduce_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_int64] + [ctypes.c_void_p] * 5
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def segment_reduce_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """(S, d) float32 sums of ``values`` (n, d) float32 by ``seg_ids``
    (n,) int32, both contiguous on one CUDA device. Rows with ids outside
    [0, num_segments) are dropped. The in-range ids must be
    non-decreasing: the kernel traps on a descending pair, so that the
    next synchronisation raises (it never returns other sums)."""
    n = seg_ids.shape[0]
    S = int(num_segments)
    dev = seg_ids.device
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_cuda: tensors on {dev}")
    if values.dtype != torch.float32 or seg_ids.dtype != torch.int32:
        raise TypeError("segment_reduce_cuda: want float32 values and int32 "
                        f"seg_ids; got {values.dtype}, {seg_ids.dtype}")
    if values.dim() != 2 or seg_ids.dim() != 1 or values.shape[0] != n:
        raise ValueError("segment_reduce_cuda: want values (n, d) and "
                         f"seg_ids (n,); got {tuple(values.shape)}, "
                         f"{tuple(seg_ids.shape)}")
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_reduce_cuda: inputs must be contiguous")
    if values.device != dev:
        raise ValueError("segment_reduce_cuda: inputs on different devices")
    if n >= 2 ** 31 or S >= 2 ** 31 or S < 0:
        raise ValueError(f"segment_reduce_cuda: n={n}, S={S} out of the "
                         "int32 index range")
    d = values.shape[1]
    out = torch.empty((S, d), dtype=torch.float32, device=dev)
    if S == 0 or d == 0:
        return out
    fn = _fn()
    # scratch: each tile's lowest and highest in-range id and the sums of
    # those two runs within it (the carries the second pass joins)
    tiles = -(-n // TILE_ROWS)
    ids = torch.empty((2, tiles), dtype=torch.int32, device=dev)
    carry = torch.empty((2, tiles, d), dtype=torch.float32, device=dev)
    build.launch(fn, dev.index,
                 (values.data_ptr(), seg_ids.data_ptr(), n, d, S,
                  out.data_ptr(), tiles, ids[0].data_ptr(),
                  ids[1].data_ptr(), carry[0].data_ptr(),
                  carry[1].data_ptr()),
                 "segment_reduce", globals(), "LAUNCHES")
    return out
