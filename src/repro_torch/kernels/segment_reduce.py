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
_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = build.load("segment_reduce").segment_reduce_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_int64] \
            + [ctypes.c_void_p] * 4 + [ctypes.c_int64] \
            + [ctypes.c_void_p] * 2
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def segment_reduce_cuda(values: torch.Tensor, seg_ids: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """(S, d) float32 sums of ``values`` (n, d) float32 by ``seg_ids``
    (n,) int32, both contiguous on one CUDA device. Rows with ids outside
    [0, num_segments) are dropped. The in-range ids should be
    non-decreasing: the result does not depend on it, the cost does
    (each segment sums the rows between its first and last row)."""
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
    if S == 0:
        return out
    fn = _fn()
    # scratch: each segment's first row and range end, the list of the
    # ranges longer than one thread sums (at most one per non-empty
    # segment) and its two counts
    first = torch.empty((S,), dtype=torch.int32, device=dev)
    end = torch.empty((S,), dtype=torch.int32, device=dev)
    list_len = max(min(S, n), 1)
    lst = torch.empty((list_len,), dtype=torch.int32, device=dev)
    counts = torch.empty((2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), seg_ids.data_ptr(), n, d, S,
                 out.data_ptr(), first.data_ptr(), end.data_ptr(),
                 lst.data_ptr(), list_len, counts.data_ptr(),
                 build.stream_handle(dev))
    build.check(err, "segment_reduce")
    build.bump(globals(), "LAUNCHES")
    return out
