"""Plain PyTorch versions of the ported kernels (mirrors the matching
functions of ``repro.kernels.ref``). The dispatch in ``ops.py`` runs
them for tensors on the CPU; ``chip_smoke.py`` holds each CUDA kernel
against them on the card."""

from __future__ import annotations

import torch

I32_MAX = torch.iinfo(torch.int32).max
I64_MAX = torch.iinfo(torch.int64).max


def segment_reduce_ref(values: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum with out-of-range ids dropped."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    vals = torch.where(ok[:, None], values, torch.zeros_like(values))
    ids = torch.where(ok, seg_ids, torch.zeros_like(seg_ids)).to(torch.int64)
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, vals)


def segment_sum_first_ref(values: torch.Tensor, keys: torch.Tensor,
                          seg_ids: torch.Tensor, num_segments: int) -> tuple:
    """(segment sums, first-row index per segment, first-row key
    values). Empty segments: firstidx == INT32_MAX, firstvals == 0.
    Out-of-range seg_ids are dropped."""
    n = seg_ids.shape[0]
    dev = seg_ids.device
    sums = segment_reduce_ref(values, seg_ids, num_segments)
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    fidx = torch.full((num_segments,), I32_MAX, dtype=torch.int32,
                      device=dev)
    fidx.scatter_reduce_(0, seg_ids[ok].to(torch.int64), idx[ok], "amin")
    exists = fidx < n
    gathered = keys[fidx.clamp(0, max(n - 1, 0)).to(torch.int64)]
    fvals = torch.where(exists[:, None], gathered, torch.zeros_like(gathered))
    return sums, fidx, fvals


def merge_positions_ref(sorted_keys: torch.Tensor, queries: torch.Tensor
                        ) -> tuple:
    """Left/right insertion points (the double searchsorted of the join
    inner loop), as int32."""
    sorted_keys = sorted_keys.to(torch.int64)
    queries = queries.to(torch.int64)
    lo = torch.searchsorted(sorted_keys, queries, side="left",
                            out_int32=True)
    hi = torch.searchsorted(sorted_keys, queries, side="right",
                            out_int32=True)
    return lo, hi


def gather_rows_ref(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with out-of-range indices mapped to 0."""
    r = values.shape[0]
    ok = (idx >= 0) & (idx < r)
    g = values[idx.clamp(0, r - 1).to(torch.int64)]
    return torch.where(ok[:, None], g, torch.zeros_like(g))
