"""Public wrappers for the ported kernels, dispatched by device.

A CUDA tensor launches the hand-written Hopper kernel; a CPU tensor
runs the plain PyTorch version in ``ref.py``; any other device raises.
There is no fallback from a failed launch and no switch to the plain
version on the GPU: ``chip_smoke.py`` calls the ``ref`` functions
directly when it compares.

Launch counts: ``launch_counts()`` reads the plain-integer counter each
kernel wrapper keeps, ``reset_launch_counts()`` zeroes them.
"""

from __future__ import annotations

import torch

from . import gather_join, ref, segment_fused


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


def segment_sum_first(values: torch.Tensor, keys: torch.Tensor,
                      seg_ids: torch.Tensor, num_segments: int) -> tuple:
    """Fused Gamma tail: (segment sums f32, first-row index i32,
    first-row key values i64). values (n, d); keys (n, k) int64
    bit-views; seg_ids (n,) non-decreasing."""
    if not _route(seg_ids, "segment_sum_first"):
        return ref.segment_sum_first_ref(values, keys, seg_ids,
                                         num_segments)
    return segment_fused.segment_sum_first_cuda(
        values.to(torch.float32).contiguous(), keys.contiguous(),
        seg_ids.to(torch.int32).contiguous(), num_segments)


def merge_positions(sorted_keys: torch.Tensor, queries: torch.Tensor
                    ) -> tuple:
    """(lo, hi) = searchsorted(sorted_keys, queries, left/right) as
    int32 — the join inner loop's position step."""
    if not _route(queries, "merge_positions"):
        return ref.merge_positions_ref(sorted_keys, queries)
    return gather_join.merge_positions_cuda(
        sorted_keys.to(torch.int64).contiguous(),
        queries.to(torch.int64).contiguous())


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather over int64 bit-views; out-of-range indices gather 0."""
    if not _route(values, "gather_rows"):
        return ref.gather_rows_ref(values, idx)
    return gather_join.gather_rows_cuda(values.contiguous(),
                                        idx.to(torch.int64).contiguous())


def launch_counts() -> dict:
    return {"segment_sum_first": segment_fused.LAUNCHES,
            "merge_positions": gather_join.MERGE_LAUNCHES,
            "gather_rows": gather_join.GATHER_LAUNCHES}


def reset_launch_counts() -> None:
    segment_fused.LAUNCHES = 0
    gather_join.MERGE_LAUNCHES = 0
    gather_join.GATHER_LAUNCHES = 0
