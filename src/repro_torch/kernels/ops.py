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

from typing import Optional

import torch

from . import decode, gather_join, ref, segment_fused


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


def _into(out: Optional[torch.Tensor], res: torch.Tensor) -> torch.Tensor:
    if out is None:
        return res
    return out.copy_(res)


def rle_expand(values: torch.Tensor, lengths: torch.Tensor, n: int,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run-length expand: out[i] = values[j] for the run j covering row
    i; the runs, ``lengths[j]`` rows each, tile [0, n). int64 bit-views;
    ``lengths`` at their stored width. ``out``: an optional (n,) int64
    tensor to decode into."""
    if not _route(values, "rle_expand"):
        return _into(out, ref.rle_expand_ref(values, lengths, n))
    return decode.rle_expand_cuda(values.contiguous(), lengths.contiguous(),
                                  n, out)


def delta_unpack(z: torch.Tensor, first: int,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zigzag-delta decode: first + inclusive modular-uint64 prefix sum
    of the decoded deltas, as int64 bits. ``z`` unsigned at its stored
    width; ``first`` the uint64 start value as a Python int."""
    if not _route(z, "delta_unpack"):
        return _into(out, ref.delta_unpack_ref(z, first))
    return decode.delta_unpack_cuda(z.contiguous(), first, out)


def bitunpack(words: torch.Tensor, k: int, vpw: int, n: int, lo: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Frame-of-reference unpack: k-bit values, vpw per uint32 word,
    + lo -> int64, trimmed to n rows."""
    if not _route(words, "bitunpack"):
        return _into(out, ref.bitunpack_ref(words, k, vpw, n, lo))
    return decode.bitunpack_cuda(words.contiguous(), k, vpw, n, lo, out)


def dict_gather(values: torch.Tensor, codes: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dictionary decode: out[i] = values[codes[i]] (int64 bit-views;
    out-of-range codes gather 0). ``codes`` at their stored width."""
    if not _route(values, "dict_gather"):
        return _into(out, ref.dict_gather_ref(values, codes))
    return decode.dict_gather_cuda(values.contiguous(), codes.contiguous(),
                                   out)


def launch_counts() -> dict:
    return {"segment_sum_first": segment_fused.LAUNCHES,
            "merge_positions": gather_join.MERGE_LAUNCHES,
            "gather_rows": gather_join.GATHER_LAUNCHES,
            "rle_expand": decode.RLE_LAUNCHES,
            "delta_unpack": decode.DELTA_LAUNCHES,
            "bitunpack": decode.BITUNPACK_LAUNCHES,
            "dict_gather": decode.DICT_LAUNCHES}


def reset_launch_counts() -> None:
    segment_fused.LAUNCHES = 0
    gather_join.MERGE_LAUNCHES = 0
    gather_join.GATHER_LAUNCHES = 0
    decode.RLE_LAUNCHES = 0
    decode.DELTA_LAUNCHES = 0
    decode.BITUNPACK_LAUNCHES = 0
    decode.DICT_LAUNCHES = 0
