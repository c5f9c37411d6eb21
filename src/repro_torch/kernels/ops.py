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

from . import (decode, flash_attention as flash_attention_kernel,
               gather_join, ref, rwkv6_scan as rwkv6_kernel, segment_fused,
               segment_reduce as segment_reduce_kernel, shuffle_pack)


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain version for {t.device}")


def segment_reduce(values: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Sorted-segment sum. values (n,) or (n, d), summed in f32 and cast
    back to their dtype; rows with ids outside [0, num_segments) are
    dropped."""
    squeeze = values.dim() == 1
    if squeeze:
        values = values[:, None]
    dtype = values.dtype
    if not _route(seg_ids, "segment_reduce"):
        out = ref.segment_reduce_ref(values.to(torch.float32), seg_ids,
                                     num_segments)
    else:
        out = segment_reduce_kernel.segment_reduce_cuda(
            values.to(torch.float32).contiguous(),
            seg_ids.to(torch.int32).contiguous(), num_segments)
    out = out.to(dtype)
    return out[:, 0] if squeeze else out


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


def pack_rows(values: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor
              ) -> torch.Tensor:
    """The packed exchange's send buffer: out[j] = values[idx[j]] where
    ``ok[j]`` and idx in range, else 0. values (r, d) int64 bit-view
    lanes; idx int32/int64; ok bool/int32."""
    if not _route(values, "pack_rows"):
        return ref.pack_rows_ref(values, idx, ok)
    return shuffle_pack.pack_rows_cuda(values.contiguous(), idx.contiguous(),
                                       ok.contiguous())


def replicate_scatter(values: torch.Tensor, vidx: torch.Tensor,
                      ok: torch.Tensor, repl: int) -> torch.Tensor:
    """The HyperCube replicating scatter: pack_rows from source row
    ``vidx[j] // repl``; negative ids give 0."""
    if not _route(values, "replicate_scatter"):
        return ref.replicate_scatter_ref(values, vidx, ok, repl)
    return shuffle_pack.replicate_scatter_cuda(
        values.contiguous(), vidx.contiguous(), ok.contiguous(), repl)


def unpack_cols(buf: torch.Tensor) -> torch.Tensor:
    """(rows, lanes) wire buffer -> contiguous (lanes, rows)."""
    if not _route(buf, "unpack_cols"):
        return ref.unpack_cols_ref(buf)
    return shuffle_pack.unpack_cols_cuda(buf.contiguous())


def member_mask(keys: torch.Tensor, heavy: torch.Tensor) -> torch.Tensor:
    """keys[i] in the padded heavy-key set (INT64_MAX never matches)."""
    if not _route(keys, "member_mask"):
        return ref.member_mask_ref(keys, heavy)
    return shuffle_pack.member_mask_cuda(keys.to(torch.int64).contiguous(),
                                         heavy.to(torch.int64).contiguous())


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of q (B, H, Sq, D) over k, v (B, Hkv, Sk, D)
    with GQA, causal and sliding-window masks (rows and keys counted
    from 0) and logit soft-capping; f32 arithmetic, out in q's dtype.
    Refuses calls where a query row has no unmasked key."""
    if not _route(q, "flash_attention"):
        flash_attention_kernel.check_masks(q.shape[2], k.shape[2], causal,
                                           window)
        return ref.attention_ref(q, k, v, causal, window, softcap, scale)
    return flash_attention_kernel.flash_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(), causal, window,
        softcap, scale)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, chunk: int = 64
               ) -> torch.Tensor:
    """The RWKV-6 recurrence: r, k, w (B, H, T, K), v (B, H, T, V), u
    (H, K) -> (B, H, T, V) in r's dtype, f32 inside. The kernel runs the
    chunked form with chunks of ``chunk`` steps; the plain version the
    sequential recurrence (the chunk changes only the rounding)."""
    if not _route(r, "rwkv6_scan"):
        return ref.rwkv6_ref(r, k, v, w, u)
    return rwkv6_kernel.rwkv6_cuda(
        r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(),
        u.to(torch.float32).contiguous(), chunk)


def launch_counts() -> dict:
    return {"segment_reduce": segment_reduce_kernel.LAUNCHES,
            "segment_sum_first": segment_fused.LAUNCHES,
            "merge_positions": gather_join.MERGE_LAUNCHES,
            "gather_rows": gather_join.GATHER_LAUNCHES,
            "rle_expand": decode.RLE_LAUNCHES,
            "delta_unpack": decode.DELTA_LAUNCHES,
            "bitunpack": decode.BITUNPACK_LAUNCHES,
            "dict_gather": decode.DICT_LAUNCHES,
            "member_mask": shuffle_pack.MEMBER_LAUNCHES,
            "pack_rows": shuffle_pack.PACK_LAUNCHES,
            "unpack_cols": shuffle_pack.UNPACK_LAUNCHES,
            "replicate_scatter": shuffle_pack.REPL_LAUNCHES,
            "flash_attention": sum(
                flash_attention_kernel.PATH_LAUNCHES.values()),
            "rwkv6": rwkv6_kernel.LAUNCHES}


def reset_launch_counts() -> None:
    segment_reduce_kernel.LAUNCHES = 0
    segment_fused.LAUNCHES = 0
    gather_join.MERGE_LAUNCHES = 0
    gather_join.GATHER_LAUNCHES = 0
    decode.RLE_LAUNCHES = 0
    decode.DELTA_LAUNCHES = 0
    decode.BITUNPACK_LAUNCHES = 0
    decode.DICT_LAUNCHES = 0
    shuffle_pack.MEMBER_LAUNCHES = 0
    shuffle_pack.PACK_LAUNCHES = 0
    shuffle_pack.UNPACK_LAUNCHES = 0
    shuffle_pack.REPL_LAUNCHES = 0
    flash_attention_kernel.reset_path_launches()
    rwkv6_kernel.LAUNCHES = 0
