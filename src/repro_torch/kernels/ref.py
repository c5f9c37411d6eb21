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


# ---------------------------------------------------------------------------
# compressed-chunk decode (repro.kernels.ref rle_expand_ref .. dict_gather_ref)
# ---------------------------------------------------------------------------

def widen_unsigned(z: torch.Tensor) -> torch.Tensor:
    """An unsigned integer member (torch.uint8/16/32/64) as int64 holding
    the same bits: zero-extended below 64 bits, a bit view at 64."""
    if z.dtype == torch.uint64:
        return z.view(torch.int64)
    if z.dtype not in (torch.uint8, torch.uint16, torch.uint32):
        raise TypeError(f"widen_unsigned: want an unsigned integer "
                        f"tensor; got {z.dtype}")
    return z.to(torch.int64)


def rle_expand_ref(values: torch.Tensor, lengths: torch.Tensor,
                   n: int) -> torch.Tensor:
    """out[i] = the value of the run covering row i; run j is
    ``lengths[j]`` rows long and the runs tile [0, n). int64 bit-views.
    The reference's plain version takes the runs as ``[starts[j],
    ends[j])``, which its reader makes from these lengths on the host;
    the port takes the stored lengths."""
    ends = torch.cumsum(lengths.to(torch.int64), 0)
    starts = ends - lengths.to(torch.int64)
    idx = torch.searchsorted(starts,
                             torch.arange(n, dtype=torch.int64,
                                          device=values.device),
                             right=True) - 1
    r = values.shape[0]
    return values[idx.clamp(0, max(r - 1, 0))]


def delta_unpack_ref(z: torch.Tensor, first: int) -> torch.Tensor:
    """Zigzag-decode the deltas and take the inclusive prefix sum from
    ``first`` modulo 2**64, as int64 bits. ``z`` is an unsigned tensor
    at its stored width; ``first`` the uint64 start value (or its int64
    bits) as a Python int. Every step is int64 arithmetic: the logical
    shift is an arithmetic shift with the top bit cleared, and the sum
    wraps as two's complement does (``torch.cumsum`` on int64 wraps;
    ``tests/test_torch_decode.py`` pins that at the extremes)."""
    u = widen_unsigned(z)
    d = ((u >> 1) & I64_MAX) ^ -(u & 1)
    return torch.cumsum(d, 0) + _as_int64_bits(first)


def bitunpack_ref(words: torch.Tensor, k: int, vpw: int, n: int,
                  lo: int) -> torch.Tensor:
    """Frame-of-reference unpack of ``k``-bit values, ``vpw`` per uint32
    word (never straddling), plus ``lo`` (wrapping in int64)."""
    w = widen_unsigned(words)
    rep = torch.repeat_interleave(w, vpw)[:n]
    pos = torch.arange(n, dtype=torch.int64, device=w.device) % vpw
    vals = (rep >> (pos * k)) & ((1 << k) - 1)
    return vals + _as_int64_bits(lo)


def dict_gather_ref(values: torch.Tensor, codes: torch.Tensor
                    ) -> torch.Tensor:
    """out[i] = values[codes[i]]; out-of-range codes (negative, or
    >= r) gather 0, as ``gather_rows_ref`` does."""
    r = values.shape[0]
    c = codes.to(torch.int64)
    ok = (c >= 0) & (c < r)
    if r == 0:
        return torch.zeros(c.shape, dtype=values.dtype, device=values.device)
    g = values[c.clamp(0, r - 1)]
    return torch.where(ok, g, torch.zeros_like(g))


def _as_int64_bits(v: int) -> int:
    """A Python int in [-2**63, 2**64) as the int64 with its low 64
    bits."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v
