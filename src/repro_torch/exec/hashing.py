"""Canonical 64-bit hashing for key packing and hash partitioning.

Bit-equal to ``repro.exec.hashing``. PyTorch has no ``>>`` for uint64
on the CPU, so splitmix64 runs in int64: a logical right shift is the
arithmetic shift with the sign-extended high bits masked off, and
wrapping int64 multiplies give the same bits as uint64 ones.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= (1 << 63) else c


GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


def _lsr(k: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (k >> s) & ((1 << (64 - s)) - 1)


def mix64(k: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer (bijective on 64 bits)."""
    k = k.to(torch.int64)
    k = (k ^ _lsr(k, 30)) * _M1
    k = (k ^ _lsr(k, 27)) * _M2
    return k ^ _lsr(k, 31)


def combine64(vals: Sequence[torch.Tensor]) -> torch.Tensor:
    """Equality-preserving composite key over int64 columns.

    One column: the value itself (exact). Multiple columns: iterated
    splitmix64 combining — columns may themselves be full-width 64-bit
    labels, so shift-packing is not sound; hash-combining preserves
    equality with ~2^-64 pairwise collision odds.
    """
    assert len(vals) >= 1, "empty key"
    if len(vals) == 1:
        return vals[0].to(torch.int64)
    k = mix64(vals[0].to(torch.int64))
    for v in vals[1:]:
        salted = v.to(torch.int64) + GOLDEN
        k = mix64(k ^ mix64(salted))
    return k
