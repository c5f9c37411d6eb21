"""Canonical 64-bit hashing for key packing and hash partitioning.

Bit-equal to ``repro.exec.hashing``. PyTorch has no ``>>`` for uint64
on the CPU, so splitmix64 runs in int64: a logical right shift is the
arithmetic shift with the sign-extended high bits masked off, and
wrapping int64 multiplies give the same bits as uint64 ones.

Float key columns are turned into integers as the reference's XLA casts
do (``astype(int64)`` on the first column, ``astype(uint64)`` on the
later ones), written out with ``where`` and ``clamp`` on float64 so
that the CPU and the card agree whatever their native casts do.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= (1 << 63) else c


GOLDEN = _signed(0x9E3779B97F4A7C15)
_M1 = _signed(0xBF58476D1CE4E5B9)
_M2 = _signed(0x94D049BB133111EB)


_INT64_MAX = (1 << 63) - 1
_TWO63 = 2.0 ** 63
_TWO64 = 2.0 ** 64
_BELOW_TWO63 = _TWO63 - 1024.0       # the largest float64 below 2^63


def _trunc_int64(x: torch.Tensor) -> torch.Tensor:
    """float64 in [-2^63, 2^63) to int64, truncating toward zero."""
    return x.clamp(-_TWO63, _BELOW_TWO63).trunc().to(torch.int64)


def to_int64_like_xla(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int64)`` as XLA does it: NaN to 0, saturating at
    INT64_MIN and INT64_MAX, truncating toward zero. Integer and bool
    tensors are cast as they are."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    x = x.to(torch.float64)
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.where(x >= _TWO63, _INT64_MAX, _trunc_int64(x))


def to_uint64_bits_like_xla(x: torch.Tensor) -> torch.Tensor:
    """The bits of ``x.astype(uint64)`` as XLA does it, as int64: NaN
    and every value <= 0 to 0, values >= 2^64 to all ones, truncating
    toward zero. A value in [2^63, 2^64) is a multiple of 2^11, so
    ``x - 2^64`` is exact in float64 and gives its bits. Integer and
    bool tensors are cast as they are."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    x = x.to(torch.float64)
    x = torch.where(torch.isnan(x) | (x <= 0), 0.0, x)
    bits = _trunc_int64(torch.where(x >= _TWO63, x - _TWO64, x))
    return torch.where(x >= _TWO64, -1, bits)


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
        return to_int64_like_xla(vals[0])
    k = mix64(to_int64_like_xla(vals[0]))
    for v in vals[1:]:
        salted = to_uint64_bits_like_xla(v) + GOLDEN
        k = mix64(k ^ mix64(salted))
    return k
