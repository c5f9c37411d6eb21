"""Compressed-chunk decode on Hopper (``csrc/decode.cu``):

* ``rle_expand_cuda``   — ``out[i] = values[j]`` for the run ``j``
  covering row ``i``;
* ``delta_unpack_cuda`` — zigzag decode, then the inclusive prefix sum
  from ``first`` modulo 2**64;
* ``bitunpack_cuda``    — ``k``-bit frame-of-reference unpack;
* ``dict_gather_cuda``  — ``out[i] = values[codes[i]]``, 0 out of range.

Each reads its members at their stored widths and writes int64 rows,
into ``out`` when the caller passes one (the storage reader passes its
column slice). The design note is in the CUDA source. ``*_LAUNCHES``
count the calls that launched each kernel (and nothing else): a call
with no rows to write returns its empty output without a launch and
is not counted.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

RLE_LAUNCHES = 0
DELTA_LAUNCHES = 0
BITUNPACK_LAUNCHES = 0
DICT_LAUNCHES = 0
_FNS = {}

U64_MASK = (1 << 64) - 1

# stored member dtypes -> the width code each C entry point takes
_DELTA_WIDTH = {torch.uint8: 1, torch.uint16: 2, torch.uint32: 4,
                torch.uint64: 8}
_CODE_KIND = {torch.uint8: 1, torch.uint16: 2, torch.uint32: 4,
              torch.int32: -4}

_P, _I64, _U64, _I = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                      ctypes.c_int)


def _fn(name: str, argtypes, restype=ctypes.c_int):
    f = _FNS.get(name)
    if f is None:
        f = getattr(build.load("decode"), name)
        f.argtypes = argtypes
        f.restype = restype
        _FNS[name] = f
    return f


def _check(what: str, dtypes, *ts: torch.Tensor) -> torch.device:
    """1-d contiguous tensors on one CUDA device, each of a dtype in the
    matching entry of ``dtypes``."""
    dev = ts[0].device
    for t, ok in zip(ts, dtypes):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: tensors must share one CUDA device; "
                             f"got {[str(x.device) for x in ts]}")
        if t.dtype not in ok or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{what}: want contiguous 1-d tensors of "
                            f"{[str(d) for d in ok]}; got {t.dtype} "
                            f"{tuple(t.shape)}")
    return dev


def _out(what: str, out: Optional[torch.Tensor], n: int,
         dev: torch.device) -> torch.Tensor:
    if out is None:
        return torch.empty((n,), dtype=torch.int64, device=dev)
    if out.device != dev or out.dtype != torch.int64 \
            or tuple(out.shape) != (n,) or not out.is_contiguous():
        raise TypeError(f"{what}: out must be a contiguous ({n},) int64 "
                        f"tensor on {dev}; got {out.dtype} "
                        f"{tuple(out.shape)} on {out.device}")
    return out


def _u64(v: int) -> int:
    return int(v) & U64_MASK


def rle_expand_cuda(values: torch.Tensor, lengths: torch.Tensor, n: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64: each row takes the value of the run covering it. Run
    ``j`` is ``lengths[j]`` rows long (at least one), the runs tile
    ``[0, n)`` in order; ``lengths`` int32, as the codec stores them.
    The run starts are scanned on the card (the C entry point refuses
    2**30 runs or more)."""
    dev = _check("rle_expand_cuda", ((torch.int64,), (torch.int32,)),
                 values, lengths)
    r, n = values.shape[0], int(n)
    if lengths.shape[0] != r:
        raise ValueError(f"rle_expand_cuda: {r} values but "
                         f"{lengths.shape[0]} run lengths")
    if n < 0 or (n > 0 and r == 0):
        raise ValueError(f"rle_expand_cuda: n={n} rows from {r} runs")
    out = _out("rle_expand_cuda", out, n, dev)
    if n == 0:
        return out
    # the scratch's layout is the C library's
    n_scratch = _fn("rle_scratch_len", [_I64, _I64], _I64)(r, n)
    scratch = torch.empty((n_scratch,), dtype=torch.int64, device=dev)
    fn = _fn("rle_expand_launch", [_P, _P, _I64, _I64, _P, _I64, _P, _P])
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), lengths.data_ptr(), r, n,
                 scratch.data_ptr(), scratch.shape[0], out.data_ptr(),
                 build.stream_handle(dev))
    build.check(err, "rle_expand")
    build.bump(globals(), "RLE_LAUNCHES")
    return out


def delta_unpack_cuda(z: torch.Tensor, first: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64 bits of ``first + cumsum(unzigzag(z))`` modulo 2**64.
    ``z`` unsigned at its stored width (uint8/16/32/64); ``first`` a
    Python int (its low 64 bits)."""
    dev = _check("delta_unpack_cuda", (tuple(_DELTA_WIDTH),), z)
    n = z.shape[0]
    out = _out("delta_unpack_cuda", out, n, dev)
    if n == 0:
        return out
    # the scratch's layout is the C library's
    n_scratch = _fn("delta_scratch_len", [_I64], _I64)(n)
    scratch = torch.empty((n_scratch,), dtype=torch.int64, device=dev)
    fn = _fn("delta_unpack_launch", [_P, _I, _I64, _U64, _P, _I64, _P, _P])
    with torch.cuda.device(dev):
        err = fn(z.data_ptr(), _DELTA_WIDTH[z.dtype], n, _u64(first),
                 scratch.data_ptr(), scratch.shape[0], out.data_ptr(),
                 build.stream_handle(dev))
    build.check(err, "delta_unpack")
    build.bump(globals(), "DELTA_LAUNCHES")
    return out


def bitunpack_cuda(words: torch.Tensor, k: int, vpw: int, n: int, lo: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64: ``k``-bit values, ``vpw`` per uint32 word, plus
    ``lo`` (wrapping as int64 addition does)."""
    dev = _check("bitunpack_cuda", ((torch.uint32,),), words)
    k, vpw, n = int(k), int(vpw), int(n)
    if not (1 <= k <= 32 and vpw >= 1 and vpw * k <= 32):
        raise ValueError(f"bitunpack_cuda: k={k}, vpw={vpw} do not fit a "
                         "32-bit word")
    if n < 0 or words.shape[0] * vpw < n:
        raise ValueError(f"bitunpack_cuda: {words.shape[0]} words of {vpw} "
                         f"values cannot hold n={n}")
    out = _out("bitunpack_cuda", out, n, dev)
    if n == 0:
        return out
    fn = _fn("bitunpack_launch", [_P, _I, _I, _I64, _U64, _P, _P])
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), k, vpw, n, _u64(lo), out.data_ptr(),
                 build.stream_handle(dev))
    build.check(err, "bitunpack")
    build.bump(globals(), "BITUNPACK_LAUNCHES")
    return out


def dict_gather_cuda(values: torch.Tensor, codes: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64 = ``values[codes]``, 0 for a code outside ``[0, r)``.
    ``codes`` at their stored width (uint8/16/32), or int32."""
    dev = _check("dict_gather_cuda", ((torch.int64,), tuple(_CODE_KIND)),
                 values, codes)
    r, n = values.shape[0], codes.shape[0]
    out = _out("dict_gather_cuda", out, n, dev)
    if n == 0:
        return out
    fn = _fn("dict_gather_launch", [_P, _I64, _P, _I, _I64, _P, _P])
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), r, codes.data_ptr(),
                 _CODE_KIND[codes.dtype], n, out.data_ptr(),
                 build.stream_handle(dev))
    build.check(err, "dict_gather")
    build.bump(globals(), "DICT_LAUNCHES")
    return out
