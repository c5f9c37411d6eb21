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
# the most dictionary entries dict_gather stages in shared memory
# (csrc/decode.cu's DICT_STAGE_MAX; a CPU test holds the two equal)
DICT_STAGE_MAX = 28032

# stored member dtypes -> the width code each C entry point takes
_DELTA_WIDTH = {torch.uint8: 1, torch.uint16: 2, torch.uint32: 4,
                torch.uint64: 8}
_CODE_KIND = {torch.uint8: 1, torch.uint16: 2, torch.uint32: 4,
              torch.int32: -4}
# each wrapper's tensors and the dtypes each may have
_RLE_KINDS = ((torch.int64,), (torch.int32,))
_DELTA_KINDS = (tuple(_DELTA_WIDTH),)
_BITUNPACK_KINDS = ((torch.uint32,),)
_DICT_KINDS = ((torch.int64,), tuple(_CODE_KIND))

_P, _I64, _U64, _I = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64,
                      ctypes.c_int)
# each C entry point's arguments, the stream last
_RLE_ARGS = (_P, _P, _I64, _I64, _P, _I64, _P, _P)
_DELTA_ARGS = (_P, _I, _I64, _U64, _P, _I64, _P, _P)
_BITUNPACK_ARGS = (_P, _I, _I, _I64, _U64, _P, _P)
_DICT_ARGS = (_P, _I64, _P, _I, _I64, _P, _P)


def _fn(name: str, argtypes, restype=ctypes.c_int):
    f = _FNS.get(name)
    if f is None:
        f = getattr(build.load("decode"), name)
        f.argtypes = list(argtypes)
        f.restype = restype
        _FNS[name] = f
    return f


def _args(what: str, dtypes, ts: tuple, out: Optional[torch.Tensor],
          n: int) -> tuple:
    """(the CUDA device index of ``ts``, the output): ``ts`` are 1-d
    contiguous tensors on one CUDA device, each of a dtype in the
    matching entry of ``dtypes``; the output is ``out``, a contiguous
    ``(n,)`` int64 tensor there, or a new one when ``out`` is None."""
    t0 = ts[0]
    index = t0.get_device()
    for t, ok in zip(ts, dtypes):
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{what}: tensors must share one CUDA device; "
                             f"got {[str(x.device) for x in ts]}")
        if t.dtype not in ok or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{what}: want contiguous 1-d tensors of "
                            f"{[str(d) for d in ok]}; got {t.dtype} "
                            f"{tuple(t.shape)}")
    if out is None:
        return index, t0.new_empty(n, dtype=torch.int64)
    if not out.is_cuda or out.get_device() != index \
            or out.dtype != torch.int64 or tuple(out.shape) != (n,) \
            or not out.is_contiguous():
        raise TypeError(f"{what}: out must be a contiguous ({n},) int64 "
                        f"tensor on {t0.device}; got {out.dtype} "
                        f"{tuple(out.shape)} on {out.device}")
    return index, out


def _u64(v: int) -> int:
    return int(v) & U64_MASK


def rle_expand_cuda(values: torch.Tensor, lengths: torch.Tensor, n: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64: each row takes the value of the run covering it. Run
    ``j`` is ``lengths[j]`` rows long (at least one), the runs tile
    ``[0, n)`` in order; ``lengths`` int32, as the codec stores them.
    The run starts are scanned on the card (the C entry point refuses
    2**30 runs or more)."""
    r, n = len(values), int(n)
    if len(lengths) != r:
        raise ValueError(f"rle_expand_cuda: {r} values but "
                         f"{len(lengths)} run lengths")
    if n < 0 or (n > 0 and r == 0):
        raise ValueError(f"rle_expand_cuda: n={n} rows from {r} runs")
    index, out = _args("rle_expand_cuda", _RLE_KINDS, (values, lengths), out,
                       n)
    if n == 0:
        return out
    # the scratch's layout is the C library's
    n_scratch = _fn("rle_scratch_len", (_I64, _I64), _I64)(r, n)
    scratch = values.new_empty((n_scratch,))
    build.launch(_fn("rle_expand_launch", _RLE_ARGS), index,
                 (values.data_ptr(), lengths.data_ptr(), r, n,
                  scratch.data_ptr(), n_scratch, out.data_ptr()),
                 "rle_expand", globals(), "RLE_LAUNCHES")
    return out


def delta_unpack_cuda(z: torch.Tensor, first: int,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64 bits of ``first + cumsum(unzigzag(z))`` modulo 2**64.
    ``z`` unsigned at its stored width (uint8/16/32/64); ``first`` a
    Python int (its low 64 bits)."""
    n = z.shape[0]
    index, out = _args("delta_unpack_cuda", _DELTA_KINDS, (z,), out, n)
    if n == 0:
        return out
    # the scratch's layout is the C library's
    n_scratch = _fn("delta_scratch_len", (_I64,), _I64)(n)
    scratch = out.new_empty((n_scratch,))
    build.launch(_fn("delta_unpack_launch", _DELTA_ARGS), index,
                 (z.data_ptr(), _DELTA_WIDTH[z.dtype], n, _u64(first),
                  scratch.data_ptr(), n_scratch, out.data_ptr()),
                 "delta_unpack", globals(), "DELTA_LAUNCHES")
    return out


def bitunpack_cuda(words: torch.Tensor, k: int, vpw: int, n: int, lo: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64: ``k``-bit values, ``vpw`` per uint32 word, plus
    ``lo`` (wrapping as int64 addition does)."""
    k, vpw, n = int(k), int(vpw), int(n)
    if not (1 <= k <= 32 and vpw >= 1 and vpw * k <= 32):
        raise ValueError(f"bitunpack_cuda: k={k}, vpw={vpw} do not fit a "
                         "32-bit word")
    if n < 0 or len(words) * vpw < n:
        raise ValueError(f"bitunpack_cuda: {len(words)} words of {vpw} "
                         f"values cannot hold n={n}")
    index, out = _args("bitunpack_cuda", _BITUNPACK_KINDS, (words,), out, n)
    if n == 0:
        return out
    build.launch(_fn("bitunpack_launch", _BITUNPACK_ARGS), index,
                 (words.data_ptr(), k, vpw, n, _u64(lo), out.data_ptr()),
                 "bitunpack", globals(), "BITUNPACK_LAUNCHES")
    return out


def dict_gather_cuda(values: torch.Tensor, codes: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n,) int64 = ``values[codes]``, 0 for a code outside ``[0, r)``.
    ``codes`` at their stored width (uint8/16/32), or int32."""
    n = codes.shape[0]
    index, out = _args("dict_gather_cuda", _DICT_KINDS, (values, codes), out,
                       n)
    if n == 0:
        return out
    build.launch(_fn("dict_gather_launch", _DICT_ARGS), index,
                 (values.data_ptr(), values.shape[0], codes.data_ptr(),
                  _CODE_KIND[codes.dtype], n, out.data_ptr()),
                 "dict_gather", globals(), "DICT_LAUNCHES")
    return out
