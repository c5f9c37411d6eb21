"""The packed shuffle on Hopper (``csrc/shuffle_pack.cu``):

* ``pack_rows_cuda``         — ``out[j] = values[idx[j]]`` where
  ``ok[j]`` and the index is in range, else 0: the send buffer of the
  packed exchange;
* ``replicate_scatter_cuda`` — the same from source row
  ``vidx[j] // repl``: the HyperCube replicating exchange;
* ``unpack_cols_cuda``       — the ``(rows, lanes)`` wire buffer
  transposed to ``(lanes, rows)``;
* ``member_mask_cuda``       — ``keys[i]`` in the heavy-key set
  (INT64_MAX never matches, on either side).

All are exact integer work; the design note is in the CUDA source.
``*_LAUNCHES`` count the calls that launched each kernel (and nothing
else): a call with no rows returns its empty output without a launch
and is not counted.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

PACK_LAUNCHES = 0
REPL_LAUNCHES = 0
UNPACK_LAUNCHES = 0
MEMBER_LAUNCHES = 0
_FNS = {}

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_IDX_BYTES = {torch.int32: 4, torch.int64: 8}
_OK_BYTES = {torch.bool: 1, torch.uint8: 1, torch.int32: 4}


def _fn(name: str, argtypes):
    f = _FNS.get(name)
    if f is None:
        f = getattr(build.load("shuffle_pack"), name)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _FNS[name] = f
    return f


def _check(what: str, t: torch.Tensor, dtypes, dim: int,
           dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{what}: tensors must share one CUDA device; "
                         f"got {t.device} and {dev}")
    if t.dtype not in dtypes or t.dim() != dim or not t.is_contiguous():
        raise TypeError(f"{what}: want a contiguous {dim}-d tensor of "
                        f"{[str(d) for d in dtypes]}; got {t.dtype} "
                        f"{tuple(t.shape)}")


def _values_dev(what: str, values: torch.Tensor) -> torch.device:
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: want CUDA tensors; got {dev}")
    _check(what, values, (torch.int64,), 2, dev)
    return dev


def _pack(what: str, counter: str, values: torch.Tensor, idx: torch.Tensor,
          ok: torch.Tensor, repl: int) -> torch.Tensor:
    dev = _values_dev(what, values)
    _check(what, idx, tuple(_IDX_BYTES), 1, dev)
    _check(what, ok, tuple(_OK_BYTES), 1, dev)
    if ok.shape != idx.shape:
        raise ValueError(f"{what}: ok {tuple(ok.shape)} and idx "
                         f"{tuple(idx.shape)} differ")
    r, d = values.shape
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=torch.int64, device=dev)
    if m == 0 or d == 0:
        return out
    fn = _fn("pack_rows_launch",
             [_P, _I64, _I, _P, _I, _P, _I, _I64, _I64, _P, _P])
    with torch.cuda.device(dev):
        err = fn(values.data_ptr(), r, d, idx.data_ptr(),
                 _IDX_BYTES[idx.dtype], ok.data_ptr(), _OK_BYTES[ok.dtype],
                 m, repl, out.data_ptr(), build.stream_handle(dev))
    build.check(err, what)
    build.bump(globals(), counter)
    return out


def pack_rows_cuda(values: torch.Tensor, idx: torch.Tensor,
                   ok: torch.Tensor) -> torch.Tensor:
    """out (m, d) int64 = values[idx] where ``ok`` and idx in [0, r),
    else 0. ``values`` (r, d) int64; ``idx`` (m,) int32 or int64; ``ok``
    (m,) bool or int32; all contiguous on one CUDA device."""
    return _pack("pack_rows", "PACK_LAUNCHES", values, idx, ok, 0)


def replicate_scatter_cuda(values: torch.Tensor, vidx: torch.Tensor,
                           ok: torch.Tensor, repl: int) -> torch.Tensor:
    """out (m, d) int64 = values[vidx // repl] where ``ok``, vidx >= 0 and
    the source row is in range, else 0 (``repl`` >= 1)."""
    if int(repl) < 1:
        raise ValueError(f"replicate_scatter: repl={repl} must be >= 1")
    return _pack("replicate_scatter", "REPL_LAUNCHES", values, vidx, ok,
                 int(repl))


def unpack_cols_cuda(buf: torch.Tensor) -> torch.Tensor:
    """(m, d) int64 wire buffer -> contiguous (d, m)."""
    dev = _values_dev("unpack_cols", buf)
    m, d = buf.shape
    out = torch.empty((d, m), dtype=torch.int64, device=dev)
    if m == 0 or d == 0:
        return out
    if d > 65535 * 8:
        raise ValueError(f"unpack_cols: {d} lanes exceed the grid")
    fn = _fn("unpack_cols_launch", [_P, _I64, _I, _P, _P])
    with torch.cuda.device(dev):
        err = fn(buf.data_ptr(), m, d, out.data_ptr(),
                 build.stream_handle(dev))
    build.check(err, "unpack_cols")
    build.bump(globals(), "UNPACK_LAUNCHES")
    return out


def member_mask_cuda(keys: torch.Tensor, heavy: torch.Tensor
                     ) -> torch.Tensor:
    """(n,) bool: keys[i] in heavy; INT64_MAX never matches on either
    side. ``keys`` (n,) and ``heavy`` (m,) int64, contiguous; ``heavy``
    need not be sorted."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"member_mask: want CUDA tensors; got {dev}")
    _check("member_mask", keys, (torch.int64,), 1, dev)
    _check("member_mask", heavy, (torch.int64,), 1, dev)
    n, m = keys.shape[0], heavy.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = _fn("member_mask_launch", [_P, _I64, _P, _I64, _P, _P])
    with torch.cuda.device(dev):
        err = fn(keys.data_ptr(), n, heavy.data_ptr(), m, out.data_ptr(),
                 build.stream_handle(dev))
    build.check(err, "member_mask")
    build.bump(globals(), "MEMBER_LAUNCHES")
    return out
