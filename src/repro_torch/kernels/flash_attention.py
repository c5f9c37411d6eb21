"""Tiled online-softmax attention on Hopper (``csrc/flash_attention.cu``;
the backward in ``csrc/flash_attention_bwd.cu`` and
``csrc/flash_attention_bwd_tc.cu``).

The Pallas kernel's function: GQA, causal and sliding-window masks and
logit soft-capping, f32 arithmetic, the output in q's dtype. The design
note is in the CUDA source.

Two hand-written kernels, chosen by a rule in the C entry point: bf16
with D a multiple of 16 runs on the tensor cores (P split into two bf16
terms for the P.V products), everything else on the CUDA cores in f32.
``kernel_path`` states the same rule, for counting.

The backward (``flash_attention_bwd_cuda``) is two more kernels a call:
dq per query tile, then dk and dv per key tile with the GQA sum in
registers. bf16 with D a multiple of 16 up to 128 runs them on the
tensor cores (wgmma; P and dS split into two bf16 terms for the
products they enter), the rest on the CUDA cores in f32: a library
each, picked by ``bwd_kernel_path``. The forward writes the row
log-sum-exp the backward needs where asked (``with_lse``).

``PATH_LAUNCHES`` counts, per path, the forward calls that launched a
kernel, and ``BWD_PATH_LAUNCHES`` the backward calls (each launches its
two kernels), and nothing else, so a run can show that its path went
through them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

PATH_LAUNCHES = {"tensor_cores": 0, "cuda_cores": 0}
BWD_PATH_LAUNCHES = {"tensor_cores": 0, "cuda_cores": 0}
_FN = None
_BWD_FNS = {}
_DTYPES = (torch.float32, torch.bfloat16)


def kernel_path(dtype: torch.dtype, D: int) -> str:
    """The kernel a call runs, as ``flash_attention_launch`` picks it:
    ``"tensor_cores"`` for bfloat16 with D a multiple of 16 (the mma
    tile's depth), ``"cuda_cores"`` otherwise. float32 stays on the CUDA
    cores: a bf16 split of f32 q and k would break the score term of the
    rounding bound."""
    if dtype == torch.bfloat16 and D % 16 == 0:
        return "tensor_cores"
    return "cuda_cores"


def bwd_kernel_path(dtype: torch.dtype, D: int) -> str:
    """The backward kernels a call runs: ``"tensor_cores"``
    (``csrc/flash_attention_bwd_tc.cu``) for bfloat16 with D a multiple
    of 16 and at most 128, ``"cuda_cores"``
    (``csrc/flash_attention_bwd.cu``) otherwise: float32 (as in the
    forward), and D = 256, whose dk and dv of a 64-key tile would not fit
    in the registers of a warpgroup."""
    if dtype == torch.bfloat16 and D % 16 == 0 and D <= 128:
        return "tensor_cores"
    return "cuda_cores"


def reset_path_launches() -> None:
    for counts in (PATH_LAUNCHES, BWD_PATH_LAUNCHES):
        for path in counts:
            counts[path] = 0


def _fn():
    global _FN
    if _FN is None:
        f = build.load("flash_attention").flash_attention_launch
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _bwd_fn(path: str):
    f = _BWD_FNS.get(path)
    if f is None:
        name = "flash_attention_bwd" + ("_tc" if path == "tensor_cores"
                                        else "")
        f = getattr(build.load(name), name + "_launch")
        f.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _BWD_FNS[path] = f
    return f


def check_masks(Sq: int, Sk: int, causal: bool,
                window: Optional[int]) -> None:
    """Refuse calls where some query row has no unmasked key: the kernel
    skips the key tiles the masks hide, which is exact only where every
    row keeps one (the lowest row's first key lies at r - window + 1)."""
    if window is not None:
        if window < 1:
            raise ValueError(f"flash_attention: window {window} masks every "
                             "key")
        if Sq - window > Sk - 1:
            raise ValueError(
                f"flash_attention: with Sq={Sq}, Sk={Sk} and window={window} "
                "the last query rows have no key in their window")


def _check(what: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int],
           softcap: Optional[float]) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: want q, k, v all float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: want q (B, H, Sq, D) and k, v (B, Hkv, "
                         f"Sk, D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{what}: q and k differ in batch or head size: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{what}: {H} query heads over {Hkv} KV heads")
    if not 1 <= D <= 256:
        raise ValueError(f"{what}: head size {D} outside [1, 256]")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"{what}: Sq={Sq}, Sk={Sk}")
    if max(B, H) > 65535:
        raise ValueError(f"{what}: B={B}, H={H} exceed the grid")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: inputs must be contiguous")
    if k.device != dev or v.device != dev:
        raise ValueError(f"{what}: inputs on different devices")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{what}: softcap {softcap}")
    check_masks(Sq, Sk, causal, window)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         with_lse: bool = False):
    """(B, H, Sq, D) attention of q (B, H, Sq, D) over k, v (B, Hkv, Sk,
    D), all contiguous on one CUDA device, of one dtype (float32 or
    bfloat16), D <= 256, H a multiple of Hkv. ``scale`` defaults to
    D ** -0.5. ``with_lse``: returns (out, lse), lse (B, H, Sq) f32 the
    rows' log-sum-exp of their masked scores."""
    _check("flash_attention_cuda", q, k, v, causal, window, softcap)
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    dev = q.device
    scale = scale if scale is not None else D ** -0.5
    path = kernel_path(q.dtype, D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev) \
        if with_lse else None
    fn = _fn()
    build.launch(fn, dev.index,
                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr() if with_lse else None,
                  B, H, Hkv, Sq, Sk, D, int(q.dtype == torch.bfloat16),
                  int(bool(causal)),
                  int(window or 0), float(scale), float(softcap or 0.0)),
                 "flash_attention", PATH_LAUNCHES, path)
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor,
                             causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None) -> tuple:
    """(dq, dk, dv) of ``flash_attention_cuda`` for the output's
    cotangent ``do``, given its output ``o`` and the ``lse`` of the same
    call (``with_lse``); all contiguous on one CUDA device, q, k, v, o
    and do of one dtype, lse f32. Each gradient in its input's dtype."""
    _check("flash_attention_bwd_cuda", q, k, v, causal, window, softcap)
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    dev = q.device
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError("flash_attention_bwd_cuda: want o and do of q's "
                         f"shape and dtype; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("flash_attention_bwd_cuda: want lse (B, H, Sq) "
                         f"float32; got {tuple(lse.shape)} {lse.dtype}")
    if not (o.is_contiguous() and do.is_contiguous()
            and lse.is_contiguous()):
        raise ValueError("flash_attention_bwd_cuda: inputs must be "
                         "contiguous")
    if any(x.device != dev for x in (o, lse, do)):
        raise ValueError("flash_attention_bwd_cuda: inputs on different "
                         "devices")
    scale = scale if scale is not None else D ** -0.5
    path = bwd_kernel_path(q.dtype, D)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    fn = _bwd_fn(path)
    build.launch(fn, dev.index,
                 (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), do.data_ptr(), dq.data_ptr(),
                  dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                  B, H, Hkv, Sq, Sk, D, int(q.dtype == torch.bfloat16),
                  int(bool(causal)), int(window or 0), float(scale),
                  float(softcap or 0.0)),
                 "flash_attention backward", BWD_PATH_LAUNCHES, path)
    return dq, dk, dv
