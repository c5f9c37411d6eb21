"""Tiled online-softmax attention on Hopper (``csrc/flash_attention.cu``).

The Pallas kernel's function: GQA, causal and sliding-window masks and
logit soft-capping, f32 arithmetic, the output in q's dtype. The design
note is in the CUDA source.

Two hand-written kernels, chosen by a rule in the C entry point: bf16
with D a multiple of 16 runs on the tensor cores (P split into two bf16
terms for the P.V products), everything else on the CUDA cores in f32.
``kernel_path`` states the same rule, for counting.

``PATH_LAUNCHES`` counts, per path, the calls that launched a kernel
(and nothing else), so a run can show that its path went through it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

PATH_LAUNCHES = {"tensor_cores": 0, "cuda_cores": 0}
_FN = None
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


def reset_path_launches() -> None:
    for path in PATH_LAUNCHES:
        PATH_LAUNCHES[path] = 0


def _fn():
    global _FN
    if _FN is None:
        f = build.load("flash_attention").flash_attention_launch
        f.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """(B, H, Sq, D) attention of q (B, H, Sq, D) over k, v (B, Hkv, Sk,
    D), all contiguous on one CUDA device, of one dtype (float32 or
    bfloat16), D <= 256, H a multiple of Hkv. ``scale`` defaults to
    D ** -0.5."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda: tensors on {dev}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda: want q, k, v all float32 or "
                        f"all bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention_cuda: want q (B, H, Sq, D) and k, "
                         f"v (B, Hkv, Sk, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash_attention_cuda: q and k differ in batch or "
                         f"head size: {tuple(q.shape)}, {tuple(k.shape)}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"flash_attention_cuda: {H} query heads over {Hkv} "
                         "KV heads")
    if not 1 <= D <= 256:
        raise ValueError(f"flash_attention_cuda: head size {D} outside "
                         "[1, 256]")
    if Sq < 1 or Sk < 1:
        raise ValueError(f"flash_attention_cuda: Sq={Sq}, Sk={Sk}")
    if max(B, H) > 65535:
        raise ValueError(f"flash_attention_cuda: B={B}, H={H} exceed the "
                         "grid")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: inputs must be contiguous")
    if k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda: inputs on different devices")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention_cuda: softcap {softcap}")
    check_masks(Sq, Sk, causal, window)
    scale = scale if scale is not None else D ** -0.5
    path = kernel_path(q.dtype, D)
    out = torch.empty_like(q)
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, H, Hkv, Sq, Sk, D, int(q.dtype == torch.bfloat16),
                 int(bool(causal)),
                 int(window or 0), float(scale), float(softcap or 0.0),
                 build.stream_handle(dev))
    build.check(err, "flash_attention")
    build.bump(PATH_LAUNCHES, path)
    return out
