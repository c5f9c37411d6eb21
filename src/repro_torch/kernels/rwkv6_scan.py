"""Chunked RWKV-6 recurrence on Hopper (``csrc/rwkv6_scan.cu``).

The Pallas kernel's function: the chunked form of the data-dependent
decay recurrence, f32 arithmetic and state, the output in r's dtype.
The design note is in the CUDA source: one kernel for f32 and bf16,
its products on the tensor cores (``PATH``) in TF32 with every f32
operand split into two terms, the decays factored at 16-step sub-chunks.

``LAUNCHES`` counts the calls that launched the kernel (and nothing
else), so a run can show that its path went through it.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = 0
PATH = "tensor_cores"  # the one path: every call of every shape takes it
_FN = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_KV = 128          # largest K and V: the chunk, its sums and the K x V
MAX_CHUNK = 64        # state stay within a block's shared memory


def _fn():
    global _FN
    if _FN is None:
        f = build.load("rwkv6_scan").rwkv6_launch
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, chunk: int = 64
               ) -> torch.Tensor:
    """(B, H, T, V) output of the RWKV-6 recurrence. r, k, w (B, H, T, K)
    and v (B, H, T, V), contiguous, of one dtype (float32 or bfloat16);
    u (H, K) float32, contiguous; all on one CUDA device. K, V <= 128;
    the chunk is min(chunk, T), at most 64."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"rwkv6_cuda: tensors on {dev}")
    if r.dtype not in _DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError("rwkv6_cuda: want r, k, v, w all float32 or all "
                        f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"rwkv6_cuda: want u float32; got {u.dtype}")
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError("rwkv6_cuda: want r, k, w (B, H, T, K) and v (B, H, "
                         f"T, V); got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, H, T, K = r.shape
    V = v.shape[3]
    if tuple(u.shape) != (H, K):
        raise ValueError(f"rwkv6_cuda: want u ({H}, {K}); got "
                         f"{tuple(u.shape)}")
    if not (1 <= K <= MAX_KV and 1 <= V <= MAX_KV):
        raise ValueError(f"rwkv6_cuda: K={K}, V={V} outside [1, {MAX_KV}]")
    if B < 1 or H < 1 or T < 1:
        raise ValueError(f"rwkv6_cuda: B={B}, H={H}, T={T}")
    chunk = min(int(chunk), T)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_cuda: chunk {chunk} outside [1, "
                         f"{MAX_CHUNK}]")
    if not all(x.is_contiguous() for x in (r, k, v, w, u)):
        raise ValueError("rwkv6_cuda: inputs must be contiguous")
    if any(x.device != dev for x in (k, v, w, u)):
        raise ValueError("rwkv6_cuda: inputs on different devices")
    out = torch.empty((B, H, T, V), dtype=r.dtype, device=dev)
    fn = _fn()
    with torch.cuda.device(dev):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), out.data_ptr(), B, H, T, K, V, chunk,
                 int(r.dtype == torch.bfloat16), build.stream_handle(dev))
    build.check(err, "rwkv6")
    build.bump(globals(), "LAUNCHES")
    return out
