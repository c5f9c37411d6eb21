"""Chunked RWKV-6 recurrence on Hopper (``csrc/rwkv6_scan.cu``; the
backward in ``csrc/rwkv6_bwd.cu``).

The Pallas kernel's function: the chunked form of the data-dependent
decay recurrence, f32 arithmetic and state, the output in r's dtype.
The design note is in the CUDA source: one kernel for f32 and bf16,
its products on the tensor cores (``PATH``) in TF32 with every f32
operand split into two terms, the decays factored at 16-step sub-chunks.

The backward (``rwkv6_bwd_cuda``) is three more kernels, parallel over
chunks of at most 64 steps: each chunk's own state and gradient
contributions from zero, a carry of the state at every chunk start and
of its gradient at every chunk end, then each chunk's gradients from
the two, the state and its gradient walked elementwise in f32 registers
(dw as rowsum(G_t * S_{t-1}) itself, never divided by w).

``LAUNCHES`` counts the forward calls that launched the kernel and
``BWD_LAUNCHES`` the backward's (and nothing else), so a run can show
that its path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = 0
BWD_LAUNCHES = 0
PATH = "tensor_cores"  # the one path: every call of every shape takes it
BWD_PATH = "cuda_cores"  # the backward's one path: f32 FMAs, chunk-parallel
_FN = None
_BWD_FN = None
_DTYPES = (torch.float32, torch.bfloat16)
MAX_KV = 128          # largest K and V: the chunk, its sums and the K x V
MAX_CHUNK = 64        # state stay within a block's shared memory
MAX_BWD_STATE = 4096  # K V of the backward: two passes of a 64 x 64 tile


def _fn():
    global _FN
    if _FN is None:
        f = build.load("rwkv6_scan").rwkv6_launch
        f.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _bwd_fn():
    global _BWD_FN
    if _BWD_FN is None:
        f = build.load("rwkv6_bwd").rwkv6_bwd_launch
        f.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        f.restype = ctypes.c_int
        _BWD_FN = f
    return _BWD_FN


def _check(what: str, r, k, v, w, u) -> None:
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors on {dev}")
    if r.dtype not in _DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise TypeError(f"{what}: want r, k, v, w all float32 or all "
                        f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"{what}: want u float32; got {u.dtype}")
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape \
            or v.dim() != 4 or v.shape[:3] != r.shape[:3]:
        raise ValueError(f"{what}: want r, k, w (B, H, T, K) and v (B, H, "
                         f"T, V); got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}")
    B, H, T, K = r.shape
    V = v.shape[3]
    if tuple(u.shape) != (H, K):
        raise ValueError(f"{what}: want u ({H}, {K}); got {tuple(u.shape)}")
    if not (1 <= K <= MAX_KV and 1 <= V <= MAX_KV):
        raise ValueError(f"{what}: K={K}, V={V} outside [1, {MAX_KV}]")
    if B < 1 or H < 1 or T < 1:
        raise ValueError(f"{what}: B={B}, H={H}, T={T}")
    if not all(x.is_contiguous() for x in (r, k, v, w, u)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if any(x.device != dev for x in (k, v, w, u)):
        raise ValueError(f"{what}: inputs on different devices")


def rwkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                   chunk: int = 64) -> tuple:
    """(dr, dk, dv, dw, du) of ``rwkv6_cuda`` for the output's cotangent
    ``do`` (B, H, T, V) of r's dtype; the arguments otherwise as
    ``rwkv6_cuda``'s. dr, dk, dv, dw in r's dtype; du (H, K) f32, the
    kernels' per-(b, h, chunk) sums added here. The kernels run chunks
    of C = min(chunk, T, 64) steps in parallel, with two f32 scratch
    arrays of B H ceil(T / C) K V floats (the state at every chunk
    start, its gradient at every chunk end)."""
    _check("rwkv6_bwd_cuda", r, k, v, w, u)
    B, H, T, K = r.shape
    V = v.shape[3]
    if K * V > MAX_BWD_STATE:
        raise ValueError(f"rwkv6_bwd_cuda: K={K}, V={V}: the backward "
                         f"kernel takes K V <= {MAX_BWD_STATE}")
    if do.shape != v.shape or do.dtype != r.dtype or not do.is_contiguous() \
            or do.device != r.device:
        raise ValueError("rwkv6_bwd_cuda: want do contiguous, of v's shape "
                         f"and r's dtype; got {tuple(do.shape)} {do.dtype}")
    chunk = min(int(chunk), T)
    if chunk < 1:
        raise ValueError(f"rwkv6_bwd_cuda: chunk {chunk}")
    C = min(chunk, MAX_CHUNK)
    NC = -(-T // C)
    if NC > 65535:
        raise ValueError(f"rwkv6_bwd_cuda: T={T} makes {NC} chunks of {C}, "
                         "beyond the grid's 65535")
    dev = r.device
    dr, dk, dw = (torch.empty_like(r) for _ in range(3))
    dv = torch.empty_like(v)
    du_part = torch.empty((B, H, NC, K), dtype=torch.float32, device=dev)
    s_st, g_st = (torch.empty((B * H * NC * K * V,), dtype=torch.float32,
                              device=dev) for _ in range(2))
    dn = torch.empty((B * H * NC * K,), dtype=torch.float32, device=dev)
    fn = _bwd_fn()
    build.launch(fn, dev.index,
                 (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), do.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
                  s_st.data_ptr(), g_st.data_ptr(), dn.data_ptr(), B, H, T, K,
                  V, C, int(r.dtype == torch.bfloat16)),
                 "rwkv6 backward", globals(), "BWD_LAUNCHES")
    return dr, dk, dv, dw, du_part.sum((0, 2))


def rwkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, chunk: int = 64
               ) -> torch.Tensor:
    """(B, H, T, V) output of the RWKV-6 recurrence. r, k, w (B, H, T, K)
    and v (B, H, T, V), contiguous, of one dtype (float32 or bfloat16);
    u (H, K) float32, contiguous; all on one CUDA device. K, V <= 128;
    the chunk is min(chunk, T), at most 64."""
    _check("rwkv6_cuda", r, k, v, w, u)
    B, H, T, K = r.shape
    V = v.shape[3]
    dev = r.device
    chunk = min(int(chunk), T)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"rwkv6_cuda: chunk {chunk} outside [1, "
                         f"{MAX_CHUNK}]")
    out = torch.empty((B, H, T, V), dtype=r.dtype, device=dev)
    fn = _fn()
    build.launch(fn, dev.index,
                 (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), out.data_ptr(), B, H, T, K, V, chunk,
                  int(r.dtype == torch.bfloat16)),
                 "rwkv6", globals(), "LAUNCHES")
    return out
