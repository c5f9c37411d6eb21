"""Shared model layers: norms, RoPE, MLP variants, chunked attention,
chunked cross-entropy.

PyTorch twin of ``repro.models.layers``. Where the reference's XLA
``chunked_attention`` has the Pallas kernel as its TPU twin, the port
calls the hand-written kernel: a call without a validity mask and
without a query offset (prefill and forward) goes to
``kernels.ops.flash_attention``. With a mask (decode against the KV
cache) the reference's masked online-softmax loop runs in PyTorch, as
the reference runs it in XLA outside any kernel. ``chunked_xent``
recomputes each chunk's logits in the backward.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import ops as kops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMS norm in f32 scaled by (1 + gamma), cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + gamma.float())).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Half-split rotation. x: (B, H, S, D); positions: (S,) or (B, S);
    f32 frequencies theta ** (-arange(half) / half)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32),
                     -torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.dim() == 1:
        ang = positions.float()[None, None, :, None] * freq
    else:
        ang = positions.float()[:, None, :, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA lowers it op by op: x * (1 / (1 + exp(-x))),
    each op rounded to x's dtype. ``F.silu`` rounds once; in bf16 the
    two differ by an ulp here and there, and an ulp can flip a near-tie
    of the next MoE router (tests/test_torch_moe_ssm.py)."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_apply(kind: str, p: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "swiglu":
        return (silu(x @ p["wi0"]) * (x @ p["wi1"])) @ p["wo"]
    if kind == "geglu":
        return (_gelu(x @ p["wi0"]) * (x @ p["wi1"])) @ p["wo"]
    if kind == "sq_relu":
        h = torch.relu(x @ p["wi0"])
        return (h * h) @ p["wo"]
    if kind == "gelu":
        return _gelu(x @ p["wi0"]) @ p["wo"]
    raise ValueError(kind)


def mlp_param_shapes(kind: str, d: int, ff: int) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"wi0": (d, ff), "wi1": (d, ff), "wo": (ff, d)}
    return {"wi0": (d, ff), "wo": (ff, d)}


# ---------------------------------------------------------------------------
# chunked (online-softmax) attention
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None,
                      chunk: int = 1024,
                      q_offset: int = 0,
                      kv_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """q: (B,H,Sq,D); k,v: (B,Hkv,Sk,D). Online softmax over KV chunks.

    ``q_offset``: absolute position of q[0] (decode: Sk-1).
    ``kv_valid``: optional (B, Sk) mask of valid cache slots. Without
    either, the call is the flash-attention kernel's function and goes to
    it (``chunk`` then changes nothing but the kernel's own tiling)."""
    if kv_valid is None and q_offset == 0:
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale)
    B, H, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    group = H // Hkv
    scale = scale if scale is not None else D ** -0.5
    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        if kv_valid is not None:
            kv_valid = F.pad(kv_valid, (0, pad))
    n_chunks = (Sk + pad) // chunk
    dev = q.device
    rows = q_offset + torch.arange(Sq, device=dev)
    qf = q.float()
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    for cj in range(n_chunks):
        sl = slice(cj * chunk, (cj + 1) * chunk)
        kj = k[:, :, sl].repeat_interleave(group, dim=1).float()
        vj = v[:, :, sl].repeat_interleave(group, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kj) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        cols = cj * chunk + torch.arange(chunk, device=dev)
        mask = (cols[None, :] < Sk).expand(Sq, chunk)
        if causal:
            mask = mask & (cols[None, :] <= rows[:, None])
        if window is not None:
            mask = mask & (cols[None, :] > rows[:, None] - window)
        mask = mask[None, None]
        if kv_valid is not None:
            mask = mask & kv_valid[:, sl][:, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        acc = corr * acc + torch.einsum("bhqk,bhkd->bhqd", p, vj)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Single-step decode: q1 (B,H,1,D) against cache (B,Hkv,Smax,D).
    ``cache_len``: number of valid cache entries (the new token's
    position is cache_len - 1 after insertion)."""
    B, Hkv, Smax, D = k_cache.shape
    pos = torch.arange(Smax, device=q1.device)
    valid = pos[None, :] < cache_len
    if window is not None:
        valid = valid & (pos[None, :] > cache_len - 1 - window)
    valid = valid.expand(B, Smax)
    return chunked_attention(q1, k_cache, v_cache, causal=False,
                             softcap=softcap, kv_valid=valid,
                             q_offset=0, chunk=4096)


# ---------------------------------------------------------------------------
# chunked cross-entropy (avoids materializing (B,S,V) logits)
# ---------------------------------------------------------------------------

def _xent_chunk(hj: torch.Tensor, emb: torch.Tensor, lj: torch.Tensor,
                final_softcap: Optional[float]) -> torch.Tensor:
    """The summed loss of one chunk: f32 logits hj @ emb^T, the final
    softcap, then logsumexp - the gold logit where the label is >= 0."""
    logits = hj.float() @ emb.t()                        # (B, chunk, V)
    if final_softcap is not None:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lj.clamp(min=0)[..., None])[..., 0]
    return torch.where(lj >= 0, lse - gold, torch.zeros_like(lse)).sum()


def chunked_xent(h: torch.Tensor, emb: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512,
                 final_softcap: Optional[float] = None) -> torch.Tensor:
    """Mean cross-entropy of the f32 logits h @ emb^T over the positions
    whose label is >= 0 (padding is -1). h: (B,S,d); emb: (V,d) (the
    head); labels: (B,S) int. Chunks of ``chunk`` positions, summed in
    order; the result is the sum over the count, at least 1. Where
    autograd records, each chunk runs under ``torch.utils.checkpoint``:
    its (B, chunk, V) f32 logits are formed again in the backward rather
    than kept (17 GB for Gemma-2's vocab at 8,192 positions); the value
    does not change."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    labels = labels.long()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    embf = emb.float()
    record = torch.is_grad_enabled() and (h.requires_grad
                                          or embf.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.int64, device=h.device)
    for c0 in range(0, S + pad, chunk):
        hj, lj = h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if record:
            part = checkpoint(_xent_chunk, hj, embf, lj, final_softcap,
                              use_reentrant=False)
        else:
            part = _xent_chunk(hj, embf, lj, final_softcap)
        tot = tot + part
        cnt = cnt + (lj >= 0).sum()
    return tot / torch.clamp(cnt, min=1).to(torch.float32)
