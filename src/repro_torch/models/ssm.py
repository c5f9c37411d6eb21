"""State-space / linear-recurrence mixers: RWKV-6 (Mamba later).

PyTorch twin of ``repro.models.ssm``. ``rwkv6_chunked`` goes to the
hand-written RWKV-6 kernel (``kernels.ops.rwkv6_scan``), which takes the
place of the reference's XLA chunked form; the one-token decode step
``rwkv6_step`` stays PyTorch, as the reference keeps it in XLA.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .layers import rms_norm

LATER = ("Mamba is ROADMAP.md queue 1 item 8's later part: not ported "
         "yet")


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent per-channel decay
# ---------------------------------------------------------------------------

def rwkv6_chunked(r, k, v, w, u, chunk: int = 64) -> torch.Tensor:
    """r,k,w: (B,H,T,K); v: (B,H,T,V); u: (H,K) -> (B,H,T,V)."""
    return kops.rwkv6_scan(r, k, v, w, u, chunk=chunk)


def rwkv6_step(S, r1, k1, v1, w1, u):
    """One decode step. S: (B,H,K,V); r1,k1,w1: (B,H,K); v1: (B,H,V)."""
    rf, kf, vf, wf = (x.float() for x in (r1, k1, v1, w1))
    kv = kf[..., :, None] * vf[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", rf, S + u[None, :, :, None] * kv)
    S = wf[..., None] * S + kv
    return S, o.to(r1.dtype)


def rwkv_mixer_params(d: int, n_heads: int, hd: int, lora: int = 64):
    return {
        "ln": (d,), "mu": (4, d),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d),
        "wo": (d, d),
        "w0": (n_heads, hd), "wa": (d, lora), "wb": (lora, d),
        "u": (n_heads, hd), "gn": (d,),
    }


def rwkv_mixer(p: dict, x: torch.Tensor, cfg, prev: Optional[torch.Tensor],
               state: Optional[torch.Tensor] = None, decode: bool = False):
    """RWKV-6 time-mix. x: (B,S,d). prev: (B,1,d) last token of previous
    segment (token shift), zeros at start. Returns (out, (last_x, S))."""
    B, S, d = x.shape
    H = d // cfg.rwkv_head_dim
    K = cfg.rwkv_head_dim
    if prev is None:
        prev = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    xx = torch.cat([prev, x[:, :-1]], dim=1)            # token shift

    def mix(i):
        mu = p["mu"][i]
        return x * mu + xx * (1.0 - mu)

    xr, xk, xv, xw = mix(0), mix(1), mix(2), mix(3)
    r = (xr @ p["wr"]).reshape(B, S, H, K).transpose(1, 2)
    k = (xk @ p["wk"]).reshape(B, S, H, K).transpose(1, 2)
    v = (xv @ p["wv"]).reshape(B, S, H, K).transpose(1, 2)
    g = F.silu(xr @ p["wg"])
    # data-dependent decay (low-rank): w in (0,1), computed in f32 and
    # rounded to the model dtype before the recurrence
    dlog = p["w0"].reshape(1, 1, d) + torch.tanh(xw @ p["wa"]) @ p["wb"]
    w = torch.exp(-torch.exp(torch.clamp(dlog.float(), -10, 4)))
    w = w.reshape(B, S, H, K).transpose(1, 2).to(x.dtype)

    if decode:
        if S != 1:
            raise ValueError(f"rwkv_mixer: a decode step takes 1 token, "
                             f"got {S}")
        new_state, o1 = rwkv6_step(state, r[:, :, 0], k[:, :, 0],
                                   v[:, :, 0], w[:, :, 0], p["u"])
        o = o1[:, :, None, :]                            # (B,H,1,V)
    else:
        o = rwkv6_chunked(r, k, v, w, p["u"], chunk=cfg.rwkv_chunk)
        new_state = None
    o = o.transpose(1, 2).reshape(B, S, d)
    o = rms_norm(o, p["gn"], cfg.norm_eps) * g
    return o @ p["wo"], (x[:, -1:], new_state)


# ---------------------------------------------------------------------------
# Mamba (S6 selective scan): later
# ---------------------------------------------------------------------------

def mamba_params(*args, **kwargs):
    raise NotImplementedError(LATER)


def mamba_mixer(*args, **kwargs):
    raise NotImplementedError(LATER)
