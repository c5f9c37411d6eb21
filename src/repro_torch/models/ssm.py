"""State-space / linear-recurrence mixers: RWKV-6 and Mamba.

PyTorch twin of ``repro.models.ssm``. ``rwkv6_chunked`` goes to the
hand-written RWKV-6 kernel (``kernels.ops.rwkv6_scan``), which takes the
place of the reference's XLA chunked form; the one-token decode step
``rwkv6_step`` stays PyTorch, as the reference keeps it in XLA. Mamba's
selective scan reaches no kernel in the reference either: it stays a
PyTorch loop over the sequence.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .layers import rms_norm, silu


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
    g = silu(xr @ p["wg"])
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
# Mamba (S6 selective scan)
# ---------------------------------------------------------------------------

SCAN_CHUNK = 256    # steps whose (B, din, n) updates are formed at once


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as XLA lowers it: max(x,
    0) + log1p(exp(-|x|)), each op rounded to x's dtype; NaN stays."""
    out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def mamba_params(d: int, expand: int, n_state: int, conv: int,
                 dt_rank: int):
    din = expand * d
    return {
        "ln": (d,),
        "in_proj": (d, 2 * din),
        "conv_w": (conv, din), "conv_b": (din,),
        "w_dt1": (din, dt_rank), "w_dt2": (dt_rank, din), "dt_b": (din,),
        "wB": (din, n_state), "wC": (din, n_state),
        "A_log": (din, n_state), "D": (din,),
        "out_proj": (din, d),
    }


def _selective_scan(dt, dh, Bm, Cm, A) -> torch.Tensor:
    """The sequential scan s_t = s_{t-1} * exp(dt_t A) + dh_t B_t,
    y_t = s_t . C_t, in f32 from s_0 = 0, over (B, S, din) dt and dt*h
    and (B, S, n) B and C; A (din, n); returns y (B, S, din). Each step
    rounds as the reference's: the product s * da, the outer product
    dh B, then their sum. The (B, din, n) factors are formed
    ``SCAN_CHUNK`` steps at a time, so memory stays at a chunk's worth
    of them. On the meta device (the dry-run) a chunk runs its first
    step, counted as many times as it has steps (``kops.meta_trips``)."""
    Bsz, S, din = dt.shape
    n = A.shape[1]
    s = torch.zeros((Bsz, din, n), dtype=torch.float32, device=dt.device)
    record = torch.is_grad_enabled() and any(
        x.requires_grad for x in (dt, dh, Bm, Cm, A))
    ys = []
    for c0 in range(0, S, SCAN_CHUNK):
        c1 = min(c0 + SCAN_CHUNK, S)
        da = torch.exp(dt[:, c0:c1, :, None] * A)           # (B,c,din,n)
        db = dh[:, c0:c1, :, None] * Bm[:, c0:c1, None, :]
        if dt.device.type == "meta":
            with kops.meta_trips(c1 - c0):
                s = s * da[:, 0] + db[:, 0]
            states = s[:, None].expand(da.shape)
        elif record:
            # autograd takes no out= and no in-place add on the saved
            # states: the same two roundings, out of place
            steps = []
            for t in range(c1 - c0):
                s = s * da[:, t] + db[:, t]
                steps.append(s)
            states = torch.stack(steps, dim=1)
        else:
            states = torch.empty_like(da)
            for t in range(c1 - c0):
                s = torch.mul(s, da[:, t], out=states[:, t])
                s.add_(db[:, t])
        ys.append(torch.einsum("bscn,bsn->bsc", states, Cm[:, c0:c1]))
        del da, db, states
    return torch.cat(ys, dim=1)


def mamba_mixer(p: dict, x: torch.Tensor, cfg,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                decode: bool = False):
    """Selective SSM. x: (B,S,d). Returns (out, (conv_state, ssm_state)):
    in a decode step (S == 1, both states given) the states after the
    token; in prefill the last kw-1 conv inputs and no ssm state."""
    B, S, d = x.shape
    kw = cfg.mamba_conv
    xz = x @ p["in_proj"]
    xin, z = xz.chunk(2, dim=-1)                          # (B,S,din)

    # causal depthwise conv1d: the reference's window einsum
    if decode:
        if S != 1 or conv_state is None or ssm_state is None:
            raise ValueError(f"mamba_mixer: a decode step takes 1 token "
                             f"and both states, got S={S}")
        window = torch.cat([conv_state, xin], dim=1)      # (B,kw,din)
        conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) \
            + p["conv_b"]
        conv_out = conv_out[:, None, :]
        new_conv = window[:, 1:]
    else:
        xin_p = F.pad(xin, (0, 0, kw - 1, 0))
        windows = xin_p.unfold(1, kw, 1)                  # (B,S,din,kw)
        conv_out = torch.einsum("bsck,kc->bsc", windows, p["conv_w"]) \
            + p["conv_b"]
        new_conv = xin_p[:, -(kw - 1):]
    h = silu(conv_out)

    dt = _softplus((h @ p["w_dt1"]) @ p["w_dt2"] + p["dt_b"])
    A = -torch.exp(p["A_log"].float())                    # (din,n)
    Bm = h @ p["wB"]                                      # (B,S,n)
    Cm = h @ p["wC"]

    if decode:
        da = torch.exp(dt.float()[:, 0, :, None] * A[None])
        db = (dt * h).float()[:, 0, :, None] * Bm.float()[:, 0, None, :]
        s = ssm_state * da + db                           # (B,din,n)
        y = torch.einsum("bcn,bn->bc", s, Cm[:, 0].float())[:, None, :]
        new_ssm = s
    else:
        y = _selective_scan(dt.float(), (dt * h).float(), Bm.float(),
                            Cm.float(), A)
        new_ssm = None
    y = y.to(x.dtype) + h * p["D"][None, None]
    y = y * silu(z)
    return y @ p["out_proj"], (new_conv, new_ssm)
