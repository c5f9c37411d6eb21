"""The architecture zoo's stacked-block LM, serving half: parameters,
forward, prefill and the cache decode step.

PyTorch twin of ``repro.models.transformer`` for the dense attention
(full, sliding-window, soft-capped, GQA) and RWKV-6 layers: RWKV-6,
Gemma, Gemma-2, DeepSeek, Nemotron and InternVL2's text path. Params
are the reference's nested dicts, stacked per pattern position with a
leading ``n_blocks`` dim; the blocks run in a Python loop where the
reference scans them. MoE, Mamba and the encoder-decoder path raise
``NotImplementedError`` (ROADMAP.md queue 1 item 8's later part), and
the sharding annotations are left out (no mesh here).

The caches are updated in place: ``decode_step`` writes the new KV
entries, token shift and RWKV state into the tensors of ``init_cache``
and returns the same dict.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..columnar.table import resolve_device
from .config import LayerKind, ModelConfig
from .layers import (chunked_attention, decode_attention, mlp_apply,
                     mlp_param_shapes, rms_norm, rope)
from .ssm import rwkv_mixer, rwkv_mixer_params

LATER = "is ROADMAP.md queue 1 item 8's later part: not ported yet"
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE (models/moe.py) {LATER}")
    if any(k == LayerKind.MAMBA for k in cfg.pattern):
        raise NotImplementedError(f"{cfg.name}: Mamba {LATER}")
    if cfg.enc_layers or cfg.cross_attention:
        raise NotImplementedError(
            f"{cfg.name}: the encoder and cross-attention {LATER}")


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# parameter definitions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PD:
    shape: tuple
    axes: tuple            # logical sharding per dim (None | "model" | ...)
    init: str = "normal"   # normal | zeros | ones


def _attn_defs(cfg: ModelConfig) -> Dict[str, PD]:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": PD((d, H * hd), (None, "model")),
        "wk": PD((d, Hkv * hd), (None, "model")),
        "wv": PD((d, Hkv * hd), (None, "model")),
        "wo": PD((H * hd, d), ("model", None)),
    }


def _mlp_defs(cfg: ModelConfig) -> Dict[str, PD]:
    out = {}
    for name, shape in mlp_param_shapes(cfg.mlp, cfg.d_model,
                                        cfg.d_ff).items():
        axes = (None, "model") if name.startswith("wi") else ("model", None)
        out[name] = PD(shape, axes)
    return out


_RWKV_AXES = {
    "mu": (None, None), "wr": (None, "model"), "wk": (None, "model"),
    "wv": (None, "model"), "wg": (None, "model"), "wo": ("model", None),
    "w0": ("model", None), "wa": (None, None), "wb": (None, "model"),
    "u": ("model", None), "gn": (None,),
}


def _layer_defs(cfg: ModelConfig, pos: int) -> Dict[str, PD]:
    kind = cfg.layer_kind(pos)
    d = cfg.d_model
    defs: Dict[str, PD] = {"ln": PD((d,), (None,), "zeros"),
                           "ln2": PD((d,), (None,), "zeros")}
    if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        defs.update(_attn_defs(cfg))
    elif kind == LayerKind.RWKV:
        H = d // cfg.rwkv_head_dim
        for name, shape in rwkv_mixer_params(d, H, cfg.rwkv_head_dim).items():
            if name == "ln":
                continue
            init = "zeros" if name in ("w0", "gn") else "normal"
            defs[name] = PD(shape, _RWKV_AXES[name], init)
    else:
        raise NotImplementedError(f"{cfg.name}: layer kind {kind} {LATER}")
    for name, pd in _mlp_defs(cfg).items():
        defs[f"mlp_{name}"] = pd
    return defs


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree (names, shapes, init kinds)."""
    _check_ported(cfg)
    d, V = cfg.d_model, cfg.vocab
    defs: Dict[str, Any] = {
        "embed": PD((V, d), (None, "model")),
        "final_ln": PD((d,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = PD((V, d), (None, "model"))
    blocks = {}
    for pos in range(cfg.period):
        blocks[str(pos)] = {
            name: PD((cfg.n_blocks,) + pd.shape, (None,) + pd.axes, pd.init)
            for name, pd in _layer_defs(cfg, pos).items()}
    defs["blocks"] = blocks
    return defs


def _leaf_map(fn, defs, path=()):
    if isinstance(defs, PD):
        return fn(path, defs)
    return {k: _leaf_map(fn, v, path + (k,)) for k, v in sorted(defs.items())}


def init_params(cfg: ModelConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on the device,
    with the reference's distributions: N(0, 1/fan_in) drawn in f32 and
    cast to the model dtype (fan_in = the second-to-last dim), zeros and
    ones where the reference puts them. Stacked leaves are drawn one
    block at a time, so that the f32 draw never holds more than one
    block's slice."""
    dev = resolve_device(device)
    dt = model_dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def mk(path, pd: PD):
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dt, device=dev)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dt, device=dev)
        fan_in = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        scale = 1.0 / np.sqrt(max(fan_in, 1))
        out = torch.empty(pd.shape, dtype=dt, device=dev)
        slices = out if path[0] == "blocks" else out[None]
        for s in slices:
            s.copy_(torch.randn(s.shape, generator=gen, dtype=torch.float32,
                                device=dev).mul_(scale))
        return out

    return _leaf_map(mk, param_defs(cfg))


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: the same
        # 16 bits, viewed as uint16 and then as torch.bfloat16
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(cfg: ModelConfig, tree, device=None) -> Dict[str, Any]:
    """The reference's parameters (a nested dict of arrays: numpy, or
    anything ``np.asarray`` takes, such as JAX arrays) as torch tensors
    on the device, bit for bit, checked against ``param_defs``."""
    dev = resolve_device(device)

    def conv(path, pd: PD):
        node = tree
        for k in path:
            node = node[k]
        t = _to_torch(node)
        if tuple(t.shape) != tuple(pd.shape):
            raise ValueError(f"params_from_numpy: {'/'.join(path)} has shape "
                             f"{tuple(t.shape)}, want {pd.shape}")
        return t.to(dev)

    return _leaf_map(conv, param_defs(cfg))


def _block(params, pos: int, b: int) -> dict:
    return {k: v[b] for k, v in params["blocks"][str(pos)].items()}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, hd).transpose(1, 2)      # (B, n, S, hd)


def _attention(cfg: ModelConfig, p: dict, x, positions, kind,
               cache=None, cache_len: Optional[int] = None):
    """Self-attention of x (B, S, d). ``cache``: (k, v) buffers (B, Hkv,
    max_len, hd), written in place at ``cache_len``."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rope(_heads(x @ p["wq"], H, hd), positions, cfg.rope_theta)
    k = rope(_heads(x @ p["wk"], Hkv, hd), positions, cfg.rope_theta)
    v = _heads(x @ p["wv"], Hkv, hd)
    window = cfg.window if kind == LayerKind.ATTN_LOCAL else None
    if cache is not None:
        kc, vc = cache
        if cache_len + S > kc.shape[2]:
            raise ValueError(f"decode: position {cache_len + S - 1} beyond "
                             f"the cache's {kc.shape[2]} slots")
        kc[:, :, cache_len:cache_len + S] = k
        vc[:, :, cache_len:cache_len + S] = v
        out = decode_attention(q, kc, vc, cache_len + S, window=window,
                               softcap=cfg.attn_softcap)
    else:
        out = chunked_attention(q, k, v, causal=True, window=window,
                                softcap=cfg.attn_softcap,
                                chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ p["wo"]


def _ffn(cfg: ModelConfig, p: dict, h):
    mlp_p = {k[len("mlp_"):]: v for k, v in p.items()
             if k.startswith("mlp_")}
    return mlp_apply(cfg.mlp, mlp_p, h)


def _apply_layer(cfg: ModelConfig, pos: int, p: dict, x, positions,
                 cache: Optional[dict] = None,
                 cache_len: Optional[int] = None):
    """One layer. ``cache``: this layer's slices of the caches ("kv_k",
    "kv_v" or "shift", "wkv"), updated in place."""
    kind = cfg.layer_kind(pos)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        kv = (cache["kv_k"], cache["kv_v"]) if cache is not None else None
        mix = _attention(cfg, p, h, positions, kind, cache=kv,
                         cache_len=cache_len)
    elif kind == LayerKind.RWKV:
        prev = cache["shift"] if cache is not None else None
        st = cache["wkv"] if cache is not None else None
        mix, (last_x, ns) = rwkv_mixer(p, h, cfg, prev, state=st,
                                       decode=cache is not None)
        if cache is not None:
            cache["shift"].copy_(last_x)
            cache["wkv"].copy_(ns)
    else:
        raise NotImplementedError(f"{cfg.name}: layer kind {kind} {LATER}")
    x = x + mix
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, p, h2)


def embed_tokens(cfg: ModelConfig, params, tokens, embeds_prefix=None):
    x = params["embed"][tokens.long()].to(model_dtype(cfg))
    if cfg.embed_scale:
        # sqrt(d) rounded to the model dtype first (68.0 for d = 4608 in
        # bf16), as the reference multiplies by jnp.asarray(.., x.dtype)
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if embeds_prefix is not None:
        x = torch.cat([embeds_prefix.to(x.dtype), x], dim=1)
    return x


def forward(cfg: ModelConfig, params, tokens, embeds_prefix=None,
            enc_embeds=None):
    """Training/prefill forward to final hidden states (B, S, d)."""
    _check_ported(cfg)
    if enc_embeds is not None:
        raise NotImplementedError(f"{cfg.name}: the encoder {LATER}")
    x = embed_tokens(cfg, params, tokens, embeds_prefix)
    positions = torch.arange(x.shape[1], device=x.device)
    for b in range(cfg.n_blocks):
        for pos in range(cfg.period):
            x = _apply_layer(cfg, pos, _block(params, pos, b), x, positions)
    return rms_norm(x, params["final_ln"], cfg.norm_eps)


def _logits(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    """f32 logits h @ head.T, then the final softcap. h: (B, d)."""
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    logits = h.float() @ head.float().t()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# -- decode -----------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0, device=None) -> dict:
    """Per-pattern-position stacked caches (n_blocks leading dim)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dt = model_dtype(cfg)
    nb, B = cfg.n_blocks, batch
    caches = {}
    for pos in range(cfg.period):
        kind = cfg.layer_kind(pos)
        if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
            shape = (nb, B, cfg.n_kv_heads, max_len, cfg.hd)
            caches[str(pos)] = {
                "kv_k": torch.zeros(shape, dtype=dt, device=dev),
                "kv_v": torch.zeros(shape, dtype=dt, device=dev)}
        elif kind == LayerKind.RWKV:
            H = cfg.d_model // cfg.rwkv_head_dim
            K = cfg.rwkv_head_dim
            caches[str(pos)] = {
                "shift": torch.zeros((nb, B, 1, cfg.d_model), dtype=dt,
                                     device=dev),
                "wkv": torch.zeros((nb, B, H, K, K), dtype=torch.float32,
                                   device=dev)}
    return caches


def decode_step(cfg: ModelConfig, params, caches, token, cache_len: int,
                enc_out=None):
    """One decode step. token: (B,) int; cache_len: the token's position.
    Returns (logits (B, V), caches), the caches updated in place."""
    _check_ported(cfg)
    if enc_out is not None:
        raise NotImplementedError(f"{cfg.name}: cross-attention {LATER}")
    x = embed_tokens(cfg, params, token[:, None])
    cache_len = int(cache_len)
    positions = torch.full((1,), cache_len, dtype=torch.int32,
                           device=x.device)
    for b in range(cfg.n_blocks):
        for pos in range(cfg.period):
            c = {k: v[b] for k, v in caches[str(pos)].items()}
            x = _apply_layer(cfg, pos, _block(params, pos, b), x, positions,
                             cache=c, cache_len=cache_len)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _logits(cfg, params, h[:, 0]), caches


def prefill(cfg: ModelConfig, params, tokens, enc_embeds=None):
    """Prefill forward returning last-position logits (B, V) in f32."""
    h = forward(cfg, params, tokens, enc_embeds=enc_embeds)
    return _logits(cfg, params, h[:, -1])
