"""The architecture zoo's stacked-block LM: parameters, forward (with
the reference's remat modes), the training loss, prefill and the cache
decode step.

PyTorch twin of ``repro.models.transformer`` for all ten configs: dense
attention (full, sliding-window, soft-capped, GQA), RWKV-6 and Mamba
mixers, MoE feed-forward layers (with Arctic's dense residual) and
Whisper's encoder-decoder (a bidirectional encoder over precomputed
frame embeddings, cross-attention in every decoder layer). Params are
the reference's nested dicts, stacked per pattern position with a
leading ``n_blocks`` dim (the encoder's with ``enc_layers``); the
blocks run in a Python loop where the reference scans them.
``param_defs`` describes shapes and logical sharding axes (``fsdp``: the
d_model dims of the attention, MLP and expert weights also over "data"),
from which ``abstract_params`` (meta tensors, the dry-run's),
``init_params``, ``param_shardings`` and ``param_pspecs`` derive; the
activations are constrained where the reference constrains them
(``sharding.constrain``, a no-op without a mesh).

The caches are updated in place: ``decode_step`` writes the new KV
entries, token shift, RWKV state and Mamba conv and ssm states into the
tensors of ``init_cache`` and returns the same dict. Cross-attention
keeps no cache: a decode step given ``enc_out`` projects it anew in
every layer, as the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import tree as TR
from ..columnar.table import resolve_device
from . import sharding as SH
from .config import LayerKind, ModelConfig
from .layers import (chunked_attention, chunked_xent, decode_attention,
                     mlp_apply, mlp_param_shapes, rms_norm, rope)
from .moe import moe_apply, moe_param_shapes
from .ssm import mamba_mixer, mamba_params, rwkv_mixer, rwkv_mixer_params

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
DRAW_ELEMS = 1 << 28   # the most elements ``init_params`` draws at once


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


def _attn_defs(cfg: ModelConfig, cross: bool = False,
               fsdp: bool = False) -> Dict[str, PD]:
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    pre = "x" if cross else ""
    dd = "data" if fsdp else None
    return {
        pre + "wq": PD((d, H * hd), (dd, "model")),
        pre + "wk": PD((d, Hkv * hd), (dd, "model")),
        pre + "wv": PD((d, Hkv * hd), (dd, "model")),
        pre + "wo": PD((H * hd, d), ("model", dd)),
    }


def _mlp_defs(cfg: ModelConfig, fsdp: bool = False) -> Dict[str, PD]:
    out = {}
    dd = "data" if fsdp else None
    for name, shape in mlp_param_shapes(cfg.mlp, cfg.d_model,
                                        cfg.d_ff).items():
        axes = (dd, "model") if name.startswith("wi") else ("model", dd)
        out[name] = PD(shape, axes)
    return out


MODEL_AXIS_SIZE = 16  # the reference's production model axis


def _moe_defs(cfg: ModelConfig, fsdp: bool = False) -> Dict[str, PD]:
    """Expert-parallel axes where the experts divide the model axis
    (Arctic 128, Jamba 16), tensor-parallel inside each expert
    otherwise (Mixtral 8), as the reference lays them out; ``fsdp`` also
    shards the d_model dim over "data"."""
    m = cfg.moe
    ep = m.num_experts % MODEL_AXIS_SIZE == 0
    dd = "data" if fsdp else None
    out = {}
    for name, shape in moe_param_shapes(cfg.d_model, m.d_ff_expert,
                                        m.num_experts, cfg.mlp).items():
        if name == "router":
            axes = (None, None)
        elif name.startswith("wi"):                      # (E, d, ff)
            axes = ("model", dd, None) if ep else (None, dd, "model")
        else:                                            # wo (E, ff, d)
            axes = ("model", None, dd) if ep else (None, "model", dd)
        out[name] = PD(shape, axes)
    return out


_MAMBA_AXES = {
    "in_proj": (None, "model"), "conv_w": (None, "model"),
    "conv_b": ("model",), "w_dt1": ("model", None),
    "w_dt2": (None, "model"), "dt_b": ("model",),
    "wB": ("model", None), "wC": ("model", None),
    "A_log": ("model", None), "D": ("model",),
    "out_proj": ("model", None),
}

_RWKV_AXES = {
    "mu": (None, None), "wr": (None, "model"), "wk": (None, "model"),
    "wv": (None, "model"), "wg": (None, "model"), "wo": ("model", None),
    "w0": ("model", None), "wa": (None, None), "wb": (None, "model"),
    "u": ("model", None), "gn": (None,),
}


def _layer_defs(cfg: ModelConfig, pos: int, cross: bool = False,
                fsdp: bool = False) -> Dict[str, PD]:
    kind = cfg.layer_kind(pos)
    d = cfg.d_model
    defs: Dict[str, PD] = {"ln": PD((d,), (None,), "zeros"),
                           "ln2": PD((d,), (None,), "zeros")}
    if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        defs.update(_attn_defs(cfg, fsdp=fsdp))
    elif kind == LayerKind.MAMBA:
        dt_rank = max(d // 16, 8)
        for name, shape in mamba_params(d, cfg.mamba_expand,
                                        cfg.mamba_d_state, cfg.mamba_conv,
                                        dt_rank).items():
            if name == "ln":
                continue
            init = "ones" if name == "A_log" else (
                "zeros" if name in ("conv_b", "dt_b", "D") else "normal")
            defs[name] = PD(shape, _MAMBA_AXES[name], init)
    elif kind == LayerKind.RWKV:
        H = d // cfg.rwkv_head_dim
        for name, shape in rwkv_mixer_params(d, H, cfg.rwkv_head_dim).items():
            if name == "ln":
                continue
            init = "zeros" if name in ("w0", "gn") else "normal"
            defs[name] = PD(shape, _RWKV_AXES[name], init)
    else:
        raise ValueError(f"{cfg.name}: layer kind {kind}")
    if cross:
        defs.update(_attn_defs(cfg, cross=True, fsdp=fsdp))
        defs["lnx"] = PD((d,), (None,), "zeros")
    if cfg.has_moe_at(pos):
        for name, pd in _moe_defs(cfg, fsdp=fsdp).items():
            defs[f"moe_{name}"] = pd
        if cfg.moe.dense_residual:
            for name, pd in _mlp_defs(cfg, fsdp=fsdp).items():
                defs[f"dense_{name}"] = pd
    else:
        for name, pd in _mlp_defs(cfg, fsdp=fsdp).items():
            defs[f"mlp_{name}"] = pd
    return defs


def _stacked(n: int, layer: Dict[str, PD]) -> Dict[str, PD]:
    return {name: PD((n,) + pd.shape, (None,) + pd.axes, pd.init)
            for name, pd in layer.items()}


def param_defs(cfg: ModelConfig, fsdp: bool = False) -> Dict[str, Any]:
    """The reference's parameter tree (names, shapes, axes, init kinds);
    ``fsdp`` as the reference's (the encoder's stay unsharded over
    "data")."""
    d, V = cfg.d_model, cfg.vocab
    defs: Dict[str, Any] = {
        "embed": PD((V, d), (None, "model")),
        "final_ln": PD((d,), (None,), "zeros"),
    }
    if not cfg.tie_embeddings:
        defs["head"] = PD((V, d), (None, "model"))
    defs["blocks"] = {
        str(pos): _stacked(cfg.n_blocks, _layer_defs(
            cfg, pos, cross=cfg.cross_attention, fsdp=fsdp))
        for pos in range(cfg.period)}
    if cfg.enc_layers:
        defs["encoder"] = _stacked(cfg.enc_layers, _layer_defs(
            cfg.reduced(pattern=(LayerKind.ATTN,), moe=None), 0))
        defs["enc_final_ln"] = PD((d,), (None,), "zeros")
    return defs


def _leaf_map(fn, defs, path=()):
    if isinstance(defs, PD):
        return fn(path, defs)
    return {k: _leaf_map(fn, v, path + (k,)) for k, v in sorted(defs.items())}


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameters as tensors of the model dtype on the ``meta``
    device: shapes without memory (``init_params`` cannot draw there)."""
    dt = model_dtype(cfg)
    return _leaf_map(lambda _, pd: torch.empty(pd.shape, dtype=dt,
                                               device="meta"),
                     param_defs(cfg))


def param_shardings(cfg: ModelConfig, fsdp: bool = False):
    return _leaf_map(lambda _, pd: SH.named_sharding(*pd.axes),
                     param_defs(cfg, fsdp=fsdp))


def param_pspecs(cfg: ModelConfig):
    return _leaf_map(lambda _, pd: SH.pspec(*pd.axes), param_defs(cfg))


def init_params(cfg: ModelConfig, seed: int = 0, device=None
                ) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on the device,
    with the reference's distributions: N(0, 1/fan_in) drawn in f32 and
    cast to the model dtype (fan_in = the second-to-last dim), zeros and
    ones where the reference puts them. Stacked leaves (the blocks' and
    the encoder's) are drawn one block at a time, and a block's slice of
    more than ``DRAW_ELEMS`` elements (MoE experts) in runs of its
    leading rows of at most that many, so that the f32 draw stays
    small beside the weights."""
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
        for s in _draw_slices(out, path[0] in ("blocks", "encoder")):
            s.copy_(torch.randn(s.shape, generator=gen, dtype=torch.float32,
                                device=dev).mul_(scale))
        return out

    return _leaf_map(mk, param_defs(cfg))


def _draw_slices(out: torch.Tensor, stacked: bool) -> list:
    """The views of ``out`` that ``init_params`` draws one at a time: the
    whole leaf, or each block of a stacked one, that block cut into runs
    of its leading rows where it holds more than ``DRAW_ELEMS``."""
    if not stacked:
        return [out]
    slices = []
    for blk in out:
        if blk.dim() < 2 or blk.numel() <= DRAW_ELEMS:
            slices.append(blk)
            continue
        rows = max(DRAW_ELEMS // (blk.numel() // blk.shape[0]), 1)
        slices.extend(blk.split(rows))
    return slices


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
               cache=None, cache_len: Optional[int] = None, pre: str = "",
               kv_override=None):
    """Attention of x (B, S, d). Self-attention (roped, causal) over x,
    or with ``kv_override`` (B, Sk, d) cross-attention over it with the
    ``pre``-prefixed weights: no rope, no mask. ``cache``: (k, v)
    buffers (B, Hkv, max_len, hd), written in place at ``cache_len``."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kv_src = x if kv_override is None else kv_override
    q = _heads(x @ p[pre + "wq"], H, hd)
    k = _heads(kv_src @ p[pre + "wk"], Hkv, hd)
    v = _heads(kv_src @ p[pre + "wv"], Hkv, hd)
    if kv_override is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
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
        out = chunked_attention(q, k, v, causal=kv_override is None,
                                window=window, softcap=cfg.attn_softcap,
                                chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ p[pre + "wo"]


def _encoder_attention(cfg: ModelConfig, p: dict, h, positions):
    """The encoder's bidirectional self-attention: roped at the encoder's
    positions, no mask, and neither window nor softcap, whatever the
    config says (the reference's encoder branch)."""
    B, S, d = h.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = rope(_heads(h @ p["wq"], H, hd), positions, cfg.rope_theta)
    k = rope(_heads(h @ p["wk"], Hkv, hd), positions, cfg.rope_theta)
    v = _heads(h @ p["wv"], Hkv, hd)
    out = chunked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return out.transpose(1, 2).reshape(B, S, H * hd) @ p["wo"]


def _prefixed(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _ffn(cfg: ModelConfig, pos: int, p: dict, h):
    if cfg.has_moe_at(pos):
        m = cfg.moe
        out, _ = moe_apply(_prefixed(p, "moe_"), h, mlp=cfg.mlp,
                           num_experts=m.num_experts, top_k=m.top_k,
                           capacity_factor=m.capacity_factor,
                           skew_aware=m.skew_aware)
        if m.dense_residual:
            out = out + mlp_apply(cfg.mlp, _prefixed(p, "dense_"), h)
        return out
    return mlp_apply(cfg.mlp, _prefixed(p, "mlp_"), h)


def _apply_layer(cfg: ModelConfig, pos: int, p: dict, x, positions,
                 cache: Optional[dict] = None,
                 cache_len: Optional[int] = None, enc_out=None,
                 causal: bool = True):
    """One layer. ``cache``: this layer's slices of the caches ("kv_k",
    "kv_v", or "conv", "ssm", or "shift", "wkv"), updated in place.
    ``causal=False``: the encoder's bidirectional self-attention.
    ``enc_out``: cross-attention over it after the mixer (Whisper's
    decoder)."""
    kind = cfg.layer_kind(pos)
    # between layers the residual stream is sequence-sharded over the
    # model axis (the reference's Megatron-SP constraint); no-op without
    # a mesh or at S == 1
    if x.shape[1] > 1 and x.shape[1] % 16 == 0:
        x = SH.constrain(x, "dp", "model", None)
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
        if not causal:
            mix = _encoder_attention(cfg, p, h, positions)
        else:
            kv = (cache["kv_k"], cache["kv_v"]) if cache is not None \
                else None
            mix = _attention(cfg, p, h, positions, kind, cache=kv,
                             cache_len=cache_len)
    elif kind == LayerKind.MAMBA:
        conv = cache["conv"] if cache is not None else None
        ssm = cache["ssm"] if cache is not None else None
        mix, (nc, ns) = mamba_mixer(p, h, cfg, conv_state=conv,
                                    ssm_state=ssm, decode=cache is not None)
        if cache is not None:
            cache["conv"].copy_(nc)
            cache["ssm"].copy_(ns)
    elif kind == LayerKind.RWKV:
        prev = cache["shift"] if cache is not None else None
        st = cache["wkv"] if cache is not None else None
        mix, (last_x, ns) = rwkv_mixer(p, h, cfg, prev, state=st,
                                       decode=cache is not None)
        if cache is not None:
            cache["shift"].copy_(last_x)
            cache["wkv"].copy_(ns)
    else:
        raise ValueError(f"{cfg.name}: layer kind {kind}")
    x = x + mix
    if cfg.cross_attention and enc_out is not None:
        hx = rms_norm(x, p["lnx"], cfg.norm_eps)
        x = x + _attention(cfg, p, hx, positions, LayerKind.ATTN, pre="x",
                           kv_override=enc_out)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + _ffn(cfg, pos, p, h2)


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


def _encoder(cfg: ModelConfig, params, enc_embeds):
    """Whisper-style encoder over precomputed frame embeddings (B, S_enc,
    d): ``enc_layers`` bidirectional attention layers, then
    ``enc_final_ln``."""
    x = enc_embeds.to(model_dtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    ecfg = cfg.reduced(pattern=(LayerKind.ATTN,), moe=None,
                       cross_attention=False)
    for b in range(cfg.enc_layers):
        p = {k: v[b] for k, v in params["encoder"].items()}
        x = _apply_layer(ecfg, 0, p, x, positions, causal=False)
    return rms_norm(x, params["enc_final_ln"], cfg.norm_eps)


# the products whose outputs "dots" keeps: the reference's
# dots_with_no_batch_dims_saveable, as x @ W reaches ATen (batched
# products, such as the plain attention's, are formed again)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_PRODUCTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, body, x, params):
    """``body(x)`` (one block's layers) under ``cfg.remat`` where autograd
    records: "block" keeps only the block's input and forms the rest
    again in the backward; "dots" keeps the outputs of the x @ W
    products as well (selective checkpointing); "none" keeps all. The
    value is the same in every mode."""
    record = torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in TR.leaves(params)))
    if cfg.remat == "none" or not record:
        return body(x)
    if cfg.remat == "block":
        return checkpoint(body, x, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(body, x, use_reentrant=False, context_fn=partial(
            create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"{cfg.name}: remat {cfg.remat!r}")


def forward(cfg: ModelConfig, params, tokens, embeds_prefix=None,
            enc_embeds=None):
    """Training/prefill forward to final hidden states (B, S, d). A
    config with an encoder needs ``enc_embeds`` (B, S_enc, d_model).
    Each block of ``cfg.period`` layers runs under ``cfg.remat``."""
    enc_out = None
    if cfg.enc_layers:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: forward needs enc_embeds, the "
                             f"encoder's frame embeddings")
        enc_out = _encoder(cfg, params, enc_embeds)
    x = SH.constrain(embed_tokens(cfg, params, tokens, embeds_prefix),
                     "dp", None, None)
    positions = torch.arange(x.shape[1], device=x.device)
    for b in range(cfg.n_blocks):
        blk = {str(pos): _block(params, pos, b) for pos in range(cfg.period)}

        def body(h, blk=blk):
            for pos in range(cfg.period):
                h = _apply_layer(cfg, pos, blk[str(pos)], h, positions,
                                 enc_out=enc_out)
            return h

        x = _remat(cfg, body, x, blk)
    return rms_norm(x, params["final_ln"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ("tokens", "labels"
    (B, S), padding -1; "embeds_prefix" (B, P, d) for a VLM's image
    prefix, whose positions carry no label; "enc_embeds" for an
    encoder) under the tied or untied head and the final softcap."""
    prefix = batch.get("embeds_prefix")
    h = forward(cfg, params, batch["tokens"], embeds_prefix=prefix,
                enc_embeds=batch.get("enc_embeds"))
    if prefix is not None:
        h = h[:, prefix.shape[1]:]
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    return chunked_xent(h, head, batch["labels"], chunk=cfg.seq_chunk_loss,
                        final_softcap=cfg.final_softcap)


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
    """Per-pattern-position stacked caches (n_blocks leading dim).
    ``enc_len`` is unused, as in the reference: cross-attention keeps no
    cache."""
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
        elif kind == LayerKind.MAMBA:
            din = cfg.mamba_expand * cfg.d_model
            caches[str(pos)] = {
                "conv": torch.zeros((nb, B, cfg.mamba_conv - 1, din),
                                    dtype=dt, device=dev),
                "ssm": torch.zeros((nb, B, din, cfg.mamba_d_state),
                                   dtype=torch.float32, device=dev)}
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
    """One decode step. token: (B,) int; cache_len: the token's position;
    ``enc_out``: the encoder's output (B, S_enc, d) for cross-attention
    (without it, Whisper's decoder runs without cross-attention, as the
    reference's serving engine runs it). Returns (logits (B, V),
    caches), the caches updated in place."""
    x = embed_tokens(cfg, params, token[:, None])
    cache_len = int(cache_len)
    positions = torch.full((1,), cache_len, dtype=torch.int32,
                           device=x.device)
    for b in range(cfg.n_blocks):
        for pos in range(cfg.period):
            c = {k: v[b] for k, v in caches[str(pos)].items()}
            x = _apply_layer(cfg, pos, _block(params, pos, b), x, positions,
                             cache=c, cache_len=cache_len, enc_out=enc_out)
    h = rms_norm(x, params["final_ln"], cfg.norm_eps)
    return _logits(cfg, params, h[:, 0]), caches


def prefill(cfg: ModelConfig, params, tokens, enc_embeds=None):
    """Prefill forward returning last-position logits (B, V) in f32."""
    h = forward(cfg, params, tokens, enc_embeds=enc_embeds)
    return _logits(cfg, params, h[:, -1])
