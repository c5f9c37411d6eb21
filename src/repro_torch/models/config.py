"""Model configuration for the assigned architecture zoo (a copy of
``repro.models.config``: dataclasses only, no backend)."""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_k_layers: int = 1        # MoE on layers where idx % k == k-1
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    skew_aware: bool = True        # heavy-expert broadcast path (DESIGN §2)


# layer mixer kinds
class LayerKind:
    ATTN = "attn"
    ATTN_LOCAL = "attn_local"      # sliding-window attention
    MAMBA = "mamba"
    RWKV = "rwkv"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    mlp: str = "swiglu"                     # swiglu | geglu | sq_relu | gelu
    rope_theta: float = 10000.0
    # layer pattern: tuple of LayerKind, cycled over layers. len must
    # divide n_layers (the scan period).
    pattern: Tuple[str, ...] = (LayerKind.ATTN,)
    window: Optional[int] = None            # for attn_local layers
    attn_softcap: Optional[float] = None    # gemma2
    final_softcap: Optional[float] = None   # gemma2
    moe: Optional[MoECfg] = None
    # ssm params
    rwkv_head_dim: int = 64
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    # enc-dec (whisper)
    enc_layers: int = 0                     # 0 => decoder-only
    enc_seq: int = 0
    cross_attention: bool = False
    # vlm
    n_image_tokens: int = 0
    # misc
    embed_scale: bool = False               # gemma: x * sqrt(d_model)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # training. "dots": block remat with dots-saveable policy — matmul
    # outputs (and their TP collectives) are saved, elementwise ops are
    # recomputed; cuts backward collective bytes ~1/3 for TP models at
    # a bounded activation-memory cost (§Perf C3).
    remat: str = "dots"                     # none | block | dots
    seq_chunk_loss: int = 512               # chunked xent block
    attn_chunk: int = 1024                  # chunked-attention KV block
    rwkv_chunk: int = 64

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.period == 0, (self.n_layers, self.pattern)
        return self.n_layers // self.period

    def layer_kind(self, pos: int) -> str:
        return self.pattern[pos % self.period]

    def has_moe_at(self, pos: int) -> bool:
        m = self.moe
        return m is not None and (pos % m.every_k_layers) == m.every_k_layers - 1

    def reduced(self, **over) -> "ModelConfig":
        return replace(self, **over)

    # -- quick parameter count (for docs / roofline MODEL_FLOPS) ----------
    def param_count(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
                q = d * self.n_heads * self.hd
                kv = 2 * d * self.n_kv_heads * self.hd
                o = self.n_heads * self.hd * d
                total += q + kv + o
            elif kind == LayerKind.MAMBA:
                din = self.mamba_expand * d
                total += 2 * d * din + din * self.mamba_conv \
                    + din * (self.mamba_d_state * 2 + 1) + din * d + din
            elif kind == LayerKind.RWKV:
                total += 4 * d * d + 2 * d  # r,k,v,o + decay/bonus approx
            if self.has_moe_at(i):
                m = self.moe
                mult = 3 if self.mlp in ("swiglu", "geglu") else 2
                total += m.num_experts * mult * d * m.d_ff_expert
                total += d * m.num_experts  # router
                if m.dense_residual:
                    total += mult * d * ff
            else:
                mult = 3 if self.mlp in ("swiglu", "geglu") else 2
                total += mult * d * ff
            total += 2 * d  # norms
        if self.enc_layers:
            # encoder stack (attention + mlp) + cross-attention in decoder
            mult = 3 if self.mlp in ("swiglu", "geglu") else 2
            enc = self.enc_layers * (4 * d * self.n_heads * self.hd
                                     + mult * d * ff + 2 * d)
            cross = self.n_layers * 4 * d * self.n_heads * self.hd
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        mult = 3 if self.mlp in ("swiglu", "geglu") else 2
        full = self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if self.has_moe_at(i))
        inactive = n_moe_layers * (m.num_experts - m.top_k) \
            * mult * self.d_model * m.d_ff_expert
        return full - inactive
