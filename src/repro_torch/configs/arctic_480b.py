"""Snowflake Arctic 480B — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base]. 35L d_model=7168 56H (kv=8)
d_ff=4864 vocab=32000. The 128-expert top-2 routing is the paper's
many-heavy-key regime: skew-aware dispatch is on (DESIGN.md §2)."""
from repro_torch.models.config import LayerKind, ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, head_dim=128,
        d_ff=4864, vocab=32000,
        mlp="swiglu",
        pattern=(LayerKind.ATTN,),
        moe=MoECfg(num_experts=128, top_k=2, d_ff_expert=4864,
                   every_k_layers=1, dense_residual=True),
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=96, vocab=139,
                            moe=MoECfg(num_experts=8, top_k=2,
                                       d_ff_expert=48, every_k_layers=1,
                                       dense_residual=True),
                            remat="none")
