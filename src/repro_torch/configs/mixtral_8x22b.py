"""Mixtral 8x22B — 8 experts top-2 MoE, sliding-window attention
[arXiv:2401.04088; hf]. 56L d_model=6144 48H (kv=8) expert_ff=16384
vocab=32768."""
from repro_torch.models.config import LayerKind, ModelConfig, MoECfg


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", n_layers=56, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab=32768,
        mlp="swiglu",
        pattern=(LayerKind.ATTN_LOCAL,),      # SWA on every layer
        window=4096,
        moe=MoECfg(num_experts=8, top_k=2, d_ff_expert=16384,
                   every_k_layers=1),
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab=149, window=8,
                            moe=MoECfg(num_experts=4, top_k=2,
                                       d_ff_expert=96, every_k_layers=1),
                            remat="none")
