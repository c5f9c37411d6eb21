"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE 16e top-2 every
other layer [arXiv:2403.19887; hf]. 32L d_model=4096 32H (kv=8)
d_ff=14336 vocab=65536."""
from repro_torch.models.config import LayerKind, ModelConfig, MoECfg

M, A = LayerKind.MAMBA, LayerKind.ATTN


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=65536,
        mlp="swiglu",
        # jamba period-8 block: attention at position 4, mamba elsewhere
        pattern=(M, M, M, M, A, M, M, M),
        moe=MoECfg(num_experts=16, top_k=2, d_ff_expert=14336,
                   every_k_layers=2),
        mamba_d_state=16, mamba_expand=2, mamba_conv=4,
        tie_embeddings=False,
    )


def smoke_config() -> ModelConfig:
    return config().reduced(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                            head_dim=16, d_ff=128, vocab=151,
                            moe=MoECfg(num_experts=4, top_k=2,
                                       d_ff_expert=64, every_k_layers=2),
                            remat="none")
